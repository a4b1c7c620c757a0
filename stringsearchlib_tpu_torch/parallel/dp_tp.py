"""2-D DP x TP composition: mesh axes ('shards', 'grams').

PyTorch counterpart of ``stringsearchlib_tpu.parallel.dp_tp``.
``parallel.dist`` scales throughput by sharding terms (DP); ``parallel.tp``
scales posting capacity by sharding the gram axis (TP).  This module
composes them on one 2-D mesh: cell (i, j) holds the j-th gram-slot slice
of term shard i's postings CSR, and term shard i's tier arrays and edges
live on the first cell of row i.

Per batch, each cell expands only its local (term-chunk x gram-slice)
postings into per-term hit counts (K6); one sum over the 'grams' axis on the
row's device reconstructs exact local-term hits (the contraction split of
the reference's accumulation loop, nGramSearch.hpp:289-298); scoring then
proceeds exactly as the 1-D dense sharded step (K5 on the short and brute
tiers) and a max over 'shards' on the mesh's first device merges per-key
maxima.  Outputs equal the single-card dense path's.  Every query takes the
dense route: this engine is the capacity configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..index.build import HostIndex
from ..search.engine import (
    _finalize,
    _floor_and_promote,
    _next_pow2,
    _pack,
    _promo_mask,
    _propagate_raw,
)
from ..search.overlap import gather_hits
from . import dist
from .dist import Mesh, _devices, replicate, upload
from .tp import _hit_scores, _local_slots

AXIS_T = dist.AXIS  # 'shards' (terms)
AXIS_G = "grams"


def make_mesh_2d(st: int, sg: int, device=None) -> Mesh:
    """(st, sg) mesh, axes ('shards', 'grams'), row-major over the devices:
    the first st * sg CUDA cards by default (a RuntimeError without a
    card), every cell on ``device`` when it is one device (``"cpu"``,
    ``"cuda:0"``), or the st * sg devices it lists."""
    return Mesh(_devices(st * sg, device), (AXIS_T, AXIS_G), (st, sg))


@dataclasses.dataclass
class DpTpIndex:
    """Host handle: 1-D term-sharded leaves plus the per-term-shard
    postings CSR re-split into contiguous gram-slot slices."""

    sx: dist.ShardedIndex
    sg: int
    g_c: int  # gram slots per gram shard
    gram_ptr2: np.ndarray  # (St, Sg, g_c + 1) local-slice CSR offsets
    gram_terms2: np.ndarray  # (St, Sg, p_max) local term ids
    lens3: np.ndarray  # (St, Sg, G) per-cell posting lengths (s_cap)


def shard_index_2d(host: HostIndex, st: int, sg: int) -> DpTpIndex:
    """Term-shard with dist.shard_index, then slice each term shard's
    postings CSR over the gram axis.  A contiguous gram-slot range is a
    contiguous CSR span, so the split is pure slicing - no re-sort."""
    sx = dist.shard_index(host, st)
    ptr = sx.leaves["gram_ptr"].astype(np.int64)  # (St, G+1)
    terms = sx.leaves["gram_terms"]  # (St, Pmax)
    g = ptr.shape[1] - 1
    g_c = -(-max(g, 1) // sg)
    bounds = np.minimum(np.arange(sg + 1) * g_c, g)  # gram-slot cuts
    starts = ptr[:, bounds[:-1]]  # (St, Sg)
    ends = ptr[:, bounds[1:]]
    p_max = max(int((ends - starts).max()), 1)
    gram_terms2 = np.zeros((st, sg, p_max), np.int32)
    gram_ptr2 = np.zeros((st, sg, g_c + 1), np.int32)
    lens3 = np.zeros((st, sg, g), np.int64)
    for i in range(st):
        for j in range(sg):
            lo, hi = int(starts[i, j]), int(ends[i, j])
            gram_terms2[i, j, : hi - lo] = terms[i, lo:hi]
            glo, ghi = int(bounds[j]), int(bounds[j + 1])
            gram_ptr2[i, j, : ghi - glo + 1] = ptr[i, glo : ghi + 1] - lo
            gram_ptr2[i, j, ghi - glo + 1 :] = ptr[i, ghi] - lo
            lens3[i, j, glo:ghi] = np.diff(ptr[i, glo : ghi + 1])
    return DpTpIndex(
        sx=sx, sg=sg, g_c=g_c, gram_ptr2=gram_ptr2,
        gram_terms2=gram_terms2, lens3=lens3,
    )


def dp_tp_dense_step(
    mesh: Mesh, shards: list, postings2: list, qbufs: dict, threshold, *,
    g_c: int, compute_short: bool, brute: bool, s_cap: int, top_k: int,
):
    """Batched dense search over the ('shards', 'grams') mesh.

    ``shards``: term shard i's leaves on row i's device; ``postings2[i][j]``
    = (gram_ptr, gram_terms) of cell (i, j) on its device; ``qbufs[device]``
    = (qtokens, qlens, qslots, n_qgrams, use_short, promo_ids).  Each cell:
    local gram-slice hit expansion -> sum over 'grams' on the row's device
    -> exact local-term hits -> tier scores -> per-key raw max -> max over
    'shards' on the first device."""
    sg = mesh.shape[1]
    vals, promos = [], []
    for i, lv in enumerate(shards):
        row_dev = lv["key_len"].device
        di = dist._ShardView(lv)
        parts = []
        for j, (gp, gt) in enumerate(postings2[i]):
            slots = qbufs[mesh.devices[i * sg + j]][2]
            parts.append(gather_hits(
                gp, gt, _local_slots(slots, j * g_c, g_c), di.n_long, s_cap
            ))
        hits = parts[0].to(row_dev, non_blocking=True)
        for p in parts[1:]:
            hits = hits + p.to(row_dev, non_blocking=True)
        qt, ql, _, ng, us, pr = qbufs[row_dev]
        s_a, mask_a, s_b, mask_b = _hit_scores(
            di, qt, ql, hits, ng, us, compute_short=compute_short, brute=brute,
        )
        eq_key = _promo_mask(di.n_keys, pr)
        key_val, promo = _propagate_raw(
            di, s_a, mask_a, s_b, mask_b, eq_key, threshold
        )
        vals.append(key_val)
        promos.append(promo)
    key_val = mesh.reduce_max(vals)
    promo = mesh.reduce_max(promos)
    score, reached = _floor_and_promote(key_val[:, :-1], promo[:, :-1])
    return _finalize(dist._FinalView(shards[0]["key_len"]), score, reached, top_k)


class DpTpEngine(dist.ShardedEngine):
    """Query front end over the 2-D DP x TP mesh.

    Reuses every host-side helper and the wildcard step from ShardedEngine
    (edges live with their term shard, so the 'shards' max stays correct);
    the batched dense and brute paths run the 2-D step above.  The
    candidate-sparse 1-D path is disabled - this engine is the CAPACITY
    configuration, every query takes the exact dense route.  ``mesh``
    defaults to the CUDA cards (``make_mesh_2d``)."""

    def __init__(self, dx: DpTpIndex, mesh: Optional[Mesh] = None):
        if mesh is None:
            mesh = make_mesh_2d(dx.sx.n_shards, dx.sg)
        if mesh.shape != (dx.sx.n_shards, dx.sg):
            raise ValueError(f"mesh {mesh.shape} for ({dx.sx.n_shards}, {dx.sg}) shards")
        super().__init__(dx.sx, mesh)
        self.dx = dx
        self._dev2: Optional[list] = None

    def _postings2(self) -> list:
        """[i][j] = (gram_ptr, gram_terms) of cell (i, j) on its device."""
        if self._dev2 is None:
            sg = self.dx.sg
            self._dev2 = [
                [
                    (upload(self.dx.gram_ptr2[sid, j], self.mesh.devices[i * sg + j]),
                     upload(self.dx.gram_terms2[sid, j], self.mesh.devices[i * sg + j]))
                    for j in range(sg)
                ]
                for i, sid in enumerate(self.mesh.shard_ids)
            ]
        return self._dev2

    # every query is dense on this engine
    def _run_candidate_chunks(self, items, threshold, limit, batch_bucket,
                              qp, out):
        return list(items)

    def _slot_mass(self, rowslots: np.ndarray) -> int:
        """s_cap: max over (term shard, gram shard) of any query's LOCAL
        posting mass (each cell expands only its own slice)."""
        lens3 = self.dx.lens3  # (St, Sg, G)
        if not lens3.size or not rowslots.size:
            return 0
        st, sg, g = lens3.shape
        flat = lens3.reshape(st * sg, g)
        per = np.where(
            rowslots[None, :, :] >= 0,
            flat[:, np.clip(rowslots, 0, None)], 0,
        ).sum(axis=2)
        return int(per.max())

    def _run_dense_chunks(self, items, threshold, limit, batch_bucket, qp,
                          out):
        self._dispatch_2d(items, threshold, limit, batch_bucket, qp, out,
                          brute=False)

    def _run_brute_chunks(self, items, threshold, limit, out):
        g = self.cfg.gram_size
        qp = max(_next_pow2(self.cfg.brute_force_cutoff + 1, 8), g + 1)
        self._dispatch_2d(items, threshold, limit, 16, qp, out, brute=True)

    def _dispatch_2d(self, items, threshold, limit, batch_bucket, qp, out,
                     *, brute):
        post2 = self._postings2()
        shards = self._leaves()
        top_k = self._top_k(limit)
        pending = []
        for lo in range(0, len(items), batch_bucket):
            chunk = items[lo : lo + batch_bucket]
            b, qtok, qlens, slots, nqg, use_short, s_cap = self._prep_rows(
                chunk, qp
            )
            if brute:
                use_short = np.ones(b, bool)
            compute_short = bool(use_short.any()) and self.sx.ts_c > 0
            qbufs = replicate(
                (qtok, qlens, slots, nqg, use_short, self._chunk_promo(chunk, b)),
                self.mesh.devices,
            )
            res = dp_tp_dense_step(
                self.mesh, shards, post2, qbufs, np.float32(threshold),
                g_c=self.dx.g_c, compute_short=compute_short or brute,
                brute=brute, s_cap=s_cap, top_k=top_k,
            )
            pending.append((chunk, b, _pack(*res)))
        self._emit_dense(pending, limit, out)
