"""Tensor parallelism over the GRAM dimension.

PyTorch counterpart of ``stringsearchlib_tpu.parallel.tp``: every shard
holds ALL terms and edges (replicated) but only a contiguous slice of the
gram->term postings CSR.  A query's hit counts are the sum over its gram
slots of posting contributions, and grams partition cleanly, so each shard
counts hits for its local gram slice (one postings expansion, K6, per
shard) and one sum on the mesh's first device (the reference's ``psum``)
reconstructs exact global counts - the contraction-dimension split of the
reference's per-gram accumulation loop (nGramSearch.hpp:289-298).

Term sharding (``dist``) scales throughput; this split scales posting
capacity, at the cost of one (B, Tl) sum per batch.  After the sum the hits
are bit-identical to the single-card ones, so the exact candidate back half
(search.candidates) runs unchanged, once, on the first device; guard-failed
rows retry on a dense step with the same summed front, whose short and
brute tiers run K5.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import INT32_MAX
from ..index.build import HostIndex
from ..search.candidates import _dense_hits_finish
from ..search.editdist import dp_match, dp_match_tiered
from ..search.engine import (
    SearchEngine,
    _fetch,
    _finalize,
    _floor_and_promote,
    _next_pow2,
    _pack,
    _promo_mask,
    _propagate_raw,
    _segment_max,
    _unpack,
    slot_mass,
)
from ..search.overlap import gather_hits
from .dist import Mesh, host_array, make_mesh, replicate, upload

AXIS = "grams"

_NEG_INF = float("-inf")

# leaves partitioned over the gram axis; the rest replicate
_G_STACKED = ("gram_ptr", "gram_terms")


@dataclasses.dataclass
class GramShardedIndex:
    """Host handle for a gram-sharded index (leaves host numpy)."""

    host: HostIndex
    n_shards: int
    g_c: int  # gram slots per shard
    leaves: dict
    host_shard_posting_lens: np.ndarray  # (S, G) local posting lengths


def shard_index_by_grams(host: HostIndex, n_shards: int) -> GramShardedIndex:
    """Partition the postings CSR into n_shards contiguous gram-slot
    slices.  Term/edge/key arrays replicate (term ids stay global), so no
    id remapping is needed anywhere.  Numpy only; a card-resident index is
    read to host numpy."""
    di = host.device
    s = n_shards
    npa = host_array
    ptr = npa(di.gram_ptr).astype(np.int64)
    terms = npa(di.gram_terms).astype(np.int32)
    g = ptr.shape[0] - 1
    g_c = -(-max(g, 1) // s)

    lens = np.diff(ptr)
    lens2d = np.zeros((s, g), np.int64)
    gram_ptr_s = np.zeros((s, g_c + 1), np.int32)
    pmax = 1
    spans = []
    for i in range(s):
        lo, hi = min(i * g_c, g), min((i + 1) * g_c, g)
        p0, p1 = int(ptr[lo]), int(ptr[hi])
        spans.append((lo, hi, p0, p1))
        pmax = max(pmax, p1 - p0)
        local = (ptr[lo : hi + 1] - p0).astype(np.int32)
        gram_ptr_s[i, : local.shape[0]] = local
        gram_ptr_s[i, local.shape[0] :] = local[-1] if local.size else 0
        lens2d[i, lo:hi] = lens[lo:hi]
    gram_terms_s = np.zeros((s, pmax), np.int32)
    for i, (lo, hi, p0, p1) in enumerate(spans):
        gram_terms_s[i, : p1 - p0] = terms[p0:p1]

    pt, xt = host.prim_tables()
    leaves = {
        "gram_ptr": gram_ptr_s,
        "gram_terms": gram_terms_s,
        "short_tokens": npa(di.short_tokens),
        "short_lengths": npa(di.short_lengths),
        "long_tokens": npa(di.long_tokens),
        "long_lengths": npa(di.long_lengths),
        "term_wmax": npa(di.term_wmax),
        "term_extra_ptr": npa(di.term_extra_ptr),
        "extra_key": npa(di.extra_key),
        "edge_term": npa(di.edge_term),
        "edge_key": npa(di.edge_key),
        "edge_weight": npa(di.edge_weight),
        "key_len": npa(di.key_len),
        "pt": npa(pt),
        "xt": npa(xt),
    }
    return GramShardedIndex(
        host=host, n_shards=s, g_c=g_c, leaves=leaves,
        host_shard_posting_lens=lens2d,
    )


class _RepView:
    """DeviceIndex-shaped view over the replicated leaves (global term and
    key id spaces - no remapping)."""

    def __init__(self, lv: dict):
        for name, arr in lv.items():
            if name not in ("pt", "xt"):
                setattr(self, name, arr)

    @property
    def n_short(self):
        return self.short_tokens.shape[0]

    @property
    def n_long(self):
        return self.long_tokens.shape[0]

    @property
    def n_keys(self):
        return self.key_len.shape[0]


def _local_slots(qslots, lo: int, g_c: int):
    """Global gram slots -> this slice's local slots [0, g_c), -1 for every
    slot another slice holds."""
    local = qslots - lo
    return torch.where((qslots >= 0) & (local >= 0) & (local < g_c), local, -1)


def _local_hits(lv: dict, qslots, sid: int, g_c: int, n_long: int, s_cap: int):
    """Per-shard partial hit counts: remap global gram slots into shard
    ``sid``'s local slice (others -1), expand the local CSR (K6), count.
    The slice offset comes from the loop index, the reference's
    ``lax.axis_index``."""
    return gather_hits(
        lv["gram_ptr"], lv["gram_terms"], _local_slots(qslots, sid * g_c, g_c),
        n_long, s_cap,
    )


def _summed_hits(mesh: Mesh, shards: list, qbufs: dict, g_c: int,
                 n_long: int, s_cap: int):
    """(B, Tl) int32 global hit counts on the first device: every shard's
    local hits, summed (the reference's psum)."""
    return mesh.reduce_sum([
        _local_hits(lv, qbufs[lv["key_len"].device][2], sid, g_c, n_long, s_cap)
        for sid, lv in zip(mesh.shard_ids, shards)
    ])


def _hit_scores(di, qtokens, qlens, hits, n_qgrams, use_short, *,
                compute_short: bool, brute: bool, long_buckets=()):
    """Both tiers' term scores from exact long-tier ``hits`` (B, Tl): the
    short tier by K5 where ``compute_short`` or ``brute`` (gated by
    ``use_short`` unless ``brute``), the long tier by K5 as well where
    ``brute``.  Returns (sA, maskA, sB, maskB), each (B, T)."""
    ts, tl = di.n_short, di.n_long
    b = qtokens.shape[0]
    dev = hits.device
    qlen_f = torch.clamp(qlens.to(torch.float32), min=1.0)[:, None]
    if compute_short or brute:
        m_short = dp_match(di.short_tokens, di.short_lengths, qtokens, qlens)
        s_short = m_short.to(torch.float32) / qlen_f
        mask_s = (use_short | brute)[:, None].expand(b, ts)
    else:
        s_short = torch.zeros((b, ts), dtype=torch.float32, device=dev)
        mask_s = torch.zeros((b, ts), dtype=torch.bool, device=dev)
    if brute:
        m_long = dp_match_tiered(
            di.long_tokens, di.long_lengths, qtokens, qlens, long_buckets
        )
        s_a = torch.cat([s_short, m_long.to(torch.float32) / qlen_f], 1)
        mask_a = torch.ones((b, ts + tl), dtype=torch.bool, device=dev)
    else:
        s_a = torch.cat(
            [s_short, torch.zeros((b, tl), dtype=torch.float32, device=dev)], 1
        )
        mask_a = torch.cat(
            [mask_s, torch.zeros((b, tl), dtype=torch.bool, device=dev)], 1
        )
    nqg = n_qgrams.to(torch.int32)[:, None]
    s_b_long = hits.to(torch.float32) / torch.clamp(nqg.to(torch.float32), min=1.0)
    s_b = torch.cat(
        [torch.zeros((b, ts), dtype=torch.float32, device=dev), s_b_long], 1
    )
    mask_b = torch.cat(
        [torch.zeros((b, ts), dtype=torch.bool, device=dev),
         (hits > 0) & (nqg > 0)], 1,
    )
    return s_a, mask_a, s_b, mask_b


def tp_candidates_step(
    mesh: Mesh, shards: list, qbufs: dict, promo_terms, promo_weights,
    threshold, *, g_c: int, compute_short: bool, s_cap: int, n_cand: int,
    n_edge: int, top_k: int, block_sel: bool,
):
    """Candidate-sparse batched search over the gram-sharded index: summed
    partial hits (the only merge), then the unchanged exact candidate back
    half once on the first device.  ``qbufs[device]`` = (qtokens, qlens,
    qslots, n_qgrams, use_short, promo_ids, limits); ``promo_terms`` /
    ``promo_weights`` (B, PK, PE) on the first device.  Returns
    _dense_hits_finish's (count, keys, scores, lens, exact)."""
    rep = shards[0]
    di = _RepView(rep)
    hits = _summed_hits(mesh, shards, qbufs, g_c, di.n_long, s_cap)
    qt, ql, _, ng, us, pr, lim = qbufs[mesh.device]
    return _dense_hits_finish(
        di, rep["pt"], rep["xt"], hits, qt, ql, ng, us, pr, promo_terms,
        promo_weights, lim, threshold, compute_short=compute_short,
        n_cand=n_cand, n_edge=n_edge, top_k=top_k, block_sel=block_sel,
    )


def tp_dense_step(
    mesh: Mesh, shards: list, qbufs: dict, threshold, *, g_c: int,
    compute_short: bool, brute: bool, s_cap: int, top_k: int,
    long_buckets: tuple = (),
):
    """Dense batched search (brute-short queries and candidate-guard
    retries): summed partial hits, then the single-card dense scoring (both
    tiers -> calcScore propagate -> full ranking) once on the first device.
    ``qbufs[device]`` = (qtokens, qlens, qslots, n_qgrams, use_short,
    promo_ids).  ``long_buckets``: width buckets for the brute whole-tier DP
    (the replicated long tier is length-sorted, as on one card)."""
    di = _RepView(shards[0])
    hits = _summed_hits(mesh, shards, qbufs, g_c, di.n_long, s_cap)
    qt, ql, _, ng, us, pr = qbufs[mesh.device]
    s_a, mask_a, s_b, mask_b = _hit_scores(
        di, qt, ql, hits, ng, us, compute_short=compute_short, brute=brute,
        long_buckets=long_buckets,
    )
    eq_key = _promo_mask(di.n_keys, pr)
    key_val, promo = _propagate_raw(di, s_a, mask_a, s_b, mask_b, eq_key, threshold)
    score, reached = _floor_and_promote(key_val, promo)
    return _finalize(di, score, reached, top_k)


def tp_wildcard_step(mesh: Mesh, shards: list, *, top_k: int):
    """Wildcard over replicated edges (no postings touched): every key at
    its max edge weight (nGramSearch.hpp:356-369)."""
    di = _RepView(shards[0])
    score = _segment_max(di.edge_weight[None, :], di.edge_key, di.n_keys, _NEG_INF)
    reached = score > _NEG_INF
    score = torch.where(reached, score, 0.0)
    return _finalize(di, score, reached, top_k)


class GramShardedEngine(SearchEngine):
    """Query front end over a GramShardedIndex.

    Shares the HOST-side helpers with SearchEngine (normalization, slot
    lookup, chunking, promo tables); every device dispatch is a summed step
    above.  ``mesh`` defaults to the CUDA cards; build the host index with
    ``device="cpu"`` - nothing here uploads the unsharded postings CSR (the
    thing this split exists to divide)."""

    # the sharded passes count no retried or dense rows: each call's
    # ``last_routing["call"]`` holds its queries only
    CALL_COUNTERS = ("queries",)

    def __init__(self, gx: GramShardedIndex, mesh: Optional[Mesh] = None):
        super().__init__(gx.host)
        if mesh is None:
            mesh = make_mesh(gx.n_shards, AXIS)
        if mesh.shape[0] != gx.n_shards:
            raise ValueError(f"mesh axis of {mesh.shape[0]} for {gx.n_shards} shards")
        self.gx = gx
        self.mesh = mesh
        self.device = mesh.device
        self._dev: Optional[list] = None
        self._wild_cache: dict = {}

    def _leaves(self) -> list:
        """One leaf dict per shard on its device: its CSR slice, and the
        replicated leaves uploaded once per distinct device."""
        if self._dev is None:
            rep: dict = {}
            shards = []
            for sid, d in zip(self.mesh.shard_ids, self.mesh.row_devices):
                if d not in rep:
                    rep[d] = {
                        name: upload(arr, d)
                        for name, arr in self.gx.leaves.items()
                        if name not in _G_STACKED
                    }
                lv = dict(rep[d])
                for name in _G_STACKED:
                    lv[name] = upload(self.gx.leaves[name][sid], d)
                shards.append(lv)
            self._dev = shards
        return self._dev

    def _search_impl(self, query, threshold=0.0, limit=0):
        return self._search_batch_impl(
            [query], threshold, limit, 256, 32, "auto"
        )[0]

    def _wildcard(self, limit: int):
        if limit == 0:
            limit = INT32_MAX
        top_k = self._top_k(limit)
        cached = self._wild_cache.get(top_k)
        if cached is None:
            res = tp_wildcard_step(self.mesh, self._leaves(), top_k=top_k)
            cached = _unpack(_fetch([_pack(*res)]), int(res[1].shape[1]))
            self._wild_cache[top_k] = cached
        return self._emit_one(*cached, limit)

    def _s_cap(self, slots, nn) -> int:
        """Static lane bound = max over shards of any query's LOCAL distinct
        posting mass (each shard expands only its own slice;
        ``overlap.gather_hits``'s lanes)."""
        d_total = slot_mass(self.gx.host_shard_posting_lens, slots[:nn])[1]
        return _next_pow2(max(d_total, 1), 1024)

    def _search_batch_impl(
        self, queries, threshold, limit, batch_bucket, qp_bucket, mode
    ):
        if limit == 0:
            limit = INT32_MAX
        out: list = [None] * len(queries)
        if not self.host.indexed:
            return [([], [])] * len(queries)

        want_cand = mode != "dense" and (
            mode == "candidates"
            or (
                limit <= self.CAND_MAX_LIMIT
                and self.host.n_terms >= self.CAND_MIN_TERMS
            )
        )
        ke_counts = self.host.host_key_edge_counts
        items, brute_items = [], []
        for i, q in enumerate(queries):
            raw = q if isinstance(q, str) else str(q)
            if len(raw) == 0 or raw == "*":
                if self.gx.leaves["edge_key"].size == 0:
                    out[i] = ([], [])
                else:
                    out[i] = self._wildcard(limit)
                continue
            qnorm, qlen = self._normalize_query(raw)
            if qlen == 0:
                out[i] = ([], [])
            elif qlen <= self.cfg.brute_force_cutoff:
                brute_items.append((i, qnorm, qlen))
            else:
                promo = None
                if want_cand:
                    pids = self.host.promo_key_ids(qnorm, qlen)
                    if pids.size <= self.PROMO_KEYS and (
                        pids.size == 0
                        or int(ke_counts[pids].max()) <= self.PROMO_EDGES
                    ):
                        promo = pids
                items.append((i, qnorm, qlen, promo))

        cand = [it for it in items if want_cand and it[3] is not None]
        dense = [it for it in items if not (want_cand and it[3] is not None)]
        if cand:
            dense.extend(
                self._run_tp_cand(cand, threshold, limit, batch_bucket, out)
            )
        if dense:
            self._run_tp_dense(
                dense, threshold, limit, batch_bucket, out, brute=False
            )
        if brute_items:
            self._run_tp_dense(
                brute_items, threshold, limit, 32, out, brute=True
            )
        return out

    def _chunk_qp(self, items) -> int:
        qmax = max((it[2] for it in items), default=1)
        return max(
            _next_pow2(qmax, max(16, self.cfg.query_pad // 4)),
            self.cfg.gram_size + 1,
        )

    def _run_tp_cand(self, items, threshold, limit, batch_bucket, out):
        """Exact candidate path on summed hits; returns guard-failed rows
        for the dense retry."""
        qp = self._chunk_qp(items)
        b_all, qtok, qlens, slots, nqg, use_short, _, _ = self._prep_rows(
            items, qp
        )
        s_cap = self._s_cap(slots, len(items))
        compute_short = bool(use_short.any())
        promo_all = np.full((b_all, self.PROMO_KEYS), -1, np.int32)
        for r, it in enumerate(items):
            promo_all[r, : it[3].size] = it[3]
        promo_t, promo_w = self._promo_tables(promo_all)
        tl = int(self.gx.leaves["long_lengths"].shape[0])
        ts = int(self.gx.leaves["short_lengths"].shape[0])
        n_lanes = (ts if compute_short else 0) + tl
        n_cand = min(
            self.CAND_TERMS_FAST, max(_next_pow2(n_lanes, 16), 16), n_lanes
        )
        x_total = int(self.gx.leaves["extra_key"].shape[0])
        n_edge = min(
            max(_next_pow2(max(x_total, 1), 16), 16), self.CAND_EDGES
        )
        top_k = _next_pow2(limit, 16)
        block_sel = n_lanes >= 4 * n_cand * 128
        shards = self._leaves()
        bsz = min(self._batch_cap(batch_bucket), b_all)
        pending = []
        for lo in range(0, len(items), bsz):
            hi = min(lo + bsz, len(items))
            b = _next_pow2(hi - lo, min(bsz, 16))
            sl = slice(lo, lo + b)
            lim_arr = np.full((b,), min(limit, 2**30), np.int32)
            qbufs = replicate(
                (qtok[sl], qlens[sl], slots[sl], nqg[sl], use_short[sl],
                 promo_all[sl], lim_arr),
                self.mesh.row_devices,
            )
            res = tp_candidates_step(
                self.mesh, shards, qbufs, upload(promo_t[sl], self.device),
                upload(promo_w[sl], self.device), np.float32(threshold),
                g_c=self.gx.g_c, compute_short=compute_short, s_cap=s_cap,
                n_cand=n_cand, n_edge=n_edge, top_k=top_k, block_sel=block_sel,
            )
            pending.append((lo, hi, _pack(res[0], res[1], res[2], res[4])))
        fetched = _fetch([blk for _, _, blk in pending])
        width = (fetched.shape[1] - 2) // 2
        retry = []
        row0 = 0
        counts, ids_b, scores_b, exact = _unpack(fetched, width, True)
        exact = exact.tolist()
        rows, positions = [], []
        for lo, hi, blk in pending:
            for r, item in enumerate(items[lo:hi]):
                if exact[row0 + r]:
                    rows.append(row0 + r)
                    positions.append(item[0])
                else:
                    retry.append(item)
            row0 += blk.shape[0]
        self._emit_rows(
            out, positions, counts[rows], ids_b[rows], scores_b[rows], limit
        )
        return retry

    def _run_tp_dense(self, items, threshold, limit, batch_bucket, out,
                      *, brute):
        qp = self._chunk_qp(items)
        top_k = self._top_k(limit)
        b_all, qtok, qlens, slots, nqg, use_short, _, _ = self._prep_rows(
            items, qp
        )
        s_cap = self._s_cap(slots, len(items))
        compute_short = bool(use_short.any()) or brute
        shards = self._leaves()
        if brute:
            # the whole-tier DP holds O(B x T x (w+2)) scan state per
            # batch (same model as SearchEngine._run_brute_chunks)
            lt = self.gx.leaves["long_tokens"]
            st = self.gx.leaves["short_tokens"]
            w = max(
                int(lt.shape[1]) if lt.ndim > 1 else 0,
                int(st.shape[1]) if st.ndim > 1 else 0,
            )
            per_q = 12 * max(self.host.n_terms, 1) * (w + 2) + (1 << 18)
            cap = max(int(self.BATCH_HBM_BUDGET // per_q), 1)
            bsz = 1
            while bsz * 2 <= min(cap, batch_bucket, b_all):
                bsz *= 2
        else:
            bsz = min(self._batch_cap(batch_bucket), b_all)
        long_buckets = self.host.long_dp_buckets() if brute else ()
        pending = []
        for lo in range(0, len(items), bsz):
            hi = min(lo + bsz, len(items))
            b = _next_pow2(hi - lo, min(bsz, 16))
            sl = slice(lo, lo + b)
            qbufs = replicate(
                (qtok[sl], qlens[sl], slots[sl], nqg[sl], use_short[sl],
                 self._promo_array(items[lo:hi], b)),
                self.mesh.row_devices,
            )
            res = tp_dense_step(
                self.mesh, shards, qbufs, np.float32(threshold),
                g_c=self.gx.g_c, compute_short=compute_short, brute=brute,
                s_cap=s_cap, top_k=top_k, long_buckets=long_buckets,
            )
            pending.append((items[lo:hi], b, _pack(*res)))
        self._emit_dense(pending, limit, out)
