"""Sharded search over a mesh of devices: term sharding.

PyTorch counterpart of ``stringsearchlib_tpu.parallel.dist``.  The
reference runs one ``jax.shard_map`` program over a ``Mesh`` and merges the
per-shard outputs with ``all_gather`` / ``lax.pmax``, replicated on every
device.  Here one controller per process does the same work in the same
order:

  * terms (both tiers), their postings, their term->key edges and their
    key->edge CSR are partitioned into strided per-shard chunks
    (``shard_index``, numpy only, the reference's leaves bit for bit);
  * each shard's leaves live on its own device (``Mesh``); queries are
    copied to every distinct device of the mesh;
  * each per-shard step is one pass of a Python loop over the shards that
    launches that shard's kernels on its device (K6's postings expansion
    on the ``runs`` front and in the dense steps, ``torch._int_mm`` on the
    ``matmul`` front, K5 on the short and brute tiers) and never waits for
    the device, so the shards of a mesh of several cards overlap;
  * the merge is the one sync point: the per-shard outputs are stacked on
    the mesh's first device (``Mesh.stack``, for the reference's
    ``all_gather``) or folded there with a max (``Mesh.reduce_max``, for
    ``pmax``), and the replicated back half runs once on that device;
  * the candidate step returns each shard's local top-k of (key, score,
    key length) triples in GLOBAL key space plus a sound upper bound on
    every key contribution it did not return (``with_bound``), and
    ``_merge_shard_topk`` dedups by key with a max (the calcScore combine),
    re-ranks by (score desc, key length asc, key id), and accepts a row
    when every shard closed its bound or the merged limit-th score strictly
    exceeds every shard's bound; rows that fail retry on the dense step.

Wildcard, brute-force-short (qlen <= gram_size) and dense-retry queries use
per-key merges: each shard scores its chunk into a (B, K+1) vector (ghost
key K absorbs padding) and the vectors merge with a max.

No unsharded index reaches a device: ``shard_index`` reads a host-resident
index (``build_index(..., device="cpu")``; a card-resident one is read to
host numpy first) and the engine uploads only per-shard slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..config import INT32_MAX
from ..index.build import HostIndex, incidence_matrix
from ..search.candidates import (
    _BLK, _stable_sort_by, candidates_matmul, candidates_runs,
)
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
    _term_scores,
    _unpack,
    slot_mass,
)

AXIS = "shards"

_NEG_INF = float("-inf")

# leaves partitioned over the mesh axis (leading dim = shard); everything
# else in the leaf dict is replicated
_STACKED = (
    "short_tokens", "short_lengths", "long_tokens", "long_lengths",
    "gram_ptr", "gram_terms", "term_wmax", "term_extra_ptr", "pt", "xt",
    "extra_key", "edge_term", "edge_key", "edge_weight",
    "key_edge_ptr", "key_edge_term", "key_edge_weight", "gm",
)


def _devices(n: int, device) -> list:
    """``n`` torch devices: the first ``n`` CUDA cards when ``device`` is
    None (a RuntimeError without a card), every one ``device`` when it is
    one device, else the ``n`` devices it lists."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device=\"cpu\" to shard "
                "on the CPU"
            )
        count = torch.cuda.device_count()
        if count < n:
            raise ValueError(
                f"mesh needs {n} devices, only {count} CUDA cards present "
                "(pass device=\"cuda:0\" to place every shard on one card)"
            )
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(device, (str, torch.device)):
        devs = [torch.device(device)] * n
    else:
        devs = [torch.device(d) for d in device]
        if len(devs) != n:
            raise ValueError(f"mesh needs {n} devices, {len(devs)} given")
    out = []
    for d in devs:
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"{d} requested but no CUDA device is available")
            if d.index is None:  # one spelling per card, so leaves dedup
                d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


class Mesh:
    """An ordered grid of devices, one per shard, named by axis: the port's
    counterpart of ``jax.sharding.Mesh``.

    ``devices`` lists this process's shards' devices in row-major order of
    ``shape``; ``first_shard`` is the global index of its first row (0 in a
    single-process mesh; ``multihost.global_mesh`` builds the multi-process
    one).  A mesh may name one device more than once - eight shards on
    ``cuda:0`` - the counterpart of the reference tests' eight virtual XLA
    devices on one host: repeated devices are for one-card runs and tests,
    where the shards run one after another.

    ``stack`` and ``reduce_max`` / ``reduce_sum`` are the merges: the
    per-shard outputs on the mesh's first device, the reference's
    ``all_gather`` and ``pmax`` / ``psum``."""

    def __init__(self, devices, axis_names: tuple, shape: tuple,
                 first_shard: int = 0):
        self.devices = tuple(devices)
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape)
        self.first_shard = first_shard
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} for shape {self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def device(self) -> torch.device:
        """The merge device: the first shard's."""
        return self.devices[0]

    @property
    def row_devices(self) -> tuple:
        """The device of each local index along the first axis (the first
        cell of each row of a 2-D mesh)."""
        return self.devices[:: math.prod(self.shape[1:])]

    @property
    def shard_ids(self) -> range:
        """Global indices along the first axis of this process's rows."""
        return range(self.first_shard, self.first_shard + len(self.row_devices))

    def stack(self, parts: list) -> torch.Tensor:
        """(S, ...) on the first device from one tensor per shard."""
        return torch.stack(
            [p.to(self.device, non_blocking=True) for p in parts]
        )

    def reduce_max(self, parts: list) -> torch.Tensor:
        out = parts[0].to(self.device, non_blocking=True)
        for p in parts[1:]:
            out = torch.maximum(out, p.to(self.device, non_blocking=True))
        return out

    def reduce_sum(self, parts: list) -> torch.Tensor:
        out = parts[0].to(self.device, non_blocking=True)
        for p in parts[1:]:
            out = out + p.to(self.device, non_blocking=True)
        return out

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, axes={self.axis_names}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(n_shards: Optional[int] = None, axis_name: str = AXIS,
              device=None) -> Mesh:
    """1-D mesh of ``n_shards`` devices: the CUDA cards by default (all of
    them when ``n_shards`` is None; a RuntimeError without a card), every
    shard on ``device`` when it is one device (``"cpu"``, ``"cuda:0"``), or
    the devices it lists."""
    if n_shards is None:
        if device is None:
            n_shards = torch.cuda.device_count() if torch.cuda.is_available() else 1
        elif isinstance(device, (str, torch.device)):
            n_shards = 1
        else:
            n_shards = len(device)
    devs = _devices(n_shards, device)
    return Mesh(devs, (axis_name,), (n_shards,))


def _pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    if arr.shape[0] >= rows:
        return arr[:rows]
    pad = [(0, rows - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


@dataclasses.dataclass
class ShardedIndex:
    """Host handle for a term-sharded index (all leaves host numpy; the
    engine uploads per-shard slices to the mesh's devices)."""

    host: HostIndex
    n_shards: int
    ts_c: int  # short terms per shard
    tl_c: int  # long terms per shard
    leaves: dict  # name -> np.ndarray; _STACKED names lead with the shard dim
    host_shard_posting_lens: np.ndarray  # (S, G) for query s_cap sizing

    @property
    def n_keys(self) -> int:
        return int(self.leaves["key_len"].shape[0])


def _shard_ranges(sorted_shard: np.ndarray, s: int) -> np.ndarray:
    """(S+1,) boundaries of contiguous shard runs in a shard-sorted array."""
    return np.searchsorted(sorted_shard, np.arange(s + 1)).astype(np.int64)


def _shard_order(shard_of: np.ndarray, s: int) -> np.ndarray:
    """The stable sort permutation of ``shard_of`` (values in [0, s)), one
    pass per shard."""
    return np.concatenate(
        [np.flatnonzero(shard_of == i) for i in range(s)]
    ).astype(np.int64)


def host_array(t) -> np.ndarray:
    """A leaf as host numpy: a tensor on any device is copied to the host
    (a CPU tensor is shared), numpy passes through."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def shard_index(host: HostIndex, n_shards: int) -> ShardedIndex:
    """Partition a built index into n_shards STRIDED term chunks
    (term t -> shard t % S, local id t // S), numpy only.

    Strided, not contiguous: the long tier is stored length-ascending
    (index.build sorts it for the width-bucketed DP), so contiguous chunks
    would concentrate the longest terms - and their posting mass - on the
    last shard.  A strided subsequence of a sorted array is still sorted,
    so every shard gets a balanced, length-ascending local tier.

    A stable partition by shard over the postings and over the edges (one
    mask pass per shard, where a stable comparison sort of hundreds of
    millions of postings costs tens of seconds).  The leaves equal the
    reference's bit for bit.  A card-resident index is read to host numpy.
    """
    di = host.device
    s = n_shards
    npa = host_array
    st_g = npa(di.short_tokens)
    sl_g = npa(di.short_lengths)
    lt_g = npa(di.long_tokens)
    ll_g = npa(di.long_lengths)
    ptr = npa(di.gram_ptr).astype(np.int64)
    terms = npa(di.gram_terms).astype(np.int64)
    et = npa(di.edge_term).astype(np.int64)
    ek = npa(di.edge_key).astype(np.int32)
    ew = npa(di.edge_weight).astype(np.float32)
    key_len = npa(di.key_len).astype(np.int32)

    ts, tl = st_g.shape[0], lt_g.shape[0]
    k = key_len.shape[0]
    g = ptr.shape[0] - 1
    ts_c = -(-max(ts, 1) // s) if ts else 0
    tl_c = -(-max(tl, 1) // s) if tl else 0
    if ts_c + tl_c == 0:
        raise ValueError("cannot shard an empty index")
    tc = ts_c + tl_c

    def _stride_stack(arr, chunk):
        # rows (N, ...) -> (S, chunk, ...); shard i holds rows i::S
        pad = _pad_rows(arr, s * chunk)
        return np.swapaxes(
            pad.reshape(chunk, s, *pad.shape[1:]), 0, 1
        ).copy()

    leaves: dict = {}
    # explicit widths: reshape(-1) is ambiguous on empty tiers
    st_w = st_g.shape[1] if st_g.ndim > 1 else 0
    lt_w = lt_g.shape[1] if lt_g.ndim > 1 else 0
    leaves["short_tokens"] = _stride_stack(
        st_g.reshape(st_g.shape[0], st_w), ts_c
    )
    leaves["short_lengths"] = _stride_stack(sl_g, ts_c)
    leaves["long_tokens"] = _stride_stack(
        lt_g.reshape(lt_g.shape[0], lt_w), tl_c
    )
    leaves["long_lengths"] = _stride_stack(ll_g, tl_c)

    # -- postings: a stable partition by shard, contiguous per-shard rows ---
    p_tot = terms.shape[0]
    if p_tot and tl_c:
        lens_all = np.diff(ptr)
        gram_of = np.repeat(np.arange(g, dtype=np.int64), lens_all)
        shard_of = terms % s
        counts2d = np.bincount(
            shard_of * g + gram_of, minlength=s * g
        ).reshape(s, g)
        del gram_of
        n_s = counts2d.sum(axis=1)
        gram_terms_s = np.zeros((s, max(int(n_s.max()), 1)), np.int32)
        for i in range(s):  # a boolean mask keeps the postings' order
            gram_terms_s[i, : n_s[i]] = terms[shard_of == i] // s
        gram_ptr_s = np.zeros((s, g + 1), np.int32)
        np.cumsum(counts2d, axis=1, out=gram_ptr_s[:, 1:])
    else:
        counts2d = np.zeros((s, g), np.int64)
        gram_terms_s = np.zeros((s, 1), np.int32)
        gram_ptr_s = np.zeros((s, g + 1), np.int32)
    leaves["gram_ptr"] = gram_ptr_s
    leaves["gram_terms"] = gram_terms_s

    # -- edges: shard by term ownership, local term ids (shorts then longs) -
    e_tot = et.shape[0]
    is_short = et < ts
    shard_e = np.where(is_short, et % s, (et - ts) % s).astype(np.int64)
    local_t = np.where(
        is_short, et // s, ts_c + (et - ts) // s
    ).astype(np.int64)

    # term-sorted within shard (global edges are (term, key)-sorted and a
    # stable shard-sort preserves that; shorts precede longs globally, so
    # the local order is local-term ascending)
    order_e = _shard_order(shard_e, s)
    se_sorted = shard_e[order_e]
    lt_sorted = local_t[order_e]
    ek_sorted = ek[order_e]
    ew_sorted = ew[order_e]
    ebounds = _shard_ranges(se_sorted, s)
    emax = max(int((ebounds[1:] - ebounds[:-1]).max()) if e_tot else 0, 1)

    def _stack_sorted(vals, fill, dtype):
        out = np.full((s, emax), fill, dtype=dtype)
        pos = np.arange(e_tot, dtype=np.int64) - ebounds[se_sorted]
        out[se_sorted, pos] = vals
        return out

    if e_tot:
        leaves["edge_term"] = _stack_sorted(
            lt_sorted.astype(np.int32), 0, np.int32
        )
        # ghost key K absorbs padded edges in the dense per-key merge
        leaves["edge_key"] = _stack_sorted(ek_sorted, k, np.int32)
        leaves["edge_weight"] = _stack_sorted(ew_sorted, 0.0, np.float32)
    else:
        leaves["edge_term"] = np.zeros((s, emax), np.int32)
        leaves["edge_key"] = np.full((s, emax), k, np.int32)
        leaves["edge_weight"] = np.zeros((s, emax), np.float32)

    # per-(shard, local term) CSR -> wmax, primary edge, extras
    flat_term = se_sorted * tc + lt_sorted
    counts_t = np.bincount(flat_term, minlength=s * tc).astype(np.int64)
    ptr_t = np.zeros(s * tc + 1, np.int64)
    np.cumsum(counts_t, out=ptr_t[1:])
    nz = counts_t > 0
    wmax_flat = np.zeros(s * tc, np.float32)
    prim_key_flat = np.full(s * tc, -1, np.int32)
    prim_w_flat = np.zeros(s * tc, np.float32)
    if e_tot:
        wmax_flat[nz] = np.maximum.reduceat(ew_sorted, ptr_t[:-1][nz])
        firsts = ptr_t[:-1][nz]
        prim_key_flat[nz] = ek_sorted[firsts]
        prim_w_flat[nz] = ew_sorted[firsts]
    leaves["term_wmax"] = wmax_flat.reshape(s, tc)

    is_extra = np.ones(e_tot, dtype=bool)
    if e_tot:
        is_extra[ptr_t[:-1][nz]] = False
    extra_counts = np.maximum(counts_t - 1, 0)
    xptr_flat = np.zeros(s * tc + 1, np.int64)
    np.cumsum(extra_counts, out=xptr_flat[1:])
    # per-shard extra CSR: subtract each shard's base offset
    xbase = xptr_flat[np.arange(s, dtype=np.int64) * tc]
    term_extra_ptr = (
        xptr_flat[: s * tc + 1][
            (np.arange(s)[:, None] * tc + np.arange(tc + 1)[None, :])
        ]
        - xbase[:, None]
    ).astype(np.int32)
    leaves["term_extra_ptr"] = term_extra_ptr
    xk_sorted = ek_sorted[is_extra]
    xw_sorted = ew_sorted[is_extra]
    xs_shard = se_sorted[is_extra]
    xbounds = _shard_ranges(xs_shard, s)
    xmax = max(int((xbounds[1:] - xbounds[:-1]).max()) if xk_sorted.size else 0, 1)
    x_tot = xk_sorted.shape[0]
    extra_key_s = np.full((s, xmax), -1, np.int32)
    extra_w_s = np.zeros((s, xmax), np.float32)
    if x_tot:
        xpos = np.arange(x_tot, dtype=np.int64) - xbounds[xs_shard]
        extra_key_s[xs_shard, xpos] = xk_sorted
        extra_w_s[xs_shard, xpos] = xw_sorted
    leaves["extra_key"] = extra_key_s
    # an all-padded (S, 1) extra table with zero extras has width 1 and
    # every ptr 0, which the candidate back half handles (tot_x = 0)

    # 4-wide [key, bitcast(weight), key_len, 0] records (prim_tables layout)
    def _records(keys2d, w2d):
        kc = np.clip(keys2d, 0, max(k - 1, 0))
        lens = key_len[kc] if k else np.zeros_like(keys2d)
        return np.stack(
            [
                keys2d,
                w2d.astype(np.float32).view(np.int32),
                np.where(keys2d >= 0, lens, 0).astype(np.int32),
                np.zeros_like(keys2d),
            ],
            axis=-1,
        ).astype(np.int32)

    leaves["pt"] = _records(
        prim_key_flat.reshape(s, tc), prim_w_flat.reshape(s, tc)
    )
    leaves["xt"] = _records(extra_key_s, extra_w_s)

    # -- per-shard key->local-edge CSR (promotion scoring) ------------------
    order_ke = np.lexsort((ek, shard_e))  # by shard, then key
    ske = shard_e[order_ke]
    kke = ek[order_ke]
    tke = local_t[order_ke].astype(np.int32)
    wke = ew[order_ke]
    ke_counts = np.bincount(
        ske * (k + 1) + kke, minlength=s * (k + 1)
    ).reshape(s, k + 1)[:, :k] if e_tot else np.zeros((s, k), np.int64)
    key_edge_ptr = np.zeros((s, k + 1), np.int32)
    np.cumsum(ke_counts, axis=1, out=key_edge_ptr[:, 1:])
    kebounds = _shard_ranges(ske, s) if e_tot else np.zeros(s + 1, np.int64)
    kemax = max(
        int((kebounds[1:] - kebounds[:-1]).max()) if e_tot else 0, 1
    )
    key_edge_term = np.zeros((s, kemax), np.int32)
    key_edge_weight = np.zeros((s, kemax), np.float32)
    if e_tot:
        kpos = np.arange(e_tot, dtype=np.int64) - kebounds[ske]
        key_edge_term[ske, kpos] = tke
        key_edge_weight[ske, kpos] = wke
    leaves["key_edge_ptr"] = key_edge_ptr
    leaves["key_edge_term"] = key_edge_term
    leaves["key_edge_weight"] = key_edge_weight

    # -- replicated key arrays ---------------------------------------------
    leaves["key_len"] = key_len

    return ShardedIndex(
        host=host,
        n_shards=s,
        ts_c=ts_c,
        tl_c=tl_c,
        leaves=leaves,
        host_shard_posting_lens=counts2d,
    )


class _ShardView:
    """DeviceIndex-shaped view over one shard's leaves (local terms, GLOBAL
    keys).  Padded term slots have length 0, wmax 0, primary key -1 and no
    extra/key edges, so they can never contribute to a key."""

    def __init__(self, lv: dict):
        for name, arr in lv.items():
            if name not in ("pt", "xt", "gm"):
                setattr(self, name, arr)

    @property
    def n_short(self):
        return self.short_tokens.shape[0]

    @property
    def n_long(self):
        return self.long_tokens.shape[0]

    @property
    def n_keys(self):
        # +1: the ghost key row that padded/invalid edges map to
        return self.key_len.shape[0] + 1


class _FinalView:
    def __init__(self, key_len):
        self.key_len = key_len
        self.n_keys = key_len.shape[0]


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """One leaf slice on ``device``, contiguous (the kernels' contract).
    Wide codepoints (uint32) widen to int32 for signed-safe compares; byte
    tokens stay uint8, as on the single-card index."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int32)
    elif not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def replicate(arrays: tuple, devices) -> dict:
    """The batch's host arrays uploaded once per distinct device:
    {device: tuple of tensors}."""
    return {d: tuple(upload(a, d) for a in arrays) for d in dict.fromkeys(devices)}


# ---------------------------------------------------------------------------
# candidate-sparse sharded step (the production path)
# ---------------------------------------------------------------------------


def _merge_shard_topk(cnt_s, keys_s, scores_s, lens_s, bound_s, k_total,
                      limit, top_k):
    """Replicated merge of per-shard local top-k lists.

    ``cnt_s`` (S, B) local reached totals; keys/scores/lens (S, B, top_k)
    in global key space; ``bound_s`` (S, B) per-shard contribution bounds
    for keys absent from that shard's list (-inf = closed).  Dedup by key
    takes the max score (the calcScore combine is a max over edges and each
    edge lives on exactly one shard); ranking reproduces the single-card
    (score desc, key length asc, key id) order, a total order, so exact
    rows equal the reference's ids included.  The reference's multi-key
    ``lax.sort`` is stable single-key sorts here, least significant first.
    Returns (count (B,), keys (B, top_k), scores (B, top_k), exact (B,)).
    """
    s, b, tk = keys_s.shape
    dev = keys_s.device
    pos = torch.arange(tk, device=dev)
    valid = pos[None, None, :] < torch.clamp(cnt_s, max=tk)[:, :, None]

    def flat(x):
        return x.transpose(0, 1).reshape(b, s * tk)

    keys_f, scores_f, lens_f, valid_f = (
        flat(keys_s), flat(scores_s), flat(lens_s), flat(valid)
    )
    m_bound = bound_s.amax(0)  # (B,)
    all_closed = (bound_s == _NEG_INF).all(0)

    kk = torch.where(valid_f, keys_f, k_total)
    order = _stable_sort_by((kk, -scores_f + 0.0))
    kk2 = kk.gather(1, order)
    sf2 = scores_f.gather(1, order)
    lf2 = lens_f.gather(1, order)
    first = torch.ones_like(kk2, dtype=torch.bool)
    first[:, 1:] = kk2[:, 1:] != kk2[:, :-1]
    mvalid = first & (kk2 < k_total)
    unique = mvalid.sum(1)
    neg = torch.where(mvalid, -sf2, float("inf")) + 0.0
    order = _stable_sort_by((neg, torch.where(mvalid, lf2, 2**30), kk2))
    neg_sorted = neg.gather(1, order)
    out_key = kk2.gather(1, order)
    out_score = sf2.gather(1, order)
    lim_idx = min(max(limit - 1, 0), s * tk - 1)
    sigma = -neg_sorted[:, lim_idx]
    exact = all_closed | ((unique >= limit) & (sigma > m_bound))
    count = torch.where(all_closed, unique, torch.clamp(unique, max=limit))
    return count, out_key[:, :tk], out_score[:, :tk], exact


def sharded_candidates_step(
    mesh: Mesh, shards: list, qbufs: dict, promo_terms: list,
    promo_weights: list, threshold, *,
    front: str,  # "matmul" | "runs"
    compute_short: bool,
    s_cap: int,
    n_cand: int,
    n_edge: int,
    top_k: int,
    block_sel: bool,
    limit: int,
):
    """Batched candidate-sparse search over the term-sharded index.

    ``shards``: one leaf dict per local shard (tensors on its device, with
    ``gm`` on the ``matmul`` front); ``qbufs[device]`` = (qtokens, qlens,
    qslots, n_qgrams, use_short, promo_ids, limits) on each distinct device;
    ``promo_terms`` / ``promo_weights``: per shard (B, PK, PE) promotion
    edge packs in shard-LOCAL term ids (-1 padded;
    ShardedEngine._promo_tables_sharded).  Each shard runs the exact
    candidate kernel on its chunk (local top-k + soundness bound), the
    outputs stack on the first device and merge.  Rows whose merged guard
    fails are retried densely by the engine."""
    kw = dict(front=front, compute_short=compute_short, s_cap=s_cap,
              n_cand=n_cand, n_edge=n_edge, top_k=top_k, block_sel=block_sel)
    outs = [
        shard_candidates(lv, qbufs[lv["key_len"].device], p_t, p_w, threshold, **kw)
        for lv, p_t, p_w in zip(shards, promo_terms, promo_weights)
    ]
    return merge_candidates(mesh, outs, int(shards[0]["key_len"].shape[0]),
                            limit, top_k)


def shard_candidates(lv: dict, qbuf: tuple, p_t, p_w, threshold, *, front: str,
                     compute_short: bool, s_cap: int, n_cand: int, n_edge: int,
                     top_k: int, block_sel: bool):
    """One shard's candidate pass: (reached (B,), keys, scores, lens (B,
    top_k), bound (B,)) in global key space, on the shard's device."""
    qt, ql, qs, ng, us, pr, lim = qbuf
    kw = dict(compute_short=compute_short, n_cand=n_cand, n_edge=n_edge,
              top_k=top_k, block_sel=block_sel, with_bound=True)
    if front == "matmul":
        return candidates_matmul(
            _ShardView(lv), lv["gm"], lv["pt"], lv["xt"], qt, ql, qs, ng, us,
            pr, p_t, p_w, lim, threshold, **kw,
        )
    return candidates_runs(
        _ShardView(lv), lv["pt"], lv["xt"], qt, ql, qs, ng, us, pr, p_t, p_w,
        lim, threshold, s_cap=s_cap, **kw,
    )


def merge_candidates(mesh: Mesh, outs: list, k_total: int, limit: int,
                     top_k: int):
    """The merge of the shards' candidate outputs: stacked on the first
    device, then ``_merge_shard_topk``."""
    cnt_s, keys_s, scores_s, lens_s, bound_s = (
        mesh.stack([o[i] for o in outs]) for i in range(5)
    )
    return _merge_shard_topk(
        cnt_s, keys_s, scores_s, lens_s, bound_s, k_total, limit, top_k
    )


# ---------------------------------------------------------------------------
# dense sharded steps (wildcard / brute / retry): per-key max merge
# ---------------------------------------------------------------------------


def sharded_dense_batch_step(
    mesh: Mesh, shards: list, qbufs: dict, threshold, *,
    compute_short: bool, brute: bool, s_cap: int, top_k: int,
):
    """Batched dense sharded search: each shard scores every local term
    (the postings expansion K6 for the gram tier, K5 for the short tier),
    propagates to a (B, K+1) raw key-max vector, and the vectors merge with
    one max pair on the first device.  ``brute`` adds the whole-tier DP the
    reference applies to qlen <= gram_size queries
    (nGramSearch.hpp:247-253).  ``qbufs[device]`` = (qtokens, qlens,
    qslots, n_qgrams, use_short, promo_ids).  Used for brute-short queries
    and candidate-guard retries."""
    vals, promos = [], []
    for lv in shards:
        qt, ql, qs, ng, us, pr = qbufs[lv["key_len"].device]
        di = _ShardView(lv)
        s_a, mask_a, s_b, mask_b = _term_scores(
            di, qt, ql, qs, ng, us, compute_short=compute_short,
            brute_long=brute, s_cap=s_cap,
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
    return _finalize(_FinalView(shards[0]["key_len"]), score, reached, top_k)


def sharded_wildcard_step(mesh: Mesh, shards: list, *, top_k: int):
    """Wildcard '' / '*': every key at its max edge weight
    (nGramSearch.hpp:356-369; scores keep their sign, no floor).  Per-shard
    segment-max + one max merge."""
    k1 = int(shards[0]["key_len"].shape[0]) + 1
    val = mesh.reduce_max([
        _segment_max(lv["edge_weight"][None, :], lv["edge_key"], k1, _NEG_INF)
        for lv in shards
    ])
    score = val[:, :-1]
    reached = score > _NEG_INF
    score = torch.where(reached, score, 0.0)
    return _finalize(_FinalView(shards[0]["key_len"]), score, reached, top_k)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class ShardedEngine(SearchEngine):
    """Query front end over a ShardedIndex.

    Inherits only the HOST-side helpers from SearchEngine (normalization,
    gram-slot lookup, shape bucketing, result emit); every device dispatch
    is a sharded step above.  ``mesh`` defaults to the CUDA cards
    (``make_mesh``); nothing here uploads an unsharded leaf.
    ``last_routing`` records the candidate front (``variant``: ``matmul``
    or ``runs``) of the most recent candidate pass."""

    # the sharded passes count no retried or dense rows: each call's
    # ``last_routing["call"]`` holds its queries only
    CALL_COUNTERS = ("queries",)

    def __init__(self, sharded: ShardedIndex, mesh: Optional[Mesh] = None):
        super().__init__(sharded.host)
        if mesh is None:
            mesh = make_mesh(sharded.n_shards)
        if mesh.shape[0] != sharded.n_shards:
            raise ValueError(
                f"mesh axis of {mesh.shape[0]} for {sharded.n_shards} shards"
            )
        self.sx = sharded
        self.mesh = mesh
        self.device = mesh.device
        self._dev: Optional[list] = None
        self._gm: object = None  # per-shard matrices, False over budget
        self._wild_cache: dict = {}

    # host-only leaves: promotion edges expand host-side
    # (_promo_tables_sharded), so the per-shard key->edge CSR never needs
    # device residency (~(K + E) x 8 B per shard at scale)
    _HOST_ONLY = ("key_edge_ptr", "key_edge_term", "key_edge_weight")

    def _leaves(self) -> list:
        """One leaf dict per local shard, every tensor on that shard's
        device; replicated leaves are uploaded once per distinct device."""
        if self._dev is None:
            rep: dict = {}
            shards = []
            for sid, d in zip(self.mesh.shard_ids, self.mesh.row_devices):
                if d not in rep:
                    rep[d] = {
                        name: upload(arr, d)
                        for name, arr in self.sx.leaves.items()
                        if name not in _STACKED
                    }
                lv = dict(rep[d])
                for name, arr in self.sx.leaves.items():
                    if name in _STACKED and name not in self._HOST_ONLY:
                        lv[name] = upload(arr[sid], d)
                shards.append(lv)
            self._dev = shards
        return self._dev

    def _gram_matrix_stacked(self):
        """Per-shard (Gp, Tl_c pad) int8 gram incidence, built on each
        shard's device from its CSR, or None when G * Tl_c is over
        GM_BUDGET (the reference's rule).  Cached; a miss as False."""
        if self._gm is None:
            g, tl_c = self.host.n_grams, self.sx.tl_c
            if g == 0 or tl_c == 0 or g * tl_c > self.GM_BUDGET:
                self._gm = False
            else:
                ptrs = self.sx.leaves["gram_ptr"]
                for sid, lv in zip(self.mesh.shard_ids, self._leaves()):
                    lv["gm"] = incidence_matrix(
                        lv["gram_ptr"], lv["gram_terms"], g, tl_c,
                        int(ptrs[sid, -1]), HostIndex.BITS_CHUNK,
                    )
                self._gm = True
        return None if self._gm is False else [lv["gm"] for lv in self._leaves()]

    # -- host-side prep overrides -----------------------------------------

    def _slot_mass(self, rowslots: np.ndarray) -> tuple:
        """Lane bounds for the sharded engine: ``slot_mass`` over each
        shard's LOCAL posting lengths, the largest over shards (each shard
        expands only its own postings; SearchEngine._prep_rows supplies
        everything else)."""
        return slot_mass(self.sx.host_shard_posting_lens, rowslots)

    def _promo_tables_sharded(self, promo_all: np.ndarray):
        """(S, B, PK, PE) promo edge term/weight packs from the host
        per-shard key->edge CSRs (shard-LOCAL term ids, -1 padded) - the
        sharded analogue of SearchEngine._promo_tables."""
        kep = self.sx.leaves["key_edge_ptr"]  # (S, K+1)
        ket = self.sx.leaves["key_edge_term"]  # (S, kemax)
        kew = self.sx.leaves["key_edge_weight"]
        s = kep.shape[0]
        b, pk = promo_all.shape
        valid = promo_all >= 0
        p_c = np.clip(promo_all, 0, max(kep.shape[1] - 2, 0))
        # (S, B, PK) per-shard edge counts of each promo key
        cnt = np.where(
            valid[None], kep[:, p_c + 1] - kep[:, p_c], 0
        ).astype(np.int64)
        pe = _next_pow2(max(int(cnt.max()) if cnt.size else 0, 1), 1)
        terms = np.full((s, b, pk, pe), -1, np.int32)
        weights = np.zeros((s, b, pk, pe), np.float32)
        si, bi, ki = np.nonzero(cnt > 0)
        if si.size:
            c = cnt[si, bi, ki]
            rep = np.repeat
            within = np.arange(c.sum()) - rep(np.cumsum(c) - c, c)
            src = rep(kep[si, p_c[bi, ki]], c) + within
            rs, rb, rk = rep(si, c), rep(bi, c), rep(ki, c)
            terms[rs, rb, rk, within] = ket[rs, src]
            weights[rs, rb, rk, within] = kew[rs, src]
        return terms, weights

    # -- public API --------------------------------------------------------

    def _search_impl(self, query, threshold: float = 0.0, limit: int = 0):
        return self._search_batch_impl([query], threshold, limit, 256, 32,
                                       "auto")[0]

    def _wildcard(self, limit: int):
        if limit == 0:
            limit = INT32_MAX
        top_k = self._top_k(limit)
        cached = self._wild_cache.get(top_k)
        if cached is None:
            res = sharded_wildcard_step(self.mesh, self._leaves(), top_k=top_k)
            cached = _unpack(_fetch([_pack(*res)]), int(res[1].shape[1]))
            self._wild_cache[top_k] = cached
        return self._emit_one(*cached, limit)

    def _search_batch_impl(
        self, queries, threshold, limit, batch_bucket, qp_bucket, mode
    ):
        if limit == 0:
            limit = INT32_MAX
        out: list = [None] * len(queries)
        if not self.host.indexed:
            return [([], [])] * len(queries)

        want_cand = mode != "dense" and limit <= self.CAND_MAX_LIMIT
        ke_counts = self.host.host_key_edge_counts
        items, brute_items, long_items = [], [], []
        for i, q in enumerate(queries):
            raw = q if isinstance(q, str) else str(q)
            if len(raw) == 0 or raw == "*":
                if self.sx.leaves["edge_key"].size == 0:
                    out[i] = ([], [])
                else:
                    out[i] = self._wildcard(limit)
                continue
            qnorm, qlen = self._normalize_query(raw)
            if qlen == 0:
                out[i] = ([], [])
            elif qlen <= self.cfg.brute_force_cutoff:
                brute_items.append((i, qnorm, qlen))
            elif qlen > qp_bucket:
                long_items.append((i, qnorm, qlen))
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

        cand_items = [it for it in items if want_cand and it[3] is not None]
        dense_items = [
            it for it in items if not (want_cand and it[3] is not None)
        ]

        if cand_items:
            retry = self._run_candidate_chunks(
                cand_items, threshold, limit, batch_bucket, qp_bucket, out
            )
            dense_items.extend(retry)
        if dense_items:
            self._run_dense_chunks(
                dense_items, threshold, limit, batch_bucket, qp_bucket, out
            )
        for lo in range(0, len(long_items), 8):
            chunk = long_items[lo : lo + 8]
            qp = _next_pow2(max(it[2] for it in chunk), qp_bucket)
            self._run_dense_chunks(chunk, threshold, limit, 8, qp, out)
        if brute_items:
            self._run_brute_chunks(brute_items, threshold, limit, out)
        return out

    # -- dispatch helpers --------------------------------------------------

    def _run_candidate_chunks(
        self, items, threshold, limit, batch_bucket, qp, out
    ):
        retry, n_used, n_avail = self._cand_pass(
            items, threshold, limit, batch_bucket, qp, out,
            self.CAND_TERMS_FAST,
        )
        n_fast = len(retry)
        if retry and n_used < min(self.CAND_TERMS, n_avail):
            retry, _, _ = self._cand_pass(
                retry, threshold, limit, batch_bucket, qp, out,
                self.CAND_TERMS,
            )
            self.last_routing["retry_full"] = len(retry)
        self.last_routing["retry_fast"] = n_fast
        return retry

    def _cand_pass(self, items, threshold, limit, batch_bucket, qp, out,
                   cand_cap):
        """One candidate sweep at selection width ``cand_cap``: the
        ``matmul`` front where every shard's gram incidence fits GM_BUDGET,
        else ``runs``.  Returns (rows for the dense path, n_cand,
        selectable lanes)."""
        shards = self._leaves()
        ts_c, tl_c = self.sx.ts_c, self.sx.tl_c
        x_total = int(self.sx.leaves["extra_key"].shape[1])
        n_edge = min(
            max(_next_pow2(max(x_total, 1), 16), 16), self.CAND_EDGES
        )
        top_k = _next_pow2(limit, 16)

        b_all, qtok, qlens, slots, nqg, use_short, s_cap, _ = self._prep_rows(
            items, qp
        )
        compute_short = bool(use_short.any()) and ts_c > 0
        promo_all = np.full((b_all, self.PROMO_KEYS), -1, dtype=np.int32)
        for r, item in enumerate(items):
            pids = item[3]
            promo_all[r, : pids.size] = pids
        promo_t, promo_w = self._promo_tables_sharded(promo_all)

        gm = self._gram_matrix_stacked()
        front = "matmul" if gm is not None else "runs"
        if front == "matmul":
            n_lanes = (ts_c if compute_short else 0) + tl_c
            per_q = 48 * (ts_c + tl_c) + 24 * n_edge + (1 << 16)
        else:
            n_lanes = (ts_c if compute_short else 0) + s_cap
            per_q = (
                48 * s_cap + 24 * n_edge
                + (48 * ts_c if compute_short else 0) + (1 << 16)
            )
        n_cand = min(cand_cap, max(_next_pow2(n_lanes, 16), 16), n_lanes)
        block_sel = n_lanes >= 4 * n_cand * _BLK
        cap = max(int(self.BATCH_HBM_BUDGET // per_q), 8)
        step = 8
        while step * 2 <= min(cap, batch_bucket):
            step *= 2
        self.last_routing = {
            "variant": front, "step": step, "n_cand": n_cand,
            "block_sel": bool(block_sel), "shards": self.sx.n_shards,
            "s_cap": s_cap,
        }

        kw = dict(front=front, compute_short=compute_short, s_cap=s_cap,
                  n_cand=n_cand, n_edge=n_edge, top_k=top_k,
                  block_sel=block_sel, limit=min(limit, 2**30))
        thr = np.float32(threshold)
        # the batch's arrays go to each device once and chunks slice them
        # there: no upload (a host sync) between one chunk's launches and
        # the next's
        lim_all = np.full((b_all,), min(limit, 2**30), dtype=np.int32)
        qall = replicate(
            (qtok, qlens, slots, nqg, use_short, promo_all, lim_all),
            self.mesh.row_devices,
        )
        devs = [lv["key_len"].device for lv in shards]
        pt_all = [upload(promo_t[sid], d) for sid, d in zip(self.mesh.shard_ids, devs)]
        pw_all = [upload(promo_w[sid], d) for sid, d in zip(self.mesh.shard_ids, devs)]
        pending = []
        for lo in range(0, len(items), step):
            hi = min(lo + step, len(items))
            b = _next_pow2(hi - lo, min(step, 16))
            sl = slice(lo, lo + b)
            qbufs = {d: tuple(t[sl] for t in ts) for d, ts in qall.items()}
            res = sharded_candidates_step(
                self.mesh, shards, qbufs, [t[sl] for t in pt_all],
                [t[sl] for t in pw_all], thr, **kw
            )
            pending.append((lo, hi, _pack(*res)))

        # ONE fetch for every chunk
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
        return retry, n_cand, n_lanes

    def _chunk_promo(self, chunk, b: int) -> np.ndarray:
        """(b, PROMO_KEYS) int32 promotion key ids for a prepared chunk.
        Items carry them at index 3 when the candidate path prepared them;
        dense/brute items are (pos, qnorm, qlen) and look them up here."""
        promo = np.full((b, self.PROMO_KEYS), -1, np.int32)
        for r, item in enumerate(chunk):
            pids = (
                item[3] if len(item) > 3 and item[3] is not None
                else self.host.promo_key_ids(item[1], item[2])
            )[: self.PROMO_KEYS]
            promo[r, : pids.size] = pids
        return promo

    def _run_dense_chunks(self, items, threshold, limit, batch_bucket, qp,
                          out):
        top_k = self._top_k(limit)
        tc = self.sx.ts_c + self.sx.tl_c
        per_query = 48 * max(tc, 1) + 8 * (self.sx.n_keys + 1) + (1 << 20)
        cap = max(int(self.BATCH_HBM_BUDGET // per_query), 8)
        bb = 8
        while bb * 2 <= min(cap, batch_bucket):
            bb *= 2
        shards = self._leaves()
        pending = []
        for lo in range(0, len(items), bb):
            chunk = items[lo : lo + bb]
            b, qtok, qlens, slots, nqg, use_short, _, d_cap = self._prep_rows(
                chunk, qp
            )
            compute_short = bool(use_short.any()) and self.sx.ts_c > 0
            qbufs = replicate(
                (qtok, qlens, slots, nqg, use_short, self._chunk_promo(chunk, b)),
                self.mesh.row_devices,
            )
            res = sharded_dense_batch_step(
                self.mesh, shards, qbufs, np.float32(threshold),
                compute_short=compute_short, brute=False, s_cap=d_cap,
                top_k=top_k,
            )
            pending.append((chunk, b, _pack(*res)))
        self._emit_dense(pending, limit, out)

    def _run_brute_chunks(self, items, threshold, limit, out):
        """qlen <= gram_size: whole-tier DP on every shard (the reference's
        long-lib brute fallback, nGramSearch.hpp:247-253), per-key max."""
        top_k = self._top_k(limit)
        g = self.cfg.gram_size
        qp = max(_next_pow2(self.cfg.brute_force_cutoff + 1, 8), g + 1)
        shards = self._leaves()
        w = max(
            int(self.sx.leaves["short_tokens"].shape[2] or 1),
            int(self.sx.leaves["long_tokens"].shape[2] or 1),
        )
        tc = self.sx.ts_c + self.sx.tl_c
        per_q = 12 * max(tc, 1) * (w + 2) + 8 * (self.sx.n_keys + 1) + (1 << 18)
        cap = max(int(self.BATCH_HBM_BUDGET // per_q), 1)
        step = 1
        while step * 2 <= min(cap, 64):
            step *= 2

        pending = []
        for lo in range(0, len(items), step):
            chunk = items[lo : lo + step]
            b, qtok, qlens, slots, nqg, _, _, d_cap = self._prep_rows(
                chunk, qp, min_b=min(step, 16)
            )
            qbufs = replicate(
                (qtok, qlens, slots, nqg, np.ones(b, bool),
                 self._chunk_promo(chunk, b)),
                self.mesh.row_devices,
            )
            res = sharded_dense_batch_step(
                self.mesh, shards, qbufs, np.float32(threshold),
                compute_short=True, brute=True, s_cap=d_cap, top_k=top_k,
            )
            pending.append((chunk, b, _pack(*res)))
        self._emit_dense(pending, limit, out)
