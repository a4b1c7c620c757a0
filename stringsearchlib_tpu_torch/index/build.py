"""Host-side index construction (fully vectorized).

PyTorch counterpart of ``stringsearchlib_tpu.index.build``: the same host
pipeline (numpy, bit for bit the reference's) ending in a ``DeviceIndex`` of
torch tensors on an explicit device:

  bulk encode -> vectorized normalize (core.text) -> element role masks
  -> interleaved string dedup -> term/key id spaces -> (term, key, weight)
  edge dedup (last weight wins) -> long/short split at 2*gram_size -> CSR
  gram->term postings (set semantics of nGramSearch.h:296), on the device
  for large narrow long tiers (index.device_build).

Deterministic id rule shared with the oracle: a string's id is its first
*recorded* occurrence in element order, counting each recorded element as
(term, then key).  Device arrays carry the reference's dtypes (int32 ids
and pointers, float32 weights, uint8 byte tokens).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_VALID_CHARS, IndexConfig
from ..core import grams as gramlib
from ..core import text as textlib
from . import native as nativelib
from .arrays import DeviceIndex


class KeyStrings:
    """Lazy decoder over the raw (trimmed) master-key token matrix."""

    def __init__(self, tokens: np.ndarray, lengths: np.ndarray, wide: bool):
        self.tokens = tokens
        self.lengths = lengths
        self.wide = wide
        self._cache: dict[int, str] = {}

    def __len__(self) -> int:
        return self.tokens.shape[0]

    def __getitem__(self, i: int) -> str:
        i = int(i)
        s = self._cache.get(i)
        if s is None:
            s = textlib.decode_row(self.tokens[i], int(self.lengths[i]), self.wide)
            self._cache[i] = s
        return s

    def take(self, ids) -> list:
        """Decode many rows at once: one gather + one bytes conversion."""
        ids = np.asarray(ids, dtype=np.int64)
        toks = self.tokens[ids]
        lens = self.lengths[ids]
        w = self.tokens.shape[1]
        if self.wide:
            buf = toks.astype(np.uint32).tobytes()
            return [
                buf[i * 4 * w : i * 4 * w + 4 * int(lens[i])].decode(
                    "utf-32-le"
                )
                for i in range(ids.shape[0])
            ]
        buf = toks.astype(np.uint8).tobytes()
        return [
            buf[i * w : i * w + int(lens[i])].decode("latin-1")
            for i in range(ids.shape[0])
        ]

    def tolist(self) -> list:
        return [self[i] for i in range(len(self))]


@dataclasses.dataclass
class HostIndex:
    """Host state for one index: lazy key strings for result return, gram id
    table for query slot lookup, and the device tensors."""

    config: IndexConfig
    tables: textlib.TextTables
    key_strings: KeyStrings
    gram_ids: np.ndarray  # (G,) int64 sorted distinct gram ids
    device: DeviceIndex
    n_terms: int  # getSize (wordMap.size, nGramSearch.hpp:488-491)
    max_term_len: int  # reference's `longest` over terms
    vocab: Optional[gramlib.WideVocab]
    indexed: bool
    host_posting_lens: np.ndarray  # (G,) int64, host copy for query caps
    host_key_norm_tokens: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 1), np.uint8)
    )
    host_key_norm_lengths: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32)
    )
    host_key_edge_counts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32)
    )
    host_long_lengths: Optional[np.ndarray] = None
    host_key_edge_ptr: Optional[np.ndarray] = None
    host_key_edge_term: Optional[np.ndarray] = None
    host_key_edge_weight: Optional[np.ndarray] = None
    # every term->key edge weight == 1.0: per-term score bounds equal the
    # score, enabling the integer h* selection (search.candidates)
    uniform_weights: bool = False
    _key_hash_cache: Optional[tuple] = None
    _dp_bucket_cache: Optional[tuple] = None
    _bitmap_cache: object = dataclasses.field(default=None, repr=False)
    _sketch_cache: object = dataclasses.field(default=None, repr=False)
    _prim_table_cache: object = dataclasses.field(default=None, repr=False)
    _gram_matrix_cache: object = dataclasses.field(default=None, repr=False)

    @property
    def n_grams(self) -> int:  # getLibSize (nGramSearch.hpp:496-499)
        return int(self.gram_ids.shape[0])

    # -- exact-match promotion lookup (host side) -----------------------

    def _key_hash_table(self):
        """Sorted FNV-1a hashes of key_norm rows for O(log K) lookup."""
        if self._key_hash_cache is None:
            h = _fnv_rows(self.host_key_norm_tokens, self.host_key_norm_lengths)
            order = np.argsort(h, kind="stable")
            self._key_hash_cache = (h[order], order.astype(np.int32))
        return self._key_hash_cache

    def promo_key_ids(self, qtokens: np.ndarray, qlen: int) -> np.ndarray:
        """Key ids whose normalized form equals the normalized query - the
        only keys the 0.999 -> 100 promotion (nGramSearch.hpp:328-336) can
        apply to.  Hash prefilter + exact row verify."""
        kt, kl = self.host_key_norm_tokens, self.host_key_norm_lengths
        if kt.shape[0] == 0 or qlen > kt.shape[1]:
            return np.zeros(0, np.int32)
        row = np.zeros((1, kt.shape[1]), dtype=kt.dtype)
        row[0, :qlen] = qtokens[:qlen]
        qh = _fnv_rows(row, np.array([qlen], np.int32))[0]
        hs, order = self._key_hash_table()
        lo = np.searchsorted(hs, qh, side="left")
        hi = np.searchsorted(hs, qh, side="right")
        cand = order[lo:hi]
        if cand.size == 0:
            return cand.astype(np.int32)
        ok = (kl[cand] == qlen) & (kt[cand] == row[0]).all(axis=1)
        return cand[ok].astype(np.int32)

    def promo_key_ids_batch(self, qtokens: np.ndarray, qlens: np.ndarray):
        """Batched promo_key_ids: one vectorized hash pass over a (B, W)
        normalized-query matrix; the exact verify runs only for hash hits."""
        kt, kl = self.host_key_norm_tokens, self.host_key_norm_lengths
        bsz = qtokens.shape[0]
        empty = np.zeros(0, np.int32)
        if kt.shape[0] == 0 or bsz == 0:
            return [empty] * bsz
        w = kt.shape[1]
        rows = np.zeros((bsz, w), dtype=kt.dtype)
        cw = min(w, qtokens.shape[1])
        rows[:, :cw] = qtokens[:, :cw]
        qlens = np.asarray(qlens, np.int32)
        qh = _fnv_rows(rows, qlens)
        hs, order = self._key_hash_table()
        lo = np.searchsorted(hs, qh, side="left")
        hi = np.searchsorted(hs, qh, side="right")
        counts = np.where(qlens <= w, hi - lo, 0)
        out = [empty] * bsz
        hit_q = np.nonzero(counts > 0)[0]
        if hit_q.size == 0:
            return out
        qidx = np.repeat(hit_q, counts[hit_q])
        within = np.arange(qidx.size) - np.repeat(
            np.cumsum(counts[hit_q]) - counts[hit_q], counts[hit_q]
        )
        cand = order[lo[qidx] + within]
        ok = (kl[cand] == qlens[qidx]) & (kt[cand] == rows[qidx]).all(axis=1)
        for i in hit_q:
            out[i] = cand[(qidx == i) & ok].astype(np.int32)
        return out

    # -- packed incidence -------------------------------------------------

    # postings per scatter chunk while building the packed table: bounds
    # the transient int64 position/row/column/value tensors (~48 B per
    # posting) at ~3 GB
    BITS_CHUNK = 1 << 26

    def _incidence_bits3(self, n_rows: int, n_cols: int) -> torch.Tensor:
        """Plane-tiled packed incidence scattered straight into its
        tile-major (n_cols // BLKB, n_rows, BLKB) int8 residency, on the
        index's device, from the resident CSR.

        The reference splits this scatter into int32-indexed row slabs
        (XLA's flat index and its 64x scatter-index padding); here one
        int64-indexed scatter per posting chunk does.  Bytes are built as
        int32 words (4 bytes each) and viewed as bytes: every (gram, term)
        posting owns a distinct bit, so the word adds never carry and equal
        a bitwise OR.  Never row-major then transposed: the table is written
        once, in place."""
        from ..ops.bitmap_matmul import BLKB, plane_coords

        dev = self.device.device
        ntiles = n_cols // BLKB
        words = torch.zeros(
            (ntiles * n_rows * BLKB) // 4, dtype=torch.int32, device=dev
        )
        gram_ptr = self.device.gram_ptr
        gram_terms = self.device.gram_terms
        total_p = int(gram_terms.shape[0])
        if total_p:
            ends = gram_ptr[1:].to(torch.int64)
            for p0 in range(0, total_p, self.BITS_CHUNK):
                p1 = min(p0 + self.BITS_CHUNK, total_p)
                pos = torch.arange(p0, p1, dtype=torch.int64, device=dev)
                rows = torch.searchsorted(ends, pos, right=True)
                col, bit = plane_coords(gram_terms[p0:p1].to(torch.int64))
                flat = ((col // BLKB) * n_rows + rows) * BLKB + col % BLKB
                val = torch.bitwise_left_shift(
                    torch.ones_like(bit), bit + 8 * (flat % 4)
                ).to(torch.int32)
                words.scatter_add_(0, flat // 4, val)
                del pos, rows, col, bit, flat, val
        return words.view(torch.int8).view(ntiles, n_rows, BLKB)

    def gram_matrix(self, budget_bytes: int = 1536 << 20):
        """Dense 0/1 gram -> long-term incidence as an int8 (Gp, Tlp)
        tensor on the index's device, or None when G * Tl would exceed
        ``budget_bytes`` (the reference's rule, on the unpadded shape).

        Rows [0, G) and columns [0, Tl) hold the reference's (G, Tl)
        matrix byte for byte; Gp and Tlp round G and Tl up to multiples of
        8 with zero rows and columns, the shapes ``torch._int_mm`` takes
        (search.candidates.gram_hits).  Built on the device from the
        resident CSR (postings are unique per (gram, term), so setting a
        byte equals the reference's add) at first use; cached per index,
        a miss as ``False``."""
        if self._gram_matrix_cache is not None:
            gm = self._gram_matrix_cache
            return None if gm is False else gm
        g = self.n_grams
        tl = int(self.device.long_lengths.shape[0])
        if g == 0 or tl == 0 or g * tl > budget_bytes:
            self._gram_matrix_cache = False
            return None
        gm = incidence_matrix(
            self.device.gram_ptr, self.device.gram_terms, g, tl,
            int(self.device.gram_terms.shape[0]), self.BITS_CHUNK,
        )
        self._gram_matrix_cache = gm
        return gm

    def bitmap_fits(self, budget_bytes: int = 6 << 30) -> bool:
        """Whether ``bitmap_tables(budget_bytes)`` holds a table, decided
        from the shapes without building it."""
        from ..ops.bitmap_matmul import g_padding

        nb, _ = self.bitmap_layout()
        tl = int(self.device.long_lengths.shape[0])
        g = self.n_grams
        return g > 0 and tl > 0 and g_padding(g) * nb <= budget_bytes

    def bitmap_tables(self, budget_bytes: int = 6 << 30):
        """(bm int8 (ntiles, G_pad, BLKB) tile-major packed incidence,
        tl_pad), or None over ``budget_bytes``.  Built on the device from the
        resident CSR at first use; cached per index.  Bytes equal the
        reference's table, padding included."""
        if self._bitmap_cache is not None:
            bm = self._bitmap_cache
            return None if bm is False else bm
        from ..ops.bitmap_matmul import g_padding

        if not self.bitmap_fits(budget_bytes):
            self._bitmap_cache = False
            return None
        nb, tl_pad = self.bitmap_layout()
        bm = self._incidence_bits3(g_padding(self.n_grams), nb)
        self._bitmap_cache = (bm, tl_pad)
        return self._bitmap_cache

    def sketch_tables(self, budget_bytes: int = 6 << 30, max_tgw: int = 128,
                      packed: bool = True):
        """Bucket-sketch tables (search.sketch): (inc, tg (tl_pad, TGW)
        int32 term->gram slots, wmax_pad (tl_pad,) float32 per-term weight
        bound, d_log2), or None when the long tier is too small or too wide
        for the path, or D = 128 buckets already pass ``budget_bytes``.

        ``packed``: inc is the plane-tiled (tl_pad/4096, D, BLKB) int8
        tile-major incidence for K2, D <= 8192.  Otherwise the (D, tl_pad)
        int8 0/1 incidence for ``torch._int_mm``, D <= 1024.  The
        reference's rules: tl_pad is a multiple of 16384 terms; D starts at
        2^13 packed or 2^10 unpacked and halves while over budget.  Built
        on the index's device from the resident token matrix for narrow
        g <= 3, from numpy gram ids otherwise; cached per index and mode."""
        if not isinstance(self._sketch_cache, dict):
            self._sketch_cache = {}
        mode = bool(packed)
        if mode in self._sketch_cache:
            sk = self._sketch_cache[mode]
            return None if sk is False else sk
        from ..search import sketch as sketchlib

        d = self.device
        tl = int(d.long_lengths.shape[0])
        g = self.config.gram_size
        tgw = int(d.long_tokens.shape[1]) - g + 1
        if not self.sketch_fits(budget_bytes, packed, max_tgw):
            self._sketch_cache[mode] = False
            return None
        tile = sketchlib._TILE
        tl_pad = -(-tl // tile) * tile
        bytes_per_d = tl_pad // 8 if packed else tl_pad
        d_log2 = 13 if packed else 10
        while d_log2 > 7 and (1 << d_log2) * bytes_per_d > budget_bytes:
            d_log2 -= 1
        if not self.config.wide and g <= 3:
            gram_ids32 = torch.from_numpy(
                self.gram_ids.astype(np.int32)
            ).to(d.device)
            builder = (
                sketchlib.build_sketch_device_packed if packed
                else sketchlib.build_sketch_device
            )
            inc, tg = builder(
                d.long_tokens, d.long_lengths, gram_ids32, gram_size=g,
                d_log2=d_log2, tl_pad=tl_pad, tgw=tgw,
            )
        else:
            inc, tg = sketchlib.build_sketch_host(
                d.long_tokens.cpu().numpy(), d.long_lengths.cpu().numpy(),
                self.lookup_gram_slots, g, self.config.wide, self.vocab,
                d_log2, tl_pad, tgw, device=d.device, packed=packed,
            )
        ts = int(d.short_lengths.shape[0])
        wmax_pad = torch.zeros(tl_pad, dtype=torch.float32, device=d.device)
        wmax_pad[:tl] = d.term_wmax[ts:]
        self._sketch_cache[mode] = (inc, tg, wmax_pad, d_log2)
        return self._sketch_cache[mode]

    def sketch_fits(self, budget_bytes: int = 6 << 30, packed: bool = True,
                    max_tgw: int = 128) -> bool:
        """Whether ``sketch_tables(budget_bytes, max_tgw, packed)`` holds a
        table, from the shapes alone: a long tier with grams, 1 <= TGW <=
        max_tgw gram windows per term, and D = 128 buckets within the
        budget (tl_pad / 8 bytes per bucket packed, tl_pad unpacked)."""
        from ..search import sketch as sketchlib

        tl = int(self.device.long_lengths.shape[0])
        tgw = int(self.device.long_tokens.shape[1]) - self.config.gram_size + 1
        if tl == 0 or self.n_grams == 0 or tgw < 1 or tgw > max_tgw:
            return False
        tl_pad = -(-tl // sketchlib._TILE) * sketchlib._TILE
        return 128 * (tl_pad // 8 if packed else tl_pad) <= budget_bytes

    def bitmap_layout(self):
        """(nb, tl_pad) of the packed-plane layout without building it."""
        from ..ops.bitmap_matmul import PAD_LANES

        tl = int(self.device.long_lengths.shape[0])
        tl_pad = -(-max(tl, 1) // PAD_LANES) * PAD_LANES
        return tl_pad // 8, tl_pad

    def prim_tables(self):
        """(T, 4) / (X, 4) int32 edge record tables for the candidate path:
        [key, bitcast(weight), key_len, 0] per primary / extra edge."""
        if self._prim_table_cache is not None:
            return self._prim_table_cache
        d = self.device
        k_total = int(d.key_len.shape[0])

        def rec(keys, weights):
            if k_total:
                klen = d.key_len[keys.clamp(0, k_total - 1).long()]
            else:
                klen = torch.zeros_like(keys)
            return torch.stack(
                [
                    keys,
                    weights.contiguous().view(torch.int32),
                    klen,
                    torch.zeros_like(keys),
                ],
                dim=1,
            )

        self._prim_table_cache = (
            rec(d.term_prim_key, d.term_prim_weight),
            rec(d.extra_key, d.extra_weight),
        )
        return self._prim_table_cache

    def key_edge_host(self):
        """(ptr, term, weight) host copies of the key->edge CSR."""
        if self.host_key_edge_ptr is None:
            d = self.device
            self.host_key_edge_ptr = d.key_edge_ptr.cpu().numpy()
            self.host_key_edge_term = d.key_edge_term.cpu().numpy()
            self.host_key_edge_weight = d.key_edge_weight.cpu().numpy()
        return (
            self.host_key_edge_ptr,
            self.host_key_edge_term,
            self.host_key_edge_weight,
        )

    # at most this many DP width buckets; buckets holding under 1/16 of the
    # tier (or under DP_MIN_BUCKET_ROWS) merge into a wider neighbor
    DP_MAX_BUCKETS = 5
    DP_MIN_BUCKET_ROWS = 512

    def long_dp_buckets(self) -> tuple:
        """((end_row, width), ...) width buckets over the length-ascending
        long tier for dp_match_tiered; () when the tier is uniform."""
        if self._dp_bucket_cache is not None:
            return self._dp_bucket_cache
        ll = self.host_long_lengths
        if ll is None:
            ll = self.device.long_lengths.cpu().numpy()
            self.host_long_lengths = ll
        n = int(ll.shape[0])
        full_w = int(self.device.long_tokens.shape[1])
        if n == 0 or ll[0] >= ll[-1] or not np.all(ll[:-1] <= ll[1:]):
            self._dp_bucket_cache = ()
            return ()
        min_rows = max(n // 16, self.DP_MIN_BUCKET_ROWS)
        raw = []
        lo, w = 0, 8
        while lo < n:
            end = int(np.searchsorted(ll, w, side="right")) if w < full_w else n
            if end > lo:
                raw.append((end, min(w, full_w)))
                lo = end
            w *= 2
        folded: list = []
        start = 0
        for end, w in raw:
            if (end - start) >= min_rows:
                folded.append((end, w))
                start = end
        if start < n:
            folded.append(raw[-1])
        while len(folded) > self.DP_MAX_BUCKETS:
            costs = []
            b0 = 0
            for i in range(len(folded) - 1):
                lo0 = b0
                end0, w0 = folded[i]
                end1, w1 = folded[i + 1]
                costs.append(((end0 - lo0) * (w1 - w0), i))
                b0 = end0
            _, i = min(costs)
            folded[i : i + 2] = [folded[i + 1]]
        out = tuple(folded) if len(folded) > 1 else ()
        self._dp_bucket_cache = out
        return out

    def lookup_gram_slots(self, ids: np.ndarray) -> np.ndarray:
        """int64 gram ids -> dense slots in [0, G), or -1 when absent."""
        idx = np.searchsorted(self.gram_ids, ids)
        idx_c = np.minimum(idx, max(self.n_grams - 1, 0))
        if self.n_grams:
            hit = self.gram_ids[idx_c] == ids
        else:
            hit = np.zeros(ids.shape, dtype=bool)
        return np.where(hit, idx_c, -1).astype(np.int32)

    def set_valid_char(self, chars: bytes) -> None:
        """Replace the valid-char set (dllmain.cpp:142-151).  Affects query
        normalization and the exact-match key comparison; the gram index is
        immutable."""
        self.tables = textlib.TextTables(
            chars, wide=self.config.wide,
            wide_upper=self.config.wide_upper,
        )
        norm, norm_len = textlib.normalize_matrix(
            self.key_strings.tokens,
            self.key_strings.lengths,
            self.tables,
            upper=False,
        )
        norm = _pad_width(norm, 1)
        self.host_key_norm_tokens = norm
        self.host_key_norm_lengths = norm_len.astype(np.int32)
        self._key_hash_cache = None


def incidence_matrix(gram_ptr, gram_terms, n_grams: int, n_long: int,
                     n_postings: int, chunk: int) -> torch.Tensor:
    """The dense 0/1 (Gp, Tlp) int8 gram -> long-term incidence of the CSR
    ``gram_ptr`` / ``gram_terms[:n_postings]`` on their device: Gp and Tlp
    round ``n_grams`` and ``n_long`` up to multiples of 8 (``torch._int_mm``'s
    shapes) with zero rows and columns.  Postings are unique per (gram, term),
    so setting a byte equals the reference's add; ``chunk`` postings per
    scatter bound the transient int64 positions."""
    dev = gram_terms.device
    gp, tlp = -(-n_grams // 8) * 8, -(-n_long // 8) * 8
    gm = torch.zeros((gp, tlp), dtype=torch.int8, device=dev)
    flat = gm.view(-1)
    ends = gram_ptr[1:].to(torch.int64)
    for p0 in range(0, n_postings, chunk):
        p1 = min(p0 + chunk, n_postings)
        pos = torch.arange(p0, p1, dtype=torch.int64, device=dev)
        rows = torch.searchsorted(ends, pos, right=True)
        flat.index_fill_(0, rows * tlp + gram_terms[p0:p1].to(torch.int64), 1)
        del pos, rows
    return gm


_FNV_OFFSET = np.uint64(1469598103934665603)
_FNV_PRIME = np.uint64(1099511628211)


def _fnv_rows(tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized FNV-1a over (length, row tokens)."""
    with np.errstate(over="ignore"):
        h = np.full(tokens.shape[0], _FNV_OFFSET, dtype=np.uint64)
        h = (h ^ lengths.astype(np.uint64)) * _FNV_PRIME
        for c in range(tokens.shape[1]):
            h = (h ^ tokens[:, c].astype(np.uint64)) * _FNV_PRIME
    return h


def _edge_csr(edge_term: np.ndarray, edge_weight: np.ndarray, n_terms: int):
    """(term_edge_ptr, term_wmax) from term-sorted edges."""
    counts = np.bincount(edge_term, minlength=n_terms).astype(np.int32)
    ptr = np.zeros(n_terms + 1, dtype=np.int32)
    np.cumsum(counts, out=ptr[1:])
    wmax = np.zeros(n_terms, dtype=np.float32)
    nz = counts > 0
    if edge_weight.shape[0]:
        wmax[nz] = np.maximum.reduceat(edge_weight, ptr[:-1][nz])
    return ptr, wmax


def _edge_primary(
    edge_term: np.ndarray,
    edge_key: np.ndarray,
    edge_weight: np.ndarray,
    n_terms: int,
):
    """Primary-edge decomposition from term-sorted edges: (prim_key,
    prim_weight, extra_ptr, extra_key, extra_weight)."""
    counts = np.bincount(edge_term, minlength=n_terms).astype(np.int64)
    ptr = np.zeros(n_terms + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    prim_key = np.full(n_terms, -1, dtype=np.int32)
    prim_weight = np.zeros(n_terms, dtype=np.float32)
    nz = counts > 0
    if edge_key.shape[0]:
        prim_key[nz] = edge_key[ptr[:-1][nz]]
        prim_weight[nz] = edge_weight[ptr[:-1][nz]]
    is_extra = np.ones(edge_term.shape[0], dtype=bool)
    if edge_key.shape[0]:
        is_extra[ptr[:-1][nz]] = False
    extra_counts = np.maximum(counts - 1, 0).astype(np.int32)
    extra_ptr = np.zeros(n_terms + 1, dtype=np.int32)
    np.cumsum(extra_counts, out=extra_ptr[1:])
    return (
        prim_key,
        prim_weight,
        extra_ptr,
        edge_key[is_extra],
        edge_weight[is_extra],
    )


def _key_edge_csr(
    edge_term: np.ndarray,
    edge_key: np.ndarray,
    edge_weight: np.ndarray,
    n_keys: int,
):
    """Key-sorted edge duplicate: (key_edge_ptr, key_edge_term,
    key_edge_weight, host key edge counts)."""
    order = np.argsort(edge_key, kind="stable")
    counts = np.bincount(edge_key, minlength=n_keys).astype(np.int32)
    ptr = np.zeros(n_keys + 1, dtype=np.int32)
    np.cumsum(counts, out=ptr[1:])
    return ptr, edge_term[order], edge_weight[order], counts


def _canonical(a: np.ndarray) -> np.ndarray:
    """The dtype the reference's device arrays carry: 64-bit integers and
    floats narrow to 32 bits (JAX's default), narrower ones stay."""
    a = np.asarray(a)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    if a.dtype == np.uint64:
        return a.astype(np.uint32)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    return a


def _from_host(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch tensors may be written in place
        a = a.copy()
    return torch.from_numpy(a).to(device)


def to_tensor(a, device) -> torch.Tensor:
    """Device tensor of a host array at the reference's dtype."""
    return _from_host(_canonical(a), device)


def to_token_tensor(mat, device) -> torch.Tensor:
    """Device token matrix: byte strings stay uint8, wide codepoints
    widen to int32 (as the reference's _upload_tokens)."""
    mat = np.asarray(mat)
    return _from_host(mat if mat.dtype == np.uint8 else mat.astype(np.int32), device)


def _pad_width(mat: np.ndarray, min_width: int, multiple: int = 8) -> np.ndarray:
    """Pad the trailing dim to a multiple."""
    width = max(mat.shape[1], min_width)
    width = -(-width // multiple) * multiple
    if width > mat.shape[1]:
        mat = np.pad(mat, ((0, 0), (0, width - mat.shape[1])))
    return mat


def _dedup_rows(rows: np.ndarray, lengths: np.ndarray):
    """Dedup matrix rows (length-aware).  Returns (first_occurrence_rank ids
    per row, unique-row indices ordered by first occurrence)."""
    n = rows.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    keyed = np.concatenate(
        [lengths.astype(rows.dtype).reshape(-1, 1), rows], axis=1
    )
    keyed = np.ascontiguousarray(keyed)
    view = keyed.view([("", np.void, keyed.dtype.itemsize * keyed.shape[1])])
    _, first_idx, inverse = np.unique(view, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return rank[inverse.ravel()].astype(np.int64), first_idx[order]


def _host_postings(lt, ll, gram_size, wide, vocab):
    """Vectorized numpy gram->term CSR from the long token matrix.
    Returns (gram_terms int32, gram_ptr int32, distinct_gram_ids int64)."""
    gids, gvalid = gramlib.gram_ids(lt, ll, gram_size, wide, vocab)
    tt, ww = np.nonzero(gvalid)
    flat_g = gids[tt, ww]
    if not wide and gram_size <= 4:
        keys = (flat_g.astype(np.uint64) << np.uint64(32)) | tt.astype(
            np.uint64
        )
        keys.sort()
        m = keys.shape[0]
        keep = np.ones(m, bool)
        keep[1:] = keys[1:] != keys[:-1]
        keys = keys[keep]
        sg = (keys >> np.uint64(32)).astype(np.int64)
        stt = (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
    else:
        order = np.lexsort((tt, flat_g))
        sg, stt = flat_g[order], tt[order]
        keep = np.ones(sg.shape[0], bool)
        keep[1:] = (sg[1:] != sg[:-1]) | (stt[1:] != stt[:-1])
        sg, stt = sg[keep], stt[keep]
    m = sg.shape[0]
    if m == 0:
        return (
            np.zeros(0, np.int32), np.zeros(1, np.int32),
            np.zeros(0, np.int64),
        )
    first = np.ones(m, bool)
    first[1:] = sg[1:] != sg[:-1]
    starts = np.nonzero(first)[0]
    distinct = sg[starts]
    ptr = np.empty(distinct.shape[0] + 1, dtype=np.int32)
    ptr[:-1] = starts
    ptr[-1] = m
    return stt.astype(np.int32), ptr, distinct


# below this many long terms the host postings build is cheaper than the
# device pass
DEVICE_POSTINGS_MIN = 50_000

# wall-clock breakdown of the most recent build_index call (seconds per
# stage), under the reference's keys
LAST_BUILD_BREAKDOWN: dict = {}


def _want_device_postings(config, n_long, device_postings):
    if device_postings is not None:
        return device_postings and not config.wide and config.gram_size <= 3
    return (
        not config.wide
        and config.gram_size <= 3
        and n_long >= DEVICE_POSTINGS_MIN
    )


def default_device() -> torch.device:
    """The first CUDA device.  Raises when no card is present: the port's
    entry points run on the card unless the caller passes ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device=\"cpu\" to build and "
            "search on the CPU"
        )
    return torch.device("cuda")


def _sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_index(
    words: Sequence,
    row_size: int,
    weights: Optional[Sequence[float]] = None,
    config: IndexConfig = IndexConfig(),
    valid_chars: bytes = DEFAULT_VALID_CHARS,
    use_native: Optional[bool] = None,
    device_postings: Optional[bool] = None,
    device=None,
) -> HostIndex:
    """Build an index from the reference's flattened row model
    (indexN, dllmain.cpp:37-49) with its tensors on ``device``: the CUDA
    card by default (``default_device``, which raises without one), the
    CPU only when asked (``device="cpu"``).

    ``use_native``: None = auto (C++ builder for narrow strings when it
    compiles), True = require it, False = numpy path.
    ``device_postings``: None = auto (device postings for narrow g<=3 long
    tiers above DEVICE_POSTINGS_MIN), True/False = force.
    """
    device = default_device() if device is None else torch.device(device)
    if use_native is None:
        use_native = not config.wide
    if use_native and not config.wide and words is not None and len(words) >= 2:
        nat = nativelib.get_native()
        if nat is not None:
            return _build_from_native(
                nat, list(words), row_size, weights, config, valid_chars,
                device_postings, device,
            )
    return _build_numpy(
        words, row_size, weights, config, valid_chars, device_postings,
        device,
    )


def _long_length_sort_native(d: dict) -> None:
    """Reorder the native builder's long tier by (length, id) in place,
    remapping every long-term id consumer (same stable permutation as the
    numpy builder)."""
    ll = d["long_lengths"]
    n_long = ll.shape[0]
    if n_long == 0:
        return
    perm = np.argsort(ll, kind="stable")
    if np.array_equal(perm, np.arange(n_long)):
        return
    rank = np.empty(n_long, dtype=np.int64)
    rank[perm] = np.arange(n_long)
    d["long_tokens"] = d["long_tokens"][perm]
    d["long_lengths"] = ll[perm]
    ns = d["short_lengths"].shape[0]
    et = d["edge_term"]
    is_long = et >= ns
    et = et.copy()
    et[is_long] = (ns + rank[et[is_long] - ns]).astype(et.dtype)
    d["edge_term"] = et
    gt = rank[d["gram_terms"]].astype(d["gram_terms"].dtype)
    ptr = d["gram_ptr"].astype(np.int64)
    if gt.shape[0]:
        row = np.repeat(
            np.arange(ptr.shape[0] - 1, dtype=np.int64), np.diff(ptr)
        )
        gt = gt[np.lexsort((gt, row))]
    d["gram_terms"] = gt


def _build_from_native(
    nat, words, row_size, weights, config, valid_chars, device_postings,
    device,
):
    """HostIndex from the C++ builder's array dict (semantics identical to
    the numpy path; see native/builder.cpp)."""
    w_arg = None
    if weights is not None:
        w_arg = [float(x) for x in weights]
    bd = LAST_BUILD_BREAKDOWN
    bd.clear()
    t_total = time.perf_counter()
    t0 = time.perf_counter()
    # the C++ postings pass is skipped: postings rebuild on the device or
    # via the vectorized numpy shingle below
    d = nat.build_narrow(
        words, int(row_size), w_arg, int(config.gram_size),
        bytes(valid_chars), 1,
    )
    bd["native_cpp"] = round(time.perf_counter() - t0, 2)
    tables = textlib.TextTables(valid_chars, wide=False)

    t0 = time.perf_counter()
    _long_length_sort_native(d)
    bd["long_length_sort"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()

    et, ek, ew = d["edge_term"], d["edge_key"], d["edge_weight"]
    order = np.lexsort((ek, et))
    et, ek, ew = et[order], ek[order], ew[order]
    n_terms_total = d["short_lengths"].shape[0] + d["long_lengths"].shape[0]
    te_ptr, t_wmax = _edge_csr(et, ew, n_terms_total)
    pk, pw, xptr, xkey, xw = _edge_primary(et, ek, ew, n_terms_total)
    ke_ptr, ke_term, ke_w, ke_counts = _key_edge_csr(
        et, ek, ew, d["key_lengths"].shape[0]
    )
    bd["edge_csr"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()

    st = _pad_width(d["short_tokens"], config.short_pad)
    lt = _pad_width(d["long_tokens"], config.gram_size)
    lt_dev = to_token_tensor(lt, device)
    ll_dev = to_tensor(d["long_lengths"], device)
    n_long_d = int(d["long_lengths"].shape[0])
    if n_long_d and _want_device_postings(config, n_long_d, device_postings):
        from .device_build import build_postings_device

        _sync(device)
        bd["token_upload"] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()
        gram_terms_dev, gram_ptr_h, gram_ids_h = build_postings_device(
            lt_dev, ll_dev, config.gram_size
        )
        _sync(device)
        bd["device_postings"] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()
    else:
        gt_h, gram_ptr_h, gram_ids_h = _host_postings(
            lt, d["long_lengths"], config.gram_size, False, None
        )
        gram_terms_dev = to_tensor(gt_h, device)
        bd["host_postings"] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()
    gram_ptr_dev = to_tensor(gram_ptr_h, device)
    key_tokens, key_lens = d["key_tokens"], d["key_lengths"]
    if key_tokens.shape[0]:
        knorm, knorm_len = textlib.normalize_matrix(
            key_tokens, key_lens, tables, upper=False
        )
    else:
        knorm = np.zeros((0, 1), np.uint8)
        knorm_len = np.zeros(0, np.int32)
    knorm = _pad_width(knorm, 1)

    dev = lambda a: to_tensor(a, device)  # noqa: E731
    di = DeviceIndex(
        short_tokens=to_token_tensor(st, device),
        short_lengths=dev(d["short_lengths"]),
        long_tokens=lt_dev,
        long_lengths=ll_dev,
        gram_ptr=gram_ptr_dev,
        gram_terms=gram_terms_dev,
        edge_term=dev(et),
        edge_key=dev(ek),
        edge_weight=dev(ew),
        term_edge_ptr=dev(te_ptr),
        term_wmax=dev(t_wmax),
        term_prim_key=dev(pk),
        term_prim_weight=dev(pw),
        term_extra_ptr=dev(xptr),
        extra_key=dev(xkey),
        extra_weight=dev(xw),
        key_edge_ptr=dev(ke_ptr),
        key_edge_term=dev(ke_term),
        key_edge_weight=dev(ke_w),
        key_len=dev(key_lens.astype(np.int32)),
    )
    _sync(device)
    bd["norm_and_uploads"] = round(time.perf_counter() - t0, 2)
    bd["total"] = round(time.perf_counter() - t_total, 2)
    return HostIndex(
        config=config,
        tables=tables,
        key_strings=KeyStrings(key_tokens, key_lens, False),
        gram_ids=gram_ids_h,
        device=di,
        n_terms=int(d["n_terms"]),
        max_term_len=int(d["max_term_len"]),
        vocab=None,
        indexed=True,
        host_posting_lens=np.diff(gram_ptr_h).astype(np.int64),
        host_key_norm_tokens=knorm,
        host_key_norm_lengths=np.asarray(knorm_len, np.int32),
        host_key_edge_counts=ke_counts,
        host_long_lengths=np.asarray(d["long_lengths"], np.int32),
        host_key_edge_ptr=ke_ptr,
        host_key_edge_term=ke_term,
        host_key_edge_weight=ke_w,
        uniform_weights=bool(ew.size == 0 or np.all(ew == 1.0)),
    )


def _build_numpy(
    words: Sequence,
    row_size: int,
    weights: Optional[Sequence[float]] = None,
    config: IndexConfig = IndexConfig(),
    valid_chars: bytes = DEFAULT_VALID_CHARS,
    device_postings: Optional[bool] = None,
    device=None,
) -> HostIndex:
    """Vectorized numpy build (the native builder must match it exactly),
    on the card unless ``device`` says otherwise."""
    device = default_device() if device is None else torch.device(device)
    tables = textlib.TextTables(
        valid_chars, wide=config.wide, wide_upper=config.wide_upper,
    )
    dev = lambda a: to_tensor(a, device)  # noqa: E731
    empty = words is None or len(words) < 2  # size<2 guard, nGramSearch.hpp:122
    words = [] if empty else list(words)
    size = len(words)
    wide = config.wide
    tok_dtype = np.uint32 if wide else np.uint8

    tokens, lengths = textlib.encode_batch(words, wide)
    null_mask = np.fromiter((w is None for w in words), bool, size) if size else (
        np.zeros(0, bool)
    )
    norm_t, norm_l = textlib.normalize_matrix(tokens, lengths, tables)
    trim_t, trim_l = textlib.trim_only_matrix(tokens, lengths, tables)

    if weights is None:
        w = np.ones(size, dtype=np.float32)
    else:
        w = np.ones(size, dtype=np.float32)
        given = np.asarray(list(weights), dtype=np.float32)[:size]
        w[: given.shape[0]] = given

    idx = np.arange(size)
    row_start = (idx // max(row_size, 1)) * max(row_size, 1)
    is_master = idx == row_start
    master_ok = (~null_mask) & (trim_l > 0)
    row_ok = master_ok[row_start]
    recorded = (
        row_ok
        & (~null_mask)
        & (w != 0.0)
        & np.where(is_master, True, norm_l > 0)
    )
    rec = np.where(recorded)[0]

    # -- interleaved string dedup: element e -> (term at 2e, key at 2e+1) ---
    r = rec.shape[0]
    t_rows, t_lens = norm_t[rec], norm_l[rec]
    k_src = row_start[rec]
    k_rows, k_lens = trim_t[k_src], trim_l[k_src]
    width = max(t_rows.shape[1] if r else 1, k_rows.shape[1] if r else 1)

    inter = np.zeros((2 * r, width), dtype=tok_dtype)
    inter_len = np.zeros(2 * r, dtype=np.int32)
    if r:
        inter[0::2, : t_rows.shape[1]] = t_rows
        inter[1::2, : k_rows.shape[1]] = k_rows
        inter_len[0::2] = t_lens
        inter_len[1::2] = k_lens
    sid, uniq_first = _dedup_rows(inter, inter_len)
    u = uniq_first.shape[0]
    term_sid, key_sid = sid[0::2], sid[1::2]
    ustr_tokens = inter[uniq_first] if u else np.zeros((0, width), tok_dtype)
    ustr_lens = inter_len[uniq_first] if u else np.zeros(0, np.int32)

    is_term = np.zeros(u, bool)
    is_key = np.zeros(u, bool)
    if r:
        is_term[term_sid] = True
        is_key[key_sid] = True

    # -- term table: short tier first (string-rank order), then long terms
    # sorted by (length, string rank) for the width-bucketed DP
    cutoff = config.long_cutoff
    term_ids = np.where(is_term)[0]
    term_lens_u = ustr_lens[term_ids]
    short_ids = term_ids[term_lens_u < cutoff]
    long_ids = term_ids[term_lens_u >= cutoff]
    long_ids = long_ids[np.argsort(ustr_lens[long_ids], kind="stable")]
    n_short, n_long = short_ids.shape[0], long_ids.shape[0]
    term_local = np.full(u, -1, np.int64)
    term_local[short_ids] = np.arange(n_short)
    term_local[long_ids] = n_short + np.arange(n_long)

    key_ids = np.where(is_key)[0]
    n_keys = key_ids.shape[0]
    key_local = np.full(u, -1, np.int64)
    key_local[key_ids] = np.arange(n_keys)

    # -- edges: dedup (term, key), LAST weight wins ---------------------------
    if r:
        et_g = term_local[term_sid]
        ek_g = key_local[key_sid]
        order = np.lexsort((np.arange(r), ek_g, et_g))
        et_s, ek_s = et_g[order], ek_g[order]
        last = np.ones(r, bool)
        last[:-1] = (et_s[1:] != et_s[:-1]) | (ek_s[1:] != ek_s[:-1])
        edge_term = et_s[last].astype(np.int32)
        edge_key = ek_s[last].astype(np.int32)
        edge_weight = w[rec][order][last].astype(np.float32)
    else:
        edge_term = np.zeros(0, np.int32)
        edge_key = np.zeros(0, np.int32)
        edge_weight = np.zeros(0, np.float32)

    # -- token matrices --------------------------------------------------------
    st = _pad_width(ustr_tokens[short_ids], config.short_pad)
    sl = ustr_lens[short_ids]
    lt = _pad_width(ustr_tokens[long_ids], config.gram_size)
    ll = ustr_lens[long_ids]

    # -- gram postings (deduped per term: posting-set semantics) ---------------
    vocab = None
    if wide and config.gram_size == 4:
        vocab = gramlib.WideVocab(lt[lt > 0] if lt.size else np.zeros(0, np.int64))
    lt_dev = to_token_tensor(lt, device)
    ll_dev = dev(ll.astype(np.int32))
    gram_terms_dev = None
    if n_long and _want_device_postings(config, n_long, device_postings):
        from .device_build import build_postings_device

        gram_terms_dev, gram_ptr, distinct_grams = build_postings_device(
            lt_dev, ll_dev, config.gram_size
        )
    elif n_long:
        gram_terms, gram_ptr, distinct_grams = _host_postings(
            lt, ll, config.gram_size, wide, vocab
        )
    else:
        distinct_grams = np.zeros(0, dtype=np.int64)
        gram_ptr = np.zeros(1, dtype=np.int32)
        gram_terms = np.zeros(0, dtype=np.int32)

    # -- keys -------------------------------------------------------------------
    key_tokens_raw = ustr_tokens[key_ids]
    key_lens_raw = ustr_lens[key_ids]
    if n_keys:
        knorm, knorm_len = textlib.normalize_matrix(
            key_tokens_raw, key_lens_raw, tables, upper=False
        )
    else:
        knorm = np.zeros((0, 1), tok_dtype)
        knorm_len = np.zeros(0, np.int32)
    knorm = _pad_width(knorm, 1)

    te_ptr, t_wmax = _edge_csr(edge_term, edge_weight, n_short + n_long)
    pk, pw, xptr, xkey, xw = _edge_primary(
        edge_term, edge_key, edge_weight, n_short + n_long
    )
    ke_ptr, ke_term, ke_w, ke_counts = _key_edge_csr(
        edge_term, edge_key, edge_weight, n_keys
    )
    if gram_terms_dev is None:
        gram_terms_dev = dev(gram_terms)
    di = DeviceIndex(
        short_tokens=to_token_tensor(st, device),
        short_lengths=dev(sl.astype(np.int32)),
        long_tokens=lt_dev,
        long_lengths=ll_dev,
        gram_ptr=dev(gram_ptr),
        gram_terms=gram_terms_dev,
        edge_term=dev(edge_term),
        edge_key=dev(edge_key),
        edge_weight=dev(edge_weight),
        term_edge_ptr=dev(te_ptr),
        term_wmax=dev(t_wmax),
        term_prim_key=dev(pk),
        term_prim_weight=dev(pw),
        term_extra_ptr=dev(xptr),
        extra_key=dev(xkey),
        extra_weight=dev(xw),
        key_edge_ptr=dev(ke_ptr),
        key_edge_term=dev(ke_term),
        key_edge_weight=dev(ke_w),
        key_len=dev(key_lens_raw.astype(np.int32)),
    )

    return HostIndex(
        config=config,
        tables=tables,
        key_strings=KeyStrings(key_tokens_raw, key_lens_raw, wide),
        gram_ids=distinct_grams,
        device=di,
        n_terms=int(term_ids.shape[0]),
        max_term_len=int(term_lens_u.max()) if term_ids.size else 0,
        vocab=vocab,
        indexed=not empty,
        host_posting_lens=np.diff(gram_ptr).astype(np.int64),
        host_key_norm_tokens=knorm,
        host_key_norm_lengths=np.asarray(knorm_len, np.int32),
        host_key_edge_counts=ke_counts,
        host_long_lengths=ll.astype(np.int32),
        host_key_edge_ptr=ke_ptr,
        host_key_edge_term=ke_term,
        host_key_edge_weight=ke_w,
        uniform_weights=bool(
            edge_weight.size == 0 or np.all(edge_weight == 1.0)
        ),
    )
