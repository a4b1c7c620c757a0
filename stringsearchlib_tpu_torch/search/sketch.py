"""Bucket-sketch candidate search for long tiers too big for the exact
packed bitmap.

PyTorch counterpart of ``stringsearchlib_tpu.search.sketch``.  The
contraction axis shrinks from G grams to D = 2^k hashed buckets:

  inc[d, t] = 1  iff term t has >= 1 distinct gram hashing to bucket d
  hits_h    = qcnt_h (B, D) x inc (D, Tl)

in one of two forms: packed (the incidence plane-tiled, 8 terms a byte,
through kernel K2 of ops.bitmap_matmul; int8 counts, so queries of at most
127 gram windows) or unpacked (a (D, Tl) int8 0/1 matrix, D <= 1024,
through ``torch._int_mm``, one product per base-128 digit of the counts:
the reference's XLA dot, any query width).  ``hits_h`` over-counts
(collisions only add), so ``u = wmax * hits_h / nqg`` is a sound upper
bound on every term's weighted score.  Candidates are selected
hierarchically on that bound (128-lane block maxima -> 128-block
superblock maxima -> top-k down the levels, each level's dropped maximum
joining the guard bound), then re-scored exactly from the term->gram table
``tg`` ((Tl, TGW) distinct gram slots per term) and handed to the shared
back half ``candidates._finish_selected``.  Results equal the dense path's
whenever the exactness guard passes; the host retries otherwise.

The packed incidence is written straight into its tile-major (Tl/4096, D,
512) residency from ``tg``; the reference builds it row-major and
transposes, holding both copies at once.  The unpacked one is set byte by
byte from ``tg`` in place of the reference's per-term bit mask, and held
column-major, the layout cuBLASLt's int8 tensor-core GEMM takes.

Ties: ``torch.topk`` does not prefer the lower index among equal values
where ``lax.top_k`` does.  ``_sel_bound`` keeps the guard sound either way;
only where a tie straddles a selection cutoff can the two packages select
different equal-valued lanes, and so differ in a row's exact flag.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import grams as gramlib
from ..ops.bitmap_matmul import BLKB, TILE_LANES, bitmap_hits, plane_coords
from .candidates import (
    _f32, _finish_selected, _short_tier, int_mm_counts, query_counts,
    topk_chunked,
)

_NEG_INF = float("-inf")

# Knuth multiplicative hash constant (2^32 / phi); buckets are the top k
# bits of the 32-bit product so neighbouring slots scatter
_HASH_MULT = 2654435761

_BLK = 128  # selection block width
_SUPER = 128  # blocks per superblock
_TILE = _BLK * _SUPER  # term padding quantum (16384)

# bytes of float32 transient per step of the block-max pass: the (B, Tl)
# bound surface is never whole at once
_SLAB_BYTES = 256 << 20
# terms per step of the incidence scatter
_PACK_TERMS = 1 << 20
# bytes of int32 product per torch._int_mm call of the unpacked sketch
_MM_SLAB_BYTES = 1 << 30


def bucket_of(slots, d_log2: int):
    """Gram slot -> bucket in [0, 2^d_log2); negative slots -> -1.

    The reference's uint32 product with wraparound, in int64: the product
    of a slot < 2^31 and the constant stays below 2^63, and masking to 32
    bits wraps it as uint32 arithmetic would."""
    h = ((slots.to(torch.int64) * _HASH_MULT) & 0xFFFFFFFF) >> (32 - d_log2)
    return torch.where(slots >= 0, h.to(torch.int32), -1)


# ---------------------------------------------------------------------------
# sketch table construction
# ---------------------------------------------------------------------------


def _pack_windows(tokens32, gram_size: int):
    """(Tl, W) int32 codepoints -> (Tl, W-g+1) int32 packed gram ids (byte
    fields, first char highest).  Narrow-only: g <= 3 stays in 24 bits."""
    w = tokens32.shape[1] - gram_size + 1
    out = torch.zeros_like(tokens32[:, :w])
    for k in range(gram_size):
        out = (out << 8) | tokens32[:, k : k + w]
    return out


def _finish_tg(slots, tl_pad: int, tgw: int):
    """(Tl, W) gram slots (>= 2^30 where absent) -> ``tg`` (tl_pad, tgw)
    int32: each row's distinct slots ascending, duplicates and absent
    windows -1, padded with -1 rows and columns."""
    big = 2**30
    slot_s = torch.sort(slots, dim=1).values
    dup = torch.zeros_like(slot_s, dtype=torch.bool)
    dup[:, 1:] = slot_s[:, 1:] == slot_s[:, :-1]
    tg = torch.where(dup | (slot_s >= big), -1, slot_s).to(torch.int32)
    tl, w = tg.shape
    out = torch.full((tl_pad, tgw), -1, dtype=torch.int32, device=tg.device)
    out[:tl, : min(w, tgw)] = tg[:, :tgw]
    return out


def _term_gram_slots(long_tokens, long_lengths, gram_ids32, *, gram_size,
                     tl_pad, tgw):
    """Per-term distinct gram slots ``tg`` (tl_pad, tgw) int32 on the
    tokens' device (narrow g <= 3)."""
    g_total = gram_ids32.shape[0]
    packed = _pack_windows(long_tokens.to(torch.int32), gram_size)
    pos = torch.arange(packed.shape[1], dtype=torch.int32, device=packed.device)
    valid = pos[None, :] < (long_lengths.to(torch.int32)[:, None] - (gram_size - 1))
    if g_total:
        # every valid window of an indexed term is in the distinct-gram
        # table by construction; the check only guards padding
        idx = torch.searchsorted(gram_ids32, packed).clamp(max=g_total - 1)
        hit = valid & (gram_ids32[idx] == packed)
        slots = torch.where(hit, idx, 2**30)
    else:
        slots = torch.full_like(packed, 2**30, dtype=torch.int64)
    return _finish_tg(slots, tl_pad, tgw)


def pack_sketch(tg, d_log2: int):
    """``tg`` (tl_pad, TGW) distinct gram slots -> the packed bucket
    incidence in its tile-major residency (tl_pad/4096, D, BLKB) int8, on
    ``tg``'s device.  Bytes equal ``to_tile_major`` of the reference's
    row-major packed build, padding included.

    Two distinct grams of one term may share a bucket, so each term's
    buckets are deduplicated before the scatter; every remaining (bucket,
    term) pair then owns a distinct bit, and adding int32 words (4 bytes
    each, viewed as bytes) equals a bitwise OR."""
    tl_pad = tg.shape[0]
    d = 1 << d_log2
    ntiles = tl_pad // TILE_LANES
    dev = tg.device
    words = torch.zeros((ntiles * d * BLKB) // 4, dtype=torch.int32, device=dev)
    for t0 in range(0, tl_pad, _PACK_TERMS):
        bk = torch.sort(bucket_of(tg[t0 : t0 + _PACK_TERMS], d_log2), dim=1).values
        keep = bk >= 0
        keep[:, 1:] &= bk[:, 1:] != bk[:, :-1]
        term = torch.arange(
            t0, t0 + bk.shape[0], dtype=torch.int64, device=dev
        )[:, None]
        byte, bit = plane_coords(term)
        flat = ((byte // BLKB) * d + bk.to(torch.int64)) * BLKB + byte % BLKB
        val = torch.bitwise_left_shift(torch.ones_like(flat), bit + 8 * (flat % 4))
        words.scatter_add_(
            0,
            torch.where(keep, flat // 4, 0).reshape(-1),
            torch.where(keep, val, 0).to(torch.int32).reshape(-1),
        )
        del bk, keep, term, byte, bit, flat, val
    return words.view(torch.int8).view(ntiles, d, BLKB)


def unpack_sketch(tg, d_log2: int):
    """``tg`` (tl_pad, TGW) distinct gram slots -> the unpacked bucket
    incidence, (D, tl_pad) int8 0/1 on ``tg``'s device: element (d, t) is
    1 iff a slot of term t hashes to bucket d (the reference's
    ``build_sketch_device`` output).  Stored column-major, as the
    transpose of a (tl_pad, D) tensor: ``torch._int_mm`` (cuBLASLt) runs
    its int8 tensor-core GEMM on a column-major right operand and a WMMA
    kernel about 4x slower on a row-major one (chip_smoke.py phase 22).
    Set in steps of _PACK_TERMS terms."""
    tl_pad = tg.shape[0]
    d = 1 << d_log2
    store = torch.zeros((tl_pad, d), dtype=torch.int8, device=tg.device)
    flat = store.view(-1)
    for t0 in range(0, tl_pad, _PACK_TERMS):
        bk = bucket_of(tg[t0 : t0 + _PACK_TERMS], d_log2).to(torch.int64)
        term = torch.arange(
            t0, t0 + bk.shape[0], dtype=torch.int64, device=tg.device
        )[:, None]
        flat.index_fill_(0, (term * d + bk)[bk >= 0], 1)
        del bk, term
    return store.t()


def build_sketch_device(long_tokens, long_lengths, gram_ids32, *,
                        gram_size: int, d_log2: int, tl_pad: int, tgw: int):
    """Unpacked sketch tables for the narrow g <= 3 case, built on the
    tokens' device: (inc (D, tl_pad) int8 0/1, tg (tl_pad, tgw) int32), as
    the reference's ``build_sketch_device``."""
    tg = _term_gram_slots(
        long_tokens, long_lengths, gram_ids32, gram_size=gram_size,
        tl_pad=tl_pad, tgw=tgw,
    )
    return unpack_sketch(tg, d_log2), tg


def build_sketch_device_packed(long_tokens, long_lengths, gram_ids32, *,
                               gram_size: int, d_log2: int, tl_pad: int,
                               tgw: int):
    """Packed sketch tables for the narrow g <= 3 case, built on the
    tokens' device: (inc (tl_pad/4096, D, BLKB) int8 tile-major, tg
    (tl_pad, tgw) int32).  ``tg`` rows are each term's DISTINCT gram slots
    ascending, -1 padded; padded terms have no incidence and never pass."""
    tg = _term_gram_slots(
        long_tokens, long_lengths, gram_ids32, gram_size=gram_size,
        tl_pad=tl_pad, tgw=tgw,
    )
    return pack_sketch(tg, d_log2), tg


def build_sketch_host(long_tokens: np.ndarray, long_lengths: np.ndarray,
                      lookup_gram_slots, gram_size: int, wide: bool, vocab,
                      d_log2: int, tl_pad: int, tgw: int, device,
                      packed: bool = True):
    """Sketch tables for wide strings / g = 4 (where the device pack of
    gram ids does not apply): ``tg`` from numpy gram ids, then the
    incidence on ``device``, packed tile-major (as
    build_sketch_device_packed) or unpacked (as build_sketch_device)."""
    gids, gvalid = gramlib.gram_ids(
        long_tokens, long_lengths, gram_size, wide, vocab
    )
    slots = lookup_gram_slots(gids.ravel()).reshape(gids.shape)
    slots = np.where(gvalid & (slots >= 0), slots, 2**30).astype(np.int64)
    tg = _finish_tg(torch.from_numpy(slots).to(device), tl_pad, tgw)
    return (pack_sketch(tg, d_log2) if packed else unpack_sketch(tg, d_log2)), tg


def pack_inc_np(inc: np.ndarray) -> np.ndarray:
    """Plain numpy packer: a (D, tl_pad) 0/1 incidence -> the plane-tiled
    row-major (D, tl_pad/8) int8 bytes (the reference's layout
    definition; ``to_tile_major`` of it equals ``pack_sketch``)."""
    d, tlp = inc.shape
    nt = tlp // TILE_LANES
    v = inc.reshape(d, nt, 8, BLKB).astype(np.uint16)
    byte = (v << np.arange(8, dtype=np.uint16)[None, None, :, None]).sum(axis=2)
    return byte.astype(np.uint8).view(np.int8).reshape(d, nt * BLKB)


# ---------------------------------------------------------------------------
# search front end
# ---------------------------------------------------------------------------


def _rescore_rows(tg_rows, qslots, nqg_f, threshold, row_valid):
    """Exact long-tier scores for gathered ``tg`` rows, batched.

    tg_rows (B, N, TGW) distinct gram slots (-1 pad); qslots (B, Qmax)
    query gram slots with multiplicity (-1 absent).  True hits = the number
    of query windows whose slot appears in the term's row (the reference's
    searchLong accumulation with the posting-set dedup folded into ``tg``),
    summed one query window at a time so no (B, N, TGW, Qmax) compare is
    ever whole."""
    present = tg_rows >= 0
    hits = torch.zeros(tg_rows.shape[:2], dtype=torch.int32, device=tg_rows.device)
    for j in range(qslots.shape[1]):
        hits += ((tg_rows == qslots[:, j, None, None]) & present).sum(2, dtype=torch.int32)
    s = hits.to(torch.float32) / nqg_f[:, None]
    p = row_valid & (hits > 0) & (s >= threshold)
    return s, p


def _sel_bound(vec, vmin, k: int):
    """Sound, tie-tight bound on the values a top-k selection dropped, per
    row: ``vmin`` (B,) is the k-th selected value.  When every value >= vmin
    was selected (count fits k), the dropped maximum is the largest value
    strictly below vmin; when ties straddle the cutoff it stays vmin."""
    n_ge = (vec >= vmin[:, None]).sum(1)
    nxt = torch.where(vec < vmin[:, None], vec, _NEG_INF).amax(1)
    return torch.where(n_ge <= k, nxt, vmin)


def unpacked_hits(qcnt, inc, vmax: int):
    """(B, D) int32 bucket counts, each at most ``vmax``, x (D, Tlp) int8
    0/1 incidence -> (B, Tlp) exact hit counts in the reference's
    ``cnt_dtype``: int8 when ``vmax`` <= 127, else int32.

    ``candidates.int_mm_counts`` (on the card one ``torch._int_mm`` per
    base-128 digit of the counts; the reference leaves this product to XLA
    outside any Pallas kernel) over column slabs of at most _MM_SLAB_BYTES
    of int32 product; a column-major ``inc`` (``unpack_sketch``'s) keeps
    each slab contiguous."""
    b, d = qcnt.shape
    tlp = inc.shape[1]
    out = torch.empty(
        (b, tlp), dtype=torch.int8 if vmax <= 127 else torch.int32,
        device=inc.device,
    )
    rows = max(-(-b // 8) * 8, 24) if inc.device.type == "cuda" else b + d
    cols = max(_TILE, _MM_SLAB_BYTES // (4 * rows) // _TILE * _TILE)
    for a in range(0, tlp, cols):
        out[:, a : a + cols] = int_mm_counts(qcnt, inc[:, a : a + cols], vmax)
    return out


def sketch_hits(qslots, inc, d_log2: int, packed: bool):
    """(B, Qmax) gram slots -> (B, Tlp) upper-bound hit counts over the
    sketch: the query's bucket multiplicities times the incidence, through
    K2 (packed; int8, Qmax <= 127) or ``unpacked_hits`` (int8 or int32 by
    Qmax, the reference's ``cnt_dtype``)."""
    qcnt = query_counts(bucket_of(qslots, d_log2), 1 << d_log2)
    if packed:
        return bitmap_hits(qcnt, inc)
    return unpacked_hits(qcnt, inc, int(qslots.shape[1]))


def _sketch_blockmax(hits, nqg, nqg_f, wmax_pad, thr):
    """(B, Tlp) int8 or int32 sketch hits -> (B, Tlp/128) float32 maxima of
    the score bound ``wmax * (hits / nqg)`` (float32 divide, then multiply,
    as the reference) over passing lanes (-inf elsewhere), computed a slab
    of lanes at a time."""
    b, tlp = hits.shape
    out = torch.empty((b, tlp // _BLK), dtype=torch.float32, device=hits.device)
    slab = max(_BLK, (_SLAB_BYTES // (4 * max(b, 1))) // _BLK * _BLK)
    live = (nqg > 0)[:, None]
    for a in range(0, tlp, slab):
        h = hits[:, a : a + slab]
        s = h.to(torch.float32) / nqg_f[:, None]
        u = torch.where(
            (h > 0) & live & (s >= thr), wmax_pad[a : a + slab] * s, _NEG_INF
        )
        out[:, a // _BLK : (a + h.shape[1]) // _BLK] = u.view(b, -1, _BLK).amax(2)
    return out


def candidates_sketch(
    di,
    inc,  # packed: (Tlp/4096, D, BLKB) int8 tile-major; else (D, Tlp) int8
    tg,  # (Tlp, TGW) int32 distinct gram slots per term
    wmax_pad,  # (Tlp,) float32 per-long-term max edge weight (0 padded)
    pt,  # (T, 4) int32 primary-edge records
    xt,  # (X, 4) int32 extra-edge records
    qtokens,  # (B, Qp) int32
    qlens,  # (B,) int32
    qslots,  # (B, Qmax) int32 gram slots, -1 absent, multiplicity kept
    n_qgrams,  # (B,) int32
    use_short,  # (B,) bool
    promo_ids,  # (B, PK) int32, -1 padded
    promo_terms,  # (B, PK, PE) int32 promo edge term ids, -1 padded
    promo_weights,  # (B, PK, PE) float32 promo edge weights
    limits,  # (B,) int32
    threshold,  # float32
    *,
    d_log2: int,
    compute_short: bool,
    n_cand: int,
    n_short_cand: int,
    ksb: int,
    kb: int,
    n_edge: int,
    top_k: int,
    packed: bool = True,
):
    """The reference's ``candidates_sketch_impl`` with its per-query body
    written out over the batch axis.  The packed form's bucket counts need
    every query to hold <= 127 gram windows (K2's contract), which the
    engine gates on the slot-matrix width; the unpacked form takes any
    width.  Returns _finish_selected's tuple."""
    ts, tl = di.n_short, di.n_long
    compute_short = compute_short and ts > 0
    b = qtokens.shape[0]
    tlp = tg.shape[0]
    nb = tlp // _BLK
    sb = nb // _SUPER
    thr = _f32(threshold)

    hits = sketch_hits(qslots, inc, d_log2, packed)  # (B, Tlp) upper bounds
    nqg = n_qgrams.to(torch.int32)
    nq_f = torch.clamp(nqg.to(torch.float32), min=1.0)
    blockmax = _sketch_blockmax(hits, nqg, nq_f, wmax_pad, thr)

    # -- hierarchical block selection over the long tier -------------------
    bm3 = blockmax.view(b, sb, _SUPER)
    sbmax = bm3.amax(2)
    sbv, sbi = topk_chunked(sbmax, ksb)
    sbi = sbi.clamp(0, sb - 1)
    sb_cov = (sbmax > _NEG_INF).sum(1) <= ksb
    u_sb = torch.where(sb_cov, _NEG_INF, _sel_bound(sbmax, sbv[:, -1], ksb))

    bm_g = bm3.gather(1, sbi[:, :, None].expand(-1, -1, _SUPER)).reshape(b, -1)
    bv, bloc = topk_chunked(bm_g, kb)
    bloc = bloc.clamp(0, bm_g.shape[1] - 1)
    blk = sbi.gather(1, bloc // _SUPER) * _SUPER + bloc % _SUPER  # global
    blk_cov = (bm_g > _NEG_INF).sum(1) <= kb
    u_blk = torch.where(blk_cov, _NEG_INF, _sel_bound(bm_g, bv[:, -1], kb))

    h_blk = hits.view(b, nb, _BLK).gather(1, blk[:, :, None].expand(-1, -1, _BLK))
    w_blk = wmax_pad.view(nb, _BLK)[blk]  # (B, kb, BLK)
    s_blk = h_blk.to(torch.float32) / nq_f[:, None, None]
    # blocks below the selection never contribute
    p_blk = (
        (h_blk > 0) & (nqg > 0)[:, None, None] & (s_blk >= thr)
        & (bv > _NEG_INF)[:, :, None]
    )
    u2 = torch.where(p_blk, w_blk * s_blk, _NEG_INF).reshape(b, -1)
    del h_blk, w_blk, s_blk, p_blk
    uv, li = topk_chunked(u2, n_cand)
    li = li.clamp(0, u2.shape[1] - 1)
    lane = blk.gather(1, li // _BLK) * _BLK + li % _BLK  # long-term local ids
    lane_cov = (u2 > _NEG_INF).sum(1) <= n_cand
    u_lane = torch.where(lane_cov, _NEG_INF, _sel_bound(u2, uv[:, -1], n_cand))
    del u2

    sel_sketch = uv > _NEG_INF
    u_c_long = torch.maximum(torch.maximum(u_sb, u_blk), u_lane)
    long_cov = sb_cov & blk_cov & lane_cov

    # -- exact rescoring of the selected lanes -----------------------------
    tg_rows = tg[lane.clamp(0, tlp - 1)]
    s_long, p_long = _rescore_rows(tg_rows, qslots, nq_f, thr, sel_sketch)
    t_long = ts + lane.clamp(0, max(tl - 1, 0))

    def long_score(p_t):
        flat = p_t.reshape(b, -1)
        rows = tg[(flat - ts).clamp(0, tlp - 1)]
        s, p = _rescore_rows(rows, qslots, nq_f, thr, flat >= ts)
        return s.view(p_t.shape), p.view(p_t.shape)

    # -- short tier: exact dense DP + its own top-k ------------------------
    if compute_short:
        qlen_f = torch.clamp(qlens.to(torch.float32), min=1.0)
        s_short, pass_short, u_short = _short_tier(
            di, qtokens, qlens, use_short, thr, qlen_f
        )
        usv, usel = topk_chunked(u_short, n_short_cand)
        usel = usel.clamp(0, ts - 1)
        s_cov = (u_short > _NEG_INF).sum(1) <= n_short_cand
        u_c_short = torch.where(
            s_cov, _NEG_INF, _sel_bound(u_short, usv[:, -1], n_short_cand)
        )
        t_sel = torch.cat([usel, t_long], 1)
        s_sel = torch.cat([s_short.gather(1, usel), s_long], 1)
        sel_valid = torch.cat([usv > _NEG_INF, p_long], 1)
        u_c = torch.maximum(u_c_long, u_c_short)
        covered = long_cov & s_cov

        def term_score(p_t):
            p_sh = p_t < ts
            idx = p_t.clamp(0, ts - 1).reshape(b, -1).long()
            p_ss = s_short.gather(1, idx).view(p_t.shape)
            p_ps = pass_short.gather(1, idx).view(p_t.shape)
            p_sl, p_pl = long_score(p_t)
            return torch.where(p_sh, p_ss, p_sl), torch.where(p_sh, p_ps, p_pl)
    else:
        t_sel, s_sel, sel_valid = t_long, s_long, p_long
        u_c, covered = u_c_long, long_cov
        term_score = long_score

    return _finish_selected(
        di, pt, xt, t_sel, s_sel, sel_valid, u_c, covered, term_score,
        (promo_ids, promo_terms, promo_weights), limits, threshold,
        n_edge=n_edge, top_k=top_k,
    )
