"""Candidate-sparse batched search: the bitmap-kernel front end with the
integer h* finish.

PyTorch counterpart of the parts of ``stringsearchlib_tpu.search.candidates``
that the main path runs.  Hit counts for the whole batch come from the K1
kernel (ops.bitmap_matmul.bitmap_hits_bmax) over the bit-packed incidence;
``_hstar_finish`` then selects candidates in integer hit space and the
shared back half ``_finish_selected`` expands edges, scores promotion keys,
ranks (score desc, key length asc) and sets the exactness guard.  Every
per-query ``jax.vmap`` body of the reference is written out here with an
explicit batch dimension.

Exactness guarantee (the host falls back to the dense path when it fails):
  * if every passing term was selected and no edge overflowed, scores,
    order and count are exact;
  * else let u_C bound every unselected term; if the limit-th ranked score
    strictly exceeds max(u_C, 0) and at least ``limit`` keys were reached,
    the returned top-limit list is exact and count = limit.

Ties: ``torch.topk`` promises no order among equal values, where
``lax.top_k`` prefers the lower index.  h* keeps every lane at or above its
level, so which equal lanes a top-k picks never changes an exact row's
top-limit list; only entries past ``limit`` (never returned) may differ.

Multi-key sorts are stable single-key sorts applied least-significant key
first.  Negated scores are canonicalized (+0.0 for -0.0) before sorting so
a zero score forms one tie class, as in the reference's float comparator.

Not ported yet (ROADMAP): the dense matmul, scan, gathered, blockmax,
dense-hits and runs front ends and finishes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import PERFECT_SCORE_CUTOFF, PROMOTED_SCORE
from .editdist import dp_match

_NEG_INF = float("-inf")

_BLK = 128  # selection block width

# chunked top-k width: each topk call stays at or under this many lanes
_TOPK_CHUNK = 1 << 15


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python scalar.  Torch casts a Python
    scalar to a float32 operand's dtype, so every score, bound and
    threshold stays float32 (a float64 operand would move ``s >=
    threshold`` at the edges) - and no device tensor is made from a host
    value, which would wait for the device's queue."""
    return float(np.float32(x))


def _stable_sort_by(keys):
    """Permutation sorting the last axis by ``keys`` = (k0, k1, ...), k0
    most significant: stable single-key sorts, least significant first."""
    order = None
    for k in reversed(keys):
        kk = k if order is None else k.gather(-1, order)
        o = torch.argsort(kk, dim=-1, stable=True)
        order = o if order is None else order.gather(-1, o)
    return order


def topk_chunked(u, k, chunk: int = _TOPK_CHUNK):
    """Exact top-k over the last axis via per-chunk top-k + merge.

    The union of per-chunk top-k sets contains the global top-k, so a second
    top-k over the merged candidates is exact.  Indices may point at padding
    when fewer than k real lanes exist; callers treat non-finite (or zero
    hit) selections as invalid."""
    n = u.shape[-1]
    if n <= chunk or k >= chunk:
        return torch.topk(u, k, dim=-1)
    nc = -(-n // chunk)
    lead = u.shape[:-1]
    if u.is_floating_point():
        neg = _NEG_INF
    else:
        neg = torch.iinfo(u.dtype).min
    pad = torch.full((*lead, nc * chunk - n), neg, dtype=u.dtype, device=u.device)
    uc = torch.cat([u, pad], dim=-1).view(*lead, nc, chunk)
    vals, idx = torch.topk(uc, k, dim=-1)
    gidx = idx + (torch.arange(nc, device=u.device) * chunk)[:, None]
    flat_v = vals.reshape(*lead, nc * k)
    flat_i = gidx.reshape(*lead, nc * k)
    v2, sel = torch.topk(flat_v, k, dim=-1)
    return v2, flat_i.gather(-1, sel)


def _finish_selected(
    di, pt, xt, t_sel, s_sel, sel_valid, u_c, covered, term_score,
    promo_pack, limits, threshold, *, n_edge, top_k,
):
    """Back half of every candidate front end, batched: from selected
    (term id, exact score, validity) per query plus selection bounds to the
    final ranked slice.

    ``t_sel``/``s_sel``/``sel_valid`` (B, C); ``u_c`` (B,) a sound bound on
    the weighted score of every unselected term (-inf when covered);
    ``covered`` (B,); ``term_score(p_t) -> (p_s, p_pass)`` evaluates the
    promotion keys' edge terms (B, PK, PE); ``promo_pack = (promo (B, PK),
    p_t (B, PK, PE), p_w (B, PK, PE))``.

    Returns (count (B,), keys (B, top_k), scores, key lengths, exact (B,)).
    """
    promo, p_t, p_w = promo_pack
    dev = t_sel.device
    b, n_cand = t_sel.shape
    ts, tl = di.n_short, di.n_long
    t_total = ts + tl
    k_total = di.key_len.shape[0]
    x_total = max(di.extra_key.shape[0], 1)
    cutoff = _f32(PERFECT_SCORE_CUTOFF)
    neg_inf = _NEG_INF

    # candidates sorted by term id (downstream order is irrelevant)
    t_key = torch.where(sel_valid, t_sel, t_total)
    t_sel, order = torch.sort(t_key, dim=1)
    s_sel = s_sel.gather(1, order)
    sel_valid = t_sel < t_total

    # -- primary edges: one 4-wide record gather per candidate ------------
    tg = t_sel.clamp(0, max(t_total - 1, 0)).long()
    prec = pt[tg]  # (B, C, 4): key, bitcast(weight), key_len, 0
    pk_e = torch.where(sel_valid, prec[..., 0], -1)
    pw_e = prec[..., 1].contiguous().view(torch.float32)
    pl_e = prec[..., 2]

    # -- extra edges (terms with >1 master key): CSR expansion ------------
    if di.extra_key.shape[0] > 0:
        xp = di.term_extra_ptr
        xlens = torch.where(sel_valid, xp[tg + 1] - xp[tg], 0).long()
        ends_x = xlens.cumsum(1)
        tot_x = ends_x[:, -1]
        overflow = tot_x > n_edge
        pos_x = torch.arange(n_edge, dtype=torch.int64, device=dev)
        rank_x = torch.searchsorted(
            ends_x, pos_x.expand(b, n_edge).contiguous(), right=True
        ).clamp(0, n_cand - 1)
        starts_x = ends_x - xlens
        x_idx = (
            xp[tg.gather(1, rank_x)].long()
            + (pos_x - starts_x.gather(1, rank_x))
        ).clamp(0, x_total - 1)
        xvalid = pos_x < torch.clamp(tot_x, max=n_edge)[:, None]
        xrec = xt[x_idx]
        xk_e = torch.where(xvalid, xrec[..., 0], -1)
        xw_e = xrec[..., 1].contiguous().view(torch.float32)
        xl_e = xrec[..., 2]
        xs_e = s_sel.gather(1, rank_x)
        k_e = torch.cat([pk_e, xk_e], 1)
        w_e = torch.cat([pw_e, xw_e], 1)
        s_e = torch.cat([s_sel, xs_e], 1)
        l_e = torch.cat([pl_e, xl_e], 1)
    else:  # no term maps to more than one key: primaries are everything
        overflow = torch.zeros(b, dtype=torch.bool, device=dev)
        k_e, w_e, s_e, l_e = pk_e, pw_e, s_sel, pl_e
    evalid = k_e >= 0
    # promo keys are scored exactly below; exclude them here
    is_promo = (k_e[:, :, None] == promo[:, None, :]).any(2)
    evalid = evalid & ~is_promo
    val_e = torch.where(evalid, w_e * s_e, neg_inf)

    # per-key max via a (key, -value) sort; key lengths ride along
    k_key = torch.where(evalid, k_e, k_total)
    order = _stable_sort_by((k_key, -val_e + 0.0))
    k_sorted = k_key.gather(1, order)
    v_sorted = val_e.gather(1, order)
    l_sorted = l_e.gather(1, order)
    kfirst = torch.ones_like(k_sorted, dtype=torch.bool)
    kfirst[:, 1:] = k_sorted[:, 1:] != k_sorted[:, :-1]
    cand_valid = kfirst & (k_sorted < k_total)
    cand_score = torch.clamp(v_sorted, min=0.0)  # entryScore 0 floor
    reached_cand = cand_valid.sum(1)

    # -- promotion keys: exact scoring from their pre-expanded edges ------
    p_c = promo.clamp(0, max(k_total - 1, 0))
    p_in = (p_t >= 0) & (promo >= 0)[:, :, None]
    p_s, p_pass_t = term_score(p_t.clamp_min(0))
    p_pass = p_in & p_pass_t
    p_val = torch.where(p_pass, p_w * p_s, neg_inf).amax(2)
    p_reached = p_pass.any(2)
    p_promoted = (p_pass & (p_s > cutoff)).any(2)
    p_score = torch.where(p_reached, torch.clamp(p_val, min=0.0), 0.0)
    p_score = torch.where(
        p_promoted & p_reached,
        torch.clamp(p_score, min=PROMOTED_SCORE), p_score,
    )
    reached_total = reached_cand + p_reached.sum(1)

    # -- final ranking: (score desc, key length asc, key id asc) ----------
    if k_total:
        p_len = di.key_len[p_c.long()]
    else:
        p_len = torch.zeros_like(p_c)
    f_key = torch.cat([k_sorted, p_c], 1)
    f_score = torch.cat([cand_score, p_score], 1)
    f_valid = torch.cat([cand_valid, p_reached], 1)
    f_len = torch.cat([l_sorted, p_len], 1)
    neg = torch.where(f_valid, -f_score, float("inf")) + 0.0
    f_len = torch.where(f_valid, f_len, 2**30)
    order = _stable_sort_by((neg, f_len, f_key))
    neg_sorted = neg.gather(1, order)
    out_len = f_len.gather(1, order)
    out_key = f_key.gather(1, order)
    out_score = f_score.gather(1, order)

    # -- exactness ---------------------------------------------------------
    lim_idx = (limits.long() - 1).clamp(0, neg.shape[1] - 1)
    sigma_l = -neg_sorted.gather(1, lim_idx[:, None])[:, 0]
    # the guard bound clamps to the entryScore floor (nGramSearch.hpp:326)
    exact = (~overflow) & (
        covered
        | ((reached_total >= limits) & (sigma_l > torch.clamp(u_c, min=0.0)))
    )
    count = torch.where(
        covered, reached_total, torch.minimum(reached_total, limits.long())
    ).to(torch.int32)
    return (
        count, out_key[:, :top_k], out_score[:, :top_k], out_len[:, :top_k],
        exact,
    )


def _short_tier(di, qtok, qlen, us, threshold, qlen_f):
    """Dense DP scores over the (small) short tier, (B, Ts)."""
    m_short = dp_match(di.short_tokens, di.short_lengths, qtok, qlen)
    s_short = m_short.to(torch.float32) / qlen_f[:, None]
    pass_short = us[:, None] & (s_short >= threshold)
    u_short = torch.where(
        pass_short, di.term_wmax[: di.n_short][None, :] * s_short, _NEG_INF
    )
    return s_short, pass_short, u_short


def _count_ge(x, vmax: int):
    """(B, N) integer levels -> (B, vmax) int32 counts of entries >= v for
    v = 1..vmax: one histogram (scatter-add, no host sync) and a suffix
    sum.  Equals the reference's compare-reduce over every level."""
    b = x.shape[0]
    lv = x.reshape(b, -1).clamp(0, vmax).long()
    lv = lv + (torch.arange(b, device=x.device) * (vmax + 1))[:, None]
    hist = torch.zeros(b * (vmax + 1), dtype=torch.int32, device=x.device)
    hist.scatter_add_(0, lv.reshape(-1), torch.ones_like(lv.reshape(-1), dtype=torch.int32))
    ge = hist.view(b, vmax + 1).flip(1).cumsum(1).flip(1)
    return ge[:, 1:].to(torch.int32)


def _first_true(mask, vmax: int):
    """1-based index of the first True per row, vmax + 1 when none."""
    first = torch.argmax(mask.to(torch.int32), dim=1).to(torch.int32) + 1
    return torch.where(mask.any(1), first, vmax + 1)


def _hstar_finish(
    di, pt, xt, hits, hmax, qtokens, qlens, n_qgrams, use_short, promo_ids,
    promo_terms, promo_weights, limits, threshold, *, compute_short,
    kb1, kb2, n_cand, n_edge, top_k, vmax, blk=_BLK, fill=2,
):
    """Integer hit-threshold (h*) selection over a huge hit matrix, batched.

    Requires every term->key weight == 1 (HostIndex.uniform_weights): a
    term's best key contribution is then exactly hits/n_qgrams, so
    selection and guard bounds live in integer hit space.

      1. exact counts cnt[v] = #128-lane blocks with block max >= v;
      2. h* = the smallest v >= max(ceil(threshold * nqg), 1) whose block
         counts fit the budgets; all blocks >= h* are kept, so every unkept
         term has hits <= h* - 1 and the guard bound is (h* - 1)/nqg;
      3. coarse-to-fine extraction: top-kb1 1024-lane maxima -> their 8
         sub-block maxima -> top-kb2 128-lane blocks -> a 32-lane fine level
         -> lane selection with its own integer level h_l.

    Levels are compared in int32 (the reference narrows them to int8, where
    a level of 128 wraps; such rows only escalate, and results agree).
    Returns _finish_selected's tuple.
    """
    dev = hits.device
    ts = di.n_short
    b, tlp = hits.shape
    nblk = tlp // blk
    c1 = 8  # coarse factor: 8 x 128 = 1024-lane level
    n1 = -(-nblk // c1)
    thr = _f32(threshold)
    neg_inf = _NEG_INF
    hm = hmax.to(torch.int32)
    if n1 * c1 != nblk:
        hm = torch.cat(
            [hm, torch.full((b, n1 * c1 - nblk), -1, dtype=torch.int32, device=dev)],
            dim=1,
        )
    nqg = n_qgrams.to(torch.int32)
    nqg_f = torch.clamp(nqg.to(torch.float32), min=1.0)
    floor_h = torch.ceil(thr * nqg_f - 1e-6).to(torch.int32).clamp(1, vmax)
    hm3 = hm.view(b, n1, c1)
    bm1 = hm3.amax(2)  # (b, n1)

    # -- exact block counts and h* (integer, per query) --------------------
    cnt128 = _count_ge(hm, vmax)
    cnt1 = _count_ge(bm1, vmax)
    fits = (cnt128 <= kb2) & (cnt1 <= kb1)  # monotone in v
    first_fit = _first_true(fits, vmax)
    any_fit = fits.any(1)
    fl_idx = (floor_h - 1).clamp(0, vmax - 1).long()[:, None]
    fits_floor = fits.gather(1, fl_idx)[:, 0]
    if fill > 0:
        want = limits.clamp_min(1).to(torch.int32)[:, None] * fill
        h_fill = (cnt128 >= want).sum(1).to(torch.int32)
    else:  # escalation retries maximize coverage instead
        h_fill = torch.zeros_like(floor_h)
    hstar = torch.where(
        fits_floor & (floor_h >= first_fit),
        floor_h,
        torch.where(
            any_fit,
            torch.maximum(floor_h, torch.maximum(first_fit, h_fill)),
            vmax + 1,
        ),
    )  # (b,)
    covered_blocks = fits_floor & (hstar <= floor_h)

    # -- coarse -> fine extraction ------------------------------------------
    h_lv = hstar[:, None]
    bv, bsel = torch.topk(bm1, min(kb1, n1), dim=1)  # (b, kb1)
    bvalid = bv >= h_lv
    sub = hm3.gather(1, bsel[:, :, None].expand(-1, -1, c1))  # (b, kb1, c1)
    sub = torch.where(bvalid[:, :, None], sub, -1)
    subid = bsel[:, :, None] * c1 + torch.arange(c1, device=dev)
    kb1_eff = sub.shape[1]
    fv, fs = torch.topk(
        sub.reshape(b, kb1_eff * c1), min(kb2, kb1_eff * c1), dim=1
    )
    fvalid = fv >= h_lv
    fid = subid.reshape(b, kb1_eff * c1).gather(1, fs).clamp(0, nblk - 1)

    h3 = hits.view(b, nblk, blk)
    hb = h3.gather(1, fid[:, :, None].expand(-1, -1, blk)).to(torch.int32)
    hb = torch.where(fvalid[:, :, None], hb, 0)  # (b, kb2, blk)
    kb2_eff = hb.shape[1]

    # -- 32-lane fine level (sub-block compaction) --------------------------
    sub_w = 32
    nsub = blk // sub_w
    kb3 = min(kb2, kb2_eff * nsub)
    nqg3 = nqg_f[:, None, None]
    pass_full = (hb > 0) & (nqg[:, None, None] > 0) & (
        hb.to(torch.float32) / nqg3 >= thr
    )
    n_pass_in = pass_full.sum((1, 2))
    u_sub = torch.full((b,), _NEG_INF, dtype=torch.float32, device=dev)
    if kb3 < kb2_eff * nsub:
        hb4 = hb.reshape(b, kb2_eff * nsub, sub_w)
        sm = hb4.amax(2)
        cnt32 = _count_ge(sm, vmax)
        fit32 = cnt32 <= kb3  # monotone in v
        first32 = _first_true(fit32, vmax)
        h32 = torch.maximum(first32, floor_h)
        cov32 = fit32.gather(1, fl_idx)[:, 0]
        sv, ss = torch.topk(sm, kb3, dim=1)  # all sub-blocks >= h32 selected
        svalid = sv >= h32[:, None]
        hb = torch.where(
            svalid[:, :, None],
            hb4.gather(1, ss[:, :, None].expand(-1, -1, sub_w)),
            0,
        )  # (b, kb3, sub_w)
        fid_g = fid.gather(1, ss // nsub)
        col2 = (
            (fid_g * blk + (ss % nsub) * sub_w)[:, :, None]
            + torch.arange(sub_w, device=dev)
        ).reshape(b, kb3 * sub_w)
        u_sub = torch.where(
            cov32, neg_inf, (h32.to(torch.float32) - 1.0) / nqg_f
        )
        lane_w = sub_w
        kb_lanes_eff = kb3
    else:
        col2 = (
            fid[:, :, None] * blk + torch.arange(blk, device=dev)
        ).reshape(b, kb2_eff * blk)
        cov32 = torch.ones(b, dtype=torch.bool, device=dev)
        lane_w = blk
        kb_lanes_eff = kb2_eff
    s2 = hb.to(torch.float32) / nqg3
    pass2 = (hb > 0) & (nqg[:, None, None] > 0) & (s2 >= thr)
    # passing hits, zero elsewhere: the integer lane-selection operand
    hbp = torch.where(pass2, hb, 0).reshape(b, kb_lanes_eff * lane_w)
    s2f = s2.reshape(b, kb_lanes_eff * lane_w)
    # lane-level integer threshold, same construction as h*
    cnt_l = _count_ge(hbp, vmax)
    lane_fit = cnt_l <= n_cand
    h_lane = _first_true(lane_fit, vmax)
    lanes_cov = cnt_l[:, 0] <= n_cand  # every passing lane selected
    u_blk = torch.where(
        covered_blocks, neg_inf, (hstar.to(torch.float32) - 1.0) / nqg_f
    )
    u_lane = torch.where(
        lanes_cov, neg_inf, (h_lane.to(torch.float32) - 1.0) / nqg_f
    )

    def s_at(col):  # exact long-tier scores at arbitrary columns (b, ...)
        h = hits.gather(
            1, col.clamp(0, tlp - 1).reshape(b, -1).long()
        ).view(col.shape).to(torch.float32)
        shape = (b,) + (1,) * (col.ndim - 1)
        s = h / nqg_f.view(shape)
        return s, (h > 0) & (nqg.view(shape) > 0) & (s >= thr)

    if compute_short:
        # short-tier DP scores are fractional: float selection over the
        # concatenated lane space
        qlen_f = torch.clamp(qlens.to(torch.float32), min=1.0)
        s_short, pass_short, u_short = _short_tier(
            di, qtokens, qlens, use_short, thr, qlen_f
        )
        u2r = torch.where(
            hbp > 0, hbp.to(torch.float32) / nqg_f[:, None], neg_inf
        )
        u_cat = torch.cat([u_short, u2r], 1)
        s_cat = torch.cat([s_short, s2f], 1)
        gid_cat = torch.cat(
            [
                torch.arange(ts, device=dev).expand(b, ts),
                ts + col2,
            ],
            1,
        )
        npi = n_pass_in + pass_short.sum(1)

        def term_score(p_t):
            p_sh = p_t < ts
            idx = p_t.clamp(0, max(ts - 1, 0)).reshape(b, -1).long()
            if ts:
                p_ss = s_short.gather(1, idx).view(p_t.shape)
                p_ps = pass_short.gather(1, idx).view(p_t.shape)
            else:
                p_ss = torch.zeros(p_t.shape, dtype=torch.float32, device=dev)
                p_ps = torch.zeros(p_t.shape, dtype=torch.bool, device=dev)
            p_sl, p_okl = s_at(p_t - ts)
            return torch.where(p_sh, p_ss, p_sl), torch.where(p_sh, p_ps, p_okl)

        ub, ls = topk_chunked(u_cat, min(n_cand, u_cat.shape[1]))
        sel_valid = ub > neg_inf
        lsc = ls.clamp(0, gid_cat.shape[1] - 1)
        t_sel = gid_cat.gather(1, lsc)
        s_sel = s_cat.gather(1, lsc)
        sel_cov = npi <= ub.shape[1]
        u_c = torch.maximum(
            torch.maximum(torch.where(sel_cov, neg_inf, ub[:, -1]), u_blk),
            u_sub,
        )
        covered = covered_blocks & sel_cov & cov32
    else:
        def term_score(p_t):
            s, ok = s_at(p_t - ts)
            return s, (p_t >= ts) & ok

        hv, ls = topk_chunked(hbp, min(n_cand, hbp.shape[1]))
        sel_valid = hv > 0
        lsc = ls.clamp(0, col2.shape[1] - 1)
        t_sel = ts + col2.gather(1, lsc)
        s_sel = hv.to(torch.float32) / nqg_f[:, None]
        u_c = torch.maximum(torch.maximum(u_lane, u_blk), u_sub)
        covered = covered_blocks & lanes_cov & cov32
    return _finish_selected(
        di, pt, xt, t_sel, s_sel, sel_valid, u_c, covered, term_score,
        (promo_ids, promo_terms, promo_weights), limits, threshold,
        n_edge=n_edge, top_k=top_k,
    )


def query_counts(qslots, gp: int):
    """(B, Qmax) gram slots (-1 absent, duplicates kept) -> (B, gp) int32
    multiplicities, built on the device from the small slot matrix."""
    b = qslots.shape[0]
    idx = torch.where(qslots >= 0, qslots, gp).long()
    qcnt = torch.zeros((b, gp + 1), dtype=torch.int32, device=qslots.device)
    qcnt.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    return qcnt[:, :gp]


def candidates_bitmap_mxu(
    di,
    bitmap,  # (ntiles, G_pad, BLKB) int8 tile-major packed incidence
    pt,  # (T, 4) int32 primary-edge records (HostIndex.prim_tables)
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
    compute_short: bool,
    n_cand: int,
    n_edge: int,
    top_k: int,
    kb1: int = 512,
    kb2: int = 512,
    hs_fill: int = 2,
    keep_hits: bool = False,
):
    """Exact hit counts via K1 over the packed incidence, then the h*
    finish (the reference's candidates_bitmap_mxu with ``hstar=True``).
    Counts are exact while every query holds <= 127 gram windows, which the
    engine gates on the slot-matrix width.  With ``keep_hits`` the hits and
    block maxima come back too, for the selection-only retry."""
    from ..ops.bitmap_matmul import bitmap_hits_bmax

    compute_short = compute_short and di.n_short > 0
    gp = bitmap.shape[1]
    qcnt = query_counts(qslots, gp)
    hits, hmax = bitmap_hits_bmax(qcnt, bitmap)
    res = _hstar_finish(
        di, pt, xt, hits, hmax, qtokens, qlens, n_qgrams, use_short,
        promo_ids, promo_terms, promo_weights, limits, threshold,
        compute_short=compute_short, kb1=kb1, kb2=kb2, n_cand=n_cand,
        n_edge=n_edge, top_k=top_k, vmax=int(qslots.shape[1]), blk=_BLK,
        fill=hs_fill,
    )
    if keep_hits:
        return res + (hits, hmax)
    return res


def hstar_retry(
    di,
    hits,  # (Br, Tl_pad) int8 rows taken from a retained kernel output
    hmax,  # (Br, Tl_pad/128) int8 block maxima rows for the same queries
    pt,
    xt,
    qtokens,
    qlens,
    n_qgrams,
    use_short,
    promo_ids,
    promo_terms,
    promo_weights,
    limits,
    threshold,
    *,
    compute_short: bool,
    kb1: int,
    kb2: int,
    n_cand: int,
    top_k: int,
    n_edge: int,
    vmax: int,
):
    """Selection-only escalation for guard-failed h* rows: _hstar_finish
    again at wider budgets on the retained hit counts (bit-identical to a
    full second pass's), with no second table stream."""
    compute_short = compute_short and di.n_short > 0
    return _hstar_finish(
        di, pt, xt, hits, hmax, qtokens, qlens, n_qgrams, use_short,
        promo_ids, promo_terms, promo_weights, limits, threshold,
        compute_short=compute_short, kb1=kb1, kb2=kb2, n_cand=n_cand,
        n_edge=n_edge, top_k=top_k, vmax=vmax, blk=_BLK, fill=0,
    )
