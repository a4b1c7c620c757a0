"""Candidate-sparse batched search: the gram-matrix, sorted-runs and bitmap
front ends (full-table and gathered-row) with their finishes.

PyTorch counterpart of ``stringsearchlib_tpu.search.candidates``.  Hit
counts for the whole batch come from one of:

  * ``candidates_matmul``: one product of the query gram multiplicities
    with the dense (G, Tl) int8 incidence (``gram_hits``; ``torch._int_mm``
    on the card, as the reference leaves its dot to XLA);
  * ``candidates_runs``: each query's own postings expanded by kernel K6
    (ops.vgather), sorted into runs whose lengths are the hit counts;
  * K1 (ops.bitmap_matmul.bitmap_hits_bmax, hits and 128-term block
    maxima) or K2 (bitmap_hits, hits only) over the bit-packed incidence -
    the resident table, or on the gathered route
    (``candidates_bitmap_gather``) the batch's own gram rows copied out of it
    by the gather kernel.

One of four finishes then selects candidates:

  * ``_hstar_finish``: integer hit-threshold selection (uniform weights);
  * ``_blockmax_finish``: block upper bounds from the int8 block maxima and
    a per-block weight maximum, then exact rescoring of the kept blocks
    (huge lane spaces, any weights);
  * ``_dense_hits_finish``: per-lane bounds over the whole hit matrix and
    ``_select_candidates`` (small lane spaces, any weights);
  * the runs route's own lanes through ``_finish_candidates``;

and the shared back half ``_finish_selected`` expands edges, scores
promotion keys, ranks (score desc, key length asc) and sets the exactness
guard.  The short tier's DP scores come from kernel K5 (ops.dp_match).
Every per-query ``jax.vmap`` body of the reference is written out here with
an explicit batch dimension.

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
The float selections of the other finishes may keep other equal lanes than
the reference where a tie straddles a cutoff: the guard bound is the same
value either way, and only such rows may differ in exact flag or count.

Multi-key sorts are stable single-key sorts applied least-significant key
first.  Negated scores are canonicalized (+0.0 for -0.0) before sorting so
a zero score forms one tie class, as in the reference's float comparator.

Not ported (ROADMAP): the bitmap scan front end; ``topk_guarded``'s
approximate mode (selection is exact, so no row ever misses);
``BLOCKMAX_IMPL`` (``block_hmax`` is one reduction); the gathered route's
8-dot XLA branch (the reference's CPU and ``gc % 32`` fallback: Gc is a
power of two >= 32, and on CPU K1's plain version runs on the compact
table).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import PERFECT_SCORE_CUTOFF, PROMOTED_SCORE
from ..ops.vgather import expand_postings
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
    promo_pack, limits, threshold, *, n_edge, top_k, with_bound=False,
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
    ``with_bound`` (the cross-shard merge of parallel.dist) returns
    (reached total (B,), keys, scores, key lengths, bound (B,)) instead:
    ``bound`` is a sound upper bound on the local contribution of any key
    not in the returned slice - max(u_c, 0) for unselected terms unless
    selection covered every passer, the top_k-th score when the slice
    truncates, +inf on extra-edge overflow.
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

    if with_bound:
        tau = torch.where(
            reached_total > top_k, out_score[:, top_k - 1], neg_inf
        )
        miss = torch.where(covered, neg_inf, torch.clamp(u_c, min=0.0))
        bound = torch.where(overflow, float("inf"), torch.maximum(miss, tau))
        return (
            reached_total, out_key[:, :top_k], out_score[:, :top_k],
            out_len[:, :top_k], bound,
        )

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


def block_hmax(hits, nblk: int, blk: int):
    """(B, nblk*blk) int hits -> (B, nblk) per-contiguous-blk-lane max."""
    return hits.view(hits.shape[0], nblk, blk).amax(2)


def _tight_bound(vals2d, vmin, k: int):
    """Sound, tie-tight bound on what a per-row top-k of ``vals2d`` dropped.

    ``vmin`` (b,) is each row's k-th selected value.  Where every value
    >= vmin was selected (count fits k), the dropped maximum is the largest
    value strictly below vmin; where ties straddle the cutoff the bound
    stays vmin (the guard escalates those rows)."""
    n_ge = (vals2d >= vmin[:, None]).sum(1)
    nxt = torch.where(vals2d < vmin[:, None], vals2d, _NEG_INF).amax(1)
    return torch.where(n_ge <= k, nxt, vmin)


def _select_candidates(u_all, n_pass, *, n_cand: int, block_sel: bool):
    """Top-``n_cand`` lanes of ``u_all`` (B, N) by upper bound, batched.

    Returns ``(ub, sel, u_c, covered)``: selected bounds and lane indices
    (B, n_cand), ``u_c`` (B,) a sound upper bound on every unselected lane
    (-inf when none passes outside the selection), ``covered`` (B,) every
    passing lane was selected.

    ``block_sel`` prunes in two exact phases: per-128-lane block maxima ->
    top-``n_cand`` blocks -> top-k over the surviving ``n_cand * 128``
    lanes; unkept blocks are bounded by the n_cand-th block maximum, which
    joins the guard bound.  Selection is exact (the reference's approximate
    mode is not ported), so no row misses."""
    neg_inf = _NEG_INF
    b = u_all.shape[0]
    if not block_sel:
        ub, sel = topk_chunked(u_all, n_cand)
        u_c = torch.where(n_pass > n_cand, ub[:, -1], neg_inf)
        return ub, sel, u_c, n_pass <= n_cand

    n = u_all.shape[1]
    nb = -(-n // _BLK)
    up = u_all
    if nb * _BLK != n:
        up = torch.cat(
            [u_all, torch.full((b, nb * _BLK - n), neg_inf,
                               dtype=u_all.dtype, device=u_all.device)], 1,
        )
    up = up.view(b, nb, _BLK)
    bmax = up.amax(2)
    kb = min(n_cand, nb)
    bvals, bsel = topk_chunked(bmax, kb)
    u2 = up.gather(
        1, bsel.clamp(0, nb - 1)[:, :, None].expand(-1, -1, _BLK)
    )
    # a kept entry with value -inf can be a clamped pad index (chunked
    # top-k pads its lane space) whose gather read a real block's lanes;
    # mask those lanes so a term is never selected under a foreign id
    u2 = torch.where((bvals > neg_inf)[:, :, None], u2, neg_inf).reshape(
        b, kb * _BLK
    )
    ub, ls = topk_chunked(u2, min(n_cand, u2.shape[1]))
    sel = bsel.gather(1, (ls // _BLK).clamp(0, kb - 1)) * _BLK + ls % _BLK

    blocks_cov = (bmax > neg_inf).sum(1) <= kb
    sel_cov = (u2 > neg_inf).sum(1) <= n_cand
    u_b = torch.where(blocks_cov, neg_inf, bvals[:, -1])
    u_c = torch.maximum(torch.where(sel_cov, neg_inf, ub[:, -1]), u_b)
    return ub, sel, u_c, blocks_cov & sel_cov


def _finish_candidates(
    di, pt, xt, u_all, s_all, gid_all, n_pass, term_score, promo_pack,
    limits, threshold, *, n_cand, n_edge, top_k, block_sel=False,
    with_bound=False,
):
    """From per-lane upper bounds and scores (B, N) and the lanes' global
    term ids ``gid_all`` ((N,), or (B, N) where each query's lanes hold its
    own terms) to the final ranked slice (passing lanes carry u = wmax * s,
    others -inf)."""
    ub, sel, u_c, covered = _select_candidates(
        u_all, n_pass, n_cand=n_cand, block_sel=block_sel
    )
    sel_valid = ub > _NEG_INF
    sel_c = sel.clamp(0, gid_all.shape[-1] - 1)
    t_sel = gid_all.gather(1, sel_c) if gid_all.ndim == 2 else gid_all[sel_c]
    return _finish_selected(
        di, pt, xt, t_sel, s_all.gather(1, sel_c), sel_valid, u_c,
        covered, term_score, promo_pack, limits, threshold, n_edge=n_edge,
        top_k=top_k, with_bound=with_bound,
    )


def _short_terms(di, qtokens, qlens, use_short, thr):
    """The short tier's scores, pass flags and bounds, each (B, Ts)."""
    qlen_f = torch.clamp(qlens.to(torch.float32), min=1.0)
    return _short_tier(di, qtokens, qlens, use_short, thr, qlen_f)


def _term_scorer(hits, n_qgrams, thr, ts, short=None):
    """``term_score(p_t) -> (score, pass)`` at arbitrary global term ids
    (B, ...), as the promotion keys' edges need them: long-tier terms scored
    exactly from ``hits`` (B, Tl_pad), short-tier terms read from ``short =
    (s_short, pass_short)`` (B, Ts) where the short tier was scored, and
    never passing where it was not."""
    b, tlp = hits.shape
    nqg = n_qgrams.to(torch.int32)
    nqg_f = torch.clamp(nqg.to(torch.float32), min=1.0)

    def term_score(p_t):
        shape = (b,) + (1,) * (p_t.ndim - 1)
        h = hits.gather(
            1, (p_t - ts).clamp(0, tlp - 1).reshape(b, -1).long()
        ).view(p_t.shape).to(torch.float32)
        s = h / nqg_f.view(shape)
        ok = (h > 0) & (nqg.view(shape) > 0) & (s >= thr)
        if short is None or not ts:
            return s, (p_t >= ts) & ok
        idx = p_t.clamp(0, ts - 1).reshape(b, -1).long()
        p_sh = p_t < ts
        return (
            torch.where(p_sh, short[0].gather(1, idx).view(p_t.shape), s),
            torch.where(p_sh, short[1].gather(1, idx).view(p_t.shape), ok),
        )

    return term_score


def _dense_hits_finish(
    di, pt, xt, hits, qtokens, qlens, n_qgrams, use_short, promo_ids,
    promo_terms, promo_weights, limits, threshold, *, compute_short,
    n_cand, n_edge, top_k, block_sel, with_bound=False,
):
    """Back half for front ends that produce a dense (B, Tl_pad) exact hit
    matrix: per-lane scores and bounds over the whole lane space,
    ``_select_candidates``, then the shared back half.  ``hits`` may be any
    integer or float dtype; columns beyond di.n_long are padding (wmax 0,
    primary key -1) and never reach a key."""
    ts, tl = di.n_short, di.n_long
    tlp = hits.shape[1]
    dev = hits.device
    thr = _f32(threshold)
    h = hits.to(torch.float32)
    nqg = n_qgrams.to(torch.int32)
    nqg_f = torch.clamp(nqg.to(torch.float32), min=1.0)
    s_long = h / nqg_f[:, None]
    pass_long = (h > 0) & (nqg[:, None] > 0) & (s_long >= thr)
    del h
    n_pass = pass_long.sum(1)
    wmax_long = di.term_wmax[ts:]
    if tlp > tl:
        wmax_long = torch.cat([
            wmax_long, torch.zeros(tlp - tl, dtype=wmax_long.dtype, device=dev)
        ])
    u_long = torch.where(pass_long, wmax_long[None, :] * s_long, _NEG_INF)
    del pass_long
    gid_long = ts + torch.clamp(torch.arange(tlp, device=dev), max=max(tl - 1, 0))
    short = None
    if compute_short:
        s_short, pass_short, u_short = _short_terms(
            di, qtokens, qlens, use_short, thr
        )
        short = (s_short, pass_short)
        n_pass = n_pass + pass_short.sum(1)
        u_all = torch.cat([u_short, u_long], 1)
        s_all = torch.cat([s_short, s_long], 1)
        gid_all = torch.cat([torch.arange(ts, device=dev), gid_long])
    else:
        u_all, s_all, gid_all = u_long, s_long, gid_long
    term_score = _term_scorer(hits, n_qgrams, thr, ts, short)
    return _finish_candidates(
        di, pt, xt, u_all, s_all, gid_all, n_pass, term_score,
        (promo_ids, promo_terms, promo_weights), limits, threshold,
        n_cand=n_cand, n_edge=n_edge, top_k=top_k, block_sel=block_sel,
        with_bound=with_bound,
    )


def _blockmax_finish(
    di, pt, xt, hits, qtokens, qlens, n_qgrams, use_short, promo_ids,
    promo_terms, promo_weights, limits, threshold, *, compute_short,
    n_cand, n_edge, top_k, hmax=None, blk=_BLK, kb_lanes=0,
):
    """Back half for huge dense hit matrices: no (B, Tl) float32 tensor.

    An int8 block maximum of the hits (``hmax``, fused into K1 or taken by
    ``block_hmax``) and a per-block weight maximum give an upper bound on
    each block's best u = wmax * hits/n_qgrams (negative-weight blocks are
    bounded by wblk * threshold: u is then largest at the smallest passing
    score).  Blocks are selected by that bound, their lanes gathered as
    contiguous ``blk``-lane rows and rescored exactly, and only those
    kb * blk lanes pay float32 math and the lane top-k.  ``kb_lanes`` > 0
    fixes the kept-lane budget instead of n_cand blocks.  Guard bounds are
    tie-tight (``_tight_bound``) at both levels."""
    ts, tl = di.n_short, di.n_long
    b, tlp = hits.shape
    dev = hits.device
    neg_inf = _NEG_INF
    thr = _f32(threshold)
    nblk = tlp // blk
    nqg = n_qgrams.to(torch.int32)
    nqg_f = torch.clamp(nqg.to(torch.float32), min=1.0)
    wpad = di.term_wmax[ts:]
    if tlp > tl:
        wpad = torch.cat([wpad, torch.zeros(tlp - tl, dtype=wpad.dtype, device=dev)])
    wpad2 = wpad.view(nblk, blk)
    h3 = hits.view(b, nblk, blk)
    if hmax is None:  # not fused into the hits kernel
        hmax = block_hmax(hits, nblk, blk)
    smax = hmax.to(torch.float32) / nqg_f[:, None]
    wblk = wpad2.amax(1)  # (nblk,)
    nonempty = (hmax > 0) & (nqg[:, None] > 0) & (smax >= thr)
    ub_blk = torch.where(wblk[None, :] >= 0, wblk[None, :] * smax, wblk[None, :] * thr)
    bmax = torch.where(nonempty, ub_blk, neg_inf)  # (b, nblk) upper bounds
    del smax, nonempty, ub_blk
    kb = min(max(kb_lanes // blk, 16) if kb_lanes else n_cand, nblk)
    blocks_cov = (bmax > neg_inf).sum(1) <= kb
    bvals, bsel = topk_chunked(bmax, kb)
    u_b = torch.where(blocks_cov, neg_inf, _tight_bound(bmax, bvals[:, -1], kb))
    del bmax
    bsel_c = bsel.clamp(0, nblk - 1)
    hb = h3.gather(1, bsel_c[:, :, None].expand(-1, -1, blk))  # (b, kb, blk)
    s2 = hb.to(torch.float32) / nqg_f[:, None, None]
    # lanes of invalid kept blocks are masked: a clamped pad index reads a
    # real block's lanes, which must never be selected under its id
    pass2 = (
        (hb > 0) & (nqg[:, None, None] > 0) & (s2 >= thr)
        & (bvals > neg_inf)[:, :, None]
    )
    del hb
    u2 = torch.where(pass2, wpad2[bsel_c] * s2, neg_inf).reshape(b, kb * blk)
    del pass2
    s2f = s2.reshape(b, kb * blk)
    col2 = (bsel_c[:, :, None] * blk + torch.arange(blk, device=dev)).reshape(
        b, kb * blk
    )

    short = None
    if compute_short:
        s_short, pass_short, u_short = _short_terms(
            di, qtokens, qlens, use_short, thr
        )
        short = (s_short, pass_short)
        u_cat = torch.cat([u_short, u2], 1)
        s_cat = torch.cat([s_short, s2f], 1)
        gid_cat = torch.cat(
            [torch.arange(ts, device=dev).expand(b, ts), ts + col2], 1
        )
    else:
        u_cat, s_cat, gid_cat = u2, s2f, ts + col2
    term_score = _term_scorer(hits, n_qgrams, thr, ts, short)
    ub, ls = topk_chunked(u_cat, min(n_cand, u_cat.shape[1]))
    sel_valid = ub > neg_inf
    lsc = ls.clamp(0, gid_cat.shape[1] - 1)
    t_sel = gid_cat.gather(1, lsc)
    s_sel = s_cat.gather(1, lsc)
    sel_cov = (u_cat > neg_inf).sum(1) <= ub.shape[1]
    lane_bound = _tight_bound(u_cat, ub[:, -1], ub.shape[1])
    u_c = torch.maximum(torch.where(sel_cov, neg_inf, lane_bound), u_b)
    covered = blocks_cov & sel_cov
    return _finish_selected(
        di, pt, xt, t_sel, s_sel, sel_valid, u_c, covered, term_score,
        (promo_ids, promo_terms, promo_weights), limits, threshold,
        n_edge=n_edge, top_k=top_k,
    )


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
    kb1, kb2, n_cand, n_edge, top_k, vmax, blk=_BLK, fill=2, with_bound=False,
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

    short = None
    if compute_short:
        # short-tier DP scores are fractional: float selection over the
        # concatenated lane space
        s_short, pass_short, u_short = _short_terms(
            di, qtokens, qlens, use_short, thr
        )
        short = (s_short, pass_short)
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
        hv, ls = topk_chunked(hbp, min(n_cand, hbp.shape[1]))
        sel_valid = hv > 0
        lsc = ls.clamp(0, col2.shape[1] - 1)
        t_sel = ts + col2.gather(1, lsc)
        s_sel = hv.to(torch.float32) / nqg_f[:, None]
        u_c = torch.maximum(torch.maximum(u_lane, u_blk), u_sub)
        covered = covered_blocks & lanes_cov & cov32
    return _finish_selected(
        di, pt, xt, t_sel, s_sel, sel_valid, u_c, covered,
        _term_scorer(hits, n_qgrams, thr, ts, short),
        (promo_ids, promo_terms, promo_weights), limits, threshold,
        n_edge=n_edge, top_k=top_k, with_bound=with_bound,
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
    block_sel: bool = False,
    fused_bmax: bool = False,
    bmax_blk: int = _BLK,
    kb_lanes: int = 0,
    hstar: bool = False,
    kb1: int = 512,
    kb2: int = 512,
    hs_fill: int = 2,
    keep_hits: bool = False,
):
    """Exact hit counts via K1 or K2 over the packed incidence, then one of
    three finishes, as the reference's candidates_bitmap_mxu:

      * ``hstar`` (uniform weights): K1, the h* finish; with ``keep_hits``
        the hits and block maxima come back too, for the selection-only
        retry;
      * ``block_sel``: ``_blockmax_finish`` on K1's block maxima
        (``fused_bmax``, 128-term blocks) or on K2's hits and
        ``block_hmax`` at ``bmax_blk``;
      * otherwise K2 and ``_dense_hits_finish``.

    Counts are exact while every query holds <= 127 gram windows, which the
    engine gates on the slot-matrix width."""
    from ..ops.bitmap_matmul import bitmap_hits, bitmap_hits_bmax

    compute_short = compute_short and di.n_short > 0
    qcnt = query_counts(qslots, bitmap.shape[1])
    kw = dict(compute_short=compute_short, n_cand=n_cand, n_edge=n_edge,
              top_k=top_k)
    args = (qtokens, qlens, n_qgrams, use_short, promo_ids, promo_terms,
            promo_weights, limits, threshold)
    if hstar:
        hits, hmax = bitmap_hits_bmax(qcnt, bitmap)
        res = _hstar_finish(
            di, pt, xt, hits, hmax, *args, kb1=kb1, kb2=kb2,
            vmax=int(qslots.shape[1]), blk=_BLK, fill=hs_fill, **kw,
        )
        if keep_hits:
            return res + (hits, hmax)
        return res
    if block_sel:
        if fused_bmax:
            hits, hmax = bitmap_hits_bmax(qcnt, bitmap)
            blk = _BLK
        else:
            hits, hmax, blk = bitmap_hits(qcnt, bitmap), None, bmax_blk
        return _blockmax_finish(
            di, pt, xt, hits, *args, hmax=hmax, blk=blk, kb_lanes=kb_lanes,
            **kw,
        )
    return _dense_hits_finish(
        di, pt, xt, bitmap_hits(qcnt, bitmap), *args, block_sel=False, **kw
    )


def candidates_bitmap_gather(
    di,
    bitmap,  # (ntiles, G_pad, BLKB) int8 tile-major packed incidence (full)
    rows,  # (Gc,) int32 the batch's gram-union table rows (padded)
    pt,
    xt,
    qtokens,
    qlens,
    qslots,  # (B, Qmax) int32 slots remapped into [0, Gc), -1 absent
    n_qgrams,
    use_short,
    promo_ids,
    promo_terms,
    promo_weights,
    limits,
    threshold,
    *,
    compute_short: bool,
    n_cand: int,
    n_edge: int,
    top_k: int,
    block_sel: bool = False,
    hstar: bool = False,
    kb1: int = 512,
    kb2: int = 512,
    hs_fill: int = 2,
):
    """Small-batch bitmap front end: hits from the batch's own gram rows.

    The gather kernel (ops.bitmap_matmul.gather_rows) copies the Gc union
    rows out of every layout tile of the resident table into a compact
    (ntiles, Gc, BLKB) table, K1 counts hits and block maxima on it (Gc is a
    power of two >= 32, K1's Gp rule), and the h*, blockmax or dense-hits
    finish follows as on the full-table route: the compact table's columns
    are the full table's, in the same term order.  The reference's 8-dot
    XLA branch (its CPU and ``gc % 32`` fallback) is not needed: on CPU,
    K1's plain version runs on the compact table."""
    from ..ops.bitmap_matmul import bitmap_hits_bmax, gather_rows

    compute_short = compute_short and di.n_short > 0
    compact = gather_rows(bitmap, rows)
    hits, hmax = bitmap_hits_bmax(query_counts(qslots, rows.shape[0]), compact)
    del compact
    kw = dict(compute_short=compute_short, n_cand=n_cand, n_edge=n_edge,
              top_k=top_k)
    args = (qtokens, qlens, n_qgrams, use_short, promo_ids, promo_terms,
            promo_weights, limits, threshold)
    if hstar:
        return _hstar_finish(
            di, pt, xt, hits, hmax, *args, kb1=kb1, kb2=kb2,
            vmax=int(qslots.shape[1]), blk=_BLK, fill=hs_fill, **kw,
        )
    if block_sel:
        return _blockmax_finish(di, pt, xt, hits, *args, hmax=hmax, blk=_BLK, **kw)
    return _dense_hits_finish(di, pt, xt, hits, *args, block_sel=False, **kw)


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


# ---------------------------------------------------------------------------
# the gram-matrix front end (gram-dense corpora)
# ---------------------------------------------------------------------------


# torch._int_mm calls issued by int_mm_counts (a library product, counted
# so a run can show a route went through it)
INT_MM_CALLS = 0


def int_mm_counts(qcnt, mat, vmax: int):
    """(B, K) int32 multiplicities, each at most ``vmax``, x (K, N) int8
    0/1 matrix -> (B, N) int32 counts, exact.

    On the card one ``torch._int_mm`` (int8 x int8 -> int32) per base-128
    digit of the multiplicities: one for ``vmax`` <= 127 (the reference's
    int8 dot), two up to 16383 (its int32 dot).  Rows pad to a multiple of
    8 past 16, as ``_int_mm`` requires; K and N must be multiples of 8.
    On the CPU one int32 product."""
    global INT_MM_CALLS
    if mat.device.type == "cpu":
        return qcnt @ mat.to(torch.int32)
    b, k = qcnt.shape
    bp = max(-(-b // 8) * 8, 24)
    if bp != b:
        qcnt = torch.cat([qcnt, qcnt.new_zeros((bp - b, k))], 0)
    hits = None
    scale, rest = 1, vmax
    while True:
        digit = (qcnt // scale) % 128
        h = torch._int_mm(digit.to(torch.int8), mat)
        INT_MM_CALLS += 1
        hits = h if hits is None else hits.add_(h, alpha=scale)
        rest //= 128
        if rest == 0:
            break
        scale *= 128
    return hits[:b]


def gram_hits(qslots, gram_matrix):
    """(B, Qmax) gram slots x (Gp, Tlp) int8 0/1 incidence -> (B, Tlp)
    int32 hit counts, exact (``int_mm_counts``: a gram's multiplicity is
    at most Qmax).  The matrix's Gp and Tlp are multiples of 8
    (HostIndex.gram_matrix)."""
    qcnt = query_counts(qslots, gram_matrix.shape[0])
    return int_mm_counts(qcnt, gram_matrix, int(qslots.shape[1]))


def candidates_matmul(
    di,
    gram_matrix,  # (Gp, Tlp) int8 0/1 incidence (HostIndex.gram_matrix)
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
    block_sel: bool = False,
    hstar: bool = False,
    kb1: int = 512,
    kb2: int = 512,
    hs_fill: int = 2,
    with_bound: bool = False,
):
    """Exact hit counts for the whole batch as one product of the query
    gram multiplicities with the dense incidence (``gram_hits``), then the
    h* finish (uniform weights, <= 127 gram windows: the hits narrowed to
    int8, padded to 1024-lane multiples, 128-lane block maxima) or the
    dense-hits finish, as the reference's candidates_matmul_impl.  The
    reference leaves the product to XLA outside any Pallas kernel.
    ``with_bound``: the per-shard form (``_finish_selected``)."""
    ts, tl = di.n_short, di.n_long
    compute_short = compute_short and ts > 0
    hits = gram_hits(qslots, gram_matrix)[:, :tl]
    kw = dict(compute_short=compute_short, n_cand=n_cand, n_edge=n_edge,
              top_k=top_k, with_bound=with_bound)
    args = (qtokens, qlens, n_qgrams, use_short, promo_ids, promo_terms,
            promo_weights, limits, threshold)
    if hstar and qslots.shape[1] <= 127:
        h8 = hits.to(torch.int8)  # exact: counts <= Qmax <= 127
        pad = (-tl) % (_BLK * 8)
        if pad:
            h8 = torch.cat([h8, h8.new_zeros((h8.shape[0], pad))], 1)
        nblk = h8.shape[1] // _BLK
        return _hstar_finish(
            di, pt, xt, h8, block_hmax(h8, nblk, _BLK), *args, kb1=kb1,
            kb2=kb2, vmax=int(qslots.shape[1]), blk=_BLK, fill=hs_fill, **kw,
        )
    return _dense_hits_finish(
        di, pt, xt, hits, *args, block_sel=block_sel, **kw
    )


# ---------------------------------------------------------------------------
# the sorted-runs front end (gram-sparse corpora, tiny batches)
# ---------------------------------------------------------------------------


def candidates_runs(
    di,
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
    compute_short: bool,
    s_cap: int,
    n_cand: int,
    n_edge: int,
    top_k: int,
    block_sel: bool = False,
    with_bound: bool = False,
):
    """Hit counts from each query's own postings, as the reference's
    candidates_runs_impl with its batch dimension written out: every
    query's posting runs expand into ``s_cap`` lanes of term ids (the
    postings expansion, the sentinel tl past the query's posting mass),
    the lanes sort so each term's postings form a run, a run's
    length is the term's hit count, and each run's first lane carries the
    term's score and bound.  Work follows the batch's posting mass, not the
    index size, and no table is built.  ``with_bound``: the per-shard form
    (``_finish_selected``)."""
    ts, tl = di.n_short, di.n_long
    compute_short = compute_short and ts > 0
    t_total = ts + tl
    b = qslots.shape[0]
    dev = qslots.device
    thr = _f32(threshold)
    nqg = n_qgrams.to(torch.int32)
    nqg_f = torch.clamp(nqg.to(torch.float32), min=1.0)

    # -- postings expansion -> sorted run lanes ----------------------------
    tid = expand_postings(di.gram_ptr, di.gram_terms, qslots, s_cap, tl)
    pos = torch.arange(s_cap, dtype=torch.int64, device=dev).expand(b, s_cap)
    tid_sorted = torch.sort(tid, dim=1).values  # sentinels (tl) sink to the end
    del tid
    lane_valid = tid_sorted < tl

    # -- run starts / lengths (hit counts) ---------------------------------
    first = lane_valid.clone()
    first[:, 1:] &= tid_sorted[:, 1:] != tid_sorted[:, :-1]
    n_valid = lane_valid.sum(1)
    starts_sorted = torch.sort(torch.where(first, pos, s_cap), dim=1).values
    next_start = torch.cat(
        [starts_sorted[:, 1:], torch.full((b, 1), s_cap, dtype=torch.int64, device=dev)],
        1,
    )
    run_len = torch.where(
        starts_sorted < s_cap,
        torch.minimum(next_start, n_valid[:, None]) - starts_sorted,
        0,
    )
    del starts_sorted, next_start
    run_id = first.to(torch.int32).cumsum(1) - 1
    hits_lane = run_len.gather(1, run_id.clamp(0, s_cap - 1).long())
    del run_len, run_id
    s_long_lane = hits_lane.to(torch.float32) / nqg_f[:, None]
    long_pass = first & (nqg > 0)[:, None] & (s_long_lane >= thr)
    n_pass = long_pass.sum(1)
    gid_lane = (ts + tid_sorted.long()).clamp(0, max(t_total - 1, 0))
    u_long = torch.where(
        long_pass, di.term_wmax[gid_lane] * s_long_lane, _NEG_INF
    )
    del long_pass

    def long_score(p_t):
        # hits at arbitrary global term ids: binary search into the lanes
        p_local = (p_t - ts).clamp(0, tl).reshape(b, -1).to(tid_sorted.dtype)
        pl = torch.searchsorted(tid_sorted, p_local.contiguous())
        pl_c = pl.clamp(0, s_cap - 1)
        found = (
            (tid_sorted.gather(1, pl_c) == p_local) & (pl < s_cap)
            & (p_t >= ts).reshape(b, -1)
        )
        p_s = hits_lane.gather(1, pl_c).to(torch.float32) / nqg_f[:, None]
        ok = found & (nqg > 0)[:, None] & (p_s >= thr)
        return p_s.view(p_t.shape), ok.view(p_t.shape)

    if compute_short:
        s_short, pass_short, u_short = _short_terms(
            di, qtokens, qlens, use_short, thr
        )
        n_pass = n_pass + pass_short.sum(1)
        u_all = torch.cat([u_short, u_long], 1)
        s_all = torch.cat([s_short, s_long_lane], 1)
        gid_all = torch.cat(
            [torch.arange(ts, device=dev).expand(b, ts), gid_lane], 1
        )

        def term_score(p_t):
            p_sl, p_pl = long_score(p_t)
            p_sh = p_t < ts
            idx_s = p_t.clamp(0, ts - 1).reshape(b, -1).long()
            return (
                torch.where(p_sh, s_short.gather(1, idx_s).view(p_t.shape), p_sl),
                torch.where(p_sh, pass_short.gather(1, idx_s).view(p_t.shape), p_pl),
            )
    else:
        u_all, s_all, gid_all = u_long, s_long_lane, gid_lane
        term_score = long_score

    return _finish_candidates(
        di, pt, xt, u_all, s_all, gid_all, n_pass, term_score,
        (promo_ids, promo_terms, promo_weights), limits, threshold,
        n_cand=n_cand, n_edge=n_edge, top_k=top_k, block_sel=block_sel,
        with_bound=with_bound,
    )
