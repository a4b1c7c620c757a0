"""Search orchestrator.

PyTorch counterpart of ``stringsearchlib_tpu.search.engine``: the host front
end (normalization, gram-slot lookup, shape bucketing, chunking) is the
reference's; every device program runs eagerly on the index's device with
an explicit batch dimension where the reference vmapped.

  short DP tier + long gram tier -> per-term scores
  -> threshold gate + weight + segment-max over term->key edges (calcScore,
     nGramSearch.hpp:310-341, incl. the 0.999 -> 100 exact-match promotion)
  -> stable sort (score desc, key length asc; ScoreComparer,
     nGramSearch.h:262-269) -> top-k slice + reached count.

Batched searches on large indexes take the candidate route: K1 hit counts
over the packed incidence, the integer h* finish, a selection-only retry
on the retained hits, and the dense path for rows whose exactness guard
still fails (``_cand_pass``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import INT32_MAX, PERFECT_SCORE_CUTOFF, PROMOTED_SCORE
from ..core import grams as gramlib
from ..core import text as textlib
from ..index.build import HostIndex
from .candidates import _BLK, _f32, candidates_bitmap_mxu, hstar_retry
from .editdist import dp_match, dp_match_tiered
from .overlap import gather_hits

_NEG_INF = float("-inf")


def _next_pow2(n: int, lo: int) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


# ---------------------------------------------------------------------------
# device-side scoring (batched: every tensor carries a leading query axis)
# ---------------------------------------------------------------------------


def _promo_mask(n_keys: int, promo_ids):
    """(B, n_keys) bool promotion-eligibility mask from host-precomputed
    key ids (B, PK), -1 padded."""
    b = promo_ids.shape[0]
    idx = torch.where(promo_ids >= 0, promo_ids, n_keys).long()
    mask = torch.zeros((b, n_keys + 1), dtype=torch.bool, device=promo_ids.device)
    mask.scatter_(1, idx, True)
    return mask[:, :n_keys]


def _term_scores(
    di, qtokens, qlens, qslots, n_qgrams, short_mask, *,
    compute_short, brute_long, s_cap, long_buckets=(),
):
    """Per-term scores for both tiers over the global term space [0, T).

    Returns (sA, maskA, sB, maskB), each (B, T): tier A is the DP map
    (scoreShort), tier B the gram map (scoreLong), kept separate because
    the reference thresholds each map independently
    (nGramSearch.hpp:393-394).  ``short_mask`` (B,) gates tier A's short
    terms per query; ``brute_long`` scores the long tier by DP as well."""
    ts, tl = di.n_short, di.n_long
    t = ts + tl
    b = qtokens.shape[0]
    dev = qtokens.device
    qlen_f = torch.clamp(qlens.to(torch.float32), min=1.0)[:, None]
    if compute_short:
        m_short = dp_match(di.short_tokens, di.short_lengths, qtokens, qlens)
        s_short = m_short.to(torch.float32) / qlen_f
    else:
        s_short = torch.zeros((b, ts), dtype=torch.float32, device=dev)
    if brute_long:
        m_long = dp_match_tiered(
            di.long_tokens, di.long_lengths, qtokens, qlens, long_buckets
        )
        s_a = torch.cat([s_short, m_long.to(torch.float32) / qlen_f], 1)
        mask_a = torch.ones((b, t), dtype=torch.bool, device=dev)
    else:
        s_a = torch.cat(
            [s_short, torch.zeros((b, tl), dtype=torch.float32, device=dev)], 1
        )
        mask_a = torch.cat(
            [
                short_mask[:, None].expand(b, ts),
                torch.zeros((b, tl), dtype=torch.bool, device=dev),
            ],
            1,
        )

    hits = gather_hits(di.gram_ptr, di.gram_terms, qslots, tl, s_cap)
    nqg = n_qgrams.to(torch.int32)[:, None]
    s_b_long = hits.to(torch.float32) / torch.clamp(nqg.to(torch.float32), min=1.0)
    zeros_s = torch.zeros((b, ts), dtype=torch.float32, device=dev)
    s_b = torch.cat([zeros_s, s_b_long], 1)
    mask_b = torch.cat(
        [torch.zeros((b, ts), dtype=torch.bool, device=dev), (hits > 0) & (nqg > 0)],
        1,
    )
    return s_a, mask_a, s_b, mask_b


def _segment_max(values, seg, n_seg: int, init):
    """(B, E) values -> (B, n_seg) per-segment max (``init`` where empty)."""
    b = values.shape[0]
    out = torch.full((b, n_seg), init, dtype=values.dtype, device=values.device)
    if values.shape[1]:
        out.scatter_reduce_(
            1, seg.long()[None, :].expand(b, -1), values, "amax",
            include_self=True,
        )
    return out


def _propagate_raw(di, s_a, mask_a, s_b, mask_b, eq_key, threshold):
    """calcScore over the edge list: threshold gate, weight multiply,
    segment-max into keys, exact-match promotion flags.  Returns (key_val
    (B, K) float32, -inf for unreached; promo (B, K) int32)."""
    k = di.n_keys
    et, ek, ew = di.edge_term.long(), di.edge_key.long(), di.edge_weight
    thr = _f32(threshold)
    ta, tb = s_a[:, et], s_b[:, et]
    pa = mask_a[:, et] & (ta >= thr)
    pb = mask_b[:, et] & (tb >= thr)
    va = torch.where(pa, ew * ta, _NEG_INF)
    vb = torch.where(pb, ew * tb, _NEG_INF)
    val = torch.maximum(va, vb)
    key_val = _segment_max(val, ek, k, _NEG_INF)
    cutoff = _f32(PERFECT_SCORE_CUTOFF)
    promo_edge = ((pa & (ta > cutoff)) | (pb & (tb > cutoff))) & eq_key[:, ek]
    promo = _segment_max(promo_edge.to(torch.int32), ek, k, 0)
    return key_val, promo


def _floor_and_promote(key_val, promo):
    """entryScore's default 0 before the max (nGramSearch.hpp:326), and
    promoted keys rise to at least 100 (nGramSearch.hpp:328-336)."""
    reached = key_val > _NEG_INF
    score = torch.where(reached, torch.clamp(key_val, min=0.0), 0.0)
    score = torch.where(
        (promo > 0) & reached, torch.clamp(score, min=PROMOTED_SCORE), score
    )
    return score, reached


def _propagate(di, s_a, mask_a, s_b, mask_b, eq_key, threshold):
    key_val, promo = _propagate_raw(di, s_a, mask_a, s_b, mask_b, eq_key, threshold)
    return _floor_and_promote(key_val, promo)


def _finalize(di, score, reached, top_k: int):
    """Stable (score desc, key len asc) sort; ties fall back to key id.
    Unreached keys sink to the end.  Returns (count (B,), ids (B, top_k),
    scores (B, top_k))."""
    neg = torch.where(reached, -score, float("inf")) + 0.0
    by_len = torch.argsort(di.key_len, stable=True)  # same for every query
    o = torch.argsort(neg[:, by_len], dim=1, stable=True)
    ids = by_len[o]
    count = reached.sum(1).to(torch.int32)
    out_ids = ids[:, :top_k].to(torch.int32)
    return count, out_ids, score.gather(1, ids[:, :top_k])


def search_device_impl(
    di, qtokens, qlens, qslots, n_qgrams, use_short, promo_ids, threshold, *,
    compute_short, brute_long, s_cap, top_k, long_buckets=(),
):
    """B queries scored densely in one program (the reference's single
    query program, its vmapped batch and its brute batch in one body).
    ``use_short`` (B,) gates the short tier per query; ``brute_long``
    scores the whole long tier by DP too (queries of qlen <= gram_size)."""
    s_a, mask_a, s_b, mask_b = _term_scores(
        di, qtokens, qlens, qslots, n_qgrams, use_short,
        compute_short=compute_short, brute_long=brute_long, s_cap=s_cap,
        long_buckets=long_buckets,
    )
    eq_key = _promo_mask(di.n_keys, promo_ids)
    score, reached = _propagate(di, s_a, mask_a, s_b, mask_b, eq_key, threshold)
    return _finalize(di, score, reached, top_k)


def search_batch_device_impl(
    di, qtokens, qlens, qslots, n_qgrams, use_short, promo_ids, threshold,
    *, compute_short, s_cap, top_k,
):
    """Batched dense search: one program scores B queries."""
    return search_device_impl(
        di, qtokens, qlens, qslots, n_qgrams, use_short, promo_ids,
        threshold, compute_short=compute_short, brute_long=False,
        s_cap=s_cap, top_k=top_k,
    )


def search_brute_batch_device_impl(
    di, qtokens, qlens, qslots, n_qgrams, promo_ids, threshold, *,
    s_cap, top_k, long_buckets=(),
):
    """Batched brute-force tier for qlen <= gram_size queries: the whole
    long tier is scored by DP (getMatchScore long-lib fallback,
    nGramSearch.hpp:247-253)."""
    b = qtokens.shape[0]
    ones = torch.ones(b, dtype=torch.bool, device=qtokens.device)
    return search_device_impl(
        di, qtokens, qlens, qslots, n_qgrams, ones, promo_ids, threshold,
        compute_short=True, brute_long=True, s_cap=s_cap, top_k=top_k,
        long_buckets=long_buckets,
    )


def _wildcard_device(di, *, top_k):
    """Wildcard '' / '*' (nGramSearch.hpp:356-369): every key at its
    weight (max across edges)."""
    k = di.n_keys
    score = _segment_max(di.edge_weight[None, :], di.edge_key, k, _NEG_INF)
    reached = score > _NEG_INF
    score = torch.where(reached, score, 0.0)
    return _finalize(di, score, reached, top_k)


def _pack(count, ids, scores, exact=None):
    """One int32 (B, 2 + 2 * top_k) block per result, so a whole dispatch
    comes back in a single device->host copy."""
    cols = [count.to(torch.int32)[:, None], ids.to(torch.int32),
            scores.to(torch.float32).contiguous().view(torch.int32)]
    if exact is not None:
        cols.append(exact.to(torch.int32)[:, None])
    return torch.cat(cols, 1)


def _unpack(block: np.ndarray, top_k: int, with_exact: bool = False):
    counts = block[:, 0]
    ids = block[:, 1 : 1 + top_k]
    scores = np.ascontiguousarray(block[:, 1 + top_k : 1 + 2 * top_k]).view(np.float32)
    if with_exact:
        return counts, ids, scores, block[:, 1 + 2 * top_k].astype(bool)
    return counts, ids, scores


def _fetch(blocks: list) -> np.ndarray:
    """Every queued result block, in one device->host copy."""
    return torch.cat(blocks, 0).cpu().numpy()


# ---------------------------------------------------------------------------
# host-side per-query front end
# ---------------------------------------------------------------------------


class SearchEngine:
    """Query front end for one HostIndex: normalization, gram-slot lookup,
    shape bucketing, device dispatch, and result materialization."""

    def __init__(self, host: HostIndex):
        self.host = host
        self.cfg = host.config
        self.device = host.device.device
        # wildcard results are query-independent and the index immutable
        self._wildcard_cache: dict = {}
        # resolved routing of the most recent candidate pass
        self.last_routing: dict = {}

    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- query prep -----------------------------------------------------

    def _normalize_query(self, query) -> tuple[np.ndarray, int]:
        tokens, lengths = textlib.encode_batch([query], self.cfg.wide)
        out, out_len = textlib.normalize_matrix(tokens, lengths, self.host.tables)
        return out[0], int(out_len[0])

    def _query_buffers(self, qnorm: np.ndarray, qlen: int):
        g = self.cfg.gram_size
        qp = _next_pow2(qlen, max(16, self.cfg.query_pad // 4))
        qtok = np.zeros(qp, dtype=np.int32)
        qtok[:qlen] = qnorm[:qlen]
        qmax = qp - g + 1
        slots = np.full(qmax, -1, dtype=np.int32)
        n_qgrams = 0
        if qlen >= g:
            n_qgrams = qlen - g + 1
            ids, valid = gramlib.gram_ids(
                qnorm[None, :max(qlen, g)], np.array([qlen]), g,
                self.cfg.wide, self.host.vocab,
            )
            slots[:n_qgrams] = self.host.lookup_gram_slots(ids[0][valid[0]])
        lens = self.host.host_posting_lens
        present = slots[slots >= 0]
        s_total = int(lens[present].sum()) if present.size else 0
        s_cap = _next_pow2(max(s_total, 1), 128)
        return qtok, qmax, slots, n_qgrams, s_cap

    def _top_k(self, limit: int) -> int:
        k = self.host.device.n_keys
        if limit <= 0 or limit >= k:
            return max(k, 1)
        return min(_next_pow2(limit, 16), max(k, 1))

    # -- public search ----------------------------------------------------

    def search(self, query, threshold: float = 0.0, limit: int = 0):
        """Returns (result key strings, scores); limit 0 = unbounded
        (nGramSearch.hpp:454-455)."""
        return self._search_impl(query, threshold, limit)

    def _search_impl(self, query, threshold: float = 0.0, limit: int = 0):
        if not self.host.indexed:
            return [], []
        if limit == 0:
            limit = INT32_MAX
        raw = query if isinstance(query, str) else str(query)
        di = self.host.device
        top_k = self._top_k(limit)

        if len(raw) == 0 or raw == "*":
            if di.edge_key.shape[0] == 0:
                return [], []
            cached = self._wildcard_cache.get(top_k)
            if cached is None:
                cached = _unpack(
                    _fetch([_pack(*_wildcard_device(di, top_k=top_k))]),
                    min(top_k, di.n_keys),
                )
                self._wildcard_cache[top_k] = cached
            count, ids_np, scores_np = cached
            n = min(int(count[0]), limit, int(ids_np.shape[1]))
            return (
                [self.host.key_strings[i] for i in ids_np[0, :n]],
                [float(s) for s in scores_np[0, :n]],
            )
        qnorm, qlen = self._normalize_query(raw)
        if qlen == 0:
            return [], []
        # an eligible single query on a large index takes the candidate
        # batch route: the dense path's full K-key sort is the wrong cost
        # model at millions of keys
        if (
            limit <= self.CAND_MAX_LIMIT
            and self.host.n_terms >= self.CAND_MIN_TERMS
            and self.cfg.brute_force_cutoff < qlen <= 32
        ):
            return self._search_batch_impl(
                [raw], threshold, limit, 256, 32, "auto"
            )[0]
        qtok, qmax, slots, n_qgrams, s_cap = self._query_buffers(qnorm, qlen)
        use_short = qlen < self.cfg.short_search_cutoff
        brute_long = qlen <= self.cfg.brute_force_cutoff
        # dense paths carry EVERY promo id (pow2-bucketed width)
        pids = self.host.promo_key_ids(qnorm, qlen)
        promo = np.full(
            _next_pow2(max(pids.size, 1), self.PROMO_KEYS), -1, np.int32
        )
        promo[: pids.size] = pids
        res = search_device_impl(
            di,
            self._t(qtok[None]),
            self._t(np.array([qlen], np.int32)),
            self._t(slots[None]),
            self._t(np.array([n_qgrams], np.int32)),
            self._t(np.array([use_short])),
            self._t(promo[None]),
            np.float32(threshold),
            compute_short=use_short,
            brute_long=brute_long,
            s_cap=s_cap,
            top_k=top_k,
            long_buckets=self.host.long_dp_buckets() if brute_long else (),
        )
        count, ids_np, scores_np = _unpack(
            _fetch([_pack(*res)]), int(res[1].shape[1])
        )
        n = min(int(count[0]), limit, int(ids_np.shape[1]))
        return (
            [self.host.key_strings[i] for i in ids_np[0, :n]],
            [float(s) for s in scores_np[0, :n]],
        )

    # -- batched search ----------------------------------------------------

    # candidate-path shape defaults
    CAND_TERMS = 4096
    CAND_TERMS_FAST = 1024  # first-pass selection width (escalates on guard failure)
    CAND_EDGES = 16384
    PROMO_KEYS = 8
    PROMO_EDGES = 128
    CAND_MIN_TERMS = 20000  # below this the dense batch is already cheap
    CAND_MAX_LIMIT = 512

    def search_batch(
        self, queries, threshold: float = 0.0, limit: int = 100,
        batch_bucket: int = 256, qp_bucket: int = 32, mode: str = "auto",
    ):
        """Batched search.  Returns a list of (strings, scores) aligned with
        ``queries``.

        ``mode``: "auto" picks the candidate path for bounded limits on
        large indexes (exact results; rows whose exactness guard fails are
        recomputed densely), "dense" forces the dense batch, "candidates"
        forces the candidate path where eligible."""
        return self._search_batch_impl(
            queries, threshold, limit, batch_bucket, qp_bucket, mode
        )

    def _search_batch_impl(
        self, queries, threshold, limit, batch_bucket, qp_bucket, mode
    ):
        if limit == 0:
            limit = INT32_MAX
        out: list = [None] * len(queries)
        if not self.host.indexed:
            return [([], [])] * len(queries)

        items = []  # (position, qnorm, qlen, promo_row or None)
        brute_items = []  # (position, qnorm, qlen): qlen <= gram_size
        want_cand = mode != "dense" and (
            mode == "candidates"
            or (
                limit <= self.CAND_MAX_LIMIT
                and self.host.n_terms >= self.CAND_MIN_TERMS
            )
        )
        ke_counts = self.host.host_key_edge_counts
        raws = [q if isinstance(q, str) else str(q) for q in queries]
        nz = [i for i, r in enumerate(raws) if len(r) > 0 and r != "*"]
        if nz:
            tokens, lengths = textlib.encode_batch(
                [raws[i] for i in nz], self.cfg.wide
            )
            norm_tok, norm_len = textlib.normalize_matrix(
                tokens, lengths, self.host.tables
            )
            promo_rows = (
                self.host.promo_key_ids_batch(norm_tok, norm_len)
                if want_cand else [None] * len(nz)
            )
        for i, raw in enumerate(raws):
            if len(raw) == 0 or raw == "*":
                out[i] = self._search_impl(raw, threshold, limit)
        for j, i in enumerate(nz):
            qnorm, qlen = norm_tok[j], int(norm_len[j])
            if qlen == 0:
                out[i] = ([], [])
            elif qlen <= self.cfg.brute_force_cutoff:
                brute_items.append((i, qnorm, qlen))
            else:
                promo = None
                if want_cand:
                    pids = promo_rows[j]
                    if pids.size <= self.PROMO_KEYS and (
                        pids.size == 0
                        or int(ke_counts[pids].max()) <= self.PROMO_EDGES
                    ):
                        promo = pids
                items.append((i, qnorm, qlen, promo))

        if not items and not brute_items:
            return out

        # queries longer than qp_bucket batch in their own pow2-width groups
        groups: dict = {}
        for it in items:
            qp_i = qp_bucket if it[2] <= qp_bucket else _next_pow2(
                it[2], qp_bucket
            )
            groups.setdefault(qp_i, []).append(it)
        for qp_i in sorted(groups):
            grp = groups[qp_i]
            cand_items = [it for it in grp if want_cand and it[3] is not None]
            dense_items = [
                it for it in grp if not (want_cand and it[3] is not None)
            ]
            if cand_items:
                retry = self._run_candidate_chunks(
                    cand_items, threshold, limit, batch_bucket, qp_i, out
                )
                dense_items.extend(retry)
            if dense_items:
                self._run_dense_chunks(
                    dense_items, threshold, limit, batch_bucket, qp_i, out
                )
        if brute_items:
            self._run_brute_chunks(brute_items, threshold, limit, out)
        return out

    def _run_brute_chunks(self, items, threshold, limit, out):
        """Batched brute tier (qlen <= gram_size); chunks are small because
        the whole-tier DP holds O(B x T x W)."""
        di = self.host.device
        top_k = self._top_k(limit)
        g = self.cfg.gram_size
        qp = max(_next_pow2(self.cfg.brute_force_cutoff + 1, 8), g + 1)
        w = max(int(di.short_tokens.shape[1]), int(di.long_tokens.shape[1]))
        per_q = 12 * max(self.host.n_terms, 1) * (w + 2) + (1 << 18)
        cap = max(int(self.BATCH_HBM_BUDGET // per_q), 1)
        step = 1
        while step * 2 <= min(cap, 64):
            step *= 2

        pending = []
        for lo in range(0, len(items), step):
            chunk = items[lo : lo + step]
            b, qtok, qlens, slots, nqg, _, s_cap = self._prep_rows(
                chunk, qp, min_b=min(step, 16)
            )
            res = search_brute_batch_device_impl(
                di,
                self._t(qtok),
                self._t(qlens),
                self._t(slots),
                self._t(nqg),
                self._t(self._promo_array(chunk, b)),
                np.float32(threshold),
                s_cap=s_cap,
                top_k=top_k,
                long_buckets=self.host.long_dp_buckets(),
            )
            pending.append((chunk, b, _pack(*res)))
        self._emit_dense(pending, limit, out)

    def _emit_dense(self, pending, limit, out):
        """One fetch for every queued dense chunk, then emit its rows."""
        if not pending:
            return
        block = _fetch([blk for _, _, blk in pending])
        width = (block.shape[1] - 1) // 2
        lo = 0
        for chunk, b, _ in pending:
            counts, ids_b, scores_b = _unpack(block[lo : lo + b], width)
            lo += b
            for r, item in enumerate(chunk):
                self._emit_row(
                    out, item[0], counts[r], ids_b[r], scores_b[r], limit
                )

    # device-memory budget for per-batch intermediates: batch sizes shrink
    # as the index grows (the reference's value)
    BATCH_HBM_BUDGET = 7 << 30

    def _batch_cap(self, batch_bucket: int) -> int:
        per_query = 48 * max(self.host.n_terms, 1) + (1 << 20)
        cap = max(int(self.BATCH_HBM_BUDGET // per_query), 8)
        pow2 = 8
        while pow2 * 2 <= cap:
            pow2 *= 2
        return min(batch_bucket, pow2)

    def _prep_rows(self, chunk, qp, min_b: int = 16):
        """Shared host buffers for a chunk of (pos, qnorm, qlen, ...): one
        batched gram extraction + slot lookup + posting-mass reduce."""
        g = self.cfg.gram_size
        qmax = qp - g + 1
        b = _next_pow2(len(chunk), min_b)
        qtok = np.zeros((b, qp), dtype=np.int32)
        qlens = np.zeros(b, dtype=np.int32)
        slots = np.full((b, qmax), -1, dtype=np.int32)
        for r, item in enumerate(chunk):
            qlen = item[2]
            qtok[r, :qlen] = item[1][:qlen]
            qlens[r] = qlen
        use_short = (qlens > 0) & (qlens < self.cfg.short_search_cutoff)
        nqg = np.maximum(qlens - (g - 1), 0).astype(np.int32)
        nn = len(chunk)
        s_total = 0
        if nn and qmax > 0:
            ids, valid = gramlib.gram_ids(
                qtok[:nn], qlens[:nn], g, self.cfg.wide, self.host.vocab
            )
            rowslots = np.full(ids.shape, -1, np.int32)
            fv = valid.ravel()
            if fv.any():
                rowslots.ravel()[fv] = self.host.lookup_gram_slots(
                    ids.ravel()[fv]
                )
            m = min(qmax, rowslots.shape[1])
            slots[:nn, :m] = rowslots[:, :m]
            s_total = self._slot_mass(rowslots)
        s_cap = _next_pow2(max(s_total, 1), 1024)
        return b, qtok, qlens, slots, nqg, use_short, s_cap

    def _slot_mass(self, rowslots: np.ndarray) -> int:
        """Max postings any one query's gram slots expand to."""
        lens_tbl = self.host.host_posting_lens
        if not lens_tbl.size or not rowslots.size:
            return 0
        stot = np.where(
            rowslots >= 0, lens_tbl[np.clip(rowslots, 0, None)], 0
        ).sum(axis=1)
        return int(stot.max())

    def _promo_tables(self, promo_all: np.ndarray):
        """(b, PK, PE) promo edge term ids (-1 padded) and weights from the
        host key->edge CSR."""
        kep, ket, kew = self.host.key_edge_host()
        b, pk = promo_all.shape
        valid = promo_all >= 0
        p_c = np.clip(promo_all, 0, max(kep.shape[0] - 2, 0))
        cnt = np.where(valid, kep[p_c + 1] - kep[p_c], 0)
        pe = _next_pow2(max(int(cnt.max()) if cnt.size else 0, 1), 1)
        terms = np.full((b, pk, pe), -1, np.int32)
        weights = np.zeros((b, pk, pe), np.float32)
        bi, ki = np.nonzero(cnt > 0)
        if bi.size:
            c = cnt[bi, ki].astype(np.int64)
            rep_b = np.repeat(bi, c)
            rep_k = np.repeat(ki, c)
            within = np.arange(c.sum()) - np.repeat(np.cumsum(c) - c, c)
            src = np.repeat(kep[p_c[bi, ki]], c) + within
            terms[rep_b, rep_k, within] = ket[src]
            weights[rep_b, rep_k, within] = kew[src]
        return terms, weights

    def _promo_array(self, chunk, b: int) -> np.ndarray:
        """(b, PK) int32 promotion key ids (-1 padded); PK buckets to the
        chunk's maximum (pow2, floor PROMO_KEYS) so dense paths carry every
        promo id."""
        rows = [
            item[3] if len(item) > 3 and item[3] is not None else (
                self.host.promo_key_ids(item[1], item[2])
            )
            for item in chunk
        ]
        width = _next_pow2(
            max((r.size for r in rows), default=1) or 1, self.PROMO_KEYS
        )
        promo = np.full((b, width), -1, np.int32)
        for r, pids in enumerate(rows):
            promo[r, : pids.size] = pids
        return promo

    def _emit_row(self, out, pos, count, ids_row, scores_row, limit):
        n = min(int(count), limit, ids_row.shape[0])
        out[pos] = (
            self.host.key_strings.take(ids_row[:n]),
            scores_row[:n].astype(np.float64).tolist(),
        )

    def _run_dense_chunks(self, items, threshold, limit, batch_bucket, qp, out):
        top_k = self._top_k(limit)
        batch_bucket = self._batch_cap(batch_bucket)
        pending = []
        for lo in range(0, len(items), batch_bucket):
            chunk = items[lo : lo + batch_bucket]
            b, qtok, qlens, slots, nqg, use_short, s_cap = self._prep_rows(chunk, qp)
            res = search_batch_device_impl(
                self.host.device,
                self._t(qtok),
                self._t(qlens),
                self._t(slots),
                self._t(nqg),
                self._t(use_short),
                self._t(self._promo_array(chunk, b)),
                np.float32(threshold),
                compute_short=bool(use_short.any()),
                s_cap=s_cap,
                top_k=top_k,
            )
            pending.append((chunk, b, _pack(*res)))
        self._emit_dense(pending, limit, out)

    # device-memory budget for the bit-packed incidence (G * Tl/8 bytes)
    BITMAP_BUDGET = 6 << 30
    # integer hit-threshold (h*) selection on the bitmap-kernel route
    # (candidates._hstar_finish); sound only for uniform-weight indexes.
    # Budgets: 1024 coarse (1024-lane) and 1024 fine (128-lane) blocks; rows
    # whose guard fails re-select from the retained hits at 4x budgets.
    HSTAR_SEL = True
    HSTAR_KB1 = 1024
    HSTAR_KB2 = 1024
    # kept-block fill target (x limit); 0 = keep every block the budget fits
    HSTAR_FILL = 0

    def _run_candidate_chunks(self, items, threshold, limit, batch_bucket, qp, out):
        """Candidate batches; returns the rows that need the dense path.

        The first pass selects at CAND_TERMS_FAST-scale budgets; rows whose
        exactness guard fails re-select from the retained hits at
        CAND_TERMS-scale budgets (selection only, no second table stream),
        and rows that still fail go dense."""
        retry, _, _, sel_ctx = self._cand_pass(
            items, threshold, limit, batch_bucket, qp, out,
            self.CAND_TERMS_FAST,
        )
        n_retry_fast = len(retry)
        if retry and sel_ctx is not None:
            retry = self._hstar_sel_retry(sel_ctx, threshold, limit, out)
            self.last_routing["retry_sel"] = len(retry)
        self.last_routing["retry_fast"] = n_retry_fast
        self.last_routing["n_items"] = len(items)
        return retry

    def _hstar_sel_retry(self, sel_ctx, threshold, limit, out):
        """Re-select guard-failed rows from the retained first-pass hits at
        the escalated budgets.  Returns the rows whose guard still fails."""
        fails = sel_ctx["fails"]  # [(item, chunk_idx, row_in_chunk, grow)]
        b_r = _next_pow2(len(fails), 8)
        pad = b_r - len(fails)
        # grouped by chunk so each chunk contributes one gather; pad rows
        # replicate the last entry (their outputs are ignored)
        order = sorted(range(len(fails)), key=lambda fi: fails[fi][1])
        rows = order + [order[-1]] * pad
        hit_parts, hmax_parts = [], []
        lo = 0
        while lo < len(rows):
            ci = fails[rows[lo]][1]
            hi = lo
            while hi < len(rows) and fails[rows[hi]][1] == ci:
                hi += 1
            idx = self._t(np.asarray([fails[fi][2] for fi in rows[lo:hi]], np.int64))
            hits_ref, hmax_ref = sel_ctx["chunks"][ci]
            hit_parts.append(hits_ref.index_select(0, idx))
            hmax_parts.append(hmax_ref.index_select(0, idx))
            lo = hi
        hits_r = torch.cat(hit_parts, 0)
        hmax_r = torch.cat(hmax_parts, 0)
        grows = np.asarray([fails[fi][3] for fi in rows], np.int64)
        lim_arr = np.full((b_r,), min(limit, 2**30), dtype=np.int32)
        scale = max(self.CAND_TERMS // self.CAND_TERMS_FAST, 1)
        n_lanes = sel_ctx["n_lanes"]
        n_cand = min(self.CAND_TERMS, max(_next_pow2(n_lanes, 16), 16), n_lanes)
        res = hstar_retry(
            self.host.device,
            hits_r,
            hmax_r,
            sel_ctx["pt"],
            sel_ctx["xt"],
            self._t(sel_ctx["qtok"][grows]),
            self._t(sel_ctx["qlens"][grows]),
            self._t(sel_ctx["nqg"][grows]),
            self._t(sel_ctx["use_short"][grows]),
            self._t(sel_ctx["promo_all"][grows]),
            self._t(sel_ctx["promo_t"][grows]),
            self._t(sel_ctx["promo_w"][grows]),
            self._t(lim_arr),
            np.float32(threshold),
            compute_short=sel_ctx["compute_short"],
            kb1=self.HSTAR_KB1 * scale,
            kb2=self.HSTAR_KB2 * scale,
            n_cand=n_cand,
            top_k=sel_ctx["top_k"],
            n_edge=sel_ctx["n_edge"],
            vmax=sel_ctx["vmax"],
        )
        width = int(res[1].shape[1])
        counts, ids_b, scores_b, exact = _unpack(
            _fetch([_pack(res[0], res[1], res[2], res[4])]), width, True
        )
        still = []
        for pos, fi in enumerate(order):
            item = fails[fi][0]
            if exact[pos]:
                self._emit_row(
                    out, item[0], counts[pos], ids_b[pos], scores_b[pos], limit,
                )
            else:
                still.append(item)
        return still

    def _cand_pass(self, items, threshold, limit, batch_bucket, qp, out, cand_cap):
        """One candidate sweep at selection width ``cand_cap``.

        The candidate rung runs when the packed table fits BITMAP_BUDGET,
        every edge weight is 1, queries hold <= 127 gram windows and the
        lane space dwarfs the h* budgets: K1 hit counts, the h* finish, and
        (with the hits retained) the selection-only retry.  Every other
        batch goes to the dense path unchanged - a routing decision with
        the same results, independent of the device.  Returns (rows for
        the dense path, n_cand, selectable lanes, retry context)."""
        di = self.host.device
        ts, tl = di.n_short, di.n_long
        x_total = int(di.extra_key.shape[0])
        n_edge = min(
            max(_next_pow2(max(x_total, 1), 16), 16), self.CAND_EDGES
        )
        top_k = _next_pow2(limit, 16)

        b_all, qtok, qlens, slots, nqg, use_short, s_cap = self._prep_rows(
            items, qp
        )
        compute_short = bool(use_short.any())
        hs_scale = max(cand_cap // self.CAND_TERMS_FAST, 1)
        hs_kb1 = self.HSTAR_KB1 * hs_scale
        hs_kb2 = self.HSTAR_KB2 * hs_scale
        hs_fill = self.HSTAR_FILL if cand_cap == self.CAND_TERMS_FAST else 0
        bm = None
        if self.HSTAR_SEL and self.host.uniform_weights and slots.shape[1] <= 127:
            bm = self.host.bitmap_tables(self.BITMAP_BUDGET)
        tlp = int(bm[1]) if bm is not None else tl
        n_lanes = (ts if compute_short else 0) + tlp
        n_cand = min(cand_cap, max(_next_pow2(n_lanes, 16), 16), n_lanes)
        use_kernel = bm is not None and n_lanes >= 4 * hs_kb2 * _BLK
        if not use_kernel:
            self.last_routing = {
                "variant": "dense",
                "step": self._batch_cap(batch_bucket),
                "n_cand": n_cand,
                "block_sel": False,
                "approx_sel": False,
                "hstar": False,
            }
            return list(items), n_cand, n_lanes, None

        per_q = (
            tlp
            + 16 * hs_kb2 * _BLK
            + 24 * n_edge
            + (48 * ts if compute_short else 0)
            + (1 << 16)
        )
        cap = max(int(self.BATCH_HBM_BUDGET // per_q), 8)
        step = 8
        while step * 2 <= min(cap, batch_bucket):
            step *= 2
        bm_table = bm[0]
        self.last_routing = {
            "variant": "bitmap_kernel",
            "step": step,
            "n_cand": n_cand,
            "block_sel": bool(n_lanes >= 4 * n_cand * _BLK),
            "approx_sel": False,
            "gp_rows": int(bm_table.shape[1]),
            "gtile": False,
            "fused_bmax": True,
            "bmax_blk": _BLK,
            "compact_rows": 0,
            "virtual": False,
            "hstar": True,
            "pair_dots": False,
            "kb1": hs_kb1,
            "kb2": hs_kb2,
        }
        keep_sel = cand_cap == self.CAND_TERMS_FAST

        promo_all = np.full((b_all, self.PROMO_KEYS), -1, dtype=np.int32)
        for r, item in enumerate(items):
            pids = item[3]
            promo_all[r, : pids.size] = pids
        promo_t, promo_w = self._promo_tables(promo_all)
        pt, xt = self.host.prim_tables()

        # every chunk is queued before any result is fetched; the batch's
        # arrays go to the device once and chunks slice them there
        qtok_d = self._t(qtok)
        qlens_d = self._t(qlens)
        slots_d = self._t(slots)
        nqg_d = self._t(nqg)
        ushort_d = self._t(use_short)
        promo_d = self._t(promo_all)
        promo_t_d = self._t(promo_t)
        promo_w_d = self._t(promo_w)
        pending = []
        for lo in range(0, len(items), step):
            hi = min(lo + step, len(items))
            b = _next_pow2(hi - lo, min(step, 16))
            sl = slice(lo, lo + b)
            lim_d = torch.full(
                (b,), min(limit, 2**30), dtype=torch.int32, device=self.device
            )
            res = candidates_bitmap_mxu(
                di,
                bm_table,
                pt,
                xt,
                qtok_d[sl],
                qlens_d[sl],
                slots_d[sl],
                nqg_d[sl],
                ushort_d[sl],
                promo_d[sl],
                promo_t_d[sl],
                promo_w_d[sl],
                lim_d,
                np.float32(threshold),
                compute_short=compute_short,
                n_cand=n_cand,
                n_edge=n_edge,
                top_k=top_k,
                kb1=hs_kb1,
                kb2=hs_kb2,
                hs_fill=hs_fill,
                keep_hits=keep_sel,
            )
            block = _pack(res[0], res[1], res[2], res[4])
            pending.append((lo, hi, block, res[5:] if keep_sel else None))

        # ONE fetch for every chunk
        fetched = _fetch([blk for _, _, blk, _ in pending])
        width = (fetched.shape[1] - 2) // 2
        retry = []
        fails = []
        row0 = 0
        for k, (lo, hi, blk, _) in enumerate(pending):
            counts, ids_b, scores_b, exact = _unpack(
                fetched[row0 : row0 + blk.shape[0]], width, True
            )
            row0 += blk.shape[0]
            for r, item in enumerate(items[lo:hi]):
                if exact[r]:
                    self._emit_row(
                        out, item[0], counts[r], ids_b[r], scores_b[r], limit
                    )
                else:
                    retry.append(item)
                    if keep_sel:
                        fails.append((item, k, r, lo + r))
        sel_ctx = None
        if keep_sel and fails:
            sel_ctx = {
                "fails": fails,
                "chunks": [kept for _, _, _, kept in pending],
                "pt": pt,
                "xt": xt,
                "qtok": qtok,
                "qlens": qlens,
                "nqg": nqg,
                "use_short": use_short,
                "promo_all": promo_all,
                "promo_t": promo_t,
                "promo_w": promo_w,
                "compute_short": compute_short,
                "top_k": top_k,
                "n_edge": n_edge,
                "vmax": int(slots.shape[1]),
                "n_lanes": n_lanes,
            }
        return retry, n_cand, n_lanes, sel_ctx
