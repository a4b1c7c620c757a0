"""Search orchestrator.

PyTorch counterpart of ``stringsearchlib_tpu.search.engine``: the host front
end (normalization, gram-slot lookup, shape bucketing, chunking) is the
reference's; every device program carries an explicit batch dimension where
the reference vmapped.  On a CUDA device each chunk's program is captured
once per shape as a CUDA graph and replayed (``search.graphs``); on the CPU
it runs eagerly.

  short DP tier + long gram tier -> per-term scores
  -> threshold gate + weight + segment-max over term->key edges (calcScore,
     nGramSearch.hpp:310-341, incl. the 0.999 -> 100 exact-match promotion)
  -> stable sort (score desc, key length asc; ScoreComparer,
     nGramSearch.h:262-269) -> top-k slice + reached count.

Batched searches on large indexes take a candidate route (``_cand_pass``),
in the reference's gate order: the gram-matrix product where the dense
incidence fits GM_BUDGET (``matmul``, h* or dense-hits finish); the sorted
runs for batches of at most RUNS_TINY_BATCH queries on large indexes
(``tiny_runs``: the postings expansion K6, a sort, no table); over the
packed incidence, K1 hit counts with the integer h* finish and a
selection-only retry on the retained hits (uniform weights), or K1/K2 with
the blockmax or dense-hits finish (any weights), and for batches of at most
GATHER_BATCH queries optionally the same over the batch's own gram rows
(the gathered-row route), and for queries of more than 127 gram windows
K2w's int32 hit counts with the dense-hits finish (``bitmap_scan``); for
indexes whose packed incidence is over budget, the bucket sketch with
exact rescoring (K2 over the packed sketch, or ``torch._int_mm`` over the
unpacked one for queries of more than 127 gram windows); else the sorted
runs (``runs``).  Non-h* routes escalate
through one full pass at wider budgets.  Rows whose exactness guard still
fails take the dense path, whose short tier and brute tier run the
edit-distance kernel K5 and whose postings expansion runs K6.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import INT32_MAX, PERFECT_SCORE_CUTOFF, PROMOTED_SCORE
from ..core import grams as gramlib
from ..core import text as textlib
from ..index.build import HostIndex
from ..utils.metrics import span
from .candidates import (
    _BLK, _f32, candidates_bitmap, candidates_bitmap_gather,
    candidates_bitmap_mxu, candidates_matmul, candidates_runs, hstar_retry,
)
from .editdist import dp_match, dp_match_tiered
from .graphs import ChainGraphs, chain_key
from .overlap import gather_hits
from .sketch import candidates_sketch

_NEG_INF = float("-inf")

# device bytes a lane of a bitmap_scan chunk holds at its peak: the int32
# hits (4), float32 scores (4) and bounds (4), the float32 product that
# makes the bounds (4) and the pass mask (1)
_SCAN_LANE_BYTES = 17

# the per-call counters of SearchEngine.last_routing["call"], each summed
# over every query-width group, pass and tier of one public call: the
# queries, the rows whose first candidate pass failed its exactness guard,
# the rows the dense path answered, the keys decoded one by one, the
# chunks whose device chain was dispatched, and of them those replayed
# from a captured graph
_CALL_KEYS = ("queries", "retry_fast", "dense_rows", "emit_slow_keys",
              "chunks", "graph_chunks")


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


def slot_mass(lens: np.ndarray, rowslots: np.ndarray) -> tuple:
    """(largest posting mass of a row of (B, Q) gram slots, one posting list
    per window: the runs routes' lanes, sized as the reference sizes them;
    the same over each row's distinct slots: ``overlap.gather_hits``'s
    lanes).  ``lens`` (..., G) posting lengths; a leading shard axis takes
    the largest over shards too."""
    if not lens.size or not rowslots.size:
        return 0, 0
    srt = np.sort(rowslots, axis=1)
    per = np.where(srt >= 0, lens[..., np.clip(srt, 0, None)], 0)
    first = np.ones(srt.shape, bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    return int(per.sum(-1).max()), int(np.where(first, per, 0).sum(-1).max())


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


def _dense_chain(impl, di, **kw):
    """The device chain of a dense chunk: ``impl`` (one of the
    ``search_*device_impl``) over the chunk's inputs, its result packed."""

    def chain(t, thr):
        return (_pack(*impl(di, *t, thr, **kw)),)

    return chain


def _unpack(block: np.ndarray, top_k: int, with_exact: bool = False):
    counts = block[:, 0]
    ids = block[:, 1 : 1 + top_k]
    scores = np.ascontiguousarray(block[:, 1 + top_k : 1 + 2 * top_k]).view(np.float32)
    if with_exact:
        return counts, ids, scores, block[:, 1 + 2 * top_k].astype(bool)
    return counts, ids, scores


def _fetch(blocks: list) -> np.ndarray:
    """Every queued result block, in one device->host copy (where the host
    waits for the device)."""
    with span("sslib.fetch"):
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
        # reset by every public call: the resolved routing of its last
        # candidate pass (``variant`` "dense" / "brute" for a single query
        # on the dense path), and under "call" the call's counters
        # (_CALL_KEYS)
        self.last_routing: dict = {}
        self._call = dict.fromkeys(_CALL_KEYS, 0)
        # optional observability (utils.metrics.QueryMetrics); None = off
        self.metrics = None
        # the captured chunk chains (on a CUDA device only)
        self._graphs = (
            ChainGraphs(self.device) if self.device.type == "cuda" else None
        )

    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _run_chain(self, fn, arrays, threshold, *, route, tables=(),
                   dev_arrays=(), graph=True, **flags):
        """One chunk's device chain ``fn(inputs, thr)`` -> a tuple of device
        tensors; ``inputs`` are the host ``arrays`` on the device, then
        ``dev_arrays``.  On a CUDA device it is replayed from the graph
        captured for its key (``graphs.chain_key``: ``route``, the inputs'
        shapes, ``tables`` and ``flags``), ``thr`` a device value;
        elsewhere, with ``graph`` False, or where the key's capture did not
        fit the device, it runs eagerly, ``thr`` the float32 threshold."""
        self._call["chunks"] += 1
        if self._graphs is not None and graph:
            key = chain_key(route, (*arrays, *dev_arrays), tables, **flags)
            outs, replayed = self._graphs.run(
                key, fn, arrays, threshold, dev_arrays, tables
            )
            if outs is not None:
                self._call["graph_chunks"] += int(replayed)
                return outs
        return fn([self._t(a) for a in arrays] + list(dev_arrays),
                  np.float32(threshold))

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
        s_cap = _next_pow2(max(self._slot_mass(slots[None])[1], 1), 128)
        return qtok, qmax, slots, n_qgrams, s_cap

    def _top_k(self, limit: int) -> int:
        k = self.host.device.n_keys
        if limit <= 0 or limit >= k:
            return max(k, 1)
        return min(_next_pow2(limit, 16), max(k, 1))

    # -- public search ----------------------------------------------------

    # the _CALL_KEYS this engine counts; an engine whose passes count fewer
    # (the sharded engines) reports only those
    CALL_COUNTERS = _CALL_KEYS

    def _open_call(self, queries: int) -> None:
        self.last_routing = {}
        self._call = dict.fromkeys(_CALL_KEYS, 0)
        self._call["queries"] = queries

    def _close_call(self, seconds: float) -> None:
        call = {k: self._call[k] for k in self.CALL_COUNTERS}
        self.last_routing["call"] = call
        if self.metrics is not None:
            self.metrics.record(seconds, call["queries"], call)

    def search(self, query, threshold: float = 0.0, limit: int = 0):
        """Returns (result key strings, scores); limit 0 = unbounded
        (nGramSearch.hpp:454-455)."""
        t0 = time.perf_counter()
        self._open_call(1)
        try:
            with span("sslib.search"):
                return self._search_impl(query, threshold, limit)
        finally:
            self._close_call(time.perf_counter() - t0)

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
            with span("sslib.emit"):
                return self._emit_one(*cached, limit)
        with span("sslib.front"):
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
        brute_long = qlen <= self.cfg.brute_force_cutoff
        self.last_routing["variant"] = "brute" if brute_long else "dense"
        if not brute_long:
            self._call["dense_rows"] += 1
        with span("sslib.front"):
            qtok, qmax, slots, n_qgrams, s_cap = self._query_buffers(qnorm, qlen)
            use_short = qlen < self.cfg.short_search_cutoff
            # dense paths carry EVERY promo id (pow2-bucketed width)
            pids = self.host.promo_key_ids(qnorm, qlen)
            promo = np.full(
                _next_pow2(max(pids.size, 1), self.PROMO_KEYS), -1, np.int32
            )
            promo[: pids.size] = pids
        with span("sslib.dispatch"):
            buckets = self.host.long_dp_buckets() if brute_long else ()
            kw = dict(compute_short=use_short, brute_long=brute_long,
                      s_cap=s_cap, top_k=top_k, long_buckets=buckets)
            block, = self._run_chain(
                _dense_chain(search_device_impl, di, **kw),
                [qtok[None], np.array([qlen], np.int32), slots[None],
                 np.array([n_qgrams], np.int32), np.array([use_short]),
                 promo[None]],
                threshold, route="dense_single", tables=(di,), **kw,
            )
        fetched = _fetch([block])
        with span("sslib.emit"):
            return self._emit_one(
                *_unpack(fetched, (fetched.shape[1] - 1) // 2), limit
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
        t0 = time.perf_counter()
        self._open_call(len(queries))
        try:
            with span("sslib.search_batch"):
                return self._search_batch_impl(
                    queries, threshold, limit, batch_bucket, qp_bucket, mode
                )
        finally:
            self._close_call(time.perf_counter() - t0)

    def _search_batch_impl(
        self, queries, threshold, limit, batch_bucket, qp_bucket, mode
    ):
        if limit == 0:
            limit = INT32_MAX
        out: list = [None] * len(queries)
        if not self.host.indexed:
            return [([], [])] * len(queries)

        raws = [q if isinstance(q, str) else str(q) for q in queries]
        for i, raw in enumerate(raws):
            if len(raw) == 0 or raw == "*":
                out[i] = self._search_impl(raw, threshold, limit)
        with span("sslib.front"):
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

            # queries longer than qp_bucket batch in their own pow2-width
            # groups
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
        buckets = self.host.long_dp_buckets()
        pending = []
        for lo in range(0, len(items), step):
            chunk = items[lo : lo + step]
            b, qtok, qlens, slots, nqg, _, _, d_cap = self._prep_rows(
                chunk, qp, min_b=min(step, 16)
            )
            promo = self._promo_array(chunk, b)
            kw = dict(s_cap=d_cap, top_k=top_k, long_buckets=buckets)
            with span("sslib.dispatch"):
                block, = self._run_chain(
                    _dense_chain(search_brute_batch_device_impl, di, **kw),
                    [qtok, qlens, slots, nqg, promo], threshold,
                    route="brute", tables=(di,), **kw,
                )
                pending.append((chunk, b, block))
        self._emit_dense(pending, limit, out)

    def _emit_dense(self, pending, limit, out):
        """One fetch for every queued dense chunk, then emit its rows."""
        if not pending:
            return
        block = _fetch([blk for _, _, blk in pending])
        width = (block.shape[1] - 1) // 2
        with span("sslib.emit"):
            counts, ids_b, scores_b = _unpack(block, width)
            rows, positions = [], []
            lo = 0
            for chunk, b, _ in pending:
                rows.extend(range(lo, lo + len(chunk)))
                positions.extend(item[0] for item in chunk)
                lo += b
            self._emit_rows(
                out, positions, counts[rows], ids_b[rows], scores_b[rows], limit
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
        batched gram extraction + slot lookup + posting-mass reduce.  Ends
        with the two lane bounds of ``_slot_mass``: ``s_cap`` (one posting
        list per window: the runs routes) and ``d_cap`` (one per distinct
        slot: ``overlap.gather_hits``)."""
        with span("sslib.prep"):
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
            s_total = d_total = 0
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
                s_total, d_total = self._slot_mass(rowslots)
            s_cap = _next_pow2(max(s_total, 1), 1024)
            d_cap = _next_pow2(max(d_total, 1), 1024)
            return b, qtok, qlens, slots, nqg, use_short, s_cap, d_cap

    def _slot_mass(self, rowslots: np.ndarray) -> tuple:
        """``slot_mass`` over the index's posting lengths."""
        return slot_mass(self.host.host_posting_lens, rowslots)

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
        with span("sslib.prep"):
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

    def _emit_rows(self, out, positions, counts, ids_b, scores_b, limit):
        """Results of the rows of one fetch (``positions[r]`` answered by
        row r): one key decode and one score conversion for them all,
        then ``_emit_row`` per row with its slices."""
        n = np.clip(counts, 0, min(limit, ids_b.shape[1]))
        kept = np.arange(ids_b.shape[1]) < n[:, None]
        keys, slow = self.host.key_strings.take_flat(ids_b[kept])
        self._call["emit_slow_keys"] += slow
        scores = scores_b[kept].astype(np.float64).tolist()
        lo = 0
        for pos, hi in zip(positions, np.cumsum(n).tolist()):
            self._emit_row(out, pos, keys[lo:hi], scores[lo:hi])
            lo = hi

    def _emit_row(self, out, pos, keys, scores):
        out[pos] = (keys, scores)

    def _emit_one(self, count, ids_np, scores_np, limit):
        """The results of a single query: row 0 of a fetched block."""
        out = [None]
        self._emit_rows(out, [0], count[:1], ids_np[:1], scores_np[:1], limit)
        return out[0]

    def _run_dense_chunks(self, items, threshold, limit, batch_bucket, qp, out):
        self._call["dense_rows"] += len(items)
        di = self.host.device
        top_k = self._top_k(limit)
        batch_bucket = self._batch_cap(batch_bucket)
        pending = []
        for lo in range(0, len(items), batch_bucket):
            chunk = items[lo : lo + batch_bucket]
            b, qtok, qlens, slots, nqg, use_short, _, d_cap = self._prep_rows(
                chunk, qp
            )
            promo = self._promo_array(chunk, b)
            kw = dict(compute_short=bool(use_short.any()), s_cap=d_cap,
                      top_k=top_k)
            with span("sslib.dispatch"):
                block, = self._run_chain(
                    _dense_chain(search_batch_device_impl, di, **kw),
                    [qtok, qlens, slots, nqg, use_short, promo], threshold,
                    route="dense", tables=(di,), **kw,
                )
                pending.append((chunk, b, block))
        self._emit_dense(pending, limit, out)

    # device-memory budget for the dense gram->term incidence of the
    # gram-matrix route (int8, G * Tl bytes)
    GM_BUDGET = 4 << 30
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
    # device-memory budget for the bucket sketch (search.sketch); D shrinks
    # to fit, floor 128 buckets.  SKETCH_PACKED takes the packed sketch
    # (K2) for queries of <= 127 gram windows; the rest, or every batch
    # without it, take the unpacked one (torch._int_mm)
    SKETCH_BUDGET = 6 << 30
    SKETCH_MIN_TERMS = 200_000
    SKETCH_PACKED = True
    # sketch first-pass budgets: superblocks and blocks kept per query
    SK_KSB = 512
    SK_KB = 1024
    # batches this small on large indexes without a gram matrix take the
    # sorted-runs route (tiny_runs) when each query's posting mass fits
    # RUNS_TINY_LANES: their cost follows the queries' postings, where the
    # bitmap and sketch routes stream a whole table per dispatch
    RUNS_TINY_BATCH = 8
    RUNS_TINY_LANES = 1 << 20
    # batches of at most GATHER_BATCH queries may take the gathered-row
    # route (candidates_bitmap_gather): the gather kernel copies the batch's
    # gram-union rows (<= GATHER_ROWS_MAX) out of the resident table and K1
    # runs on that compact table.  The reference takes it on row-major
    # tables only; resident tables are tile-major, so BITMAP_GATHER_TMAJ
    # forces it (the reference's switch, off by default)
    GATHER_BATCH = 8
    GATHER_ROWS_MAX = 512
    BITMAP_GATHER_TMAJ = False
    # the fused block-max epilogue (K1) on the non-h* blockmax finish:
    # forced by BITMAP_FUSED_BMAX, else taken once the padded long tier
    # reaches BITMAP_FUSED_MIN_TLP lanes; the h* finish always takes it.
    # BITMAP_BMAX_BLK is block_hmax's block width on the K2 blockmax
    # finish; BITMAP_KB_LANES > 0 fixes that finish's kept-lane budget
    # (0 = n_cand blocks).  All at the reference's values
    BITMAP_FUSED_BMAX = False
    BITMAP_FUSED_MIN_TLP = 4 << 20
    BITMAP_BMAX_BLK = 128
    BITMAP_KB_LANES = 0

    def _run_candidate_chunks(self, items, threshold, limit, batch_bucket, qp, out):
        """Candidate batches; returns the rows that need the dense path.

        The first pass selects at CAND_TERMS_FAST-scale budgets.  Rows whose
        exactness guard fails re-select at CAND_TERMS-scale budgets: from
        the retained hits on the full-table h* route (selection only, no
        second table stream), through one full second pass on every other
        route (which records ``retry_full``).  Rows that still fail go
        dense."""
        retry, n_used, n_avail, sel_ctx = self._cand_pass(
            items, threshold, limit, batch_bucket, qp, out,
            self.CAND_TERMS_FAST,
        )
        n_retry_fast = len(retry)
        n_sel = None
        if retry and sel_ctx is not None:
            retry = self._hstar_sel_retry(sel_ctx, threshold, limit, out)
            n_sel = len(retry)
        elif retry and n_used < min(self.CAND_TERMS, n_avail):
            retry, _, _, _ = self._cand_pass(
                retry, threshold, limit, batch_bucket, qp, out,
                self.CAND_TERMS,
            )
            self.last_routing["retry_full"] = len(retry)
        if n_sel is not None:
            self.last_routing["retry_sel"] = n_sel
        self.last_routing["retry_fast"] = n_retry_fast
        self.last_routing["n_items"] = len(items)
        self._call["retry_fast"] += n_retry_fast
        return retry

    def _hstar_sel_retry(self, sel_ctx, threshold, limit, out):
        """Re-select guard-failed rows from the retained first-pass hits at
        the escalated budgets.  Returns the rows whose guard still fails."""
        fails = sel_ctx["fails"]  # [(item, chunk_idx, row_in_chunk, grow)]
        with span("sslib.prep"):
            b_r = _next_pow2(len(fails), 8)
            pad = b_r - len(fails)
            # grouped by chunk so each chunk contributes one gather; pad rows
            # replicate the last entry (their outputs are ignored)
            order = sorted(range(len(fails)), key=lambda fi: fails[fi][1])
            rows = order + [order[-1]] * pad
            groups = []  # (chunk index, its rows to gather)
            lo = 0
            while lo < len(rows):
                ci = fails[rows[lo]][1]
                hi = lo
                while hi < len(rows) and fails[rows[hi]][1] == ci:
                    hi += 1
                groups.append(
                    (ci, np.asarray([fails[fi][2] for fi in rows[lo:hi]], np.int64))
                )
                lo = hi
            grows = np.asarray([fails[fi][3] for fi in rows], np.int64)
            lim_arr = np.full((b_r,), min(limit, 2**30), dtype=np.int32)
            scale = max(self.CAND_TERMS // self.CAND_TERMS_FAST, 1)
            n_lanes = sel_ctx["n_lanes"]
            n_cand = min(self.CAND_TERMS, max(_next_pow2(n_lanes, 16), 16), n_lanes)
        di, pt, xt = self.host.device, sel_ctx["pt"], sel_ctx["xt"]
        kw = dict(
            compute_short=sel_ctx["compute_short"], kb1=self.HSTAR_KB1 * scale,
            kb2=self.HSTAR_KB2 * scale, n_cand=n_cand, top_k=sel_ctx["top_k"],
            n_edge=sel_ctx["n_edge"], vmax=sel_ctx["vmax"],
        )

        def chain(t, thr):
            res = hstar_retry(di, t[8], t[9], pt, xt, *t[:8], thr, **kw)
            return (_pack(res[0], res[1], res[2], res[4]),)

        with span("sslib.dispatch"):
            hit_parts, hmax_parts = [], []
            for ci, sel in groups:
                idx = self._t(sel)
                hits_ref, hmax_ref = sel_ctx["chunks"][ci]
                hit_parts.append(hits_ref.index_select(0, idx))
                hmax_parts.append(hmax_ref.index_select(0, idx))
            arrays = [sel_ctx[name][grows] for name in (
                "qtok", "qlens", "nqg", "use_short", "promo_all", "promo_t",
                "promo_w")]
            block, = self._run_chain(
                chain, arrays + [lim_arr], threshold, route="hstar_retry",
                tables=(di, pt, xt),
                dev_arrays=(torch.cat(hit_parts, 0), torch.cat(hmax_parts, 0)),
                **kw,
            )
        fetched = _fetch([block])
        with span("sslib.emit"):
            counts, ids_b, scores_b, exact = _unpack(
                fetched, (fetched.shape[1] - 2) // 2, True
            )
            exact = exact.tolist()
            rows, positions, still = [], [], []
            for pos, fi in enumerate(order):
                item = fails[fi][0]
                if exact[pos]:
                    rows.append(pos)
                    positions.append(item[0])
                else:
                    still.append(item)
            self._emit_rows(
                out, positions, counts[rows], ids_b[rows], scores_b[rows], limit
            )
        return still

    def _gather_rows_plan(self, slots: np.ndarray):
        """Gathered-row plan for a small batch: (rows (gc,) int32 table rows
        to gather, slot matrix remapped into [0, gc), gc) or None when the
        gram union is empty or exceeds GATHER_ROWS_MAX.  gc is a power of
        two >= 32 (K1's Gp rule); padding rows duplicate row 0 and no
        remapped slot references them."""
        used = np.unique(slots[slots >= 0])
        if used.size == 0 or used.size > self.GATHER_ROWS_MAX:
            return None
        gc = _next_pow2(int(used.size), 32)
        rows = np.zeros(gc, np.int32)
        rows[: used.size] = used
        out = np.full(slots.shape, -1, np.int32)
        mask = slots >= 0
        out[mask] = np.searchsorted(used, slots[mask]).astype(np.int32)
        return rows, out, gc

    def _cand_pass(self, items, threshold, limit, batch_bucket, qp, out, cand_cap):
        """One candidate sweep at selection width ``cand_cap``.

        The reference's gates, in the reference's order:

          * the dense gram matrix fits GM_BUDGET: ``matmul``, one product
            of the batch's gram multiplicities with it, then the h* finish
            where every edge weight is 1, queries hold <= 127 gram windows
            and the lane space dwarfs the h* budgets, else the dense-hits
            finish;
          * tiny runs: at most RUNS_TINY_BATCH queries whose posting mass
            fits RUNS_TINY_LANES, on an index of >= SKETCH_MIN_TERMS terms
            without a gram matrix: ``tiny_runs``, the sorted-runs route, and
            no table is built;
          * the packed table fits BITMAP_BUDGET: the bitmap routes.  Queries
            of more than 127 gram windows take ``bitmap_scan``, K2w's int32
            hits and the dense-hits finish (``block_sel`` where the lane
            space dwarfs n_cand blocks).  Queries of <= 127 gram windows
            take the kernel routes: with BITMAP_GATHER_TMAJ, batches of
            <= GATHER_BATCH queries whose gram union fits GATHER_ROWS_MAX
            take ``bitmap_gather`` (the gather kernel, then K1 on the
            compact table); the rest ``bitmap_kernel`` over the whole table.
            The finish is h* where every edge weight is 1 and the lane space
            dwarfs the h* budgets; else the blockmax finish where it dwarfs
            n_cand blocks (``block_sel``; fused K1 block maxima when
            ``fused_bmax``, else K2 and ``block_hmax``); else K2 and the
            dense-hits finish.  As in the reference, h* eligibility forces
            ``fused_bmax`` before the lane-space check can turn h* off;
          * the packed table does not fit, the index holds >=
            SKETCH_MIN_TERMS terms and the sketch fits SKETCH_BUDGET: with
            SKETCH_PACKED and queries of <= 127 gram windows
            ``sketch_packed``, K2 over the packed bucket sketch; else (or
            when the packed table does not fit) ``sketch``, one
            ``torch._int_mm`` per base-128 digit of the bucket counts over
            the unpacked sketch; both then rescore exactly;
          * none of these: ``runs``, the sorted-runs route.

        ``bitmap_scan`` takes any window count, as the reference's scan
        does: K2w counts a row's sums in parts of at most WIDE_MAX_SUM, one
        launch a part, adding into the same int32 hits, so a batch of
        queries of 64K characters and more keeps the route and needs no
        second hits buffer.
        Returns (rows for the dense path, n_cand, selectable lanes, retry
        context)."""
        di = self.host.device
        ts, tl = di.n_short, di.n_long
        x_total = int(di.extra_key.shape[0])
        n_edge = min(
            max(_next_pow2(max(x_total, 1), 16), 16), self.CAND_EDGES
        )
        top_k = _next_pow2(limit, 16)

        b_all, qtok, qlens, slots, nqg, use_short, s_cap, _ = self._prep_rows(
            items, qp
        )
        compute_short = bool(use_short.any())
        short_lanes = ts if compute_short else 0
        hs_scale = max(cand_cap // self.CAND_TERMS_FAST, 1)
        hs_kb1 = self.HSTAR_KB1 * hs_scale
        hs_kb2 = self.HSTAR_KB2 * hs_scale
        hs_fill = self.HSTAR_FILL if cand_cap == self.CAND_TERMS_FAST else 0
        int8_counts = slots.shape[1] <= 127  # K1/K2 count contract
        uniform_hstar = self.HSTAR_SEL and self.host.uniform_weights
        gm = self.host.gram_matrix(self.GM_BUDGET)
        tiny_runs = (
            gm is None
            and self.host.n_terms >= self.SKETCH_MIN_TERMS
            and len(items) <= self.RUNS_TINY_BATCH
            and s_cap <= self.RUNS_TINY_LANES
        )
        bm = sk = None
        sk_packed = False
        if gm is None and not tiny_runs:
            bm = self.host.bitmap_tables(self.BITMAP_BUDGET)
            if bm is None and self.host.n_terms >= self.SKETCH_MIN_TERMS:
                sk_packed = self.SKETCH_PACKED and int8_counts
                if sk_packed:
                    sk = self.host.sketch_tables(self.SKETCH_BUDGET)
                if sk is None:
                    sk_packed = False
                    sk = self.host.sketch_tables(self.SKETCH_BUDGET, packed=False)
        gplan = None
        bm_hstar = gm_hstar = False
        if gm is not None:
            variant = "matmul"
            n_lanes = short_lanes + tl
            gm_hstar = uniform_hstar and int8_counts
            per_q = 48 * (ts + tl) + 24 * n_edge + (1 << 16)
        elif bm is not None and not int8_counts:
            variant = "bitmap_scan"
            tlp = int(bm[1])
            n_lanes = short_lanes + tlp
            bm_fused = False
            # the reference's budget charges 8 B a lane; the port's hits
            # and dense-hits finish hold _SCAN_LANE_BYTES a lane at their
            # peak, so the step is sized from that
            per_q = (
                _SCAN_LANE_BYTES * tlp + 24 * n_edge + 48 * short_lanes
                + (1 << 16)
            )
        elif bm is not None:
            tlp = int(bm[1])
            n_lanes = short_lanes + tlp
            if len(items) <= self.GATHER_BATCH and self.BITMAP_GATHER_TMAJ:
                gplan = self._gather_rows_plan(slots)
            variant = "bitmap_kernel" if gplan is None else "bitmap_gather"
            bm_fused = self.BITMAP_FUSED_BMAX or tlp >= self.BITMAP_FUSED_MIN_TLP
            if uniform_hstar:
                bm_fused = True
            # the reference's budget: the hits (twice where block_hmax
            # takes a separate pass) and ~16 B per kept lane of the
            # finish's gathers
            blk_eff = _BLK if bm_fused else self.BITMAP_BMAX_BLK
            kept = hs_kb2 if uniform_hstar else cand_cap
            per_q = (
                (tlp if bm_fused else 2 * tlp) + 16 * kept * blk_eff
                + 24 * n_edge + 48 * short_lanes + (1 << 16)
            )
            bm_hstar = uniform_hstar and n_lanes >= 4 * hs_kb2 * _BLK
        elif sk is not None:
            variant = "sketch_packed" if sk_packed else "sketch"
            n_lanes = short_lanes + tl
            # the reference's sketch budget, both forms; the port holds the
            # hits and ~14 B per kept block lane, its block maxima and the
            # unpacked product built in fixed-size slabs (search.sketch)
            per_q = (
                3 * int(sk[1].shape[0]) + 24 * n_edge + 48 * short_lanes
                + (1 << 16)
            )
        else:
            variant = "tiny_runs" if tiny_runs else "runs"
            n_lanes = short_lanes + s_cap
            per_q = 48 * s_cap + 24 * n_edge + 48 * short_lanes + (1 << 16)
        n_cand = min(cand_cap, max(_next_pow2(n_lanes, 16), 16), n_lanes)
        block_sel = bool(n_lanes >= 4 * n_cand * _BLK)
        cap = max(int(self.BATCH_HBM_BUDGET // per_q), 8)
        step = 8
        while step * 2 <= min(cap, batch_bucket):
            step *= 2
        pt, xt = self.host.prim_tables()
        bm_gather = gplan is not None
        keep_sel = variant == "bitmap_kernel" and bm_hstar and (
            cand_cap == self.CAND_TERMS_FAST
        )
        self.last_routing = {
            "variant": variant,
            "step": step,
            "n_cand": n_cand,
            "block_sel": block_sel,
        }
        hs_kw = dict(hstar=True, kb1=hs_kb1, kb2=hs_kb2, hs_fill=hs_fill)
        bm_slots = slots
        extra = []  # the gathered route's table rows, an input of each chunk
        # the route's function, the resident tables before the chunk's
        # inputs, and its keywords (every one fixed at trace time)
        kw = dict(compute_short=compute_short, n_cand=n_cand, n_edge=n_edge,
                  top_k=top_k)
        graph = True
        if gm is not None:
            gm_hstar = gm_hstar and n_lanes >= 4 * hs_kb2 * _BLK
            self.last_routing["hstar"] = bool(gm_hstar)
            cand_fn, tables = candidates_matmul, (di, gm, pt, xt)
            kw.update(block_sel=block_sel, **(hs_kw if gm_hstar else {}))
        elif bm is not None:
            bm_table = bm[0]
            self.last_routing.update(
                gp_rows=int(bm_table.shape[1]),
                fused_bmax=bool(bm_fused and not bm_gather),
                hstar=bool(bm_hstar),
            )
            kw.update(block_sel=block_sel)
            if bm_hstar:
                self.last_routing.update(kb1=hs_kb1, kb2=hs_kb2)
                kw.update(hs_kw)
            if variant == "bitmap_scan":
                # K2w reads its row sums back to size its parts: eager
                cand_fn, graph = candidates_bitmap, False
                tables = (di, bm_table, pt, xt)
            elif bm_gather:
                g_rows, bm_slots, g_gc = gplan
                self.last_routing["gather_rows"] = int(g_gc)
                extra = [g_rows]
                cand_fn, tables = candidates_bitmap_gather, (di, bm_table, pt, xt)
            else:
                cand_fn, tables = candidates_bitmap_mxu, (di, bm_table, pt, xt)
                kw.update(fused_bmax=bm_fused, bmax_blk=self.BITMAP_BMAX_BLK,
                          kb_lanes=self.BITMAP_KB_LANES, keep_hits=keep_sel)
                # the hits kept for the selection retry outlive the chunk,
                # and a graph's next replay overwrites its outputs: eager
                graph = not keep_sel
        elif sk is not None:
            inc, tg, wmax_pad, d_log2 = sk
            # superblock count from the TERM width (tg rows), not the
            # packed table's byte width
            sb = max(int(tg.shape[0]) // (_BLK * 128), 1)
            ksb = min(self.SK_KSB * hs_scale, sb)
            kb = min(self.SK_KB * hs_scale, ksb * 128)
            n_short_cand = min(
                max(_next_pow2(min(ts, 512), 16), 16), max(ts, 1)
            )
            cand_fn, tables = candidates_sketch, (di, inc, tg, wmax_pad, pt, xt)
            kw.update(d_log2=d_log2, n_cand=min(n_cand, kb * 128),
                      n_short_cand=n_short_cand, ksb=ksb, kb=kb,
                      packed=sk_packed)
        else:
            cand_fn, tables = candidates_runs, (di, pt, xt)
            kw.update(s_cap=s_cap, block_sel=block_sel)

        def chain(t, thr):
            # t: qtok, qlens, slots, nqg, use_short, promo, promo_t,
            # promo_w, limits, then the gathered route's rows
            if bm_gather:
                res = cand_fn(di, bm_table, t[9], pt, xt, *t[:9], thr, **kw)
            else:
                res = cand_fn(*tables, *t, thr, **kw)
            block = _pack(res[0], res[1], res[2], res[4])
            return (block, *res[5:]) if keep_sel else (block,)

        with span("sslib.prep"):
            promo_all = np.full((b_all, self.PROMO_KEYS), -1, dtype=np.int32)
            for r, item in enumerate(items):
                pids = item[3]
                promo_all[r, : pids.size] = pids
            promo_t, promo_w = self._promo_tables(promo_all)

        # every chunk is queued before any result is fetched; each chunk's
        # rows of the batch's arrays go to the device as its chain's inputs
        with span("sslib.dispatch"):
            batch = (qtok, qlens, bm_slots, nqg, use_short, promo_all, promo_t,
                     promo_w)
            # the gathered route pads its chunks to 8 queries, tiny runs to
            # a power of two from 1, the others to 16
            min_b = 1 if tiny_runs else (8 if bm_gather else 16)
            pending = []
            for lo in range(0, len(items), step):
                hi = min(lo + step, len(items))
                b = _next_pow2(hi - lo, min(step, min_b))
                lims = np.full((b,), min(limit, 2**30), np.int32)
                res = self._run_chain(
                    chain, [x[lo : lo + b] for x in batch] + [lims] + extra,
                    threshold, route=variant, tables=tables, graph=graph, **kw,
                )
                pending.append((lo, hi, res[0], res[1:] if keep_sel else None))

        # ONE fetch for every chunk
        fetched = _fetch([blk for _, _, blk, _ in pending])
        width = (fetched.shape[1] - 2) // 2
        retry = []
        fails = []
        row0 = 0
        with span("sslib.emit"):
            counts, ids_b, scores_b, exact = _unpack(fetched, width, True)
            exact = exact.tolist()
            rows, positions = [], []
            for k, (lo, hi, blk, _) in enumerate(pending):
                for r, item in enumerate(items[lo:hi]):
                    if exact[row0 + r]:
                        rows.append(row0 + r)
                        positions.append(item[0])
                    else:
                        retry.append(item)
                        if keep_sel:
                            fails.append((item, k, r, lo + r))
                row0 += blk.shape[0]
            self._emit_rows(
                out, positions, counts[rows], ids_b[rows], scores_b[rows], limit
            )
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
