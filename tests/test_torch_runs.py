"""The sorted-runs front end of the PyTorch port (``candidates_runs``: the
postings expansion through kernel K6's plain version, batched sorts into
runs, the short tier through kernel K5's plain version) against the JAX
package's ``candidates_runs_impl`` on the same index arrays, and the
engine's ``runs`` and ``tiny_runs`` routes end to end against the JAX engine
and the oracle.

Tolerances: counts, ids and exact flags identical, float32 scores exactly
equal on exact rows.  ``torch.topk`` and ``lax.top_k`` may keep different
equal values, so a row's exact flag and count may differ only where a numpy
recomputation shows a selection tie straddling a cutoff.  Engine results are
compared as (score, key length) tie groups."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringsearchlib_tpu.config import IndexConfig as JConfig
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.search import candidates as jc
from stringsearchlib_tpu.search.engine import SearchEngine as JEngine
from stringsearchlib_tpu.utils.oracle import OracleIndex
from stringsearchlib_tpu_torch.config import IndexConfig
from stringsearchlib_tpu_torch.index.build import build_index as pbuild
from stringsearchlib_tpu_torch.ops import dp_match as pdp
from stringsearchlib_tpu_torch.ops import vgather as pvg
from stringsearchlib_tpu_torch.search import candidates as pc
from stringsearchlib_tpu_torch.search.engine import SearchEngine as PEngine

THRESHOLD = np.float32(0.25)
LIMIT = 10
TOP_K = 16
_NEG_INF = np.float32(-np.inf)


def _corpus(n, seed=21):
    rng = random.Random(seed)
    syll = ["ka", "lo", "me", "ri", "su", "ta", "ve", "nor", "bel"]
    return [
        "".join(rng.choice(syll) for _ in range(rng.randint(2, 5)))
        for _ in range(n)
    ]


def _weighted(n=2500, seed=21):
    words = sorted(set(_corpus(n, seed=seed)))
    rng = np.random.default_rng(seed)
    weights = rng.choice([1.0, 0.4, 0.0], size=len(words), p=[0.6, 0.3, 0.1])
    weights[np.array([len(w) >= 11 for w in words])] = -0.5
    return words, weights


def _groups(res):
    out: dict = {}
    for k, s in zip(*res):
        out.setdefault((round(float(s), 5), len(k)), set()).add(k)
    return out


def _counts(res):
    return sorted((round(float(s), 5), len(k)) for k, s in zip(*res))


@pytest.fixture(scope="module")
def case():
    """One weighted index built by both packages and 16 queries (short, long
    and 11+ character ones) prepared by the JAX engine's host front end."""
    words, weights = _weighted()
    jh = jbuild(words, 1, weights, JConfig())
    ph = pbuild(words, 1, weights, IndexConfig(), device="cpu")
    eng = JEngine(jh)
    rng = random.Random(13)
    longs = [w for w in words if len(w) >= 11]
    queries = [rng.choice(words) for _ in range(8)]
    queries = [q if i % 2 else q[:-1] + "x" for i, q in enumerate(queries)]
    queries += [w[:-2] for w in rng.sample(longs, 4)] + ["kalo", "rime", "sutave", "nor"]
    items = []
    for pos, q in enumerate(queries):
        qnorm, qlen = eng._normalize_query(q)
        items.append((pos, qnorm, qlen, jh.promo_key_ids(qnorm, qlen)))
    b, qtok, qlens, slots, nqg, use_short, s_cap = eng._prep_rows(items, 32)
    assert use_short.any()
    promo = np.full((b, eng.PROMO_KEYS), -1, np.int32)
    for r, it in enumerate(items):
        promo[r, : it[3].size] = it[3]
    promo_t, promo_w = eng._promo_tables(promo)
    host = dict(
        qtok=qtok, qlens=qlens, slots=slots, nqg=nqg, use_short=use_short,
        promo=promo, promo_t=promo_t, promo_w=promo_w,
        lim=np.full((b,), LIMIT, np.int32), s_cap=int(s_cap),
    )
    return jh, ph, host


_KEYS = ("qtok", "qlens", "slots", "nqg", "use_short", "promo", "promo_t",
         "promo_w", "lim")


def _runs_bounds(ph, h, compute_short):
    """numpy recomputation of the route's lanes: each query's postings
    sorted by term id, a run's first lane carrying wmax * hits / nqg where
    the term passes, every other lane -inf; the short tier's bounds first."""
    d = ph.device
    ptr, terms = d.gram_ptr.numpy(), d.gram_terms.numpy()
    wl = d.term_wmax[d.n_short:].numpy()
    s_cap = h["s_cap"]
    rows = []
    for r in range(h["slots"].shape[0]):
        tids = np.sort(np.concatenate(
            [terms[ptr[s]:ptr[s + 1]] for s in h["slots"][r] if s >= 0] + [np.zeros(0, np.int32)]
        ))[:s_cap]
        u = np.full(s_cap, _NEG_INF, np.float32)
        t, start, hits = np.unique(tids, return_index=True, return_counts=True)
        nqg = h["nqg"][r]
        s = hits.astype(np.float32) / np.float32(max(nqg, 1))
        ok = (nqg > 0) & (s >= THRESHOLD)
        u[start[ok]] = wl[t[ok]] * s[ok]
        rows.append(u)
    u = np.stack(rows)
    if compute_short:
        qlen_f = torch.clamp(torch.from_numpy(h["qlens"]).float(), min=1.0)
        u_short = pc._short_tier(
            d, torch.from_numpy(h["qtok"]), torch.from_numpy(h["qlens"]),
            torch.from_numpy(h["use_short"]), float(THRESHOLD), qlen_f,
        )[2].numpy()
        u = np.concatenate([u_short, u], 1)
    return u


def _straddles(v, k):
    if k >= v.size:
        return False
    vk = np.sort(v)[::-1][k - 1]
    return bool(vk > _NEG_INF and (v >= vk).sum() > k)


def _kept(v, k):
    if k >= v.size:
        return np.flatnonzero(v > _NEG_INF)
    vk = np.sort(v)[::-1][k - 1]
    return np.flatnonzero((v >= vk) & (v > _NEG_INF))


def _tie_rows(u, n_cand, block_sel):
    ties = set()
    for r in range(u.shape[0]):
        if not block_sel:
            if _straddles(u[r], n_cand):
                ties.add(r)
            continue
        nb = -(-u.shape[1] // 128)
        up = np.full(nb * 128, _NEG_INF, np.float32)
        up[: u.shape[1]] = u[r]
        up = up.reshape(nb, 128)
        kb = min(n_cand, nb)
        if _straddles(up.max(1), kb):
            ties.add(r)
        elif _straddles(up[_kept(up.max(1), kb)].ravel(), min(n_cand, kb * 128)):
            ties.add(r)
    return ties


@pytest.mark.parametrize("compute_short,n_cand,block_sel", [
    (True, 4096, False),
    (False, 4096, False),
    (True, 32, False),
    (True, 16, True),
    (False, 16, True),
], ids=["short_covering", "long_covering", "short_starved", "block_sel", "long_block_sel"])
def test_candidates_runs_matches_jax(case, compute_short, n_cand, block_sel):
    jh, ph, h = case
    covering = n_cand >= 4096
    n_cand = min(n_cand, (ph.device.n_short if compute_short else 0) + h["s_cap"])
    kw = dict(compute_short=compute_short, s_cap=h["s_cap"], n_cand=n_cand,
              n_edge=32, top_k=TOP_K, block_sel=block_sel)
    pt_j, xt_j = jh.prim_tables()
    want = [np.asarray(x) for x in jc.candidates_runs(
        jh.device, pt_j, xt_j, *[jnp.asarray(h[k]) for k in _KEYS], THRESHOLD, **kw
    )]
    pt_p, xt_p = ph.prim_tables()
    calls = (pvg.K6_REF_CALLS, pdp.K5_REF_CALLS)
    got = [x.numpy() for x in pc.candidates_runs(
        ph.device, pt_p, xt_p,
        *[torch.from_numpy(np.ascontiguousarray(h[k])) for k in _KEYS], THRESHOLD, **kw,
    )]
    assert (pvg.K6_REF_CALLS, pdp.K5_REF_CALLS) == (
        calls[0] + 1, calls[1] + int(compute_short)
    )
    ties = _tie_rows(_runs_bounds(ph, h, compute_short), n_cand, block_sel)
    differ = set(np.flatnonzero((got[4] != want[4]) | (got[0] != want[0])))
    assert differ <= ties, (sorted(differ), sorted(ties))
    both = np.flatnonzero(got[4] & want[4])
    assert both.size
    if covering:
        assert got[4].all() and want[4].all()
    else:
        assert not got[4].all(), "the starved budgets left every row exact"
    for r in both:
        n = min(int(got[0][r]), TOP_K)
        assert min(int(want[0][r]), TOP_K) == n
        for i in (1, 2, 3):  # ids, float32 scores, key lengths
            np.testing.assert_array_equal(got[i][r][:n], want[i][r][:n])


# ---------------------------------------------------------------------------
# the engine's runs routes
# ---------------------------------------------------------------------------


_ROUTE_KEYS = ("variant", "step", "n_cand", "block_sel")


def _force(eng, route):
    eng.GM_BUDGET = 0
    eng.BITMAP_BUDGET = 0
    eng.CAND_MIN_TERMS = 100
    eng.SKETCH_MIN_TERMS = 10**9 if route == "runs" else 1


def _engine_case(words, weights, cfg_kw, route, nq, seed, starved=False):
    jh = jbuild(words, 1, weights, JConfig(**cfg_kw))
    ph = pbuild(words, 1, weights, IndexConfig(**cfg_kw), device="cpu")
    je, pe = JEngine(jh), PEngine(ph)
    for eng in (je, pe):
        _force(eng, route)
        if starved:
            eng.CAND_TERMS_FAST, eng.CAND_TERMS = 4, 16
    rng = random.Random(seed)
    queries = []
    for i in range(nq):
        w = words[rng.randrange(len(words))]
        j = rng.randrange(max(len(w) - 1, 1))
        queries.append(w if i % 3 == 0 else w[:j] + "x" + w[j + 1:])
    return jh, ph, je, pe, queries


@pytest.mark.parametrize("route,weighted,starved", [
    ("runs", False, False),
    ("runs", True, False),
    ("runs", True, True),
    ("tiny_runs", False, False),
    ("tiny_runs", True, False),
], ids=["runs_uniform", "runs_weighted", "runs_retry", "tiny_uniform", "tiny_weighted"])
def test_engine_runs_routes_match_jax_and_oracle(route, weighted, starved):
    words, weights = _weighted(2000, seed=31) if weighted else (_corpus(2000, seed=31), None)
    nq = 24 if route == "runs" else 6
    jh, ph, je, pe, queries = _engine_case(words, weights, {}, route, nq, 5, starved)
    calls = (pvg.K6_REF_CALLS, pdp.K5_REF_CALLS)
    got = pe.search_batch(queries, 0.25, 10, mode="candidates")
    want = je.search_batch(queries, 0.25, 10, mode="candidates")
    for k in _ROUTE_KEYS:
        assert pe.last_routing[k] == je.last_routing[k], k
    assert pe.last_routing["variant"] == route
    assert pvg.K6_REF_CALLS > calls[0]
    if starved:
        assert pe.last_routing["retry_fast"] > 0 and "retry_full" in pe.last_routing
    # the runs routes build no table
    assert ph._bitmap_cache is None or ph._bitmap_cache is False
    assert ph._sketch_cache is None
    oracle = OracleIndex(words, row_size=1, weights=None if weights is None else list(weights))
    dense = je.search_batch(queries, 0.25, 10, mode="dense")
    for q, g, w, d in zip(queries, got, want, dense):
        assert _groups(g) == _groups(w) == _groups(d), q
        assert _counts(g) == _counts(oracle.search(q, 0.25, 10)), q


def _wide_words(n=1500, seed=3):
    rng = np.random.default_rng(seed)
    pool = [chr(c) for c in range(0x4E00, 0x4E18)] + list("àáâäåçèéêë") + list("abcdefghij ")
    lens = rng.integers(4, 14, n)
    out = ["".join(rng.choice(pool, size=k)).strip() or "pad" for k in lens]
    return sorted(set(out))


def test_engine_wide_g3_routes_runs():
    """A wide gram-size-3 index (the shape of wide_100k_g3) whose packed
    bitmap is over budget and whose term count is under SKETCH_MIN_TERMS
    takes the sorted runs, as the reference's does."""
    words = _wide_words()
    jh, ph, je, pe, queries = _engine_case(
        words, None, dict(wide=True, gram_size=3), "runs", 20, 9
    )
    assert ph.device.long_tokens.dtype == torch.int32
    got = pe.search_batch(queries, 0.3, 10, mode="candidates")
    want = je.search_batch(queries, 0.3, 10, mode="candidates")
    assert pe.last_routing["variant"] == je.last_routing["variant"] == "runs"
    dense = pe.search_batch(queries, 0.3, 10, mode="dense")
    for q, g, w, d in zip(queries, got, want, dense):
        assert _groups(g) == _groups(w) == _groups(d), q


def test_tiny_runs_gate_matches_jax():
    """The tiny-runs gate in the reference's order: it needs no gram matrix,
    SKETCH_MIN_TERMS terms, at most RUNS_TINY_BATCH queries and a posting
    mass within RUNS_TINY_LANES; it comes before the bitmap (which it never
    builds), and 9 queries leave it."""
    words = _corpus(2500, seed=7)
    jh, ph, je, pe, queries = _engine_case(words, None, {}, "tiny_runs", 9, 3)
    for eng in (je, pe):
        eng.BITMAP_BUDGET = 6 << 30
    cases = [(queries[:8], "tiny_runs"), (queries, "bitmap")]
    for qs, route in cases:
        got = pe.search_batch(qs, 0.25, 10, mode="candidates")
        je.search_batch(qs, 0.25, 10, mode="candidates")
        assert pe.last_routing["variant"].startswith(route)
        assert je.last_routing["variant"].startswith(route)
        if route == "tiny_runs":
            assert ph._bitmap_cache is None
        for q, g, d in zip(qs, got, pe.search_batch(qs, 0.25, 10, mode="dense")):
            assert _groups(g) == _groups(d), q
    pe.RUNS_TINY_LANES = 1  # every query's posting mass is over it
    pe.search_batch(queries[:8], 0.25, 10, mode="candidates")
    assert pe.last_routing["variant"] == "bitmap_kernel"
    pe.RUNS_TINY_LANES = 1 << 20
    pe.GM_BUDGET = 4 << 30
    ph._gram_matrix_cache = None  # the miss is cached per index, like a table
    pe.search_batch(queries[:8], 0.25, 10, mode="candidates")
    assert pe.last_routing["variant"] == "matmul"
