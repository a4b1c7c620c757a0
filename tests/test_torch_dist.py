"""The PyTorch port's term-sharded engine (parallel.dist) against the JAX
package's on the CPU: the reference's tests/test_dist.py and
tests/test_dist_large.py mirrored - the JAX engine on the virtual 8-device
CPU mesh (tests/conftest.py), the port on ``make_mesh(n, device="cpu")``,
both over the same words - plus the sharded leaves bit for bit, the
conversion of the reference's sharded state, each shard's ``with_bound``
outputs on both candidate fronts, and the top-k merge on random inputs.

Results are compared as (score, key length) tie groups and, since every
engine ranks by the total order (score desc, key length asc, key id), as
identical ids and scores; scores are float32 in both packages, compared
exactly."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringsearchlib_tpu.config import IndexConfig as JConfig
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.parallel import dist as jdist
from stringsearchlib_tpu.search import candidates as jc
from stringsearchlib_tpu_torch.config import IndexConfig
from stringsearchlib_tpu_torch.index.build import build_index
from stringsearchlib_tpu_torch.index.convert import (
    host_index_from_arrays, sharded_index_from_arrays,
)
from stringsearchlib_tpu_torch.ops import vgather as pvg
from stringsearchlib_tpu_torch.parallel import dist as pdist
from stringsearchlib_tpu_torch.parallel.dist import (
    ShardedEngine, make_mesh, shard_index,
)
from stringsearchlib_tpu_torch.search import candidates as pc
from stringsearchlib_tpu_torch.search.engine import SearchEngine

FIXTURE = ["LWMS", "LWM", "LWMA", "LWYY", "L", "I", "GHRSDGSDGS Egdsrtg g"]

WORDS = [
    "telephone", "telegraph", "photograph", "telescope", "microphone",
    "phonograph", "graphite", "telephony", "phone", "graph", "tele", "scope",
    "micro", "mic", "LWMS", "LWM", "LWMA", "L", "a b c", "abc def ghi",
]
QUERIES = ["telephon", "graph", "LWMS", "tele", "a", "zz", "abc", "micro phone"]
MASTER_WORDS = ["Widget A", "wdgt", "gadget a", "Widget B", "wb", "small b"]


def _engines(words, n_shards, row_size=1, weights=None):
    """(port single, port sharded, JAX sharded) over the same rows."""
    host = build_index(words, row_size, weights, IndexConfig(), device="cpu")
    jhost = jbuild(words, row_size, weights, JConfig(), to_device=False)
    return (
        SearchEngine(host),
        ShardedEngine(shard_index(host, n_shards), make_mesh(n_shards, device="cpu")),
        jdist.ShardedEngine(jdist.shard_index(jhost, n_shards), jdist.make_mesh(n_shards)),
    )


def _tiegroups(res):
    keys, scores = res
    return sorted((round(s, 5), len(k)) for k, s in zip(keys, scores))


def _same(got, want, what=""):
    """Equal tie groups, then identical ids and scores."""
    assert _tiegroups(got) == _tiegroups(want), what
    assert list(got[0]) == list(want[0]), what
    assert list(got[1]) == list(want[1]), what


@pytest.fixture(scope="module", params=[2, 8])
def small(request):
    """Engines over WORDS at mesh sizes 2 and 8, and the JAX sharded
    engine's batch results for QUERIES at both thresholds (limit 0)."""
    n = request.param
    single, sharded, jsharded = _engines(WORDS, n)
    jres = {thr: jsharded.search_batch(QUERIES, thr, 0) for thr in (0.0, 0.3)}
    return n, single, sharded, jsharded, jres


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("threshold", [0.0, 0.3])
def test_sharded_matches_single(small, query, threshold):
    _, single, sharded, _, jres = small
    got = sharded.search(query, threshold, 0)
    _same(got, single.search(query, threshold, 0), query)
    _same(got, jres[threshold][QUERIES.index(query)], query)


def test_sharded_fixture(small):
    n = small[0]
    single, sharded, jsharded = _engines(FIXTURE, n)
    got = sharded.search("LWMS", 0.5, 0)
    assert got[0] == ["LWMS", "LWM", "LWMA", "LWYY"]
    assert got[1][0] == 100.0
    _same(got, jsharded.search("LWMS", 0.5, 0))


def test_sharded_with_master_rows(small):
    n = small[0]
    single, sharded, jsharded = _engines(MASTER_WORDS, n, row_size=3)
    qs = ["WDGT", "wb", "widget", "*"]
    jres = jsharded.search_batch(qs, 0.0, 0)
    for q, w in zip(qs, jres):
        got = sharded.search(q, 0.0, 0)
        assert got == single.search(q, 0.0, 0)
        _same(got, w, q)


def test_sharded_limit(small):
    _, single, sharded, jsharded, _ = small
    got = sharded.search("graph", 0.2, 3)
    assert got == single.search("graph", 0.2, 3)
    _same(got, jsharded.search("graph", 0.2, 3))


def test_sharded_batch_matches_single(small):
    _, single, sharded, jsharded, _ = small
    queries = ["telephon", "graph", "LWMS", "tele", "zz", "micro phone",
               "*", "", "a", "x" * 40]
    for threshold in (0.0, 0.3):
        got = sharded.search_batch(queries, threshold, 10)
        jgot = jsharded.search_batch(queries, threshold, 10)
        for q, g, jg in zip(queries, got, jgot):
            _same(g, single.search(q, threshold, 10), (q, threshold))
            _same(g, jg, (q, threshold))


def test_sharded_batch_weights(small):
    n = small[0]
    weights = [1.0, 0.5, 0.7, 1.0, 0.2, 0.9]
    single, sharded, jsharded = _engines(MASTER_WORDS, n, row_size=3, weights=weights)
    got = sharded.search_batch(["widget", "gadget"], 0.0, 5)
    jgot = jsharded.search_batch(["widget", "gadget"], 0.0, 5)
    for q, g, jg in zip(["widget", "gadget"], got, jgot):
        assert g == single.search(q, 0.0, 5)
        _same(g, jg, q)


# ---------------------------------------------------------------------------
# tests/test_dist_large.py: a randomized corpus, cross-shard keys, retries
# ---------------------------------------------------------------------------


def _corpus(n, seed=11):
    rng = random.Random(seed)
    syll = ["ba", "do", "ke", "mi", "ra", "tu", "zo", "len", "car", "pix"]
    out = []
    for _ in range(n):
        w = "".join(rng.choice(syll) for _ in range(rng.randint(2, 5)))
        if rng.random() < 0.3:
            w += " " + rng.choice(syll)
        out.append(w)
    return out


@pytest.fixture(scope="module")
def large():
    words = _corpus(3000)
    # row_size 3: every third word is a master key; terms map across rows,
    # so keys collect contributions from terms that land on DIFFERENT shards
    host = build_index(words, 3, None, IndexConfig(), device="cpu")
    jhost = jbuild(words, 3, None, JConfig(), to_device=False)
    sx = shard_index(host, 8)
    jsx = jdist.shard_index(jhost, 8)
    sharded = ShardedEngine(sx, make_mesh(8, device="cpu"))
    jsharded = jdist.ShardedEngine(jsx, jdist.make_mesh(8))
    return SearchEngine(host), sharded, jsharded, words, sx, jsx


def _mutated(words, n, seed):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        w = words[rng.randrange(len(words))]
        if i % 4 == 0:
            out.append(w)
        else:
            j = rng.randrange(max(len(w), 1))
            out.append(w[:j] + "x" + w[j + 1 :])
    return out


def test_no_unsharded_device_leaves(large):
    """The host index stays host-resident and the engine holds only
    per-shard slices: no tensor of an unsharded leaf's size."""
    _, sharded, _, _, sx, _ = large
    assert sharded.host.device.gram_terms.device.type == "cpu"
    shards = sharded._leaves()
    assert len(shards) == 8
    for lv in shards:
        for name, t in lv.items():
            if name in pdist._STACKED:
                assert tuple(t.shape) == sx.leaves[name].shape[1:], name
            else:
                assert name == "key_len", name
        assert not set(pdist.ShardedEngine._HOST_ONLY) & set(lv)


@pytest.mark.parametrize("threshold", [0.0, 0.25, 0.6])
def test_batch_parity_candidates(large, threshold):
    single, sharded, jsharded, words, _, _ = large
    queries = _mutated(words, 120, 5) + ["*", "", "zz", "a", "q" * 40]
    got = sharded.search_batch(queries, threshold, 10)
    assert sharded.last_routing["variant"] == "matmul"
    want = single.search_batch(queries, threshold, 10)
    jgot = jsharded.search_batch(queries, threshold, 10)
    for q, g, w, jg in zip(queries, got, want, jgot):
        assert _tiegroups(g) == _tiegroups(w), (q, threshold)
        _same(g, jg, (q, threshold))


def test_batch_parity_runs_front(large, monkeypatch):
    """The ``runs`` front (gram incidence over GM_BUDGET) on both packages."""
    single, _, _, words, sx, jsx = large
    monkeypatch.setattr(ShardedEngine, "GM_BUDGET", 0)
    monkeypatch.setattr(jdist.ShardedEngine, "GM_BUDGET", 0)
    sharded = ShardedEngine(sx, make_mesh(8, device="cpu"))
    jsharded = jdist.ShardedEngine(jsx, jdist.make_mesh(8))
    queries = _mutated(words, 48, 6)
    pvg.EXPAND_LAUNCHES = pvg.K6_REF_CALLS = 0
    got = sharded.search_batch(queries, 0.25, 10)
    assert sharded.last_routing["variant"] == "runs"
    assert pvg.K6_REF_CALLS >= 8  # one postings expansion per shard
    jgot = jsharded.search_batch(queries, 0.25, 10)
    want = single.search_batch(queries, 0.25, 10)
    for q, g, w, jg in zip(queries, got, want, jgot):
        assert _tiegroups(g) == _tiegroups(w), q
        _same(g, jg, q)


def test_batch_parity_unbounded_limit(large):
    """limit 0 -> INT32_MAX routes the sharded path densely; full parity."""
    single, sharded, jsharded, words, _, _ = large
    qs = [words[7], words[123][:-1] + "z", "bado"]
    jgot = jsharded.search_batch(qs, 0.4, 0)
    for q, jg in zip(qs, jgot):
        got = sharded.search(q, 0.4, 0)
        assert _tiegroups(got) == _tiegroups(single.search(q, 0.4, 0)), q
        _same(got, jg, q)


def test_weighted_rows_parity():
    words = _corpus(600, seed=3)
    weights = [round(0.2 + (i % 9) * 0.1, 2) for i in range(len(words))]
    single, sharded, jsharded = _engines(words, 4, row_size=2, weights=weights)
    rng = random.Random(9)
    queries = [words[rng.randrange(len(words))][:-1] + "q" for _ in range(40)]
    got = sharded.search_batch(queries, 0.2, 8)
    want = single.search_batch(queries, 0.2, 8)
    jgot = jsharded.search_batch(queries, 0.2, 8)
    for q, g, w, jg in zip(queries, got, want, jgot):
        assert _tiegroups(g) == _tiegroups(w), q
        _same(g, jg, q)


@pytest.mark.parametrize("fast,full", [(16, 32), (4, 8)])
def test_forced_narrow_candidates_retry(large, fast, full):
    """A tiny candidate cap forces guard failures (at 4 / 8 lanes on this
    corpus; the reference's test uses 16 / 32); the retries must restore
    exactness."""
    single, sharded, jsharded, words, _, _ = large
    old = (sharded.CAND_TERMS_FAST, sharded.CAND_TERMS)
    jold = (jsharded.CAND_TERMS_FAST, jsharded.CAND_TERMS)
    try:
        sharded.CAND_TERMS_FAST, sharded.CAND_TERMS = fast, full
        jsharded.CAND_TERMS_FAST, jsharded.CAND_TERMS = fast, full
        jsharded._jitted.clear()
        queries = [words[i][:-1] + "z" for i in range(0, 60, 3)]
        got = sharded.search_batch(queries, 0.0, 5)
        assert (sharded.last_routing["retry_fast"] > 0) == (fast == 4)
        want = single.search_batch(queries, 0.0, 5)
        jgot = jsharded.search_batch(queries, 0.0, 5)
        for q, g, w, jg in zip(queries, got, want, jgot):
            assert _tiegroups(g) == _tiegroups(w), q
            _same(g, jg, q)
    finally:
        sharded.CAND_TERMS_FAST, sharded.CAND_TERMS = old
        jsharded.CAND_TERMS_FAST, jsharded.CAND_TERMS = jold
        jsharded._jitted.clear()


# ---------------------------------------------------------------------------
# the sharded state: leaves bit for bit, conversion, meshes
# ---------------------------------------------------------------------------


def _assert_same_leaves(sx, jsx):
    assert (sx.n_shards, sx.ts_c, sx.tl_c) == (jsx.n_shards, jsx.ts_c, jsx.tl_c)
    assert set(sx.leaves) == set(jsx.leaves)
    for name, want in jsx.leaves.items():
        got = sx.leaves[name]
        assert got.shape == want.shape, name
        if want.dtype == np.uint32:  # wide codepoints: the port holds int32
            want = want.astype(np.int32)
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name
    assert np.array_equal(sx.host_shard_posting_lens, jsx.host_shard_posting_lens)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("kind", ["narrow", "wide", "weighted_2d"])
def test_shard_index_leaves_bit_identical(n_shards, kind):
    words = _corpus(400, seed=17)
    row, weights, cfg = 1, None, {}
    if kind == "wide":
        words = [w.replace("a", "á").replace("o", "中") for w in words]
        cfg = {"wide": True}
    elif kind == "weighted_2d":
        row, weights = 2, [1.0, 0.4] * (len(words) // 2)
    host = build_index(words, row, weights, IndexConfig(**cfg), device="cpu")
    jhost = jbuild(words, row, weights, JConfig(**cfg), to_device=False)
    _assert_same_leaves(shard_index(host, n_shards), jdist.shard_index(jhost, n_shards))


def test_sharded_index_from_arrays(large):
    """The reference's ShardedIndex state, converted, drives the port's
    engine to the same results as the port's own sharding."""
    single, sharded, _, words, sx, jsx = large
    jh = jsx.host
    arrays = {f"dev_{f}": np.asarray(getattr(jh.device, f))
              for f in ("short_tokens", "short_lengths", "long_tokens",
                        "long_lengths", "gram_ptr", "gram_terms", "edge_term",
                        "edge_key", "edge_weight", "term_edge_ptr", "term_wmax",
                        "term_prim_key", "term_prim_weight", "term_extra_ptr",
                        "extra_key", "extra_weight", "key_edge_ptr",
                        "key_edge_term", "key_edge_weight", "key_len")}
    arrays.update(
        gram_ids=jh.gram_ids, key_tokens=jh.key_strings.tokens,
        key_lengths=jh.key_strings.lengths,
        host_key_norm_tokens=jh.host_key_norm_tokens,
        host_key_norm_lengths=jh.host_key_norm_lengths,
        host_key_edge_counts=jh.host_key_edge_counts,
    )
    meta = dict(gram_size=jh.config.gram_size, wide=jh.config.wide,
                n_terms=jh.n_terms, max_term_len=jh.max_term_len,
                indexed=jh.indexed)
    host = host_index_from_arrays(arrays, meta, "cpu")
    carried = sharded_index_from_arrays(
        host, jsx.leaves,
        dict(n_shards=jsx.n_shards, ts_c=jsx.ts_c, tl_c=jsx.tl_c),
        jsx.host_shard_posting_lens,
    )
    _assert_same_leaves(carried, jsx)
    engine = ShardedEngine(carried, make_mesh(8, device="cpu"))
    queries = _mutated(words, 32, 12)
    for q, g, w in zip(queries, engine.search_batch(queries, 0.25, 10),
                       sharded.search_batch(queries, 0.25, 10)):
        _same(g, w, q)
    with pytest.raises(KeyError):
        sharded_index_from_arrays(
            host, {k: v for k, v in jsx.leaves.items() if k != "pt"},
            dict(n_shards=8, ts_c=jsx.ts_c, tl_c=jsx.tl_c),
            jsx.host_shard_posting_lens,
        )


def test_meshes_default_to_the_card():
    m = make_mesh(3, device="cpu")
    assert m.shape == (3,) and m.devices == (torch.device("cpu"),) * 3
    assert list(m.shard_ids) == [0, 1, 2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh(2)
        with pytest.raises(RuntimeError):
            ShardedEngine(shard_index(build_index(WORDS, 1, device="cpu"), 2))
    with pytest.raises(ValueError):
        make_mesh(2, device=["cpu"])
    with pytest.raises(ValueError):
        ShardedEngine(shard_index(build_index(WORDS, 1, device="cpu"), 2),
                      make_mesh(3, device="cpu"))


# ---------------------------------------------------------------------------
# per-shard with_bound outputs, and the merge
# ---------------------------------------------------------------------------


def _straddles(u, n_cand):
    """Rows whose n_cand-th largest lane ties lanes outside the selection
    (top-k may keep other equal lanes than lax.top_k)."""
    out = []
    for row in u:
        v = np.sort(row)[::-1]
        if n_cand >= v.size or v[n_cand - 1] == -np.inf:
            out.append(False)
            continue
        cut = v[n_cand - 1]
        out.append(bool((v > cut).sum() < n_cand < (v >= cut).sum()))
    return np.asarray(out)


@pytest.mark.parametrize("front", ["matmul", "runs"])
@pytest.mark.parametrize("narrow", [True, False])
def test_with_bound_matches_jax_per_shard(large, front, narrow):
    """Each shard's (reached, keys, scores, lens, bound) equal to the
    reference's ``*_impl(with_bound=True)`` on the same shard and query
    buffers; with a narrow selection, rows whose cutoff ties straddle it
    compare only their bound."""
    _, sharded, _, words, sx, jsx = large
    queries = _mutated(words, 24, 21)
    items = []
    for pos, q in enumerate(queries):
        qn, ql = sharded._normalize_query(q)
        items.append((pos, qn, ql, sharded.host.promo_key_ids(qn, ql)[:8]))
    b, qtok, qlens, slots, nqg, use_short, s_cap, _ = sharded._prep_rows(items, 32)
    promo = np.full((b, sharded.PROMO_KEYS), -1, np.int32)
    for r, it in enumerate(items):
        promo[r, : it[3].size] = it[3]
    promo_t, promo_w = sharded._promo_tables_sharded(promo)
    lim = np.full(b, 10, np.int32)
    thr = np.float32(0.25)
    g = sharded.host.n_grams
    # narrow: 16 lanes; else every lane the front has
    n_cand = 16 if narrow else (sx.tl_c if front == "matmul" else s_cap)
    kw = dict(compute_short=False, n_cand=n_cand, n_edge=64, top_k=16,
              block_sel=False)
    shards = sharded._leaves()

    @jax.jit
    def jfn(jlv, gm, *a):
        jdi = jdist._ShardView(jlv, strip=True)
        pt, xt = jlv["pt"][0], jlv["xt"][0]
        if front == "matmul":
            return jc.candidates_matmul_impl(jdi, gm, pt, xt, *a[:-1], thr,
                                             with_bound=True, **kw)
        return jc.candidates_runs_impl(jdi, pt, xt, *a[:-1], thr, s_cap=s_cap,
                                       with_bound=True, **kw)

    for i in range(8):
        lv = shards[i]
        di = pdist._ShardView(lv)
        jlv = {n: jnp.asarray(a[i : i + 1]) if n in jdist._STACKED else jnp.asarray(a)
               for n, a in jsx.leaves.items()}
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
        args = (t(qtok), t(qlens), t(slots), t(nqg), t(use_short), t(promo),
                t(promo_t[i]), t(promo_w[i]), t(lim), thr)
        jargs = tuple(jnp.asarray(np.asarray(a)) for a in args[:-1]) + (thr,)
        gm = pdist.incidence_matrix(lv["gram_ptr"], lv["gram_terms"], g, sx.tl_c,
                                    int(sx.leaves["gram_ptr"][i, -1]), 1 << 20)
        if front == "matmul":
            got = pc.candidates_matmul(di, gm, lv["pt"], lv["xt"], *args,
                                       with_bound=True, **kw)
        else:
            got = pc.candidates_runs(di, lv["pt"], lv["xt"], *args,
                                     s_cap=s_cap, with_bound=True, **kw)
        want = jfn(jlv, jnp.asarray(gm[:g, : sx.tl_c].numpy()), *jargs)
        qc = pc.query_counts(t(slots), gm.shape[0]).numpy()
        hits = (qc.astype(np.int64) @ gm.numpy().astype(np.int64))[:, : sx.tl_c]
        # per-term selection bounds, as both packages compute them
        s = hits.astype(np.float32) / np.maximum(nqg, 1).astype(np.float32)[:, None]
        ok = (hits > 0) & (nqg[:, None] > 0) & (s >= thr)
        wmax = sx.leaves["term_wmax"][i, sx.ts_c :]
        u = np.where(ok, wmax[None, :] * s, -np.inf).astype(np.float32)
        tie = _straddles(u, n_cand)
        assert not tie[: len(items)].all()
        want = [np.asarray(w) for w in want]
        got = [x.numpy() for x in got]
        np.testing.assert_array_equal(got[4], want[4])  # the bound
        for r in range(b):
            if tie[r]:
                continue
            assert got[0][r] == want[0][r], (i, r)
            n = min(int(want[0][r]), 16)
            for j in (1, 2, 3):
                np.testing.assert_array_equal(got[j][r, :n], want[j][r, :n])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("limit", [1, 5, 16])
def test_merge_shard_topk_matches_jax(seed, limit):
    """Random per-shard lists with forced score and length ties, shared
    keys across shards, open and closed bounds."""
    rng = np.random.default_rng(seed)
    s, b, tk, k_total = 4, 6, 16, 40
    key_len = rng.integers(1, 6, k_total).astype(np.int32)
    keys = np.stack([
        np.stack([rng.choice(k_total, tk, replace=False) for _ in range(b)])
        for _ in range(s)
    ]).astype(np.int32)
    scores = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0, 100.0]), (s, b, tk)).astype(np.float32)
    lens = key_len[keys]
    cnt = rng.integers(0, tk + 6, (s, b)).astype(np.int32)
    bound = rng.choice(np.float32([-np.inf, 0.0, 0.25, 0.5, np.inf]), (s, b)).astype(np.float32)
    bound[:, 0] = -np.inf  # a row every shard closed
    want = jdist._merge_shard_topk(
        jnp.asarray(cnt), jnp.asarray(keys), jnp.asarray(scores),
        jnp.asarray(lens), jnp.asarray(bound), k_total, limit, tk,
    )
    got = pdist._merge_shard_topk(
        torch.from_numpy(cnt), torch.from_numpy(keys), torch.from_numpy(scores),
        torch.from_numpy(lens), torch.from_numpy(bound), k_total, limit, tk,
    )
    w_count, w_keys, w_scores, w_exact = (np.asarray(x) for x in want)
    g_count, g_keys, g_scores, g_exact = (x.numpy() for x in got)
    np.testing.assert_array_equal(g_count, w_count)
    np.testing.assert_array_equal(g_exact, w_exact)
    np.testing.assert_array_equal(g_keys, w_keys)
    for r in range(b):
        n = int(w_count[r])
        np.testing.assert_array_equal(g_scores[r, :n], w_scores[r, :n])
