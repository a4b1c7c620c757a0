"""The gram-matrix front end of the PyTorch port against the JAX package:
``HostIndex.gram_matrix`` (the dense (G, Tl) int8 incidence, padded to
multiples of 8), ``candidates_matmul`` with the h* finish and with the
dense-hits finish against ``candidates_matmul_impl``, and the engine's
``matmul`` route on a 3k-key corpus as tests/test_batch.py drives the
reference's.

Tolerances: the incidence's bytes and the hit counts bit-identical; counts,
ids, exact flags identical and float32 scores exactly equal on rows exact
in both (the budgets cover every row); engine results as (score, key
length) tie groups."""

import random
import string

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
from stringsearchlib_tpu_torch.search import candidates as pc
from stringsearchlib_tpu_torch.search.engine import SearchEngine as PEngine

THRESHOLD = np.float32(0.25)
LIMIT = 10
TOP_K = 16


def _rand_words(rng, n):
    alphabet = string.ascii_letters + " .%"
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(1, 18)))
            for _ in range(n)]


def _sylls(n, seed):
    rng = random.Random(seed)
    syll = ["ka", "lo", "me", "ri", "su", "ta", "ve", "nor", "bel"]
    return ["".join(rng.choice(syll) for _ in range(rng.randint(2, 5))) for _ in range(n)]


@pytest.fixture(scope="module", params=["uniform", "weighted_rows2"])
def pair(request):
    if request.param == "uniform":
        words, row, weights = _sylls(2500, 21), 1, None
    else:
        rng = random.Random(5)
        words = _rand_words(rng, 3000)
        weights = [0.5 if rng.random() < 0.2 else 1.0 for _ in range(3000)]
        row = 2
    jh = jbuild(words, row, weights, JConfig())
    ph = pbuild(words, row, weights, IndexConfig(), device="cpu")
    return words, row, weights, jh, ph


def test_gram_matrix_matches_jax(pair):
    _, _, _, jh, ph = pair
    want = np.asarray(jh.gram_matrix())
    got = ph.gram_matrix()
    g, tl = want.shape
    assert got.dtype == torch.int8
    assert got.shape == (-(-g // 8) * 8, -(-tl // 8) * 8)
    np.testing.assert_array_equal(got[:g, :tl].numpy(), want)
    assert not got[g:].any() and not got[:, tl:].any()
    assert ph.gram_matrix() is got  # cached per index


def test_gram_matrix_budget():
    ph = pbuild(_sylls(200, 3), 1, None, IndexConfig(), device="cpu")
    assert ph.gram_matrix(budget_bytes=1) is None
    assert ph._gram_matrix_cache is False  # the miss is cached
    assert ph.gram_matrix() is None


@pytest.mark.parametrize("qmax", [12, 200])
def test_gram_hits_exact(pair, qmax):
    """Hit counts equal the numpy product of multiplicities and incidence,
    with grams repeated past 127 times where Qmax allows."""
    _, _, _, jh, ph = pair
    gm = ph.gram_matrix()
    g = ph.n_grams
    rng = np.random.default_rng(qmax)
    slots = rng.integers(-1, g, (9, qmax)).astype(np.int32)
    slots[0, :] = 3  # one gram, qmax times
    got = pc.gram_hits(torch.from_numpy(slots), gm).numpy()
    qcnt = np.zeros((9, gm.shape[0]), np.int64)
    for r in range(9):
        for s in slots[r]:
            if s >= 0:
                qcnt[r, s] += 1
    np.testing.assert_array_equal(got, qcnt @ gm.numpy().astype(np.int64))


def _front(jh, words, n=16, seed=23):
    eng = JEngine(jh)
    rng = random.Random(seed)
    queries = []
    for i in range(n):
        w = words[rng.randrange(len(words))]
        queries.append(w if i % 2 else w[:-1] + "x")
    queries[-1] = "ka"  # the short tier
    items = []
    for pos, q in enumerate(queries):
        qnorm, qlen = eng._normalize_query(q)
        items.append((pos, qnorm, qlen, jh.promo_key_ids(qnorm, qlen)))
    b, qtok, qlens, slots, nqg, use_short, _ = eng._prep_rows(items, 32)
    promo = np.full((b, eng.PROMO_KEYS), -1, np.int32)
    for r, it in enumerate(items):
        promo[r, : it[3].size] = it[3]
    promo_t, promo_w = eng._promo_tables(promo)
    return [qtok, qlens, slots, nqg, use_short, promo, promo_t, promo_w,
            np.full((b,), LIMIT, np.int32)]


@pytest.mark.parametrize("finish", ["dense_hits", "block_sel", "hstar"])
def test_candidates_matmul_matches_jax(pair, finish):
    words, _, weights, jh, ph = pair
    if finish == "hstar" and weights is not None:
        pytest.skip("the h* finish is sound for uniform weights only (the engine's rule)")
    h = _front(jh, words)
    lanes = ph.device.n_short + ph.device.n_long
    kw = dict(compute_short=True, n_cand=min(2048, lanes), n_edge=32, top_k=TOP_K,
              block_sel=finish == "block_sel")
    if finish == "hstar":
        kw.update(hstar=True, kb1=64, kb2=64)
    pt_j, xt_j = jh.prim_tables()
    want = [np.asarray(x) for x in jc.candidates_matmul(
        jh.device, jh.gram_matrix(), pt_j, xt_j, *[jnp.asarray(a) for a in h],
        THRESHOLD, **kw,
    )]
    pt_p, xt_p = ph.prim_tables()
    calls = pdp.K5_REF_CALLS
    got = [x.numpy() for x in pc.candidates_matmul(
        ph.device, ph.gram_matrix(), pt_p, xt_p,
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in h], THRESHOLD, **kw,
    )]
    assert pdp.K5_REF_CALLS == calls + 1
    assert got[4].all() and want[4].all()
    np.testing.assert_array_equal(got[0], want[0])
    for r in range(got[0].shape[0]):
        n = min(int(got[0][r]), TOP_K)
        for i in (1, 2, 3):
            np.testing.assert_array_equal(got[i][r][:n], want[i][r][:n])


def test_engine_matmul_route_matches_jax_and_oracle(pair):
    """The reference's tests/test_batch.py case: a gram matrix within
    GM_BUDGET takes the matmul route for batches and for tiny batches (the
    tiny-runs gate needs no gram matrix), with the JAX engine's routing, and
    its results equal the oracle's; then the sorted runs on the same index."""
    words, row, weights, jh, ph = pair
    oracle = OracleIndex(words, row_size=row, weights=weights)
    pe, je = PEngine(ph), JEngine(jh)
    for eng in (pe, je):
        eng.CAND_MIN_TERMS = 100
        eng.SKETCH_MIN_TERMS = 1
        eng.HSTAR_KB1, eng.HSTAR_KB2 = 1, 1  # lanes dwarf these on a small index
    rng = random.Random(5)
    queries = [words[rng.randrange(len(words))][: rng.randint(4, 12)] for _ in range(12)]
    queries += ["zzzz9", words[0]]
    first = []
    orig = pe._cand_pass

    def spy(items, *a):
        res = orig(items, *a)
        first.append(dict(pe.last_routing))
        return res

    pe._cand_pass = spy
    for qs in (queries, queries[:4]):
        first.clear()
        got = pe.search_batch(qs, 0.25, 20, mode="candidates")
        je.search_batch(qs, 0.25, 20, mode="candidates")
        for k in ("variant", "hstar", "n_cand", "block_sel", "step"):
            assert pe.last_routing[k] == je.last_routing[k], k
        assert first[0]["variant"] == "matmul"
        assert first[0]["hstar"] is (weights is None)
        for q, g in zip(qs, got):
            ws, wsc = oracle.search(q, 0.25, 20)
            assert sorted((round(s, 4), len(k)) for k, s in zip(*g)) == sorted(
                (round(s, 4), len(k)) for k, s in zip(ws, wsc)), q
    ph._gram_matrix_cache = False  # the sorted runs, as the reference's test
    pe.BITMAP_BUDGET, pe.SKETCH_MIN_TERMS = 0, 10**9
    first.clear()
    got = pe.search_batch(queries, 0.25, 20, mode="candidates")
    assert first[0]["variant"] == "runs"
    for q, g in zip(queries, got):
        ws, wsc = oracle.search(q, 0.25, 20)
        assert sorted((round(s, 4), len(k)) for k, s in zip(*g)) == sorted(
            (round(s, 4), len(k)) for k, s in zip(ws, wsc)), q
    ph._gram_matrix_cache = None
