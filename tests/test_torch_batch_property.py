"""Batched search against the oracle in both packages: the reference's
tests/test_batch_property.py (every mode and front end, gram sizes 2-4,
narrow and wide strings) and tests/test_length_tiers.py (the
length-sorted long tier and its width-bucketed DP, and its sharding case),
each parametrised over the JAX package and the PyTorch port on the CPU."""

import random
from collections import defaultdict

import numpy as np
import pytest

from stringsearchlib_tpu.config import IndexConfig as JConfig
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.parallel.dist import shard_index as jshard_index
from stringsearchlib_tpu.search.engine import SearchEngine as JEngine
from stringsearchlib_tpu.utils.oracle import OracleIndex as JOracle
from stringsearchlib_tpu_torch.config import IndexConfig as PConfig
from stringsearchlib_tpu_torch.index.build import build_index as pbuild
from stringsearchlib_tpu_torch.parallel.dist import shard_index as pshard_index
from stringsearchlib_tpu_torch.search.engine import SearchEngine as PEngine
from stringsearchlib_tpu_torch.utils.oracle import OracleIndex as POracle


def _jax_build(words, row, weights, cfg_kw, **kw):
    return jbuild(words, row, weights, JConfig(**cfg_kw), **kw)


def _port_build(words, row, weights, cfg_kw, **kw):
    return pbuild(words, row, weights, PConfig(**cfg_kw), device="cpu", **kw)


PKGS = {
    "jax": (_jax_build, JEngine, JOracle),
    "torch": (_port_build, PEngine, POracle),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


NARROW_ALPHABET = "abcdefgHIJKLm nopQ.%"
WIDE_ALPHABET = "día中文かなΩ é. ab"


def _corpus(rng, n, wide):
    alphabet = WIDE_ALPHABET if wide else NARROW_ALPHABET
    return [
        "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 14)))
        for _ in range(n)
    ]


def _canon(pairs):
    d = defaultdict(list)
    for k, v in pairs:
        d[round(v, 4)].append(len(k))
    return {v: sorted(ks) for v, ks in d.items()}


# ---------------------------------------------------------------------------
# tests/test_batch_property.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("gram_size", [2, 3, 4])
def test_batch_modes_match_oracle(pkg, wide, gram_size):
    build, engine_cls, oracle_cls = pkg
    rng = random.Random(100 * gram_size + wide)
    words = _corpus(rng, 600, wide)
    weights = [0.5 if rng.random() < 0.2 else 1.0 for _ in words]
    host = build(words, 2, weights, {"gram_size": gram_size, "wide": wide})
    oracle = oracle_cls(words, row_size=2, weights=weights, gram_size=gram_size,
                        wide=wide)
    engine = engine_cls(host)
    queries = [words[rng.randrange(len(words))][: rng.randint(2, 10)]
               for _ in range(6)] + ["*", ""]
    # over-width queries (> qp_bucket 32) exercise the pow2 width groups
    queries += ["".join(words[rng.randrange(len(words))] for _ in range(4))
                for _ in range(2)]
    for threshold, limit in ((0.0, 10), (0.3, 5)):
        want = {}
        for q in queries:
            rs, ss = oracle.search(q, threshold, limit)
            want[q] = _canon(zip(rs, ss))
        for mode in ("candidates", "dense", "auto"):
            outs = engine.search_batch(queries, threshold, limit, mode=mode)
            for q, (r, s) in zip(queries, outs):
                got = _canon(zip(r, [float(x) for x in s]))
                assert got == want[q], (wide, gram_size, mode, threshold, q)


@pytest.mark.parametrize("wide", [False, True])
def test_batch_runs_front_end_matches_oracle(pkg, wide):
    """Force the sorted-runs front end (gram matrix disabled)."""
    build, engine_cls, oracle_cls = pkg
    rng = random.Random(7 + wide)
    words = _corpus(rng, 500, wide)
    host = build(words, 1, None, {"wide": wide})
    host._gram_matrix_cache = False
    oracle = oracle_cls(words, row_size=1, wide=wide)
    engine = engine_cls(host)
    queries = [words[rng.randrange(len(words))][: rng.randint(4, 10)]
               for _ in range(6)]
    outs = engine.search_batch(queries, 0.25, 10, mode="candidates")
    for q, (r, s) in zip(queries, outs):
        rs, ss = oracle.search(q, 0.25, 10)
        assert _canon(zip(r, map(float, s))) == _canon(zip(rs, ss)), (wide, q)


# ---------------------------------------------------------------------------
# tests/test_length_tiers.py
# ---------------------------------------------------------------------------


def _skewed_words(rng, n=400):
    """Mostly ~8-char long terms, a handful of very long ones."""
    alpha = list("ABCDEFGH ")
    words = ["".join(rng.choice(alpha, size=rng.integers(6, 13))) for _ in range(n)]
    words += ["".join(rng.choice(alpha, size=rng.integers(150, 200))) for _ in range(6)]
    rng.shuffle(words)
    return words


def test_long_tier_sorted_by_length(pkg):
    build = pkg[0]
    rng = np.random.default_rng(7)
    for use_native in (False, True):
        host = build(_skewed_words(rng), 1, None, {}, use_native=use_native)
        ll = np.asarray(host.device.long_lengths)
        assert np.all(ll[:-1] <= ll[1:]), use_native
        assert host.host_long_lengths is not None
        np.testing.assert_array_equal(host.host_long_lengths, ll)


def test_buckets_cover_tier_and_bound_widths(pkg):
    build = pkg[0]
    host = build(_skewed_words(np.random.default_rng(11)), 1, None, {})
    host.DP_MIN_BUCKET_ROWS = 4  # the test tier is small
    host._dp_bucket_cache = None
    buckets = host.long_dp_buckets()
    ll = host.host_long_lengths
    n = ll.shape[0]
    full_w = int(host.device.long_tokens.shape[1])
    assert len(buckets) >= 2  # the skew must actually split
    assert buckets[-1][0] == n
    lo = 0
    for end, w in buckets:
        assert lo < end <= n
        assert w <= full_w
        assert int(ll[lo:end].max()) <= w  # width covers every member
        lo = end
    assert buckets[0][1] < full_w // 4


def test_tiered_brute_parity(pkg):
    """qlen <= gram_size queries (whole-tier DP) return identical results
    whether the DP runs tiered or single-width."""
    build, engine_cls, _ = pkg
    host = build(_skewed_words(np.random.default_rng(13)), 1, None, {})
    host.DP_MIN_BUCKET_ROWS = 4
    host._dp_bucket_cache = None
    assert len(host.long_dp_buckets()) >= 2
    flat = build(_skewed_words(np.random.default_rng(13)), 1, None, {})
    flat._dp_bucket_cache = ()  # force the single full-width DP
    tiered_eng, flat_eng = engine_cls(host), engine_cls(flat)
    queries = ["A", "AB", "ABC", "GH", "  ", "E F"]
    for q in queries:
        got = tiered_eng.search(q, 0.1, 25)
        want = flat_eng.search(q, 0.1, 25)
        assert got[0] == want[0], q
        np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    got_b = tiered_eng.search_batch(queries, 0.1, 25)
    want_b = flat_eng.search_batch(queries, 0.1, 25)
    for g, w, q in zip(got_b, want_b, queries):
        assert g[0] == w[0], q
        np.testing.assert_allclose(g[1], w[1], atol=1e-6)


def test_tiered_matches_longer_queries_too(pkg):
    """The long-tier permutation is invisible to gram-path queries (term
    ids are internal): the native and numpy builders agree."""
    build, engine_cls, _ = pkg
    words = _skewed_words(np.random.default_rng(17))
    host_n = build(words, 1, None, {}, use_native=True)
    host_p = build(words, 1, None, {}, use_native=False)
    for f in ("gram_ptr", "gram_terms", "edge_term", "edge_key", "long_lengths"):
        np.testing.assert_array_equal(
            np.asarray(getattr(host_n.device, f)), np.asarray(getattr(host_p.device, f)),
            err_msg=f,
        )
    res = engine_cls(host_n).search("ABCDEFGH", 0.0, 10)
    assert len(res[0]) <= 10


@pytest.mark.parametrize("name", sorted(PKGS))
def test_strided_sharding_balances_sorted_tier(name):
    """The length-sorted long tier must not skew posting mass onto the
    last shard: strided assignment keeps shards balanced AND each shard's
    local tier length-ascending (tests/test_length_tiers.py's sharding
    case; the host index stays on the host)."""
    build = PKGS[name][0]
    shard_index = {"jax": jshard_index, "torch": pshard_index}[name]
    rng = np.random.default_rng(23)
    kw = {"to_device": False} if name == "jax" else {}
    host = build(_skewed_words(rng, 600), 1, None, {}, **kw)
    sx = shard_index(host, 4)
    per_shard = sx.host_shard_posting_lens.sum(axis=1)
    assert per_shard.sum() == int(np.asarray(host.device.gram_ptr)[-1])
    # contiguous chunks over the sorted tier would put ALL the 150+ char
    # terms (and their postings) on the last shard; strided stays tight
    assert per_shard.max() <= 1.25 * max(per_shard.min(), 1), per_shard
    ll = sx.leaves["long_lengths"]
    for i in range(4):
        row = ll[i][ll[i] > 0]
        assert np.all(row[:-1] <= row[1:])
