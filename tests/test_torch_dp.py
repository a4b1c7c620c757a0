"""The edit-distance DP of the PyTorch port (the plain version of kernel K5,
``ops.dp_match``) against the JAX package: the TPU kernel
``tools.experimental.dp_pallas.dp_match_batch`` in interpret mode (widths
<= 127, its contract), the XLA ``search.editdist.dp_match`` at every width,
the oracle's ``string_match``, and the length-tiered DP over a long tier
split into width buckets.

Tolerance: none - match counts are integers and must be bit-identical.  The
CUDA kernel is held against the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringsearchlib_tpu.config import IndexConfig as JConfig
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.search import editdist as jed
from stringsearchlib_tpu.search.engine import SearchEngine as JEngine
from stringsearchlib_tpu.utils.oracle import OracleIndex
from stringsearchlib_tpu_torch.config import IndexConfig
from stringsearchlib_tpu_torch.index.build import build_index as pbuild
from stringsearchlib_tpu_torch.ops import dp_match as pdp
from stringsearchlib_tpu_torch.search import editdist as ped
from stringsearchlib_tpu_torch.search.engine import SearchEngine as PEngine
from tools.experimental import dp_pallas


@pytest.fixture
def interpret():
    old = dp_pallas.INTERPRET
    dp_pallas.INTERPRET = True
    yield
    dp_pallas.INTERPRET = old


def _case(seed, n, w, b, qp, wide):
    """numpy terms (N, W) with lengths 0..W over a small alphabet, so that
    matches happen, and queries (B, Qp) whose lengths include 0, 1 and Qp;
    padding is 0 as in the index.  Wide tokens are CJK code points."""
    rng = np.random.default_rng(seed)
    lo = 0x4E00 if wide else ord("A")
    tokens = rng.integers(lo, lo + 5, size=(n, w)).astype(np.int32)
    lengths = rng.integers(0, w + 1, size=n).astype(np.int32)
    lengths[: min(n, 2)] = [0, w][: min(n, 2)]
    tokens[np.arange(w)[None, :] >= lengths[:, None]] = 0
    qtok = rng.integers(lo, lo + 5, size=(b, qp)).astype(np.int32)
    qlens = rng.integers(0, qp + 1, size=b).astype(np.int32)
    qlens[: min(b, 3)] = [0, 1, qp][: min(b, 3)]
    qtok[np.arange(qp)[None, :] >= qlens[:, None]] = 0
    return tokens, lengths, qtok, qlens


def _port(tokens, lengths, qtok, qlens, wide):
    tok = torch.from_numpy(tokens if wide else tokens.astype(np.uint8))
    return ped.dp_match(tok, torch.from_numpy(lengths), torch.from_numpy(qtok),
                        torch.from_numpy(qlens)).numpy()


def _xla(tokens, lengths, qtok, qlens):
    """The JAX package's XLA dp_match, one query at a time (its contract)."""
    tok, ln = jnp.asarray(tokens), jnp.asarray(lengths)
    f = jax.vmap(lambda q, ql: jed.dp_match(tok, ln, q, ql))
    return np.asarray(f(jnp.asarray(qtok), jnp.asarray(qlens)))


@pytest.mark.parametrize("n,w,b,qp,wide", [
    (40, 8, 5, 8, False),
    (33, 16, 4, 12, True),
    (20, 127, 3, 6, False),
])
def test_plain_matches_dp_pallas(interpret, n, w, b, qp, wide):
    tokens, lengths, qtok, qlens = _case(n + w, n, w, b, qp, wide)
    want = np.asarray(dp_pallas.dp_match_batch(
        jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(qtok),
        jnp.asarray(qlens), tile=8,
    ))
    calls = pdp.K5_REF_CALLS
    got = _port(tokens, lengths, qtok, qlens, wide)
    assert pdp.K5_REF_CALLS == calls + 1
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,w,b,qp,wide", [
    (300, 8, 16, 16, False),
    (120, 24, 9, 20, True),
    (64, 130, 4, 40, False),
    (40, 200, 3, 70, True),
    (0, 12, 4, 8, False),
])
def test_plain_matches_xla_dp_match(n, w, b, qp, wide):
    tokens, lengths, qtok, qlens = _case(n + 7 * w, n, w, b, qp, wide)
    got = _port(tokens, lengths, qtok, qlens, wide)
    assert got.shape == (b, n)
    if n:
        np.testing.assert_array_equal(got, _xla(tokens, lengths, qtok, qlens))


def test_plain_matches_oracle_string_match():
    oracle = OracleIndex(["x"], row_size=1)
    words = ["BANANA", "BAND", "ANA", "NAB", "XYZ", "", "ABANDONED LAND"]
    queries = ["ANA", "BAN", "NA", "B", "Q", "", "BANDANA LAND"]
    width, qp = 16, 12
    tokens = np.zeros((len(words), width), np.uint8)
    lengths = np.array([len(w) for w in words], np.int32)
    for i, w in enumerate(words):
        tokens[i, : len(w)] = np.frombuffer(w.encode(), np.uint8)
    qtok = np.zeros((len(queries), qp), np.int32)
    qlens = np.array([len(q) for q in queries], np.int32)
    for i, q in enumerate(queries):
        qtok[i, : len(q)] = np.frombuffer(q.encode(), np.uint8)
    got = ped.dp_match(torch.from_numpy(tokens), torch.from_numpy(lengths),
                       torch.from_numpy(qtok), torch.from_numpy(qlens)).numpy()
    for i, q in enumerate(queries):
        for j, w in enumerate(words):
            if q:  # the oracle scores non-empty queries only
                assert got[i, j] == oracle.string_match(q, w), (q, w)
            else:
                assert got[i, j] == 0, w


def test_wrapper_contracts():
    tokens, lengths, qtok, qlens = (torch.from_numpy(a) for a in _case(1, 6, 4, 2, 3, False))
    with pytest.raises(ValueError):
        pdp.dp_match(tokens, lengths[:3], qtok, qlens)
    with pytest.raises(ValueError):
        pdp.dp_match(tokens[0], lengths, qtok, qlens)


@pytest.mark.parametrize("qp,w,form", [
    (16, 16, "query"), (16, 40, "query"), (32, 8, "term"), (128, 16, "term"),
    (64, 200, "query"), (80, 100, "scratch"), (130, 200, "scratch"),
])
def test_pick_form(qp, w, form):
    # the state along the shorter static bound while one fits 64
    assert pdp.pick_form(qp, w) == form


def _skewed_words(rng, n=400):
    """Mostly ~8-char long terms and a handful of very long ones (as
    tests/test_length_tiers.py builds them)."""
    alpha = list("ABCDEFGH ")
    words = ["".join(rng.choice(alpha, size=rng.integers(6, 13))) for _ in range(n)]
    words += ["".join(rng.choice(alpha, size=rng.integers(150, 200))) for _ in range(6)]
    rng.shuffle(words)
    return words


@pytest.fixture(scope="module")
def tiered():
    words = _skewed_words(np.random.default_rng(13))
    jh = jbuild(words, 1, None, JConfig())
    ph = pbuild(words, 1, None, IndexConfig(), device="cpu")
    for h in (jh, ph):
        h.DP_MIN_BUCKET_ROWS = 4  # the test tier is small
        h._dp_bucket_cache = None
    return words, jh, ph


def test_dp_match_tiered_matches_jax(tiered):
    """The long tier in >= 2 width buckets: the port's tiered DP against
    the JAX package's, query by query, and against the single-width DP."""
    _, jh, ph = tiered
    buckets = ph.long_dp_buckets()
    assert buckets == jh.long_dp_buckets() and len(buckets) >= 2
    d = ph.device
    qtok = np.zeros((4, 8), np.int32)
    qlens = np.array([1, 2, 3, 8], np.int32)
    for i, q in enumerate(["A", "GH", "E F", "ABCDEFGH"]):
        qtok[i, : len(q)] = np.frombuffer(q.encode(), np.uint8)
    got = ped.dp_match_tiered(d.long_tokens, d.long_lengths, torch.from_numpy(qtok),
                              torch.from_numpy(qlens), buckets).numpy()
    flat = ped.dp_match(d.long_tokens, d.long_lengths, torch.from_numpy(qtok),
                        torch.from_numpy(qlens)).numpy()
    np.testing.assert_array_equal(got, flat)
    jd = jh.device
    for i in range(4):
        want = np.asarray(jed.dp_match_tiered(
            jd.long_tokens, jd.long_lengths, jnp.asarray(qtok[i]), jnp.int32(qlens[i]),
            jh.long_dp_buckets(),
        ))
        np.testing.assert_array_equal(got[i], want)


def test_brute_tier_search_matches_jax(tiered):
    """Queries of at most gram_size characters take the brute tier (the
    tiered DP over the whole long tier): the same tie groups as the JAX
    engine."""
    _, jh, ph = tiered
    pe, je = PEngine(ph), JEngine(jh)
    queries = ["A", "AB", "ABC", "GH", "E F"]
    got = pe.search_batch(queries, 0.1, 25)
    want = je.search_batch(queries, 0.1, 25)
    for q, g, w in zip(queries, got, want):
        assert sorted(zip(np.round(g[1], 5), map(len, g[0]))) == sorted(
            zip(np.round(w[1], 5), map(len, w[0]))), q
