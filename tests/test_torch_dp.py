"""The edit-distance DP of the PyTorch port (the plain version of kernel K5,
``ops.dp_match``) against the JAX package: the TPU kernel
``tools.experimental.dp_pallas.dp_match_batch`` in interpret mode (widths
<= 127, its contract), the XLA ``search.editdist.dp_match`` at every width,
the oracle's ``string_match``, and the length-tiered DP over a long tier
split into width buckets; and a numpy model of the CUDA kernel's
bit-parallel recurrence against the same references, with the kernel's
launch plan.

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


def _myers(tokens, lengths, qtok, qlens, lanes=16):
    """numpy model of csrc/dp_match.cu's recurrence: the queries in chunks
    of ``pdp.plan``'s ``qc``, each chunk's match masks in 32-bit
    words per table row - a row per byte for uint8 tokens, a dense row per
    distinct code point of the chunk for int32 ones and one more row for
    any other character.  A query of m characters takes ceil(m/32) words,
    position i at bit i + pad (pad = 32 ceil(m/32) - m): the pad rows below
    it match every character and start with vertical delta 0, so D stays 0
    along them (the semi-global boundary) and the last position is bit 31
    of the top word.  Myers' step per term character, the horizontal delta
    passed from word to word (nothing enters the lowest), the score from m
    following the top word's outgoing delta, its least value over j in
    [0, len]."""
    n, w = tokens.shape
    b, qp = qtok.shape
    wide = tokens.dtype != np.uint8
    p = pdp.plan(qp, n, b)
    nw = p["nw"] or p["words"]
    qc = p["qc"]
    out = np.zeros((b, n), np.int64)
    ln = np.minimum(lengths.astype(np.int64), w)
    one = np.uint32(1)
    for b0 in range(0, b, qc):
        chunk = range(b0, min(b, b0 + qc))
        ms = [int(np.clip(qlens[q], 0, qp)) for q in chunk]
        pads = [(32 - m % 32) % 32 for m in ms]
        if wide:
            held = sorted({int(qtok[q, i]) for q, m in zip(chunk, ms) for i in range(m)})
            slot = {c: r for r, c in enumerate(held)}
            rows = np.full(tokens.shape, len(held), np.int64)
            for c, r in slot.items():
                rows[tokens == c] = r
            eq = np.zeros((len(held) + 1, qc, nw), np.uint32)
        else:
            rows = tokens.astype(np.int64)
            eq = np.zeros((256, qc, nw), np.uint32)
        for k, (q, m, pad) in enumerate(zip(chunk, ms, pads)):
            eq[:, k, 0] = (1 << pad) - 1
            for i in range(m):
                c, bit = int(qtok[q, i]), i + pad
                r = slot[c] if wide else c
                if 0 <= r < eq.shape[0]:
                    eq[r, k, bit >> 5] |= one << np.uint32(bit & 31)
        for k, (q, m, pad) in enumerate(zip(chunk, ms, pads)):
            best = np.full(n, m, np.int64)
            if m:
                top = (m - 1) >> 5
                pv = np.full((top + 1, n), 0xFFFFFFFF, np.uint32)
                pv[0] = ~np.uint32((1 << pad) - 1)
                mv = np.zeros((top + 1, n), np.uint32)
                score = np.full(n, m, np.int64)
                for j in range(w):
                    live = j < ln
                    e_all = eq[rows[:, j], k]  # (N, nw)
                    hp = hm = np.zeros(n, np.uint32)
                    for word in range(top + 1):
                        e, pw, nv = e_all[:, word], pv[word], mv[word]
                        xv = e | nv
                        e = e | hm
                        xh = (((e & pw) + pw) ^ pw) | e
                        ph = nv | ~(xh | pw)
                        mh = pw & xh
                        hp_out, hm_out = ph >> np.uint32(31), mh >> np.uint32(31)
                        if word == top:
                            score += np.where(live, hp_out.astype(np.int64) - hm_out, 0)
                        ph = (ph << one) | hp
                        mh = (mh << one) | hm
                        pv[word] = np.where(live, mh | ~(xv | ph), pw)
                        mv[word] = np.where(live, ph & xv, nv)
                        hp, hm = hp_out, hm_out
                    best = np.minimum(best, score)
            out[q] = np.where(lengths < 0, qlens[q] - (1 << 30), qlens[q] - best)
    return out.astype(np.int32)


def _edge_case(seed, n, w, qp, ms, wide):
    """``_case`` with queries of lengths ``ms`` (repeated characters, and
    characters that no term holds), a qlen past Qp and a negative one,
    terms of length over W and below 0."""
    tokens, lengths, _, _ = _case(seed, n, w, 1, 1, wide)
    rng = np.random.default_rng(seed + 1)
    lo = 0x4E00 if wide else ord("A")
    b = len(ms) + 2
    qtok = np.zeros((b, qp), np.int32)
    qlens = np.array(list(ms) + [qp + 3, -2], np.int32)
    for q, m in enumerate(qlens):
        m = int(np.clip(m, 0, qp))
        qtok[q, :m] = rng.integers(lo, lo + 7, size=m)  # lo + 5, lo + 6: in no term
        qtok[q, : m // 3] = lo  # a run of one character
    if n > 3:
        lengths[2], lengths[3] = w + 4, -1
    return tokens, lengths, qtok, qlens


_MS = (0, 1, 2, 3, 31, 32, 33, 63, 64, 65, 129)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("w", [1, 8, 16, 32, 64, 65, 200])
def test_bit_parallel_model_matches_xla(w, wide):
    """The kernel's recurrence, word for word, against the JAX package's
    DP and the port's plain version: m on both sides of each word boundary,
    every edge rule (qlen past Qp and below 0, len past W and below 0)."""
    tokens, lengths, qtok, qlens = _edge_case(w, 12, w, 130, _MS, wide)
    got = _myers(tokens, lengths, qtok, qlens)
    np.testing.assert_array_equal(got, _port(tokens, lengths, qtok, qlens, wide))
    np.testing.assert_array_equal(got, _xla(tokens, lengths, qtok, qlens))


@pytest.mark.parametrize("n,w,b,qp,wide", [
    (40, 8, 5, 8, False),
    (33, 16, 20, 12, True),
    (20, 127, 3, 40, False),
])
def test_bit_parallel_model_matches_dp_pallas(interpret, n, w, b, qp, wide):
    tokens, lengths, qtok, qlens = _case(n + w, n, w, b, qp, wide)
    want = np.asarray(dp_pallas.dp_match_batch(
        jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(qtok),
        jnp.asarray(qlens), tile=8,
    ))
    np.testing.assert_array_equal(_myers(tokens, lengths, qtok, qlens), want)


def test_bit_parallel_model_matches_oracle():
    oracle = OracleIndex(["x"], row_size=1)
    words = ["BANANA", "BAND", "ANA", "NAB", "XYZ", "", "ABANDONED LAND",
             "A" * 70 + "BANDANA" + "Z" * 40]
    queries = ["ANA", "BAN", "NA", "B", "Q", "BANDANA LAND",
               "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAB", "ABANDONED LANDS" * 3]
    width, qp = 128, 48
    tokens = np.zeros((len(words), width), np.uint8)
    lengths = np.array([len(w) for w in words], np.int32)
    for i, w in enumerate(words):
        tokens[i, : len(w)] = np.frombuffer(w.encode(), np.uint8)
    qtok = np.zeros((len(queries), qp), np.int32)
    qlens = np.array([len(q) for q in queries], np.int32)
    for i, q in enumerate(queries):
        qtok[i, : len(q)] = np.frombuffer(q.encode(), np.uint8)
    got = _myers(tokens, lengths, qtok, qlens)
    for i, q in enumerate(queries):
        for j, w in enumerate(words):
            assert got[i, j] == oracle.string_match(q, w), (q, w)


@pytest.mark.parametrize("qp,nw,qc", [
    (0, 1, 16), (8, 1, 16), (32, 1, 16), (33, 2, 8), (64, 2, 8), (65, 4, 4),
    (128, 4, 4), (129, 8, 2), (256, 8, 2), (257, 0, 1), (512, 0, 1),
])
def test_plan(qp, nw, qc):
    """The least register instance that holds ceil(Qp/32) words, 16 mask
    words per table row for a full batch, and past 8 words the scratch
    kernel's bounded grid."""
    p = pdp.plan(qp, 3_000_000, 256)
    assert (p["nw"], p["qc"]) == (nw, qc)
    assert p["words"] == max(1, -(-qp // 32))
    if nw:
        assert p["qc"] * p["nw"] == 16 and p["threads"] == 0
    else:
        assert p["threads"] % 128 == 0 and 0 < p["threads"] <= 3_000_064
        assert 8 * p["words"] * p["threads"] <= 64 << 20


@pytest.mark.parametrize("qp,b,qc", [
    (8, 1, 1), (32, 2, 1), (32, 3, 16), (33, 1, 1), (33, 2, 8), (65, 1, 1),
    (65, 2, 4), (129, 1, 1), (129, 2, 2), (257, 1, 1),
])
def test_plan_small_batch(qp, b, qc):
    """A chunk of one query when the call's queries fill at most an eighth
    of a full chunk (or there is one query), else the full chunk; the word
    instance does not depend on B."""
    p = pdp.plan(qp, 1000, b)
    assert p["qc"] == qc
    assert p["nw"] == pdp.plan(qp, 1000, 256)["nw"]


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
