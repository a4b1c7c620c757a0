"""The result emit on the CPU: ``KeyStrings.take_flat`` against
``decode_row`` key for key, and every emit site of the engine (candidate
pass, h* selection retry, dense and brute chunks, the single and the
wildcard) against a per-row reference emit - a gather and a bytes decode
per row, a ``tolist`` of each row's scores - result for result and type for
type; ``_emit_row`` stays the one per-row store."""

import random

import numpy as np
import pytest

from stringsearchlib_tpu_torch.config import IndexConfig
from stringsearchlib_tpu_torch.core import text
from stringsearchlib_tpu_torch.index.build import KeyStrings, build_index
from stringsearchlib_tpu_torch.search.engine import SearchEngine
from stringsearchlib_tpu_torch.utils.oracle import OracleIndex

NARROW = [
    "kalomeri", "caf\xe9 au lait", "\xff\x80\xa0bel", "".join(map(chr, range(128, 256))),
    "ends in nul\x00", "nul\x00inside", "\x00", "x", "ta ve nor",
]
WIDE = [
    "日本語", "\U0001f600 emoji", "\U0010ffff\U00010000", "caf\xe9",
    "퟿￿", "wide ends in nul\x00", "a\x00b", "Ā" * 50,
]


def _corpus(n, seed):
    rng = random.Random(seed)
    syll = ["ka", "lo", "me", "ri", "su", "ta", "ve", "nor", "bel"]
    return ["".join(rng.choice(syll) for _ in range(rng.randint(2, 5))) for _ in range(n)]


def _queries(words, n, seed):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        w = words[rng.randrange(len(words))]
        j = rng.randrange(max(len(w) - 1, 1))
        out.append(w if i % 3 == 0 else w[:j] + "x" + w[j + 1:])
    return out


def _take_per_row(ks, ids):
    """The per-row decode the block emit replaced: one gather and one bytes
    conversion for the row, then a slice and a decode per key."""
    ids = np.asarray(ids, dtype=np.int64)
    toks, lens, w = ks.tokens[ids], ks.lengths[ids], ks.tokens.shape[1]
    if ks.wide:
        buf = toks.astype(np.uint32).tobytes()
        return [buf[i * 4 * w: i * 4 * w + 4 * int(lens[i])].decode("utf-32-le")
                for i in range(ids.shape[0])]
    buf = toks.astype(np.uint8).tobytes()
    return [buf[i * w: i * w + int(lens[i])].decode("latin-1") for i in range(ids.shape[0])]


def _reference_emit_rows(self, out, positions, counts, ids_b, scores_b, limit):
    for pos, c, ids_row, scores_row in zip(positions, counts, ids_b, scores_b):
        n = min(int(c), limit, ids_row.shape[0])
        out[pos] = (_take_per_row(self.host.key_strings, ids_row[:n]),
                    scores_row[:n].astype(np.float64).tolist())


def _same(got, want):
    """Equal element for element, keys ``str`` and scores ``float``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
        assert all(type(k) is str for k in g[0]) and all(type(s) is float for s in g[1])


def _key_strings(strings, wide):
    tokens, lengths = text.encode_batch(strings, wide)
    return KeyStrings(tokens, lengths, wide)


@pytest.mark.parametrize("wide", [False, True])
def test_take_flat_equals_decode_row(wide):
    strings = WIDE if wide else NARROW
    ks = _key_strings(strings, wide)
    assert int(ks.lengths.max()) == ks.tokens.shape[1]  # a key of the full width
    rng = np.random.default_rng(7)
    ids = rng.integers(0, len(strings), 200)
    keys, slow = ks.take_flat(ids)
    want = [text.decode_row(ks.tokens[i], int(ks.lengths[i]), wide) for i in ids]
    assert keys == want == [strings[i] for i in ids]
    assert all(type(k) is str for k in keys)
    # the keys ending in U+0000 are decoded one by one, and counted
    ended = {i for i, s in enumerate(strings) if s.endswith("\x00")}
    assert set(ks.nul_ended.tolist()) == ended
    assert slow == sum(int(i) in ended for i in ids) > 0
    assert ks.take_flat(ids[[i not in ended for i in ids]])[1] == 0
    assert ks.take_flat(np.zeros(0, np.int64)) == ([], 0)


def test_take_flat_ignores_what_lies_past_a_length():
    ks = _key_strings(NARROW, False)
    ks.tokens[np.arange(ks.tokens.shape[1]) >= ks.lengths[:, None]] = ord("#")
    ids = np.arange(len(NARROW))
    assert ks.take_flat(ids)[0] == NARROW


def test_wide_keys_hold_no_lone_surrogate():
    """Wide keys come from ``encode("utf-32-le")`` (or a UTF-8 decode), which
    refuse lone surrogates: every wide token is a code point that the "U"
    view and ``decode("utf-32-le")`` read alike."""
    with pytest.raises(UnicodeEncodeError):
        text.encode_batch(["a\ud800b"], True)
    with pytest.raises(UnicodeDecodeError):
        text.encode_batch([b"a\xed\xa0\x80b"], True)


@pytest.fixture(scope="module")
def words():
    return _corpus(1500, seed=41) + ["caf\xe9 " + w for w in _corpus(30, seed=43)]


@pytest.fixture()
def engine(words):
    """Batches take the candidate route (bitmap_kernel, h* on these uniform
    weights); small h* budgets send rows to the selection and dense
    retries."""
    eng = SearchEngine(build_index(words, 1, None, IndexConfig(), device="cpu"))
    eng.GM_BUDGET = 0
    eng.CAND_MIN_TERMS = 100
    return eng


def _spy(monkeypatch, eng, name):
    seen = []
    orig = getattr(eng, name)
    monkeypatch.setattr(eng, name, lambda *a: seen.append(1) or orig(*a))
    return seen


def _both(monkeypatch, eng, run):
    """The results of ``run`` and its call's counters, once the same run
    with the per-row reference emit has given the same results."""
    got = run()
    call = eng.last_routing["call"]
    with monkeypatch.context() as m:
        m.setattr(SearchEngine, "_emit_rows", _reference_emit_rows)
        want = run()
    _same(got, want)
    return got, call


@pytest.mark.parametrize("case,limit", [
    ("candidates", 3), ("candidates", 10), ("retried", 3), ("retried", 10),
    ("dense", 3), ("dense", 0), ("brute", 3), ("brute", 0),
])
def test_search_batch_equals_the_per_row_emit(engine, words, monkeypatch, case, limit):
    qs = _queries(words, 40, seed=45) + ["qqqq zzzz", "!!!###", ""]
    mode = "auto"
    if case == "retried":
        monkeypatch.setattr(engine, "HSTAR_KB1", 1)
        monkeypatch.setattr(engine, "HSTAR_KB2", 1)
    elif case == "dense":
        mode = "dense"
    elif case == "brute":
        qs = qs[:8] + ["ka", "lo", "r", "zq"]
    sel = _spy(monkeypatch, engine, "_hstar_sel_retry")
    dense = _spy(monkeypatch, engine, "_run_dense_chunks")
    brute = _spy(monkeypatch, engine, "_run_brute_chunks")
    got, call = _both(monkeypatch, engine,
                      lambda: engine.search_batch(qs, 0.2, limit, mode=mode))
    assert bool(sel) == (case == "retried") and bool(brute) == (case == "brute")
    # an unbounded limit sends every row past the brute tier dense
    assert bool(dense) == (case in ("retried", "dense") or not limit)
    assert call["emit_slow_keys"] == 0
    counts = [len(k) for k, _ in got]
    assert 0 in counts  # rows of count 0
    assert max(counts) == limit or (not limit and max(counts) > 10)
    # the same answers as the oracle's, position for position
    oracle = OracleIndex(words, 1)
    for q, (k, s) in zip(qs, got):
        want = oracle.search(q, 0.2, limit)
        assert sorted((round(x, 5), len(y)) for y, x in zip(k, s)) == sorted(
            (round(float(x), 5), len(y)) for y, x in zip(*want)), q


@pytest.mark.parametrize("query", ["kalomeri", "ka", "lokameri supo belnor tave kalo ri", "*", ""])
@pytest.mark.parametrize("limit", [2, 0])
def test_search_equals_the_per_row_emit(engine, words, monkeypatch, query, limit):
    engine.search_batch(_queries(words, 16, seed=47), 0.2, 10)  # the resident tables
    ((keys, scores),), _ = _both(monkeypatch, engine,
                                 lambda: [engine.search(query, 0.05, limit)])
    assert keys
    assert len(keys) == limit or (not limit and len(keys) > 2)
    if query in ("*", ""):
        assert len(engine._wildcard_cache) >= 1


def test_emit_row_stores_each_emitted_row_once(engine, words, monkeypatch):
    """``_emit_row(self, out, pos, keys, scores)`` is called once per row
    emitted, with lists of the row's own; what it leaves in ``out[pos]`` is
    the answer (the hook a planted fault alters)."""
    monkeypatch.setattr(engine, "HSTAR_KB1", 1)
    monkeypatch.setattr(engine, "HSTAR_KB2", 1)
    qs = _queries(words, 40, seed=49) + ["ka", "r", "qqqq zzzz"]
    calls = []
    orig = SearchEngine._emit_row

    def emit_row(self, out, pos, *a, **k):
        orig(self, out, pos, *a, **k)
        calls.append(pos)
        keys, scores = out[pos]
        if scores:
            scores[0] = -1.0

    monkeypatch.setattr(SearchEngine, "_emit_row", emit_row)
    got = engine.search_batch(qs, 0.2, 5)
    assert engine.last_routing["call"]["retry_fast"] > 0
    assert sorted(calls) == list(range(len(qs)))
    lists = [id(x) for k, s in got for x in (k, s)]
    assert len(set(lists)) == len(lists)
    assert all(s[0] == -1.0 for _, s in got if s)
    assert got[-1] == ([], [])  # a row of count 0, emitted all the same
    calls.clear()
    keys, scores = engine.search("kalomeri", 0.2, 5)
    assert calls == [0] and scores[0] == -1.0


@pytest.mark.parametrize("wide", [False, True])
def test_emit_slow_keys_counts_the_fallback(monkeypatch, wide):
    strings = WIDE if wide else NARROW
    eng = SearchEngine(build_index(strings, 1, None, IndexConfig(wide=wide), device="cpu"))
    ended = sum(s.endswith("\x00") for s in strings)
    qs = ["*", "ends in nul", "kalomeri"] if not wide else ["*", "wide ends in nul", "caf\xe9"]
    got, call = _both(monkeypatch, eng, lambda: eng.search_batch(qs, 0.0, 0))
    assert call["emit_slow_keys"] >= ended + 1
    assert any(k.endswith("\x00") for k in got[0][0])
    eng.search_batch(qs[2:], 0.5, 0)
    assert eng.last_routing["call"]["emit_slow_keys"] == 0
