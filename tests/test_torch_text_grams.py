"""Normalization and gram extraction in both packages: the reference's
tests/test_text.py and tests/test_grams.py, each parametrised over the JAX
package and the PyTorch port (its own copies of ``core/text.py``,
``core/grams.py`` and the oracle), and the port's copies held bit-identical
to the reference's over random byte and wide inputs."""

import random

import numpy as np
import pytest

from stringsearchlib_tpu.core import grams as jgrams
from stringsearchlib_tpu.core import text as jtext
from stringsearchlib_tpu.utils.oracle import OracleIndex as JOracle
from stringsearchlib_tpu_torch.core import grams as pgrams
from stringsearchlib_tpu_torch.core import text as ptext
from stringsearchlib_tpu_torch.utils.oracle import OracleIndex as POracle

PKGS = {"jax": (jtext, jgrams, JOracle), "torch": (ptext, pgrams, POracle)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _norm_via_matrix(text, strings, upper=True, wide=False):
    tables = text.TextTables(wide=wide)
    tokens, lengths = text.encode_batch(strings, wide=wide)
    out, out_len = text.normalize_matrix(tokens, lengths, tables, upper=upper)
    return [text.decode_row(out[i], int(out_len[i]), wide) for i in range(len(strings))]


# ---------------------------------------------------------------------------
# tests/test_text.py
# ---------------------------------------------------------------------------


def test_normalize_matches_oracle(pkg):
    text, _, oracle_cls = pkg
    oracle = oracle_cls(["a", "b"], row_size=1)
    cases = ["  hello world  ", "MiXeD-CaSe!", "...", "", "\t tabs\tand\nnewlines \r",
             "a!b@c#d$e%f", "   ", "UPPER lower 0123"]
    assert _norm_via_matrix(text, cases) == [oracle.normalize(c) for c in cases]


def test_normalize_no_upper_matches_oracle(pkg):
    text, _, oracle_cls = pkg
    oracle = oracle_cls(["a", "b"], row_size=1)
    cases = ["  Foo-Bar  ", "LWMS", "x!y"]
    got = _norm_via_matrix(text, cases, upper=False)
    assert got == [oracle.normalize(c, upper=False) for c in cases]


def test_wide_normalize(pkg):
    text, _, oracle_cls = pkg
    oracle = oracle_cls(["北", "京"], row_size=1, wide=True)
    cases = ["  北京 café ", "Ärger!", "ｗｉｄｅ"]
    assert _norm_via_matrix(text, cases, wide=True) == [oracle.normalize(c) for c in cases]


def test_trim_all_space_row(pkg):
    text = pkg[0]
    tokens, lengths = text.encode_batch(["   ", "a"], wide=False)
    out, out_len = text.trim_matrix(tokens, lengths, text.TextTables())
    assert out_len.tolist() == [0, 1]
    assert (out[0] == 0).all()


def test_escape_blank_preserves_pad(pkg):
    text = pkg[0]
    tokens, lengths = text.encode_batch(["a!b", "xy"], wide=False)
    out = text.escape_blank_matrix(tokens, lengths, text.TextTables())
    assert text.decode_row(out[0], 3, False) == "a b"
    assert out[1, 2] == 0  # pad untouched


def test_upper_only_ascii_lowercase(pkg):
    text = pkg[0]
    tokens, lengths = text.encode_batch(["abZ9.", "\xe9"], wide=False)
    out = text.upper_matrix(tokens, lengths, text.TextTables())
    assert text.decode_row(out[0], 5, False) == "ABZ9."
    # latin-1 e-acute is untouched by C toupper in the C locale
    assert text.decode_row(out[1], 1, False) == "\xe9"


def _upper_wide(text, s, mode):
    tables = text.TextTables(wide=True, wide_upper=mode)
    tokens, lengths = text.encode_batch([s], wide=True)
    out = text.upper_matrix(tokens, lengths, tables)
    return text.decode_row(out[0], int(lengths[0]), True)


def test_wide_upper_divergent_codepoints(pkg):
    """The towupper parity decision (IndexConfig.wide_upper) on the
    codepoints where C towupper and Unicode full / simple uppercase
    disagree (nGramSearch.h:83-87)."""
    text = pkg[0]
    cases = [
        ("\xe9", "\xc9"), ("\xff", "Ÿ"), ("\xdf", "\xdf"), ("ı", "I"),
        ("İ", "İ"), ("ﬁ", "ﬁ"), ("\xb5", "Μ"), ("ǆ", "Ǆ"),
    ]
    for s, want in cases:
        assert _upper_wide(text, s, "simple") == want, s
        assert _upper_wide(text, s, "c") == s, s  # C-locale: ASCII only
    assert _upper_wide(text, "abz", "simple") == "ABZ"
    assert _upper_wide(text, "abz", "c") == "ABZ"


def test_wide_upper_modes_match_oracle(pkg):
    text, _, oracle_cls = pkg
    cases = ["Stra\xdfe", "ırmak", "caf\xe9 \xff", "ﬁne"]
    for mode in ("simple", "c"):
        oracle = oracle_cls(["a", "b"], row_size=1, wide=True, wide_upper=mode)
        tables = text.TextTables(wide=True, wide_upper=mode)
        tokens, lengths = text.encode_batch(cases, wide=True)
        out, out_len = text.normalize_matrix(tokens, lengths, tables)
        got = [text.decode_row(out[i], int(out_len[i]), True) for i in range(len(cases))]
        assert got == [oracle.normalize(c) for c in cases], mode


# ---------------------------------------------------------------------------
# tests/test_grams.py
# ---------------------------------------------------------------------------


def _gram_list(pkg, s, g, wide=False, vocab=None):
    text, grams, _ = pkg
    tokens, lengths = text.encode_batch([s], wide=wide)
    ids, valid = grams.gram_ids(tokens, lengths, g, wide, vocab)
    return ids[0][valid[0]].tolist()


def test_trigram_matches_reference_hash(pkg):
    # for ASCII g=3 the packed value equals gramHash (nGramSearch.h:147-150)
    assert _gram_list(pkg, "ABC", 3) == [(ord("A") << 16) | (ord("B") << 8) | ord("C")]


def test_window_counts(pkg):
    assert _gram_list(pkg, "ABCD", 3) == [
        (65 << 16) | (66 << 8) | 67, (66 << 16) | (67 << 8) | 68,
    ]
    assert _gram_list(pkg, "AB", 3) == []
    assert _gram_list(pkg, "", 3) == []
    assert len(_gram_list(pkg, "ABCD", 2)) == 3
    assert len(_gram_list(pkg, "ABCDE", 4)) == 2


def test_duplicates_preserved_query_side(pkg):
    ids = _gram_list(pkg, "AAAA", 3)
    assert len(ids) == 2 and ids[0] == ids[1]


def test_unique_grams_per_row(pkg):
    text, grams, _ = pkg
    tokens, lengths = text.encode_batch(["AAAA"], wide=False)
    ids, valid = grams.gram_ids(tokens, lengths, 3, False)
    _, uvalid = grams.unique_grams_per_row(ids, valid)
    assert uvalid.sum() == 1


def test_wide_packing_injective(pkg):
    a = _gram_list(pkg, "北京烤", 3, wide=True)
    b = _gram_list(pkg, "北京鸭", 3, wide=True)
    assert a != b and len(a) == len(b) == 1


def test_wide_g4_vocab(pkg):
    text, grams, _ = pkg
    tokens, _ = text.encode_batch(["北京烤鸭店"], wide=True)
    vocab = grams.WideVocab(tokens.ravel())
    ids = _gram_list(pkg, "北京烤鸭店", 4, wide=True, vocab=vocab)
    assert len(ids) == 2 and ids[0] != ids[1]
    # an unseen codepoint maps through id 0: a gram no index row has
    assert _gram_list(pkg, "XXXX", 4, wide=True, vocab=vocab)[0] not in ids


def test_distinct_count_fixture(pkg):
    # "GHRSDGSDGS EGDSRTG G" -> 18 trigrams, 16 distinct (test.cpp:15)
    ids = _gram_list(pkg, "GHRSDGSDGS EGDSRTG G", 3)
    assert len(ids) == 18 and len(set(ids)) == 16


# ---------------------------------------------------------------------------
# the port's copies against the reference's, on random inputs
# ---------------------------------------------------------------------------

_NARROW_POOL = [chr(c) for c in range(256)]
_WIDE_POOL = (_NARROW_POOL + [chr(c) for c in range(0x100, 0x250)]
              + list("中文日本語かなカナ한국ΩΣλ") + ["　", " ", "ﬁ", "ǆ"])


def _random_strings(seed, pool, n=300):
    rng = random.Random(seed)
    return ["".join(rng.choice(pool) for _ in range(rng.randint(0, 40))) for _ in range(n)]


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wide,wide_upper,seed", [
    (False, "simple", 1), (False, "simple", 2), (True, "simple", 3), (True, "c", 4),
])
def test_text_copy_bit_identical(wide, wide_upper, seed):
    strings = _random_strings(seed, _WIDE_POOL if wide else _NARROW_POOL)
    valid = bytes(random.Random(seed).sample(range(256), 120))
    jt, pt = (t.TextTables(valid, wide=wide, wide_upper=wide_upper) for t in (jtext, ptext))
    enc = jtext.encode_batch(strings, wide)
    _same(ptext.encode_batch(strings, wide), enc)
    tokens, lengths = enc
    for fn, extra in (("escape_blank_matrix", ()), ("trim_matrix", ()),
                      ("upper_matrix", ()), ("trim_only_matrix", ())):
        _same(getattr(ptext, fn)(tokens, lengths, pt, *extra),
              getattr(jtext, fn)(tokens, lengths, jt, *extra))
    for upper in (True, False):
        want = jtext.normalize_matrix(tokens, lengths, jt, upper=upper)
        _same(ptext.normalize_matrix(tokens, lengths, pt, upper=upper), want)
        out, out_len = want
        for i in range(len(strings)):
            assert (ptext.decode_row(out[i], int(out_len[i]), wide)
                    == jtext.decode_row(out[i], int(out_len[i]), wide))


@pytest.mark.parametrize("wide,gram_size", [
    (False, 2), (False, 3), (False, 4), (True, 2), (True, 3), (True, 4),
])
def test_grams_copy_bit_identical(wide, gram_size):
    strings = _random_strings(10 * gram_size + wide, _WIDE_POOL if wide else _NARROW_POOL)
    tokens, lengths = jtext.encode_batch(strings, wide)
    jv = pv = None
    if wide and gram_size == 4:
        jv, pv = jgrams.WideVocab(tokens.ravel()), pgrams.WideVocab(tokens.ravel())
        np.testing.assert_array_equal(pv.codepoints, jv.codepoints)
    _same(pgrams.window_count(lengths, gram_size), jgrams.window_count(lengths, gram_size))
    windows = jgrams.extract_windows(tokens, lengths, gram_size)
    _same(pgrams.extract_windows(tokens, lengths, gram_size), windows)
    for bits in (8, 21):
        _same(pgrams.pack_fields(windows[0], bits), jgrams.pack_fields(windows[0], bits))
    want = jgrams.gram_ids(tokens, lengths, gram_size, wide, jv)
    _same(pgrams.gram_ids(tokens, lengths, gram_size, wide, pv), want)
    _same(pgrams.unique_grams_per_row(*want), jgrams.unique_grams_per_row(*want))
