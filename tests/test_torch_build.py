"""Index build in the PyTorch port against the JAX package: every device
array, every host table, the packed incidence and the edge records must be
identical for the same corpus, through every builder."""

import random

import jax
import numpy as np
import pytest
import torch

from stringsearchlib_tpu.config import IndexConfig
from stringsearchlib_tpu.core import grams as jgrams
from stringsearchlib_tpu.core import text as jtext
from stringsearchlib_tpu.index import build as jbuild
from stringsearchlib_tpu_torch.core import grams as pgrams
from stringsearchlib_tpu_torch.core import text as ptext
from stringsearchlib_tpu_torch.index import build as pbuild
from stringsearchlib_tpu_torch.index.arrays import FIELDS
from stringsearchlib_tpu_torch.index.convert import host_index_from_arrays


def _corpus(n, seed=21):
    rng = random.Random(seed)
    syll = ["ka", "lo", "me", "ri", "su", "ta", "ve", "nor", "bel", "x"]
    out = []
    for _ in range(n):
        w = "".join(rng.choice(syll) for _ in range(rng.randint(1, 6)))
        if rng.random() < 0.2:
            w = w.upper() + " " + rng.choice(syll)
        out.append(w)
    return out


def _rows(n, seed=5):
    """Row-size-2 corpus with weights (zero weights drop pairs, repeated
    descriptions give terms several master keys)."""
    words = _corpus(2 * n, seed)
    rng = np.random.default_rng(seed)
    weights = rng.choice([1.0, 0.5, 0.0, 2.0], size=2 * n).astype(np.float32)
    for i in range(1, 2 * n, 7):
        words[i] = words[1]
    return words, weights


_HOST_ARRAYS = (
    "gram_ids", "host_posting_lens", "host_key_norm_tokens",
    "host_key_norm_lengths", "host_key_edge_counts", "host_long_lengths",
    "host_key_edge_ptr", "host_key_edge_term", "host_key_edge_weight",
)


def _assert_same_index(jh, ph):
    for f in FIELDS:
        a = np.asarray(getattr(jh.device, f))
        b = getattr(ph.device, f).cpu().numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in _HOST_ARRAYS:
        np.testing.assert_array_equal(
            np.asarray(getattr(jh, f)), np.asarray(getattr(ph, f)), err_msg=f
        )
    np.testing.assert_array_equal(jh.key_strings.tokens, ph.key_strings.tokens)
    np.testing.assert_array_equal(jh.key_strings.lengths, ph.key_strings.lengths)
    for f in ("n_terms", "max_term_len", "indexed", "uniform_weights", "n_grams"):
        assert getattr(jh, f) == getattr(ph, f), f


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("device_postings", [True, False])
def test_build_matches_jax(use_native, device_postings):
    words = _corpus(1500)
    kw = dict(use_native=use_native, device_postings=device_postings)
    jh = jbuild.build_index(words, 1, None, IndexConfig(), **kw)
    ph = pbuild.build_index(words, 1, None, IndexConfig(), device="cpu", **kw)
    _assert_same_index(jh, ph)
    if use_native and device_postings:
        assert "native_cpp" in pbuild.LAST_BUILD_BREAKDOWN
        assert "device_postings" in pbuild.LAST_BUILD_BREAKDOWN
        assert set(pbuild.LAST_BUILD_BREAKDOWN) == set(jbuild.LAST_BUILD_BREAKDOWN)


@pytest.mark.parametrize("use_native", [True, False])
def test_weighted_rows_build_matches_jax(use_native):
    words, weights = _rows(600)
    jh = jbuild.build_index(words, 2, weights, IndexConfig(), use_native=use_native)
    ph = pbuild.build_index(
        words, 2, weights, IndexConfig(), use_native=use_native, device="cpu"
    )
    assert not ph.uniform_weights
    assert ph.device.extra_key.shape[0] > 0
    _assert_same_index(jh, ph)
    for a, b in zip(jh.prim_tables(), ph.prim_tables()):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_bitmap_tables_match_jax_bytes(monkeypatch):
    words = _corpus(2500, seed=9)
    jh = jbuild.build_index(words, 1, None, IndexConfig())
    ph = pbuild.build_index(words, 1, None, IndexConfig(), device="cpu")
    jbm, jtl = jh.bitmap_tables()
    pbm, ptl = ph.bitmap_tables()
    assert jtl == ptl
    assert pbm.dtype == torch.int8 and tuple(pbm.shape) == tuple(jbm.shape)
    np.testing.assert_array_equal(pbm.numpy(), np.asarray(jbm))
    # the posting-chunked scatter gives the same bytes at any chunk size
    monkeypatch.setattr(pbuild.HostIndex, "BITS_CHUNK", 1001)
    ph._bitmap_cache = None
    np.testing.assert_array_equal(ph.bitmap_tables()[0].numpy(), np.asarray(jbm))
    for a, b in zip(jh.prim_tables(), ph.prim_tables()):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert ph.bitmap_layout() == jh.bitmap_layout()
    assert ph.long_dp_buckets() == jh.long_dp_buckets()


def test_text_and_grams_match_jax():
    rng = np.random.default_rng(11)
    alpha = np.frombuffer(b"aAbB zZ09.%$@!#\t-_", np.uint8)
    strings = [
        alpha[rng.integers(0, alpha.size, rng.integers(0, 24))].tobytes().decode()
        for _ in range(300)
    ]
    tok_j, len_j = jtext.encode_batch(strings, False)
    tok_p, len_p = ptext.encode_batch(strings, False)
    np.testing.assert_array_equal(tok_j, tok_p)
    np.testing.assert_array_equal(len_j, len_p)
    tj = jtext.TextTables(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .%$@")
    tp = ptext.TextTables(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .%$@")
    nj, lj = jtext.normalize_matrix(tok_j, len_j, tj)
    npt, lp = ptext.normalize_matrix(tok_p, len_p, tp)
    np.testing.assert_array_equal(nj, npt)
    np.testing.assert_array_equal(lj, lp)
    for g in (2, 3, 4):
        gj, vj = jgrams.gram_ids(nj, lj, g, False)
        gp_, vp = pgrams.gram_ids(npt, lp, g, False)
        np.testing.assert_array_equal(gj, gp_)
        np.testing.assert_array_equal(vj, vp)


def _jax_arrays(jh):
    arrays = {f"dev_{f}": np.asarray(jax.device_get(getattr(jh.device, f))) for f in FIELDS}
    arrays.update(
        gram_ids=jh.gram_ids,
        key_tokens=jh.key_strings.tokens,
        key_lengths=jh.key_strings.lengths,
        host_key_norm_tokens=jh.host_key_norm_tokens,
        host_key_norm_lengths=jh.host_key_norm_lengths,
        host_key_edge_counts=jh.host_key_edge_counts,
    )
    meta = dict(
        gram_size=jh.config.gram_size, wide=jh.config.wide,
        valid_chars=jh.tables.valid_chars, n_terms=jh.n_terms,
        max_term_len=jh.max_term_len, indexed=jh.indexed,
    )
    return arrays, meta


def test_host_index_from_arrays_equals_own_build():
    words, weights = _rows(400, seed=8)
    jh = jbuild.build_index(words, 2, weights, IndexConfig())
    own = pbuild.build_index(words, 2, weights, IndexConfig(), device="cpu")
    arrays, meta = _jax_arrays(jh)
    carried = host_index_from_arrays(arrays, meta, "cpu")
    _assert_same_index(jh, carried)
    _assert_same_index(jh, own)
    assert carried.tables.valid_chars == own.tables.valid_chars
    with pytest.raises(KeyError):
        host_index_from_arrays({k: v for k, v in arrays.items() if k != "dev_key_len"}, meta, "cpu")
