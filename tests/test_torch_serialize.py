"""Index persistence of the PyTorch port: its own save/load round trips
(the reference's tests/test_serialize.py, mirrored on the CPU) and the
``.npz`` format across packages - JAX save -> port load and port save ->
JAX load - with bit-identical arrays and equal results."""

import io

import numpy as np
import pytest
import torch

from stringsearchlib_tpu.config import IndexConfig as JConfig
from stringsearchlib_tpu.index import serialize as jser
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.search.engine import SearchEngine as JEngine
from stringsearchlib_tpu_torch import StringSearchIndex
from stringsearchlib_tpu_torch.config import IndexConfig
from stringsearchlib_tpu_torch.index import serialize as pser
from stringsearchlib_tpu_torch.index.arrays import FIELDS
from stringsearchlib_tpu_torch.index.build import build_index
from stringsearchlib_tpu_torch.search.engine import SearchEngine

WORDS = [
    "LWMS", "LWM", "LWMA", "LWYY", "L", "I", "GHRSDGSDGS Egdsrtg g",
    "telephone", "telegraph", "photograph", "microscope", "wdgt",
]


def _build(words, row=1, weights=None, **cfg):
    return build_index(words, row, weights, IndexConfig(**cfg), device="cpu")


def _roundtrip(host):
    buf = io.BytesIO()
    pser.save_index(host, buf)
    buf.seek(0)
    return pser.load_index(buf, device="cpu")


# ---------------------------------------------------------------------------
# the reference's round trips, on the port
# ---------------------------------------------------------------------------


def test_roundtrip_narrow(tmp_path):
    host = _build(WORDS)
    path = tmp_path / "idx.npz"
    pser.save_index(host, path)
    loaded = pser.load_index(path, device="cpu")
    assert loaded.n_terms == host.n_terms
    assert loaded.n_grams == host.n_grams
    assert loaded.config == host.config
    np.testing.assert_array_equal(loaded.gram_ids, host.gram_ids)
    for f in FIELDS:
        a, b = getattr(loaded.device, f), getattr(host.device, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    e1, e2 = SearchEngine(host), SearchEngine(loaded)
    for q in ("LWMS", "teleph", "photogra", "xyz", "*", ""):
        assert e1.search(q, 0.3, 10) == e2.search(q, 0.3, 10)


def test_roundtrip_weights_and_rows():
    host = _build(["key a", "alias one", "key b", "alias two"], 2,
                  [1.0, 0.5, 1.0, 0.25])
    loaded = _roundtrip(host)
    assert not loaded.uniform_weights
    e1, e2 = SearchEngine(host), SearchEngine(loaded)
    for q in ("alias", "key", "*"):
        assert e1.search(q, 0.0, 5) == e2.search(q, 0.0, 5)


def test_roundtrip_wide():
    host = _build(["café crème", "中文搜索引擎", "naïve test"], wide=True)
    loaded = _roundtrip(host)
    assert loaded.device.long_tokens.dtype == torch.int32
    e1, e2 = SearchEngine(host), SearchEngine(loaded)
    for q in ("café", "中文搜", "naive"):
        assert e1.search(q, 0.0, 5) == e2.search(q, 0.0, 5)


def test_roundtrip_wide_g4_vocab():
    host = _build(["中文搜索引擎字符", "abcdefgh ijklmnop"], gram_size=4, wide=True)
    loaded = _roundtrip(host)
    assert loaded.vocab is not None
    np.testing.assert_array_equal(loaded.vocab.codepoints, host.vocab.codepoints)
    e1, e2 = SearchEngine(host), SearchEngine(loaded)
    assert e1.search("中文搜索", 0.0, 5) == e2.search("中文搜索", 0.0, 5)


@pytest.mark.parametrize("loader", ["port", "jax"])
def test_version_guard(tmp_path, loader):
    host = _build(WORDS)
    path = tmp_path / "idx.npz"
    pser.save_index(host, path)
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    payload["format_version"] = np.int64(pser.FORMAT_VERSION + 1)
    np.savez(path, **payload)
    with pytest.raises(ValueError, match="format version"):
        if loader == "port":
            pser.load_index(path, device="cpu")
        else:
            jser.load_index(path)
    assert pser.FORMAT_VERSION == jser.FORMAT_VERSION


def test_set_valid_char_survives_roundtrip():
    host = _build(WORDS)
    host.set_valid_char(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ")
    loaded = _roundtrip(host)
    assert loaded.tables.valid_chars == host.tables.valid_chars
    e1, e2 = SearchEngine(host), SearchEngine(loaded)
    assert e1.search("LWMS", 0.3, 5) == e2.search("LWMS", 0.3, 5)


def test_object_api_save_load_and_card_default(tmp_path):
    idx = StringSearchIndex(WORDS, device="cpu")
    path = tmp_path / "obj.npz"
    idx.save(path)
    loaded = StringSearchIndex.load(path, device="cpu")
    assert (loaded.size(), loaded.lib_size()) == (idx.size(), idx.lib_size())
    assert loaded.score("LWMS", 0.5, 0) == idx.score("LWMS", 0.5, 0)
    if not torch.cuda.is_available():
        # like every entry point: the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            StringSearchIndex.load(path)


# ---------------------------------------------------------------------------
# the format across packages
# ---------------------------------------------------------------------------


def _rows2d(n=300):
    """bench.py's 2-D layout, weights [1.0, 0.4]: (words, row, weights, cfg)."""
    import bench

    names = bench._product_names(n, seed=3)
    descs = bench._rich_names(n, seed=4)
    return [x for kv in zip(names, descs) for x in kv], 2, [1.0, 0.4] * n, {}


_CASES = {
    "narrow": lambda: (WORDS * 3 + [w + "x" for w in WORDS], 1, None, {}),
    "rows2d_weighted": _rows2d,
    "wide": lambda: (["café crème", "中文搜索引擎", "naïve test", "Ärger über",
                      "中文字符"], 1, None, {"wide": True}),
    "wide_g4_vocab": lambda: (["中文搜索引擎字符", "abcdefgh ijklmnop", "字符引擎"],
                              1, None, {"wide": True, "gram_size": 4}),
    "narrow_g2": lambda: (WORDS, 1, None, {"gram_size": 2}),
}
_QUERIES = ["LWMS", "teleph", "中文搜", "café", "alias", "*", "", "!!!",
            "acme nova", "GHRSDG"]


def _case(name):
    return _CASES[name]()


def _queries(cfg):
    """Every query for a wide index; a narrow one takes latin-1 only."""
    if cfg.get("wide"):
        return _QUERIES
    return [q for q in _QUERIES if all(ord(c) < 256 for c in q)]


def _assert_same_files(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_jax_file_loads_in_port(tmp_path, name):
    words, row, weights, cfg = _case(name)
    jh = jbuild(words, row, weights, JConfig(**cfg))
    path = tmp_path / "jax.npz"
    jser.save_index(jh, path)
    ph = pser.load_index(path, device="cpu")
    for f in FIELDS:
        want = np.asarray(getattr(jh.device, f))
        got = getattr(ph.device, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(ph.gram_ids, jh.gram_ids)
    np.testing.assert_array_equal(ph.key_strings.tokens, jh.key_strings.tokens)
    np.testing.assert_array_equal(ph.host_key_norm_tokens, jh.host_key_norm_tokens)
    assert (ph.n_terms, ph.n_grams, ph.max_term_len, ph.uniform_weights) == (
        jh.n_terms, jh.n_grams, jh.max_term_len, jh.uniform_weights)
    assert ph.tables.valid_chars == jh.tables.valid_chars
    # the port writes the same file back, key for key and byte for byte
    back = tmp_path / "port.npz"
    pser.save_index(ph, back)
    _assert_same_files(path, back)
    pe, je = SearchEngine(ph), JEngine(jh)
    for q in _queries(cfg):
        assert pe.search(q, 0.2, 10) == je.search(q, 0.2, 10), q


@pytest.mark.parametrize("name", sorted(_CASES))
def test_port_file_loads_in_jax(tmp_path, name):
    words, row, weights, cfg = _case(name)
    ph = build_index(words, row, weights, IndexConfig(**cfg), device="cpu")
    path = tmp_path / "port.npz"
    pser.save_index(ph, path)
    jh = jser.load_index(path)
    for f in FIELDS:
        want = getattr(ph.device, f).numpy()
        got = np.asarray(getattr(jh.device, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    if ph.vocab is not None:
        np.testing.assert_array_equal(jh.vocab.codepoints, ph.vocab.codepoints)
    # the reference builds the same file from the same words
    fresh = tmp_path / "jax.npz"
    jser.save_index(jbuild(words, row, weights, JConfig(**cfg)), fresh)
    _assert_same_files(path, fresh)
    pe, je = SearchEngine(ph), JEngine(jh)
    for q in _queries(cfg):
        assert je.search(q, 0.2, 10) == pe.search(q, 0.2, 10), q
