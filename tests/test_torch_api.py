"""The PyTorch port's API surface on the CPU: the flat C-style API (handle
and guid registries, README variants, quirks), its ctypes shim with the
reference DLL's signatures, and save/load through it - the reference's
tests/test_api.py, test_cabi.py and test_capi_persist.py mirrored with
``device="cpu"`` and compared with the reference's ``capi`` on the same
inputs.  Also: the port imports neither jax nor the reference package."""

import ctypes as ct
import os
import re
import subprocess
import sys
import threading

import pytest

from stringsearchlib_tpu.api import capi as jcapi
from stringsearchlib_tpu.api.registry import GLOBAL_REGISTRY as JREG
from stringsearchlib_tpu_torch import StringSearchIndex
from stringsearchlib_tpu_torch.api import cabi, capi
from stringsearchlib_tpu_torch.api.registry import GLOBAL_REGISTRY, RWLock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = ["LWMS", "LWM", "LWMA", "LWYY", "L", "I", "GHRSDGSDGS Egdsrtg g"]
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def clean_registry():
    GLOBAL_REGISTRY.clear()
    JREG.clear()
    yield
    GLOBAL_REGISTRY.clear()
    JREG.clear()


# ---------------------------------------------------------------------------
# capi (tests/test_api.py)
# ---------------------------------------------------------------------------


def test_handle_lifecycle():
    h = capi.indexN(FIXTURE, rowSize=1, **CPU)
    assert h == 1 == jcapi.indexN(FIXTURE, rowSize=1)
    assert capi.getSize(h) == 7 == jcapi.getSize(h)
    assert capi.getLibSize(h) == 16 == jcapi.getLibSize(h)
    res = capi.search(h, "LWMS", 0.5, 0)
    assert len(res) == 4 and res[0] == "LWMS"
    strings, scores = capi.score(h, "LWMS", 0.5, 0)
    assert scores[0] == 100.0
    assert (strings, scores) == jcapi.score(h, "LWMS", 0.5, 0)
    capi.release(h, strings, scores)  # no-op
    capi.dispose(h)
    assert capi.search(h, "LWMS") == []
    assert capi.getSize(h) == 0
    capi.dispose(h)  # missing handle ignored


def test_handle_reuse_lowest_free():
    h1 = capi.indexN(["a", "b"], rowSize=1, **CPU)
    h2 = capi.indexN(["c", "d"], rowSize=1, **CPU)
    assert (h1, h2) == (1, 2)
    capi.dispose(h1)
    assert capi.indexN(["e", "f"], rowSize=1, **CPU) == 1


def test_guid_keyed_index():
    capi.index("lib-1", FIXTURE, rowSize=1, **CPU)
    assert capi.getSize("lib-1") == 7
    assert capi.search("lib-1", "LWMS", 0.5, 0)[0] == "LWMS"
    capi.dispose("lib-1")
    assert capi.search("lib-1", "LWMS") == []


def test_missing_keys_return_zero():
    assert capi.search(42, "q") == []
    assert capi.score("nope", "q") == ([], [])
    assert capi.getSize(42) == 0
    assert capi.getLibSize("nope") == 0


def test_size_truncation():
    h = capi.indexN(FIXTURE + ["EXTRA"], size=7, rowSize=1, **CPU)
    assert capi.getSize(h) == 7


def test_unusable_small_index_still_gets_handle():
    h = capi.indexN(["only"], rowSize=1, **CPU)
    assert h >= 1
    assert capi.search(h, "only") == [] == jcapi.search(jcapi.indexN(["only"]), "only")


def test_index_wide():
    capi.indexW("w", ["北京烤鸭店", "Càfé au lait"], rowSize=1, **CPU)
    assert capi.searchW("w", "北京烤鸭", 0.3)[0] == "北京烤鸭店"
    assert capi.getSizeW("w") == 2
    jcapi.indexW("w", ["北京烤鸭店", "Càfé au lait"], rowSize=1)
    for q in ("北京烤鸭", "cafe", "Càfé"):
        assert capi.scoreW("w", q, 0.1) == jcapi.scoreW("w", q, 0.1), q
    capi.disposeW("w")


def test_index2d():
    rows = [["Widget A", "wdgt", "gadget a"], ["Widget B", "wb"]]
    capi.index2D("2d", rows, **CPU)
    assert capi.search("2d", "WDGT", 0.5) == ["Widget A"]
    assert capi.search("2d", "wb", 0.9) == ["Widget B"]
    jcapi.index2D("2d", rows)
    for q in ("WDGT", "wb", "gadget", "widget"):
        assert capi.score("2d", q, 0.0) == jcapi.score("2d", q, 0.0), q


def test_index2d_weights():
    rows = [["keyA", "altA"], ["keyB", "altB"]]
    weight = [[1.0, 0.0], [1.0, 0.5]]
    capi.index2DW("2dw", rows, weight=weight, **CPU)
    assert capi.searchW("2dw", "ALTA", 0.9) == []  # weight 0 drops the pair
    strings, scores = capi.scoreW("2dw", "ALTB", 0.4)
    assert strings == ["keyB"] and scores[0] == pytest.approx(0.5)
    jcapi.index2DW("2dw", rows, weight=weight)
    assert capi.scoreW("2dw", "ALTB", 0.4) == jcapi.scoreW("2dw", "ALTB", 0.4)


def test_gsize_parameter():
    capi.index("g2", ["ab", "abcd", "zz"], gSize=2, **CPU)
    assert capi.getLibSize("g2") == 3
    assert "abcd" in capi.search("g2", "abc", 0.4, 0)


def test_set_valid_char():
    h = capi.indexN(["foo-bar", "baz"], rowSize=1, **CPU)
    assert capi.search(h, "foo-bar", 0.9) == ["foo-bar"]
    capi.setValidChar(h, "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ-")
    strings, scores = capi.score(h, "foo-bar", 0.3)
    assert strings == ["foo-bar"] and scores[0] == pytest.approx(0.4)
    j = jcapi.indexN(["foo-bar", "baz"], rowSize=1)
    jcapi.setValidChar(j, "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ-")
    assert capi.score(h, "foo-bar", 0.3) == jcapi.score(j, "foo-bar", 0.3)


def test_pythonic_class():
    idx = StringSearchIndex(FIXTURE, device="cpu")
    assert idx.size() == 7 and idx.lib_size() == 16
    strings, scores = idx.score("LWMS", 0.5, limit=0)
    assert strings[0] == "LWMS" and scores[0] == 100.0
    assert idx.search("lwm", 0.5)[0] in ("LWM", "LWMS")


def test_build_defaults_to_the_card():
    """Building or loading through the flat API, like every entry point,
    targets the card unless the caller asks for the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        capi.indexN(FIXTURE, rowSize=1)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        capi.index("g", FIXTURE)
    assert capi.getSize(1) == 0 and capi.getSize("g") == 0


def test_concurrent_readers_and_writers():
    h = capi.indexN(FIXTURE, rowSize=1, **CPU)
    errors = []

    def reader():
        try:
            for _ in range(20):
                capi.search(h, "LWMS", 0.5)
                capi.getSize(h)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def writer():
        try:
            for _ in range(10):
                capi.dispose(capi.indexN(["x", "y"], rowSize=1, **CPU))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(4)] + [
        threading.Thread(target=writer) for _ in range(2)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


def test_rwlock_excludes_writers():
    lock = RWLock()
    state = {"readers": 0, "writer": False}
    bad = []

    def read_task():
        for _ in range(50):
            with lock.read():
                state["readers"] += 1
                if state["writer"]:
                    bad.append("reader saw writer")
                state["readers"] -= 1

    def write_task():
        for _ in range(20):
            with lock.write():
                if state["readers"] or state["writer"]:
                    bad.append("writer not exclusive")
                state["writer"] = True
                state["writer"] = False

    threads = [threading.Thread(target=read_task) for _ in range(4)] + [
        threading.Thread(target=write_task) for _ in range(2)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad


# ---------------------------------------------------------------------------
# saveIndex / loadIndex (tests/test_capi_persist.py)
# ---------------------------------------------------------------------------


def test_save_load_handle(tmp_path):
    h = capi.indexN(FIXTURE, rowSize=1, **CPU)
    path = tmp_path / "idx.npz"
    assert capi.saveIndex(h, path)
    h2 = capi.loadIndex(path, **CPU)
    assert h2 != h
    assert capi.getSize(h2) == capi.getSize(h) == 7
    assert capi.getLibSize(h2) == 16
    assert capi.score(h2, "LWMS", 0.5, 0) == capi.score(h, "LWMS", 0.5, 0)
    # the reference loads the port's file, and the port the reference's
    j = jcapi.loadIndex(path)
    assert jcapi.score(j, "LWMS", 0.5, 0) == capi.score(h2, "LWMS", 0.5, 0)
    jpath = tmp_path / "jax.npz"
    assert jcapi.saveIndex(j, jpath)
    h3 = capi.loadIndex(jpath, **CPU)
    assert capi.score(h3, "LWMS", 0.5, 0) == capi.score(h, "LWMS", 0.5, 0)
    for k in (h, h2, h3):
        capi.dispose(k)


def test_save_missing_handle(tmp_path):
    assert not capi.saveIndex(999999, tmp_path / "x.npz")


def test_load_guid(tmp_path):
    h = capi.indexN(FIXTURE, rowSize=1, **CPU)
    path = tmp_path / "idx.npz"
    capi.saveIndex(h, path)
    capi.dispose(h)
    assert capi.loadIndex(path, guid="restored", **CPU) == "restored"
    assert capi.getSize("restored") == 7
    capi.dispose("restored")


# ---------------------------------------------------------------------------
# cabi (tests/test_cabi.py), its tables bound to the CPU
# ---------------------------------------------------------------------------

WORDS = [w.encode() for w in FIXTURE]


def _char_pp(items):
    arr = (ct.c_char_p * len(items))()
    for i, b in enumerate(items):
        arr[i] = b
    return arr


def _fn(table, name):
    """A table's entry called through its raw address, as a C host would."""
    fn, addr = table[name]
    return ct.cast(addr, type(fn))


def test_cabi_fixture_roundtrip():
    tbl = cabi.function_table(**CPU)
    index_n, score, search = (_fn(tbl, n) for n in ("indexN", "score", "search"))
    release, dispose = _fn(tbl, "release"), _fn(tbl, "dispose")
    words = _char_pp(WORDS)
    h = index_n(words, len(WORDS), 1, None)
    assert h >= 1
    assert _fn(tbl, "getSize")(h) == 7
    assert _fn(tbl, "getLibSize")(h) == 16

    results = ct.POINTER(ct.c_char_p)()
    scores = ct.POINTER(ct.c_float)()
    n = score(h, b"LWMS", ct.byref(results), ct.byref(scores), ct.c_float(0.5), 0)
    assert n == 4
    got = [(results[i].decode(), round(scores[i], 4)) for i in range(n)]
    assert got[0] == ("LWMS", 100.0)
    assert set(got[1:3]) == {("LWM", 0.75), ("LWMA", 0.75)}
    assert got[3] == ("LWYY", 0.5)
    assert results[n] is None
    jres = ct.POINTER(ct.c_char_p)()
    jsc = ct.POINTER(ct.c_float)()
    from stringsearchlib_tpu.api import cabi as jcabi

    jh = jcabi.indexN(words, len(WORDS), 1, None)
    assert jcabi.score(jh, b"LWMS", ct.byref(jres), ct.byref(jsc),
                       ct.c_float(0.5), 0) == n
    assert [(jres[i], jsc[i]) for i in range(n)] == [(results[i], scores[i]) for i in range(n)]
    jcabi.release(jh, jres, jsc)
    release(h, results, scores)

    res2 = ct.POINTER(ct.c_char_p)()
    n2 = search(h, b"LWMS", ct.byref(res2), ct.c_float(0.5), 0)
    assert n2 == 4 and res2[0] == b"LWMS"
    release(h, res2, None)

    # weights: zero weight drops the pair
    w = (ct.c_float * len(WORDS))(*([1.0] * len(WORDS)))
    w[0] = 0.0
    h2 = index_n(words, len(WORDS), 1, w)
    res3 = ct.POINTER(ct.c_char_p)()
    n3 = search(h2, b"LWMS", ct.byref(res3), ct.c_float(0.5), 0)
    assert b"LWMS" not in [res3[i] for i in range(n3)]
    release(h2, res3, None)

    # setValidChar then dispose; missing handle -> 0 results
    _fn(tbl, "setValidChar")(h, b"ABC", 3)
    dispose(h)
    dispose(h2)
    assert search(h, b"LWMS", ct.byref(res3), ct.c_float(0.5), 0) == 0
    assert _fn(tbl, "getSize")(h) == 0


def test_cabi_function_table():
    tbl = cabi.function_table(**CPU)
    assert set(tbl) == {"indexN", "search", "score", "release", "dispose",
                        "getSize", "getLibSize", "setValidChar"}
    for _, (fn, addr) in tbl.items():
        assert isinstance(addr, int) and addr != 0
    # bound once per device; the module's own callbacks are the card's
    assert cabi.function_table(**CPU)["indexN"][1] == tbl["indexN"][1]
    assert cabi.function_table()["indexN"][0] is cabi.indexN
    assert tbl["indexN"][0] is not cabi.indexN
    assert tbl["search"][0] is cabi.search


def test_cabi_guid_narrow_roundtrip():
    tbl = cabi.function_table_guid(**CPU)
    words = _char_pp(WORDS)
    _fn(tbl, "index")(b"fixture-guid", words, len(WORDS), 1, None, 3)
    assert _fn(tbl, "getSize")(b"fixture-guid") == 7
    assert _fn(tbl, "getLibSize")(b"fixture-guid") == 16
    results = ct.POINTER(ct.c_char_p)()
    n = ct.c_uint32(0)
    search = _fn(tbl, "search")
    search(b"fixture-guid", b"LWMS", ct.byref(results), ct.byref(n), ct.c_float(0.5), 0)
    assert n.value == 4
    assert results[0] == b"LWMS" and results[n.value] is None
    _fn(tbl, "release")(b"fixture-guid", ct.byref(results), n.value)
    _fn(tbl, "dispose")(b"fixture-guid")
    search(b"fixture-guid", b"LWMS", ct.byref(results), ct.byref(n), ct.c_float(0.5), 0)
    assert n.value == 0


def test_cabi_guid_wide_roundtrip():
    tbl = cabi.function_table_guid(**CPU)
    wide_words = ["café", "naïve", "汉字检索", "übermut", "汉字系统"]
    arr = (ct.c_wchar_p * len(wide_words))(*wide_words)
    _fn(tbl, "indexW")(b"wide-guid", arr, len(wide_words), 1, None, 2)
    assert _fn(tbl, "getSizeW")(b"wide-guid") == len(wide_words)
    results = ct.POINTER(ct.c_wchar_p)()
    n = ct.c_uint32(0)
    _fn(tbl, "searchW")(b"wide-guid", "汉字检索", ct.byref(results), ct.byref(n),
                        ct.c_float(0.2), 0)
    got = [results[i] for i in range(n.value)]
    assert got[0] == "汉字检索" and "汉字系统" in got
    jcapi.indexW("wide-guid", wide_words, rowSize=1, gSize=2)
    assert got == jcapi.searchW("wide-guid", "汉字检索", 0.2, 0)
    _fn(tbl, "releaseW")(b"wide-guid", ct.byref(results), n.value)
    _fn(tbl, "disposeW")(b"wide-guid")


def test_cabi_guid_2d_roundtrip():
    tbl = cabi.function_table_guid(**CPU)
    rows_py = [
        [b"ALPHA KEY", b"first description text"],
        [b"BETA KEY", b"second description text"],
    ]
    row_arrs = [(ct.c_char_p * 2)(*r) for r in rows_py]
    key = (ct.POINTER(ct.c_char_p) * 2)(
        *[ct.cast(a, ct.POINTER(ct.c_char_p)) for a in row_arrs]
    )
    w_rows = [(ct.c_float * 2)(1.0, 0.4) for _ in rows_py]
    weight = (ct.POINTER(ct.c_float) * 2)(
        *[ct.cast(a, ct.POINTER(ct.c_float)) for a in w_rows]
    )
    _fn(tbl, "index2D")(b"2d-guid", key, 2, 2, weight, 3)
    results = ct.POINTER(ct.c_char_p)()
    n = ct.c_uint32(0)
    _fn(tbl, "search")(b"2d-guid", b"first description", ct.byref(results),
                       ct.byref(n), ct.c_float(0.2), 0)
    assert n.value >= 1 and results[0] == b"ALPHA KEY"
    _fn(tbl, "release")(b"2d-guid", ct.byref(results), n.value)
    _fn(tbl, "dispose")(b"2d-guid")


def test_cabi_guid_function_table():
    tbl = cabi.function_table_guid(**CPU)
    assert set(tbl) == {
        "index", "indexW", "index2D", "index2DW", "search", "searchW",
        "release", "releaseW", "dispose", "disposeW", "getSize",
        "getSizeW", "getLibSize", "getLibSizeW",
    }
    for name, (fn, addr) in tbl.items():
        assert isinstance(addr, int) and addr != 0, name


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------


def test_every_port_module_imports_without_jax():
    """Every module of the port, imported in a fresh interpreter, loads
    neither jax nor the reference package."""
    code = (
        "import sys, pkgutil, importlib; sys.path.insert(0, sys.argv[1]);"
        "import stringsearchlib_tpu_torch as P;"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')];"
        "[importlib.import_module(n) for n in names];"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'stringsearchlib_tpu' or k.startswith('stringsearchlib_tpu.'));"
        "assert not bad, bad;"
        "need = {'api.capi', 'api.cabi', 'api.registry', 'index.serialize',"
        " 'utils.metrics', 'utils.oracle', 'utils.capacity', 'parallel',"
        " 'parallel.dist', 'parallel.tp', 'parallel.dp_tp', 'parallel.multihost'};"
        "assert need <= {n.split('.', 1)[1] for n in names}, names;"
        "print('ok', len(names))"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code, ROOT], capture_output=True, text=True,
        timeout=300, env=env, cwd=os.path.dirname(ROOT),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith("ok")
    smoke = open(os.path.join(ROOT, "chip_smoke.py")).read()
    banned = re.compile(r"\s*(from|import)\s+(jax|stringsearchlib_tpu)\b")
    assert not [ln for ln in smoke.splitlines() if banned.match(ln)]
    # the multi-process worker entry (tests/test_torch_multihost.py --worker)
    # imports no jax either: only its golden-result helper, which no worker
    # runs, imports the reference
    worker = open(os.path.join(ROOT, "tests", "test_torch_multihost.py")).read()
    top = [ln for ln in worker.splitlines() if not ln.startswith(" ")]
    assert not [ln for ln in top if banned.match(ln)]
    body = worker.split("def _worker(")[1].split("\ndef ")[0]
    assert not [ln for ln in body.splitlines() if banned.match(ln)]
