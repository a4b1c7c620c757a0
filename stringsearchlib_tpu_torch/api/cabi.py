"""Binary C-ABI shim (ctypes) with the reference DLL's exact signatures.

PyTorch counterpart of ``stringsearchlib_tpu.api.cabi``.  The DLL's product
is an ``extern "C"`` surface (dllmain.cpp:37-151):

  uint32_t indexN(char** words, uint64_t size, uint16_t rowSize, float* weight)
  uint32_t search(uint32_t handle, const char* query, char*** results,
                  float threshold, uint32_t limit)
  uint32_t score(uint32_t handle, const char* query, char*** results,
                 float** scores, float threshold, uint32_t limit)
  void     release(uint32_t handle, char** results, float* scores)
  void     dispose(uint32_t handle)
  uint64_t getSize(uint32_t handle)
  uint64_t getLibSize(uint32_t handle)
  void     setValidChar(uint32_t handle, char* characters, int n)

This module reproduces that surface as ctypes CFUNCTYPE callbacks - int
handles, out-parameters, count returns, and explicit release() ownership of
the allocated result arrays - so a C host (through the CPython API or any
FFI that accepts raw function pointers) drives the library exactly like the
DLL.  ``function_table()`` returns the callbacks plus their raw addresses.

The C signatures carry no device, so the callbacks that build an index are
bound to one when a table is made: ``function_table(device=None)`` and
``function_table_guid(device=None)`` build on the CUDA card (raising
without one) unless ``device="cpu"`` is passed.  The module-level
callbacks are those bound to the card.

Semantics match api.capi: result strings are COPIES (the DLL returns
pointers into its string pool that die with the index, nGramSearch.hpp:
461-468; here release() frees the copies instead), weight is read per
flattened element (nGramSearch.hpp:141-148), limit 0 = unbounded, missing
handle = 0 results.
"""

from __future__ import annotations

import ctypes as ct
import threading

from . import capi

_LOCK = threading.Lock()
# results-array address -> (keepalive objects) while the caller may read it
_LIVE: dict[int, tuple] = {}

_SEARCH_SIG = ct.CFUNCTYPE(
    ct.c_uint32, ct.c_uint32, ct.c_char_p, ct.POINTER(ct.POINTER(ct.c_char_p)),
    ct.c_float, ct.c_uint32,
)
_SCORE_SIG = ct.CFUNCTYPE(
    ct.c_uint32, ct.c_uint32, ct.c_char_p, ct.POINTER(ct.POINTER(ct.c_char_p)),
    ct.POINTER(ct.POINTER(ct.c_float)), ct.c_float, ct.c_uint32,
)
_INDEXN_SIG = ct.CFUNCTYPE(
    ct.c_uint32, ct.POINTER(ct.c_char_p), ct.c_uint64, ct.c_uint16,
    ct.POINTER(ct.c_float),
)
_RELEASE_SIG = ct.CFUNCTYPE(
    None, ct.c_uint32, ct.POINTER(ct.c_char_p), ct.POINTER(ct.c_float)
)
_DISPOSE_SIG = ct.CFUNCTYPE(None, ct.c_uint32)
_GETSIZE_SIG = ct.CFUNCTYPE(ct.c_uint64, ct.c_uint32)
_SETVALID_SIG = ct.CFUNCTYPE(None, ct.c_uint32, ct.c_char_p, ct.c_int)


def _decode(b: bytes | None):
    if b is None:
        return None
    try:
        return b.decode("utf-8")
    except UnicodeDecodeError:
        return b.decode("latin-1")


def _alloc_results(strings):
    """(char** array, keepalive bufs) with a NULL terminator slot."""
    n = len(strings)
    arr = (ct.c_char_p * (n + 1))()
    bufs = []
    for i, s in enumerate(strings):
        b = ct.create_string_buffer(s.encode("utf-8"))
        bufs.append(b)
        arr[i] = ct.cast(b, ct.c_char_p)
    arr[n] = None
    return arr, bufs


@_SEARCH_SIG
def search(handle, query, results, threshold, limit):
    strings = capi.search(
        handle, _decode(query) or "", float(threshold), int(limit)
    )
    if not results:
        return len(strings)
    arr, bufs = _alloc_results(strings)
    ptr = ct.cast(arr, ct.POINTER(ct.c_char_p))
    results[0] = ptr
    with _LOCK:
        _LIVE[ct.addressof(arr)] = (arr, bufs)
    return len(strings)


@_SCORE_SIG
def score(handle, query, results, scores, threshold, limit):
    strings, vals = capi.score(
        handle, _decode(query) or "", float(threshold), int(limit)
    )
    n = len(strings)
    if results:
        arr, bufs = _alloc_results(strings)
        results[0] = ct.cast(arr, ct.POINTER(ct.c_char_p))
        with _LOCK:
            _LIVE[ct.addressof(arr)] = (arr, bufs)
    if scores:
        sarr = (ct.c_float * max(n, 1))(*[float(v) for v in vals])
        scores[0] = ct.cast(sarr, ct.POINTER(ct.c_float))
        with _LOCK:
            _LIVE[ct.addressof(sarr)] = (sarr,)
    return n


@_RELEASE_SIG
def release(handle, results, scores):
    with _LOCK:
        if results:
            _LIVE.pop(ct.addressof(results.contents), None)
        if scores:
            _LIVE.pop(ct.addressof(scores.contents), None)


@_DISPOSE_SIG
def dispose(handle):
    capi.dispose(int(handle))


@_GETSIZE_SIG
def getSize(handle):
    return capi.getSize(int(handle))


@_GETSIZE_SIG
def getLibSize(handle):
    return capi.getLibSize(int(handle))


@_SETVALID_SIG
def setValidChar(handle, characters, n):
    if characters is None:
        return
    capi.setValidChar(int(handle), characters[: n] if n >= 0 else characters)


def function_table(device=None):
    """All C-ABI callbacks plus their raw addresses (for a C host), indexN
    bound to ``device`` (the card unless ``device="cpu"``)."""
    fns = {
        "indexN": _bound(device)["indexN"],
        "search": search,
        "score": score,
        "release": release,
        "dispose": dispose,
        "getSize": getSize,
        "getLibSize": getLibSize,
        "setValidChar": setValidChar,
    }
    return {
        name: (fn, ct.cast(fn, ct.c_void_p).value) for name, fn in fns.items()
    }


# ---------------------------------------------------------------------------
# Documented README surface: guid-string-keyed, narrow + wide (wchar_t)
# ---------------------------------------------------------------------------
#
# The reference's README documents a SECOND family the compiled DLL never
# exported (Readme.md:31-231): guid-keyed `index`/`indexW`/`index2D`/
# `index2DW` with a gSize parameter, `search`/`searchW` with a uint32_t*
# out-count, `release`/`releaseW`/`dispose`/`disposeW`/`getSize[W]`/
# `getLibSize[W]`.  api.capi implements them all; these callbacks give
# that family a binary entry point too.  wchar_t maps to the platform
# wide char (UTF-32 on Linux), matching the W variants' UTF-32 intent.

_INDEX_G_SIG = ct.CFUNCTYPE(
    None, ct.c_char_p, ct.POINTER(ct.c_char_p), ct.c_uint64, ct.c_uint16,
    ct.POINTER(ct.c_float), ct.c_uint16,
)
_INDEXW_G_SIG = ct.CFUNCTYPE(
    None, ct.c_char_p, ct.POINTER(ct.c_wchar_p), ct.c_uint64, ct.c_uint16,
    ct.POINTER(ct.c_float), ct.c_uint16,
)
_INDEX2D_G_SIG = ct.CFUNCTYPE(
    None, ct.c_char_p, ct.POINTER(ct.POINTER(ct.c_char_p)), ct.c_uint64,
    ct.c_uint16, ct.POINTER(ct.POINTER(ct.c_float)), ct.c_uint16,
)
_INDEX2DW_G_SIG = ct.CFUNCTYPE(
    None, ct.c_char_p, ct.POINTER(ct.POINTER(ct.c_wchar_p)), ct.c_uint64,
    ct.c_uint16, ct.POINTER(ct.POINTER(ct.c_float)), ct.c_uint16,
)
_SEARCH_G_SIG = ct.CFUNCTYPE(
    None, ct.c_char_p, ct.c_char_p, ct.POINTER(ct.POINTER(ct.c_char_p)),
    ct.POINTER(ct.c_uint32), ct.c_float, ct.c_uint32,
)
_SEARCHW_G_SIG = ct.CFUNCTYPE(
    None, ct.c_char_p, ct.c_wchar_p, ct.POINTER(ct.POINTER(ct.c_wchar_p)),
    ct.POINTER(ct.c_uint32), ct.c_float, ct.c_uint32,
)
_RELEASE_G_SIG = ct.CFUNCTYPE(
    None, ct.c_char_p, ct.POINTER(ct.POINTER(ct.c_char_p)), ct.c_uint64
)
_RELEASEW_G_SIG = ct.CFUNCTYPE(
    None, ct.c_char_p, ct.POINTER(ct.POINTER(ct.c_wchar_p)), ct.c_uint64
)
_DISPOSE_G_SIG = ct.CFUNCTYPE(None, ct.c_char_p)
_GETSIZE_G_SIG = ct.CFUNCTYPE(ct.c_uint64, ct.c_char_p)


def _guid(b) -> str:
    return _decode(b) or ""


def _read_weights_1d(weight, size):
    if not weight:
        return None
    return [float(weight[i]) for i in range(size)]


def _rows_2d(key, size, rowSize, weight):
    rows, wrows = [], []
    for i in range(size):
        row = key[i]
        rows.append([row[j] for j in range(rowSize)])
        if weight:
            wrow = weight[i]
            wrows.append([float(wrow[j]) for j in range(rowSize)])
    return rows, (wrows if weight else None)


def _index_callbacks(device) -> dict:
    """The callbacks that build an index, bound to ``device``."""

    @_INDEXN_SIG
    def indexN(words, size, rowSize, weight):
        py_words = [_decode(words[i]) for i in range(size)]
        w = None
        if weight:
            w = [float(weight[i]) for i in range(size)]
        return capi.indexN(py_words, size, rowSize, w, device=device)

    @_INDEX_G_SIG
    def index_guid(guid, key, size, rowSize, weight, gSize):
        # ``size`` counts the FLATTENED words array (Readme.md:81 "size of
        # the words"), same as dllmain's indexN; weight is per flattened
        # element (nGramSearch.hpp:141-148)
        words = [_decode(key[i]) for i in range(size)]
        capi.index(
            _guid(guid), words, rowSize=int(rowSize),
            weight=_read_weights_1d(weight, size),
            gSize=int(gSize) or 3, device=device,
        )

    @_INDEXW_G_SIG
    def indexW_guid(guid, key, size, rowSize, weight, gSize):
        words = [key[i] for i in range(size)]
        capi.indexW(
            _guid(guid), words, rowSize=int(rowSize),
            weight=_read_weights_1d(weight, size),
            gSize=int(gSize) or 3, device=device,
        )

    @_INDEX2D_G_SIG
    def index2D_guid(guid, key, size, rowSize, weight, gSize):
        rows, wrows = _rows_2d(key, size, rowSize, weight)
        rows = [[_decode(c) for c in r] for r in rows]
        capi.index2D(
            _guid(guid), rows, rowSize=int(rowSize), weight=wrows,
            gSize=int(gSize) or 3, device=device,
        )

    @_INDEX2DW_G_SIG
    def index2DW_guid(guid, key, size, rowSize, weight, gSize):
        rows, wrows = _rows_2d(key, size, rowSize, weight)
        capi.index2DW(
            _guid(guid), rows, rowSize=int(rowSize), weight=wrows,
            gSize=int(gSize) or 3, device=device,
        )

    return {
        "indexN": indexN, "index": index_guid, "indexW": indexW_guid,
        "index2D": index2D_guid, "index2DW": index2DW_guid,
    }


# device -> its bound callbacks, kept alive while a C host may hold their
# addresses
_BOUND: dict = {}


def _bound(device) -> dict:
    key = None if device is None else str(device)
    with _LOCK:
        if key not in _BOUND:
            _BOUND[key] = _index_callbacks(device)
        return _BOUND[key]


_CARD = _bound(None)
indexN = _CARD["indexN"]
index_guid = _CARD["index"]
indexW_guid = _CARD["indexW"]
index2D_guid = _CARD["index2D"]
index2DW_guid = _CARD["index2DW"]


@_SEARCH_G_SIG
def search_guid(guid, query, results, size, threshold, limit):
    strings = capi.search(
        _guid(guid), _decode(query) or "", float(threshold), int(limit)
    )
    if size:
        size[0] = len(strings)
    if not results:
        return
    arr, bufs = _alloc_results(strings)
    results[0] = ct.cast(arr, ct.POINTER(ct.c_char_p))
    with _LOCK:
        _LIVE[ct.addressof(arr)] = (arr, bufs)


@_SEARCHW_G_SIG
def searchW_guid(guid, query, results, size, threshold, limit):
    strings = capi.searchW(
        _guid(guid), query or "", float(threshold), int(limit)
    )
    if size:
        size[0] = len(strings)
    if not results:
        return
    n = len(strings)
    arr = (ct.c_wchar_p * (n + 1))()
    bufs = []
    for i, s in enumerate(strings):
        b = ct.create_unicode_buffer(s)
        bufs.append(b)
        arr[i] = ct.cast(b, ct.c_wchar_p)
    arr[n] = None
    results[0] = ct.cast(arr, ct.POINTER(ct.c_wchar_p))
    with _LOCK:
        _LIVE[ct.addressof(arr)] = (arr, bufs)


@_RELEASE_G_SIG
def release_guid(guid, results, size):
    with _LOCK:
        if results and results[0]:
            _LIVE.pop(ct.addressof(results[0].contents), None)


@_RELEASEW_G_SIG
def releaseW_guid(guid, results, size):
    with _LOCK:
        if results and results[0]:
            _LIVE.pop(ct.addressof(results[0].contents), None)


@_DISPOSE_G_SIG
def dispose_guid(guid):
    capi.dispose(_guid(guid))


@_DISPOSE_G_SIG
def disposeW_guid(guid):
    capi.disposeW(_guid(guid))


@_GETSIZE_G_SIG
def getSize_guid(guid):
    return capi.getSize(_guid(guid))


@_GETSIZE_G_SIG
def getLibSize_guid(guid):
    return capi.getLibSize(_guid(guid))


def function_table_guid(device=None):
    """The README-documented guid-keyed family (narrow + wide), under its
    documented export names (Readme.md:31-231), the index builders bound
    to ``device`` (the card unless ``device="cpu"``)."""
    bound = _bound(device)
    fns = {
        "index": bound["index"],
        "indexW": bound["indexW"],
        "index2D": bound["index2D"],
        "index2DW": bound["index2DW"],
        "search": search_guid,
        "searchW": searchW_guid,
        "release": release_guid,
        "releaseW": releaseW_guid,
        "dispose": dispose_guid,
        "disposeW": disposeW_guid,
        "getSize": getSize_guid,
        "getSizeW": getSize_guid,
        "getLibSize": getLibSize_guid,
        "getLibSizeW": getLibSize_guid,
    }
    return {
        name: (fn, ct.cast(fn, ct.c_void_p).value) for name, fn in fns.items()
    }
