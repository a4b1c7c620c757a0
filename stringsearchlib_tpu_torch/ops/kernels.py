"""Build and load the hand-written CUDA kernels in ``csrc/``.

Every source ``csrc/<name>.cu`` exports plain C entry points that launch
its kernel on a given stream and return ``cudaGetLastError()``.  Each
source is compiled with nvcc for sm_90a into ``build/kernels/lib<name>.so``
(rebuilt when the source, or a ``csrc/*.cuh`` header it includes, is newer
than the library), one nvcc process per source, all started together, at
the first launch of any kernel; the libraries are bound with ctypes.
Nothing here runs when the package is imported.

The wrappers count their launches in module counters (``*_LAUNCHES``)
through ``count_launches``, which a chain being captured into a CUDA
graph (``search.graphs``) diverts into the graph's own tally.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import threading

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
_CSRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "csrc"))
_OUT_DIR = os.path.join(_ROOT, "build", "kernels")
_LIBS: dict = {}
_LIB_LOCK = threading.Lock()
# the launch tally of the chain this thread is capturing, if any
_CAPTURE = threading.local()

_P, _I, _LL, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32

# every kernel source csrc/<name>.cu: its entries' ctypes argument types
ARGTYPES = {
    "bitmap_hits": {
        "bitmap_hits_bmax_launch": [_P] * 5 + [_I] * 4 + [_P],
        "bitmap_hits_launch": [_P] * 4 + [_I] * 4 + [_P],
        "bitmap_hits_bmax_rowmajor_launch": [_P] * 5 + [_I] * 4 + [_P],
        "bitmap_hits_rowmajor_launch": [_P] * 4 + [_I] * 4 + [_P],
        # ..., list width, accumulate, stream
        "bitmap_hits_wide_launch": [_P] * 4 + [_I] * 5 + [_P],
    },
    "probe_stream": {
        # table, r (or null), out, G, ntiles, row stride, tile stride, stream
        "probe_stream_launch": [_P] * 3 + [_I] * 2 + [_LL] * 2 + [_P],
    },
    "probe_hits": {
        # table, rows, mults, out, B, ntiles, list width, row stride, tile
        # stride, out query stride, out tile stride, epilogue, queries per
        # block, stream
        "probe_hits_launch": [_P] * 4 + [_I] * 3 + [_LL] * 4 + [_I] * 2 + [_P],
    },
    "gather_rows": {
        "gather_rows_launch": [_P] * 3 + [_LL] + [_I] * 3 + [_P],
    },
    "dp_match": {
        # tokens, lengths, qtokens, qlens, out, scratch, n, w, b, qp,
        # token bytes, words instance (0: scratch kernel), queries per
        # chunk, scratch threads, stream
        "dp_match_launch": [_P] * 6 + [_I] * 8 + [_P],
    },
    "gather_tables": {
        # idx, 4 tables, 4 outputs, 4 fill bit patterns, total, T, n_tables,
        # index bytes, rows, cols, stream
        "gather_tables_launch": [_P] * 9 + [_U32] * 4 + [_LL, _LL, _I, _I, _LL, _LL, _P],
        # gram_ptr, gram_terms, slots, out, G, P, B, Qmax, s_cap, fill bit
        # pattern, stream
        "expand_postings_launch": [_P] * 4 + [_LL, _LL, _I, _I, _LL, _U32, _P],
    },
}


def count_launches(scope: dict, name: str, n: int = 1) -> None:
    """``n`` launches added to the counter ``name`` of the module whose
    globals are ``scope`` - or, while this thread captures a chain
    (``capturing``), to the capture's tally: a capture launches nothing,
    and its graph adds the tally at each replay.  Counters moved by other
    threads, other engines' chains included, are never touched here."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is None:
        scope[name] += n
    else:
        key = (scope["__name__"], name)
        tally[key] = tally.get(key, 0) + n


@contextlib.contextmanager
def capturing():
    """This thread's launches counted into a fresh tally, yielded as
    {(module name, counter name): launches}, instead of their counters."""
    tally: dict = {}
    _CAPTURE.tally = tally
    try:
        yield tally
    finally:
        _CAPTURE.tally = None


def source_mtime(src: str) -> float:
    """The newest modification time of ``src`` and of the ``csrc/`` headers
    it includes (``#include "x.cuh"``, one level: the headers include no
    other header of csrc/)."""
    with open(src) as f:
        headers = re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(), re.M)
    return max([os.path.getmtime(src)]
               + [os.path.getmtime(os.path.join(_CSRC, h)) for h in headers])


def build_kernels() -> dict:
    """Compile every ``csrc/<name>.cu`` whose ``build/kernels/lib<name>.so``
    is missing or older than its source or a header the source includes,
    for sm_90a, one nvcc process per source, all started together.  Returns
    {name: library path}.  Raises when nvcc is absent or a compile fails."""
    os.makedirs(_OUT_DIR, exist_ok=True)
    out, jobs = {}, []
    for name in ARGTYPES:
        src = os.path.join(_CSRC, f"{name}.cu")
        so = os.path.abspath(os.path.join(_OUT_DIR, f"lib{name}.so"))
        out[name] = so
        if os.path.exists(so) and os.path.getmtime(so) >= source_mtime(src):
            continue
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: {name}.cu cannot be built")
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-I", _CSRC, "-shared", "-Xcompiler", "-fPIC", "-o", tmp, src,
        ]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        jobs.append((name, tmp, so, proc))
    failed = []
    for name, tmp, so, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{stdout}\n{stderr}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def lib(name: str):
    """The loaded library of ``csrc/<name>.cu`` (building every kernel
    source at the first call), its entries' argument types set."""
    with _LIB_LOCK:
        if not _LIBS:
            for n, so in build_kernels().items():
                handle = ctypes.CDLL(so)
                for fn, argtypes in ARGTYPES[n].items():
                    getattr(handle, fn).argtypes = argtypes
                    getattr(handle, fn).restype = ctypes.c_int
                _LIBS[n] = handle
    return _LIBS[name]
