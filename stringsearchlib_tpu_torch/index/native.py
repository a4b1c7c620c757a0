"""Loader for the native (C++) index builder.

Compiles the repository's ``native/builder.cpp`` (the same source the JAX
package builds) with g++ on first use, into ``build/native/`` at the
repository root.  Plain CPython + numpy C API, no torch.  All failures
degrade silently to the vectorized numpy builder - the native path is a
performance tier, never a correctness dependency; callers that must know
which builder ran read ``index.build.LAST_BUILD_BREAKDOWN`` (it holds a
``native_cpp`` entry only when the C++ builder ran).
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading

_LOCK = threading.Lock()
_MODULE = None
_TRIED = False

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
_SRC = os.path.join(_ROOT, "native", "builder.cpp")
_OUT_DIR = os.path.join(_ROOT, "build", "native")


def _compile() -> str | None:
    import numpy as np

    src = os.path.abspath(_SRC)
    if not os.path.exists(src):
        return None
    os.makedirs(_OUT_DIR, exist_ok=True)
    so = os.path.join(
        _OUT_DIR,
        f"_native.cpython-{sys.version_info.major}{sys.version_info.minor}.so",
    )
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-o", tmp, src,
        f"-I{sysconfig.get_paths()['include']}",
        f"-I{np.get_include()}",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(tmp, so)  # atomic: concurrent builders never load a torn .so
    except Exception:
        return None
    return so


def get_native():
    """The compiled _native module, or None."""
    global _MODULE, _TRIED
    if _MODULE is not None or _TRIED:
        return _MODULE
    with _LOCK:
        if _MODULE is not None or _TRIED:
            return _MODULE
        _TRIED = True
        if os.environ.get("STRINGSEARCH_NO_NATIVE"):
            return None
        so = _compile()
        if so is None:
            return None
        try:
            spec = importlib.util.spec_from_file_location("_native", so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _MODULE = mod
        except Exception:
            _MODULE = None
        return _MODULE
