"""stringsearchlib_tpu_torch: n-gram fuzzy string search on PyTorch and CUDA.

The PyTorch port of ``stringsearchlib_tpu`` (which stays the reference):
the same index build and exact search semantics, on torch tensors, with the
reference's Pallas kernels rewritten by hand for NVIDIA Hopper
(``csrc/``).  This package imports torch and numpy, never jax.

Ported so far: the index build (native C++ builder, numpy builder, device
postings, the bit-packed incidence, the packed and unpacked bucket sketch,
the dense gram matrix), the batch search's candidate routes in the
reference's gate order - the gram-matrix product (``matmul``), the sorted
runs for tiny batches and as the fallback (``tiny_runs``, ``runs``), the
bitmap routes (K1/K2, the gathered-row route with the row gather K3/K4)
and the bucket sketch (K2 packed, ``torch._int_mm`` unpacked) - with their
finishes, the dense path, wildcard and brute-force-short queries, index
persistence in the reference's ``.npz`` format, and both API styles:

  * :class:`StringSearchIndex` - the pythonic object API, with
    ``save`` / ``load``;
  * :mod:`stringsearchlib_tpu_torch.api.capi` - the reference-compatible
    flat surface (handle- and guid-keyed, ``saveIndex`` / ``loadIndex``),
    and :mod:`~stringsearchlib_tpu_torch.api.cabi`, its ctypes shim with
    the reference DLL's C signatures.

The edit-distance DP (K5) and the postings expansion (K6) run as CUDA
kernels on every route that needs them.  ROADMAP.md lists what is still
to port.

Every entry point runs on the CUDA card unless the caller asks for the CPU
(``device="cpu"``); without a card and without that argument it raises.
"""

from __future__ import annotations

import os as _os

# numpy's madvise(MADV_HUGEPAGE) makes first-touch of large fresh
# allocations slow on hosts with THP defrag=madvise; disable it before numpy
# loads (no effect if numpy is already imported)
_os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

from typing import Optional, Sequence

from .config import DEFAULT_VALID_CHARS, IndexConfig
from .index.build import HostIndex, build_index, default_device
from .search.engine import SearchEngine

__version__ = "0.1.0"


class StringSearchIndex:
    """One indexed library: build once, search many times."""

    def __init__(
        self,
        words: Sequence,
        row_size: int = 1,
        weights: Optional[Sequence[float]] = None,
        gram_size: int = 3,
        wide: bool = False,
        valid_chars: bytes = DEFAULT_VALID_CHARS,
        device=None,
    ):
        cfg = IndexConfig(gram_size=gram_size, wide=wide)
        self.host: HostIndex = build_index(
            words, row_size, weights, cfg, valid_chars, device=device,
        )
        self.engine = SearchEngine(self.host)

    def search(self, query, threshold: float = 0.0, limit: int = 100) -> list:
        """Ranked result strings (score desc, key length asc)."""
        results, _ = self.engine.search(query, threshold, limit)
        return results

    def score(self, query, threshold: float = 0.0, limit: int = 100):
        """(result strings, scores)."""
        return self.engine.search(query, threshold, limit)

    def size(self) -> int:
        """Distinct normalized terms (reference getSize)."""
        return self.host.n_terms

    def lib_size(self) -> int:
        """Distinct gram hashes (reference getLibSize)."""
        return self.host.n_grams

    def set_valid_char(self, chars) -> None:
        if isinstance(chars, str):
            chars = chars.encode("latin-1")
        self.host.set_valid_char(bytes(chars))

    def save(self, path) -> None:
        """Persist the built index (arrays only; loads skip the build), in
        the reference's ``.npz`` format."""
        from .index.serialize import save_index

        save_index(self.host, path)

    @classmethod
    def load(cls, path, device=None) -> "StringSearchIndex":
        """Reconstruct an index saved with :meth:`save` (by either package)
        on ``device``: the CUDA card unless ``device="cpu"``."""
        from .index.serialize import load_index

        obj = cls.__new__(cls)
        obj.host = load_index(path, device=device)
        obj.engine = SearchEngine(obj.host)
        return obj


__all__ = [
    "StringSearchIndex",
    "IndexConfig",
    "DEFAULT_VALID_CHARS",
    "build_index",
    "default_device",
    "HostIndex",
    "SearchEngine",
    "__version__",
]
