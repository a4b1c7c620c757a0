"""stringsearchlib_tpu_torch: n-gram fuzzy string search on PyTorch and CUDA.

The PyTorch port of ``stringsearchlib_tpu`` (which stays the reference):
the same index build and exact search semantics, on torch tensors, with the
reference's Pallas kernels rewritten by hand for NVIDIA Hopper
(``csrc/``).  This package imports torch and numpy, never jax.

Ported so far: the index build (native C++ builder, numpy builder, device
postings, the bit-packed incidence), the batch search's main path (K1
``bitmap_hits_bmax`` + the integer h* finish + the selection-only retry),
the dense path, wildcard and brute-force-short queries, and the
``StringSearchIndex`` object API.  ROADMAP.md lists what is still to port.
"""

from __future__ import annotations

import os as _os

# numpy's madvise(MADV_HUGEPAGE) makes first-touch of large fresh
# allocations slow on hosts with THP defrag=madvise; disable it before numpy
# loads (no effect if numpy is already imported)
_os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

from typing import Optional, Sequence

import torch

from .config import DEFAULT_VALID_CHARS, IndexConfig
from .index.build import HostIndex, build_index
from .search.engine import SearchEngine

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The first CUDA device when one is present, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


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
            words, row_size, weights, cfg, valid_chars,
            device=default_device() if device is None else device,
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
