"""Frozen configuration for a string-search index.

The reference hard-codes every tunable (gram size 3 at nGramSearch.h:147-150,
long/short cutoff 6 at nGramSearch.hpp:82, short-search cutoff 9 at
nGramSearch.hpp:381, brute-force cutoff 3 at nGramSearch.hpp:235,247,281,
exact-match promotion 0.999 -> 100 at nGramSearch.hpp:328-335, default
validChar at nGramSearch.h:307-313).  Its README documents a configurable
``gSize`` (Readme.md:39,63,85,109) that the compiled code never wires up; this
build implements the documented contract: gram_size in {2, 3, 4} with every
derived cutoff scaling as the reference's constants imply (2*g and 3*g).
"""

from __future__ import annotations

import dataclasses

# The reference's default allowed characters (nGramSearch.h:307-313).
DEFAULT_VALID_CHARS: bytes = (
    b".%$ @" b"0123456789" b"abcdefghijklmnopqrstuvwxyz" b"ABCDEFGHIJKLMNOPQRSTUVWXYZ"
)

# Exact-match promotion constants (nGramSearch.hpp:328-335).
PERFECT_SCORE_CUTOFF: float = 0.999
PROMOTED_SCORE: float = 100.0

# limit == 0 means unbounded (nGramSearch.hpp:420-421,454-455).
INT32_MAX: int = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Static configuration shared by the host pipeline and compiled kernels.

    Attributes:
      gram_size: n-gram window width; the reference fixes 3, the README
        documents 2..4.
      wide: False -> narrow/byte strings (``index``), True -> UTF-32 codepoint
        strings (``indexW``).
      short_pad: padded width of the short-tier token matrix (terms shorter
        than ``long_cutoff`` characters).
      long_pad: padded width of the long-tier token matrix.  Terms longer than
        this are still indexed; only the brute-force DP tier clamps to it.
      query_pad: padded width for query token buffers inside jit.
      wide_upper: uppercase mapping for wide codepoints >= 128.  The
        reference calls C ``towupper`` (nGramSearch.h:83-87) without ever
        calling setlocale, so the DLL as compiled uppercases ASCII only
        ("c" mode).  The default "simple" mode applies the Unicode simple
        uppercase mapping instead (single-codepoint only: one-to-many
        expansions like ß -> SS and the fi ligature stay unchanged, which
        is also what towupper does under a Unicode locale since it cannot
        expand).  Narrow indexes always uppercase ASCII only.
    """

    gram_size: int = 3
    wide: bool = False
    short_pad: int = 8
    long_pad: int = 64
    query_pad: int = 64
    wide_upper: str = "simple"

    def __post_init__(self) -> None:
        if self.gram_size not in (2, 3, 4):
            raise ValueError(f"gram_size must be in {{2,3,4}}, got {self.gram_size}")
        if self.short_pad < self.long_cutoff:
            raise ValueError("short_pad must cover the short tier")
        if self.wide_upper not in ("simple", "c"):
            raise ValueError(
                f"wide_upper must be 'simple' or 'c', got {self.wide_upper!r}"
            )

    # ---- derived cutoffs (reference constants generalized to gram_size) ----

    @property
    def long_cutoff(self) -> int:
        """Terms with normalized length >= this go to the long tier.

        Reference: 6 == 2 * gram_size (nGramSearch.hpp:82, nGramSearch.h:281).
        """
        return 2 * self.gram_size

    @property
    def short_search_cutoff(self) -> int:
        """Queries shorter than this also run the short (edit-distance) tier.

        Reference: 9 == 3 * gram_size (nGramSearch.hpp:381).
        """
        return 3 * self.gram_size

    @property
    def brute_force_cutoff(self) -> int:
        """Queries of length <= this brute-force the long tier with DP and are
        too short for gram search.

        Reference: 3 == gram_size (nGramSearch.hpp:235,247,281).
        """
        return self.gram_size

    @property
    def min_dp_rows(self) -> int:
        """Minimum DP row width: max(query+1, 6) in the reference
        (nGramSearch.hpp:234); 6 == 2 * gram_size."""
        return 2 * self.gram_size


DEFAULT_CONFIG = IndexConfig()
