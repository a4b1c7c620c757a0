"""The yardstick's arithmetic: the card's published memory rate and the
least time a piece of work could take on it.

One NVIDIA H100 SXM (NVIDIA's data sheet, at 700 W) reads HBM at
3.35 TB/s.  A bound here is bytes over that rate (the byte half of the
program's ``tools/common.bound``; no metric reads an operations bound yet).
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12


def bytes_bound(nbytes: float) -> float:
    """The least seconds the card could take to move ``nbytes``."""
    return nbytes / PEAK_BYTES


def hits_bytes(distinct_grams: int, indexed_terms: int) -> float:
    """Bytes a gram-hit count must read for one batch, whatever implements
    it: for each distinct gram of the batch that the corpus holds, its
    incidence row, one bit per indexed (long-tier) term, read once.  The
    counts' own bytes are left out: they depend on the implementation."""
    return distinct_grams * indexed_terms / 8
