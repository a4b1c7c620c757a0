"""Long-tier gram-overlap scorer (dense path).

PyTorch counterpart of ``stringsearchlib_tpu.search.overlap``: reproduces
``searchLong`` (nGramSearch.hpp:278-301) - every query gram (with
multiplicity) adds 1 to every long term in its posting set - with an
explicit batch dimension.  Each query's posting ranges are flattened with
the CSR-expand pattern (cumsum of lengths + searchsorted rank) into
``s_cap`` lanes, then accumulated with one scatter-add.
"""

from __future__ import annotations

import torch


def gather_hits(
    gram_ptr: torch.Tensor,  # (G+1,) int32
    gram_terms: torch.Tensor,  # (P,) int32
    slots: torch.Tensor,  # (B, Qmax) int32; -1 = gram absent from index
    n_long: int,
    s_cap: int,
) -> torch.Tensor:
    """Hit counts (B, n_long) int32 via CSR expand + scatter-add."""
    b, qmax = slots.shape
    dev = slots.device
    if gram_terms.shape[0] == 0 or n_long == 0 or qmax == 0:
        return torch.zeros((b, n_long), dtype=torch.int32, device=dev)
    present = slots >= 0
    slots_c = slots.clamp_min(0).long()
    lens = torch.where(present, gram_ptr[slots_c + 1] - gram_ptr[slots_c], 0)
    ends = lens.cumsum(1)  # int64
    total = ends[:, -1:]
    pos = torch.arange(s_cap, dtype=torch.int64, device=dev).expand(b, s_cap).contiguous()
    rank = torch.searchsorted(ends, pos, right=True).clamp_max(qmax - 1)
    starts = ends - lens
    src = gram_ptr[slots_c.gather(1, rank)].long() + (pos - starts.gather(1, rank))
    valid = pos < total
    ids = gram_terms[src.clamp(0, gram_terms.shape[0] - 1)].long()
    # invalid lanes target the extra column n_long, dropped below
    ids = torch.where(valid, ids, n_long)
    hits = torch.zeros((b, n_long + 1), dtype=torch.int32, device=dev)
    hits.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.int32))
    return hits[:, :n_long]
