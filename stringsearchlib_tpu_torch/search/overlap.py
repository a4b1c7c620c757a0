"""Long-tier gram-overlap scorer (dense path).

PyTorch counterpart of ``stringsearchlib_tpu.search.overlap``: reproduces
``searchLong`` (nGramSearch.hpp:278-301) - every query gram (with
multiplicity) adds 1 to every long term in its posting set - with an
explicit batch dimension.  Each query's posting ranges are flattened with
the CSR-expand pattern (``posting_index``: cumsum of lengths + searchsorted
rank) into ``s_cap`` lanes, expanded to term ids by kernel K6 (ops.vgather; invalid
lanes read index -1 and take the fill n_long), then accumulated with one
scatter-add.
"""

from __future__ import annotations

import torch

from ..ops.vgather import gather_tables


def posting_index(
    gram_ptr: torch.Tensor,  # (G+1,) int32
    slots: torch.Tensor,  # (B, Qmax) int32, Qmax >= 1; -1 = gram absent
    s_cap: int,
) -> torch.Tensor:
    """The CSR expand: (B, s_cap) int64 positions into ``gram_terms`` of
    each query's postings, its grams' posting ranges one after another in
    slot order (a gram repeated in the query repeats its range), and -1
    past the query's posting mass."""
    b, qmax = slots.shape
    slots_c = slots.clamp_min(0).long()
    lens = torch.where(slots >= 0, gram_ptr[slots_c + 1] - gram_ptr[slots_c], 0)
    ends = lens.cumsum(1)  # int64
    pos = torch.arange(s_cap, dtype=torch.int64, device=slots.device)
    pos = pos.expand(b, s_cap).contiguous()
    rank = torch.searchsorted(ends, pos, right=True).clamp_max(qmax - 1)
    starts = ends - lens
    src = gram_ptr[slots_c.gather(1, rank)].long() + (pos - starts.gather(1, rank))
    return torch.where(pos < ends[:, -1:], src, -1)


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
    # invalid lanes take the extra column n_long, dropped below
    idx = posting_index(gram_ptr, slots, s_cap)
    ids = gather_tables(idx, [gram_terms], [n_long])[0].long()
    hits = torch.zeros((b, n_long + 1), dtype=torch.int32, device=dev)
    hits.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.int32))
    return hits[:, :n_long]
