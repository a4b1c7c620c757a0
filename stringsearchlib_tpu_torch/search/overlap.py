"""Long-tier gram-overlap scorer (dense path).

PyTorch counterpart of ``stringsearchlib_tpu.search.overlap``: reproduces
``searchLong`` (nGramSearch.hpp:278-301) - every query gram (with
multiplicity) adds 1 to every long term in its posting set - with an
explicit batch dimension.  Each query's distinct gram slots have their
posting runs laid end to end in ``s_cap`` lanes of term ids by the postings
expansion (``ops.vgather.expand_postings``, kernel K6's expansion entry;
lanes past the query's distinct posting mass take the fill n_long), then
accumulated with one scatter-add that adds each slot's multiplicity: the
reference's counts, from one posting list per distinct slot where the
reference lays out one per window (a run of one character 70,000 long is
one list, not 70,000 copies of it).
"""

from __future__ import annotations

import torch

from ..ops.vgather import expand_postings


def gather_hits(
    gram_ptr: torch.Tensor,  # (G+1,) int32
    gram_terms: torch.Tensor,  # (P,) int32
    slots: torch.Tensor,  # (B, Qmax) int32; -1 = gram absent from index
    n_long: int,
    s_cap: int,
) -> torch.Tensor:
    """Hit counts (B, n_long) int32 via the postings expansion + scatter-add.
    ``s_cap`` holds every row's distinct posting mass (the postings of its
    distinct slots, ``SearchEngine._slot_mass``'s second figure)."""
    b, qmax = slots.shape
    dev = slots.device
    if gram_terms.shape[0] == 0 or n_long == 0 or qmax == 0:
        return torch.zeros((b, n_long), dtype=torch.int32, device=dev)
    slots, at, delta, closing = _distinct_slots(gram_ptr, slots, s_cap)
    # invalid lanes take the extra column n_long, dropped below
    ids = expand_postings(gram_ptr, gram_terms, slots, s_cap, n_long).long()
    # each lane's multiplicity: a running sum of the changes at each slot's
    # first lane.  Each row's changes sum to 0 through its extra lane, so
    # one scan of the flattened rows restarts at every row (a scan along
    # dim 1 runs each row in one thread block: slow for a few long rows).
    weights = torch.zeros((b, s_cap + 1), dtype=torch.int32, device=dev)
    weights.scatter_add_(1, at, delta)
    weights[:, s_cap] = closing
    weights = weights.view(-1).cumsum_(0).view(b, s_cap + 1)[:, :s_cap]
    hits = torch.zeros((b, n_long + 1), dtype=torch.int32, device=dev)
    hits.scatter_add_(1, ids, weights)
    return hits[:, :n_long]


def _distinct_slots(gram_ptr, slots, s_cap: int):
    """(B, Qmax) slots -> (each row's slots sorted, each repeat replaced
    by -1; for each slot that owns lanes, in lane order, its first lane
    and its multiplicity less the previous slot's, (B, Qmax) int64 and
    int32, the other entries at lane s_cap, which no lane reads; (B,)
    int32, less the last owning slot's multiplicity: the change at lane
    s_cap that brings the row's sum back to 0)."""
    b, qmax = slots.shape
    dev = slots.device
    srt = torch.sort(slots, dim=1).values.contiguous()
    first = srt >= 0
    first[:, 1:] &= srt[:, 1:] != srt[:, :-1]
    mult = torch.searchsorted(srt, srt, right=True) - torch.arange(qmax, device=dev)
    g = srt.clamp(min=0).long()
    lens = torch.where(first, (gram_ptr[g + 1] - gram_ptr[g]).long(), 0)
    starts = lens.cumsum(1) - lens
    # the slots that own lanes, in lane order, then the rest (start s_cap:
    # the dropped column)
    owns = first & (lens > 0)
    order = torch.argsort((~owns).to(torch.uint8), dim=1, stable=True)
    m = torch.where(owns, mult, 0).gather(1, order)
    delta = m.clone()
    delta[:, 1:] -= m[:, :-1]
    at = torch.where(owns, starts, s_cap).gather(1, order).clamp_(max=s_cap)
    closing = -torch.where(owns.gather(1, order), delta, 0).sum(1)
    return (torch.where(first, srt, -1), at, delta.to(torch.int32),
            closing.to(torch.int32))
