"""Long-tier gram-overlap scorer (dense path).

PyTorch counterpart of ``stringsearchlib_tpu.search.overlap``: reproduces
``searchLong`` (nGramSearch.hpp:278-301) - every query gram (with
multiplicity) adds 1 to every long term in its posting set - with an
explicit batch dimension.  Each query's posting runs are laid end to end
in ``s_cap`` lanes of term ids by the postings expansion
(``ops.vgather.expand_postings``, kernel K6's expansion entry; lanes past
the query's posting mass take the fill n_long), then accumulated with one
scatter-add.
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
    """Hit counts (B, n_long) int32 via the postings expansion + scatter-add."""
    b, qmax = slots.shape
    dev = slots.device
    if gram_terms.shape[0] == 0 or n_long == 0 or qmax == 0:
        return torch.zeros((b, n_long), dtype=torch.int32, device=dev)
    # invalid lanes take the extra column n_long, dropped below
    ids = expand_postings(gram_ptr, gram_terms, slots, s_cap, n_long).long()
    hits = torch.zeros((b, n_long + 1), dtype=torch.int32, device=dev)
    hits.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.int32))
    return hits[:, :n_long]
