"""Batched semi-global edit-distance scorer (short tier, brute tier).

PyTorch counterpart of ``stringsearchlib_tpu.search.editdist``.  Reproduces
``stringMatch`` (nGramSearch.hpp:182-222): free leading and trailing gaps in
the source, so the result is the best match of the query against any
substring of the source; the returned value is qlen - min_edit.

``dp_match`` is kernel K5 (ops.dp_match): the hand-written CUDA kernel on a
CUDA tensor, its plain PyTorch version on a CPU tensor.
"""

from __future__ import annotations

import torch

from ..ops.dp_match import dp_match

__all__ = ["dp_match", "dp_match_tiered"]


def dp_match_tiered(
    tokens: torch.Tensor,  # (N, L), rows sorted by length ascending
    lengths: torch.Tensor,  # (N,) int32, ascending
    qtokens: torch.Tensor,
    qlen: torch.Tensor,
    buckets: tuple,  # ((end_row, width), ...) covering [0, N)
) -> torch.Tensor:
    """dp_match over a length-sorted tier in width buckets, each bucket at
    its own width (index.build sorts the long tier by length).

    On a CUDA tensor the whole tier is one K5 launch: the kernel walks each
    term's own ``len`` characters, so a bucket's narrower width changes
    nothing but the padding it skips, and the result is identical.  The
    plain version on a CPU tensor pays the width, so it runs per bucket."""
    if len(buckets) <= 1 or tokens.device.type == "cuda":
        return dp_match(tokens, lengths, qtokens, qlen)
    outs = []
    lo = 0
    for end, w in buckets:
        outs.append(
            dp_match(tokens[lo:end, :w], lengths[lo:end], qtokens, qlen)
        )
        lo = end
    return torch.cat(outs, dim=1)
