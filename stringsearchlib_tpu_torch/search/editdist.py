"""Batched semi-global edit-distance scorer (short tier).

PyTorch counterpart of ``stringsearchlib_tpu.search.editdist``.  Reproduces
``stringMatch`` (nGramSearch.hpp:182-222): free leading and trailing gaps in
the source, so the result is the best match of the query against any
substring of the source; the returned value is qlen - min_edit.

One step per query character updates the DP rows of all terms for all B
queries at once.  The in-row dependency is a min-plus prefix scan:

    row2[p] = min(row2[p-1] + 1, a[p]),   a[p] = min(row1[p]+1, row1[p-1]+cost)
  =>  row2[p] = p + cummin_k<=p (a[k] - k),  with a[0] := q+1
"""

from __future__ import annotations

import torch

_BIG = 1 << 30


def dp_match(
    tokens: torch.Tensor,  # (N, L) uint8/int32, 0-padded
    lengths: torch.Tensor,  # (N,) int32
    qtokens: torch.Tensor,  # (B, Qp) int32, 0-padded
    qlen: torch.Tensor,  # (B,) int32
) -> torch.Tensor:
    """Match counts (B, N) int32: qlen - semi-global edit distance."""
    n, width = tokens.shape
    b, qp = qtokens.shape
    dev = tokens.device
    positions = torch.arange(width + 1, dtype=torch.int32, device=dev)
    tok = tokens.to(torch.int32)[None]  # (1, N, L)
    row1 = torch.zeros((b, n, width + 1), dtype=torch.int32, device=dev)
    for q in range(qp):
        qc = qtokens[:, q].to(torch.int32)[:, None, None]
        active = (qlen > q)[:, None, None]
        cost = (tok != qc).to(torch.int32)  # (B, N, L)
        a = torch.minimum(row1[:, :, 1:] + 1, row1[:, :, :-1] + cost)
        d0 = torch.full((b, n, 1), q + 1, dtype=torch.int32, device=dev)
        d = torch.cat([d0, a - positions[1:]], dim=2)
        row2 = positions + torch.cummin(d, dim=2).values
        row1 = torch.where(active, row2, row1)
    # min over p in [0, len] only (nGramSearch.hpp:217-220)
    in_range = positions[None, :] <= lengths[:, None]  # (N, L+1)
    mismatch = torch.where(in_range, row1, _BIG).amin(dim=2)
    return qlen.to(torch.int32)[:, None] - mismatch


def dp_match_tiered(
    tokens: torch.Tensor,  # (N, L), rows sorted by length ascending
    lengths: torch.Tensor,  # (N,) int32, ascending
    qtokens: torch.Tensor,
    qlen: torch.Tensor,
    buckets: tuple,  # ((end_row, width), ...) covering [0, N)
) -> torch.Tensor:
    """dp_match over a length-sorted tier in width buckets, each bucket at
    its own width (index.build sorts the long tier by length)."""
    if len(buckets) <= 1:
        return dp_match(tokens, lengths, qtokens, qlen)
    outs = []
    lo = 0
    for end, w in buckets:
        outs.append(
            dp_match(tokens[lo:end, :w], lengths[lo:end], qtokens, qlen)
        )
        lo = end
    return torch.cat(outs, dim=1)
