"""On-device gram-posting construction.

PyTorch counterpart of ``stringsearchlib_tpu.index.device_build``: the
postings are built on the device from the already-resident long-token
matrix, so only the distinct gram ids and CSR pointers (O(G)) cross to the
host:

  pack g-byte windows -> one int64 ``(gram << 32) | term`` key per valid
  window -> sort + dedup (posting-set semantics, nGramSearch.h:296) ->
  distinct grams + CSR pointers.

The reference sorts (gram, term) pairs with a two-key sort over every
window slot, padding included; torch has no multi-key sort, and one packed
int64 key sorts the same order.  Only valid windows are keyed (the host
knows their count), so the key is made once, at its final size.  Output is
bit-identical to the host build and to the reference's device build.

Narrow gram_size<=3 only (the packed gram fits 24 bits).
"""

from __future__ import annotations

import numpy as np
import torch


def build_postings_device(long_tokens, long_lengths, gram_size: int):
    """Device CSR from resident long-term tensors.

    Returns (gram_terms (P,) int32 tensor on the tokens' device,
    gram_ptr (G+1,) np.int32, gram_ids (G,) np.int64).
    """
    t = long_tokens.to(torch.int32)
    w = t.shape[1] - gram_size + 1
    packed = t[:, 0:w].clone()
    for k in range(1, gram_size):
        packed = (packed << 8) | t[:, k : k + w]
    del t
    pos = torch.arange(w, device=packed.device, dtype=torch.int32)
    valid = pos[None, :] < (long_lengths.to(torch.int32)[:, None] - (gram_size - 1))
    # (term, window) of every valid window, row-major
    tid = torch.arange(
        packed.shape[0], device=packed.device, dtype=torch.int64
    )[:, None].expand_as(packed)
    key = (packed[valid].to(torch.int64) << 32) | tid[valid]
    del packed, valid, tid
    key = torch.unique(key, sorted=True)  # sort + posting-set dedup
    gram = key >> 32
    gram_terms = (key & 0xFFFFFFFF).to(torch.int32)
    del key
    p = gram.shape[0]
    if p == 0:
        return (
            gram_terms, np.zeros(1, np.int32), np.zeros(0, np.int64),
        )
    first = torch.ones(p, dtype=torch.bool, device=gram.device)
    first[1:] = gram[1:] != gram[:-1]
    starts = torch.nonzero(first).flatten()
    gram_ids = gram[starts].cpu().numpy().astype(np.int64)
    gram_ptr = np.empty(gram_ids.shape[0] + 1, np.int32)
    gram_ptr[:-1] = starts.cpu().numpy()
    gram_ptr[-1] = p
    return gram_terms, gram_ptr, gram_ids
