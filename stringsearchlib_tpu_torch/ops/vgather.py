"""Filled gather of 1-D tables at shared indices (kernel K6) on Hopper.

``gather_tables(idx (B, C) int32/int64, tables [(T,) int32 or float32],
fills)`` -> one (B, C) tensor per table with ``out[b, c] =
table[idx[b, c]]`` where 0 <= idx < T and the table's fill elsewhere:
every table read at the same indices in one pass.  This is the postings
expansion of the dense path's ``gather_hits`` and of the sorted-runs route
(``tid = where(valid, gram_terms[src], sentinel)``).

On a CUDA tensor the wrapper launches ``csrc/gather_tables.cu``, the
counterpart of the TPU kernel ``tools/experimental/vgather.py``
(``_gather_call``); on a CPU tensor it runs the plain version
``gather_tables_ref``.  Nothing else chooses between the two: a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import lib as _lib

# launches of the CUDA kernel, and calls of its plain version made by the
# wrapper for CPU tensors; plain integers that callers may reset
K6_LAUNCHES = 0
K6_REF_CALLS = 0

_MAX_TABLES = 4
_DTYPES = {torch.int32: np.int32, torch.float32: np.float32}


def gather_tables_ref(idx, tables, fills):
    """Plain PyTorch version of ``gather_tables``:
    ``torch.where(valid, table[idx.clamp(0, T - 1)], fill)``."""
    t_len = tables[0].shape[0]
    if t_len == 0:
        return [torch.full(idx.shape, f, dtype=t.dtype, device=idx.device)
                for t, f in zip(tables, fills)]
    valid = (idx >= 0) & (idx < t_len)
    idc = idx.clamp(0, t_len - 1).long()
    return [torch.where(valid, t[idc], f) for t, f in zip(tables, fills)]


def _fill_word(fill, dtype) -> int:
    """The fill value as the raw 32-bit word the kernel stores."""
    return int(np.asarray(fill, dtype=_DTYPES[dtype]).view(np.uint32))


def gather_tables(idx, tables, fills):
    """Gather every (T,) table of ``tables`` at the (B, C) indices ``idx``,
    ``fills[k]`` outside [0, T).  Returns a list of (B, C) tensors.

    CUDA tensors launch the K6 kernel; CPU tensors run the plain version."""
    global K6_LAUNCHES, K6_REF_CALLS
    tables, fills = list(tables), list(fills)
    if not 1 <= len(tables) <= _MAX_TABLES or len(fills) != len(tables):
        raise ValueError(f"1 to {_MAX_TABLES} tables with one fill each, got "
                         f"{len(tables)} tables and {len(fills)} fills")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    t_len = tables[0].shape[0]
    for t in tables:
        if t.ndim != 1 or t.shape[0] != t_len:
            raise ValueError(f"tables must be 1-D of one length, got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"tables must be int32 or float32, got {t.dtype}")
        if t.device != idx.device:
            raise ValueError(f"idx on {idx.device}, a table on {t.device}")
    if idx.device.type == "cpu":
        K6_REF_CALLS += 1
        return gather_tables_ref(idx, tables, fills)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    if not idx.is_contiguous() or idx.data_ptr() % 16:
        raise ValueError("idx must be contiguous and 16-byte aligned")
    if any(not t.is_contiguous() for t in tables):
        raise ValueError("tables must be contiguous")
    outs = [torch.empty(idx.shape, dtype=t.dtype, device=idx.device) for t in tables]
    total = idx.numel()
    if total == 0:
        return outs
    pad = _MAX_TABLES - len(tables)
    srcs = [t.data_ptr() for t in tables] + [0] * pad
    dsts = [o.data_ptr() for o in outs] + [0] * pad
    words = [_fill_word(f, t.dtype) for f, t in zip(fills, tables)] + [0] * pad
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = _lib("gather_tables").gather_tables_launch(
            idx.data_ptr(), *srcs, *dsts, *words, total, t_len, len(tables),
            idx.element_size(), stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_tables kernel launch failed: cuda error {err}")
    K6_LAUNCHES += 1
    return outs
