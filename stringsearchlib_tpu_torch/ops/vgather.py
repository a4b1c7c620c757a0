"""Filled gather of 1-D tables at shared indices (kernel K6) on Hopper,
and the postings expansion built on it.

``gather_tables(idx (B, C) int32/int64, tables [(T,) int32 or float32],
fills)`` -> one (B, C) tensor per table with ``out[b, c] =
table[idx[b, c]]`` where 0 <= idx < T and the table's fill elsewhere:
every table read at the same indices in one pass.  It is the contract of
the TPU kernel ``tools/experimental/vgather.py`` (``_gather_call``).

``expand_postings(gram_ptr, gram_terms, slots (B, Qmax), s_cap, fill)`` ->
(B, s_cap) int32 is that gather at the indices of the CSR expand
(``posting_index``): lane c of row b holds the c-th posting of the row's
present gram slots, their posting runs ``gram_terms[gram_ptr[s] :
gram_ptr[s + 1]]`` laid end to end in slot order (a repeated gram repeats
its run), and ``fill`` past the row's posting mass.  It is the postings
expansion of the dense path's ``gather_hits`` and of the sorted-runs route
(``tid = where(valid, gram_terms[src], sentinel)``); on the card it is one
kernel that finds and copies the runs itself, so no index matrix is built.

On a CUDA tensor each wrapper launches its entry of
``csrc/gather_tables.cu``; on a CPU tensor it runs its plain version
(``gather_tables_ref``, ``expand_postings_ref``).  Nothing else chooses
between the two: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import lib as _lib

# launches of either entry of csrc/gather_tables.cu, and calls of a plain
# version made by a wrapper for CPU tensors; EXPAND_LAUNCHES counts the
# launches of the postings expansion alone.  Plain integers that callers
# may reset
K6_LAUNCHES = 0
K6_REF_CALLS = 0
EXPAND_LAUNCHES = 0

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


def expand_postings_ref(gram_ptr, gram_terms, slots, s_cap: int, fill: int):
    """Plain PyTorch version of ``expand_postings``: the filled gather of
    ``gram_terms`` at the CSR expand's positions."""
    idx = posting_index(gram_ptr, slots, s_cap)
    return gather_tables_ref(idx, [gram_terms], [fill])[0]


def expand_postings(gram_ptr, gram_terms, slots, s_cap: int, fill: int):
    """Each row's postings, its present slots' runs of ``gram_terms`` laid
    end to end in slot order, in ``s_cap`` lanes, ``fill`` past the row's
    posting mass: (B, s_cap) int32.  ``gram_ptr`` (G+1,) int32 must not
    decrease; a slot is -1 (absent) or in [0, G); Qmax >= 1.

    CUDA tensors launch the expansion kernel, once per call; CPU tensors
    run the plain version."""
    global K6_LAUNCHES, K6_REF_CALLS, EXPAND_LAUNCHES
    if not gram_ptr.dtype == gram_terms.dtype == slots.dtype == torch.int32:
        raise TypeError(f"gram_ptr, gram_terms and slots must be int32, got "
                        f"{gram_ptr.dtype}, {gram_terms.dtype}, {slots.dtype}")
    if gram_ptr.ndim != 1 or gram_terms.ndim != 1 or slots.ndim != 2:
        raise ValueError(f"gram_ptr and gram_terms must be 1-D and slots 2-D, got "
                         f"{tuple(gram_ptr.shape)}, {tuple(gram_terms.shape)}, "
                         f"{tuple(slots.shape)}")
    dev = slots.device
    if gram_ptr.device != dev or gram_terms.device != dev:
        raise ValueError(f"slots on {dev}, gram_ptr on {gram_ptr.device}, "
                         f"gram_terms on {gram_terms.device}")
    if s_cap < 1 or slots.shape[1] < 1:
        raise ValueError(f"s_cap and Qmax must be at least 1, got {s_cap} and "
                         f"{slots.shape[1]}")
    if not -(1 << 31) <= fill < (1 << 31):
        raise ValueError(f"fill {fill} is not an int32")
    if dev.type == "cpu":
        K6_REF_CALLS += 1
        return expand_postings_ref(gram_ptr, gram_terms, slots, s_cap, fill)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (slots.is_contiguous() and gram_ptr.is_contiguous()
            and gram_terms.is_contiguous()):
        raise ValueError("gram_ptr, gram_terms and slots must be contiguous")
    b, qmax = slots.shape
    out = torch.empty((b, s_cap), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    args = (gram_ptr.data_ptr(), gram_terms.data_ptr(), slots.data_ptr(),
            out.data_ptr(), max(gram_ptr.shape[0] - 1, 0), gram_terms.shape[0],
            b, qmax, s_cap, fill & 0xFFFFFFFF)
    # the raw stream handle: torch.cuda.current_stream() builds a Stream
    # object per call, a few microseconds of host time the launch waits for
    if dev.index == torch._C._cuda_getDevice():
        err = _lib("gather_tables").expand_postings_launch(
            *args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = _lib("gather_tables").expand_postings_launch(
                *args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"expand_postings kernel launch failed: cuda error {err}")
    K6_LAUNCHES += 1
    EXPAND_LAUNCHES += 1
    return out
