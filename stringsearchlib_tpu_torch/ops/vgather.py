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

import struct

import torch

from .kernels import count_launches, lib as _lib

# launches of either entry of csrc/gather_tables.cu, and calls of a plain
# version made by a wrapper for CPU tensors; EXPAND_LAUNCHES counts the
# launches of the postings expansion alone.  Plain integers that callers
# may reset
K6_LAUNCHES = 0
K6_REF_CALLS = 0
EXPAND_LAUNCHES = 0

_MAX_TABLES = 4
_DTYPES = (torch.int32, torch.float32)
_CHUNK_BYTES = 256 * 16  # index bytes a block of its one pass takes
_ONE_PASS = None  # gather_tables_launch, bound at its first launch
_F32, _U32 = struct.Struct("<f"), struct.Struct("<I")


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
    """The fill value as the raw 32-bit word the kernel stores: float32
    rounded to nearest (past its range, an infinity), int32 truncated
    toward zero as numpy casts it; an int32 fill outside its range raises
    OverflowError."""
    if dtype == torch.float32:
        f = float(fill)
        try:
            return _U32.unpack(_F32.pack(f))[0]
        except OverflowError:
            return 0x7F800000 if f > 0 else 0xFF800000
    v = int(fill)
    if not -(1 << 31) <= v < (1 << 31):
        raise OverflowError(f"fill {fill} is out of bounds for int32")
    return v & 0xFFFFFFFF


def _grid_rows(shape, index_bytes: int):
    """(rows, cols) of the one pass's block order for an index matrix of
    ``shape``: a block per chunk of one row, the row fastest, so the blocks
    in flight read the same narrow slice of the tables where the rows are
    sorted; (1, total), the chunks in order, where a row is no whole number
    of 16-byte index vectors or fills less than a block's chunk (256 of
    them), which would leave most of each block idle."""
    total = 1
    for d in shape:
        total *= d
    row_bytes = (shape[-1] if len(shape) else 1) * index_bytes
    if row_bytes % 16 == 0 and row_bytes >= _CHUNK_BYTES:
        return total // shape[-1], shape[-1]
    return 1, total


def _outputs(idx, tables):
    """One (B, C) output per table, each of its table's dtype: views of one
    (n_tables, round_up(B * C, 4)) allocation (the tensor itself for one
    table), each table's row padded to 16 bytes so every view is 16-byte
    aligned and the kernel stores vectors whatever B * C.  The views share
    their storage: any one of them keeps all of it alive."""
    if len(tables) == 1:
        return [torch.empty_like(idx, dtype=tables[0].dtype)]
    total = idx.numel()
    buf = idx.new_empty((len(tables), -(-total // 4) * 4), dtype=tables[0].dtype)
    return [(o if o.dtype == t.dtype else o.view(t.dtype))[:total].view(idx.shape)
            for o, t in zip(buf.unbind(0), tables)]


def _check(idx, tables, fills) -> bool:
    """The gather's operand checks; True for CUDA operands (raises on
    operands the kernel does not take)."""
    n = len(tables)
    if not 1 <= n <= _MAX_TABLES or len(fills) != n:
        raise ValueError(f"1 to {_MAX_TABLES} tables with one fill each, got "
                         f"{n} tables and {len(fills)} fills")
    if idx.dtype is not torch.int32 and idx.dtype is not torch.int64:
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    dev = idx.device
    t_len = tables[0].shape[0]
    for t in tables:
        if t.ndim != 1 or t.shape[0] != t_len:
            raise ValueError(f"tables must be 1-D of one length, got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"tables must be int32 or float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"idx on {dev}, a table on {t.device}")
    if not idx.is_cuda:
        if dev.type == "cpu":
            return False
        raise ValueError(f"unsupported device {dev}")
    if not idx.is_contiguous() or idx.data_ptr() % 16:
        raise ValueError("idx must be contiguous and 16-byte aligned")
    for t in tables:
        if not t.is_contiguous():
            raise ValueError("tables must be contiguous")
    return True


def gather_tables(idx, tables, fills):
    """Gather every (T,) table of ``tables`` at the (B, C) indices ``idx``,
    ``fills[k]`` outside [0, T).  Returns a list of (B, C) tensors (on the
    card, views of one allocation).

    CUDA tensors launch the K6 kernel's one pass (blocks over the rows'
    chunks, the row fastest: ``_grid_rows``); CPU tensors run the plain
    version."""
    global K6_REF_CALLS
    if not isinstance(tables, (list, tuple)):
        tables = list(tables)
    if not isinstance(fills, (list, tuple)):
        fills = list(fills)
    if not _check(idx, tables, fills):
        K6_REF_CALLS += 1
        return gather_tables_ref(idx, tables, fills)
    n = len(tables)
    t0 = tables[0]
    total = idx.numel()
    if n == 1:  # the common case, without building lists
        word = _fill_word(fills[0], t0.dtype)
        out = torch.empty_like(idx, dtype=t0.dtype)
        outs = [out]
        if total == 0:
            return outs
        args = (idx.data_ptr(), t0.data_ptr(), 0, 0, 0, out.data_ptr(), 0, 0, 0,
                word, 0, 0, 0, total, t0.shape[0], 1, idx.element_size())
    else:
        words = [_fill_word(f, t.dtype) for f, t in zip(fills, tables)]
        outs = _outputs(idx, tables)
        if total == 0:
            return outs
        pad = (0,) * (_MAX_TABLES - n)
        args = ((idx.data_ptr(), *[t.data_ptr() for t in tables], *pad,
                 *[o.data_ptr() for o in outs], *pad, *words, *pad)
                + (total, t0.shape[0], n, idx.element_size()))
    fn = _ONE_PASS or _bind()
    args += _grid_rows(idx.shape, idx.element_size())
    # the raw stream handle: torch.cuda.current_stream() builds a Stream
    # object per call, a few microseconds of host time the launch waits for
    dev = idx.get_device()
    if dev == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"gather_tables kernel launch failed: cuda error {err}")
    count_launches(globals(), "K6_LAUNCHES")
    return outs


def _bind():
    global _ONE_PASS
    _ONE_PASS = _lib("gather_tables").gather_tables_launch
    return _ONE_PASS


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
    global K6_REF_CALLS
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
    count_launches(globals(), "K6_LAUNCHES")
    count_launches(globals(), "EXPAND_LAUNCHES")
    return out
