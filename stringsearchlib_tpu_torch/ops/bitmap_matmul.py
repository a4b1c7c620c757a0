"""Hit counts from a bit-packed gram incidence (kernels K1 and K2) and the
row gather of a packed table (kernels K3 and K4) on Hopper.

PyTorch counterpart of ``stringsearchlib_tpu.ops.bitmap_matmul``.  The
layout helpers are the reference's, so tables are byte-identical:
bytes are grouped into tiles of ``BLKB``; bit ``p`` of byte ``j*BLKB + k``
holds term ``j*8*BLKB + p*BLKB + k``; resident tables are tile-major
``(ntiles, Gp, BLKB)`` int8 (HostIndex.bitmap_tables).

``bitmap_hits_bmax`` (K1: hits and 128-term block maxima) and
``bitmap_hits`` (K2: hits only) keep the reference's contracts and both
its table layouts, tile-major and row-major ``(Gp, NB)`` (the reference's
gathered route over row-major tables); on a CUDA tensor each launches its
entry of the hand-written kernel in ``csrc/bitmap_hits.cu``.
``bitmap_hits_wide`` (K2w) counts the same hits as int32 for any sums
below 2^31 on tile-major tables, one launch per part of at most
``WIDE_MAX_SUM`` a row (the first storing, the rest adding into the hits in
place): the hits of the reference's per-slot scan
(``candidates_bitmap_impl``, an XLA scan, no Pallas kernel) for queries of
more than 127 gram windows, from the same source.
``gather_rows`` (``out[i] = table[rows[i]]`` along
the gram axis of either layout) launches ``csrc/gather_rows.cu``, which
serves both of the reference's TPU gathers: ``gather_rows_dma`` (K3) and
``gather_rows_pallas`` (K4) keep their names, row-major contracts and
asserts.  Each source is built with nvcc for sm_90a into ``build/kernels/``
at first use and bound with ctypes (ops.kernels).
On a CPU tensor each wrapper runs its plain PyTorch version
(``bitmap_hits_bmax_ref``, ``bitmap_hits_ref``, ``gather_rows_ref``).
Nothing else chooses between the two: a CUDA tensor launches the kernel or
raises.

The reference's pair dots, 31-window gate, G tiling and VMEM budget exist
for the TPU's matrix unit and VMEM; the Hopper kernel keeps every query's
counts in integer registers as bit-sliced carry-save counters for any Gp
multiple of 32, so only the <= 127 count contract remains (int8 hits).
"""

from __future__ import annotations

import torch

from .kernels import count_launches, lib as _lib

BLKB = 512
TILE_LANES = 8 * BLKB
# term-axis padding of the resident tables: eight layout tiles (the
# reference's value, kept so tables stay byte-identical)
PAD_LANES = 8 * TILE_LANES
# the reference's G-block constants; here they only fix g_padding, the row
# padding the resident table is built with
GBLK = 2048
SBLK_MAX = 4096
_BMAX_BLK = 128
_SUBS = TILE_LANES // _BMAX_BLK  # 128-term blocks per layout tile (32)
# row-list width: the <= 127 contract bounds a query's nonzero qcnt columns
# by 127, and 128 int32 keep every list 16-byte aligned
_LIST = 128
# K2w's bound on a query's multiplicity sum in one launch: 16 counter
# slices; larger sums take one launch per part of at most this much
WIDE_MAX_SUM = (1 << 16) - 1
# bitmap_hits_wide's bound on a row's multiplicity sum: int32 hits
_WIDE_SUM_LIMIT = 1 << 31

# launches of each CUDA kernel (K1 bitmap_hits_bmax, K2 bitmap_hits, and
# the row gather G that serves K3 and K4), and calls of its plain version
# made by the wrapper for CPU tensors; plain integers that callers may reset
K1_LAUNCHES = 0
K1_REF_CALLS = 0
K2_LAUNCHES = 0
K2_REF_CALLS = 0
G_LAUNCHES = 0
G_REF_CALLS = 0
K2W_LAUNCHES = 0
K2W_REF_CALLS = 0
# bytes of the float32 operand the plain versions unpack at a time
_PLAIN_CHUNK_BYTES = 1 << 30


def plane_coords(term):
    """term id -> (byte, bit) under the plane-tiled layout (numpy or torch)."""
    j = term // TILE_LANES
    r = term % TILE_LANES
    return j * BLKB + r % BLKB, r // BLKB


def g_padding(g: int) -> int:
    """Row padding the table is built with: 128-multiple up to SBLK_MAX
    rows, GBLK-multiple beyond (the reference's rule)."""
    r = -(-max(g, 1) // 128) * 128
    if r <= SBLK_MAX:
        return r
    return -(-g // GBLK) * GBLK


def to_tile_major(planes):
    """(Gp, NB) row-major packed planes -> (ntiles, Gp, BLKB) tile-major."""
    gp, nb = planes.shape
    return planes.reshape(gp, nb // BLKB, BLKB).permute(1, 0, 2).contiguous()


def from_tile_major(planes3):
    """(ntiles, Gp, BLKB) tile-major -> row-major (Gp, NB)."""
    nt, gp, blkb = planes3.shape
    return planes3.permute(1, 0, 2).reshape(gp, nt * blkb)


def _compact_qcnt(qcnt, width: int = _LIST):
    """(B, Gp) multiplicities -> (B, V) int32 row and multiplicity lists,
    V = min(Gp, ``width`` rounded up to a multiple of 4, as the kernels'
    vector loads need): the columns of multiplicity 1, then the other
    nonzero ones, each in row order, then zeros.  ``width`` must be at
    least every row's count of nonzero columns."""
    gp = qcnt.shape[1]
    v = min(gp, -(-max(width, 1) // 4) * 4)
    key = (qcnt == 0).to(torch.uint8) * 2 + (qcnt != 1).to(torch.uint8)
    order = torch.argsort(key, dim=1, stable=True)[:, :v]
    rows = order.to(torch.int32).contiguous()
    mults = qcnt.gather(1, order).to(torch.int32).contiguous()
    return rows, mults


def table_shape(planes):
    """(ntiles, Gp) of a packed table in either of the reference's layouts:
    tile-major (ntiles, Gp, BLKB) or row-major (Gp, NB), NB % BLKB == 0.
    Raises on any other shape or dtype."""
    if planes.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"planes must be int8, got {planes.dtype}")
    if planes.ndim == 3 and planes.shape[2] == BLKB:
        return planes.shape[0], planes.shape[1]
    if planes.ndim == 2 and planes.shape[1] % BLKB == 0:
        return planes.shape[1] // BLKB, planes.shape[0]
    raise ValueError(f"planes must be (ntiles, Gp, {BLKB}) or (Gp, NB) with "
                     f"NB % {BLKB} == 0, got {tuple(planes.shape)}")


def tile_columns(planes, t0: int, t1: int):
    """Layout tiles [t0, t1) of a packed table in either layout as a
    (Gp, t1 - t0, BLKB) view (the row-major table's own columns)."""
    if planes.ndim == 3:
        return planes[t0:t1].permute(1, 0, 2)
    return planes[:, t0 * BLKB : t1 * BLKB].view(planes.shape[0], t1 - t0, BLKB)


def _check(qcnt, planes):
    _, gp = table_shape(planes)
    if qcnt.ndim != 2 or qcnt.shape[1] != gp:
        raise ValueError(
            f"qcnt {tuple(qcnt.shape)} does not match planes {tuple(planes.shape)}"
        )
    if gp % 32:
        raise ValueError(f"Gp must be a multiple of 32, got {gp}")
    if qcnt.device != planes.device:
        raise ValueError(f"qcnt on {qcnt.device}, planes on {planes.device}")


def _cuda_operands(qcnt, planes, width: int = _LIST):
    """Checks a CUDA call's table and compacts its counts."""
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    if not planes.is_contiguous() or planes.data_ptr() % 16:
        raise ValueError("planes must be contiguous and 16-byte aligned")
    return _compact_qcnt(qcnt, width)


def bitmap_hits_bmax(qcnt, planes):
    """qcnt (B, Gp) gram multiplicities (any numeric dtype; integer values,
    each row summing to <= 127)  x  planes, int8 packed incidence in either
    of the reference's layouts - tile-major (ntiles, Gp, BLKB), as the
    resident tables are, or row-major (Gp, ntiles*BLKB)  ->  (hits
    (B, ntiles*TILE_LANES) int8 in term order, bmax (B, ntiles*32) int8
    per-128-term block maxima).

    CUDA tensors launch the K1 kernel; CPU tensors run the plain version."""
    global K1_REF_CALLS
    _check(qcnt, planes)
    if planes.device.type == "cpu":
        K1_REF_CALLS += 1
        return bitmap_hits_bmax_ref(qcnt, planes)
    b = qcnt.shape[0]
    ntiles, gp = table_shape(planes)
    hits = torch.empty((b, ntiles * TILE_LANES), dtype=torch.int8,
                       device=planes.device)
    bmax = torch.empty((b, ntiles * _SUBS), dtype=torch.int8,
                       device=planes.device)
    if b == 0 or ntiles == 0:
        return hits, bmax
    rows, mults = _cuda_operands(qcnt, planes)
    lib = _lib("bitmap_hits")
    launch = (lib.bitmap_hits_bmax_launch if planes.ndim == 3
              else lib.bitmap_hits_bmax_rowmajor_launch)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = launch(
            planes.data_ptr(), rows.data_ptr(), mults.data_ptr(),
            hits.data_ptr(), bmax.data_ptr(), b, gp, ntiles,
            rows.shape[1], stream,
        )
    if err != 0:
        raise RuntimeError(f"bitmap_hits_bmax kernel launch failed: cuda error {err}")
    count_launches(globals(), "K1_LAUNCHES")
    return hits, bmax


def bitmap_hits(qcnt, planes):
    """qcnt (B, Gp) multiplicities (integer values, each row summing to
    <= 127)  x  planes, int8 packed incidence, tile-major (ntiles, Gp, BLKB)
    or row-major (Gp, ntiles*BLKB)  ->  hits (B, ntiles*TILE_LANES) int8 in
    term order: K1's hits without the block maxima (the reference's
    ``bitmap_hits``).

    CUDA tensors launch the K2 kernel; CPU tensors run the plain version."""
    global K2_REF_CALLS
    _check(qcnt, planes)
    if planes.device.type == "cpu":
        K2_REF_CALLS += 1
        return bitmap_hits_ref(qcnt, planes)
    b = qcnt.shape[0]
    ntiles, gp = table_shape(planes)
    hits = torch.empty((b, ntiles * TILE_LANES), dtype=torch.int8,
                       device=planes.device)
    if b == 0 or ntiles == 0:
        return hits
    rows, mults = _cuda_operands(qcnt, planes)
    lib = _lib("bitmap_hits")
    launch = (lib.bitmap_hits_launch if planes.ndim == 3
              else lib.bitmap_hits_rowmajor_launch)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = launch(
            planes.data_ptr(), rows.data_ptr(), mults.data_ptr(),
            hits.data_ptr(), b, gp, ntiles, rows.shape[1], stream,
        )
    if err != 0:
        raise RuntimeError(f"bitmap_hits kernel launch failed: cuda error {err}")
    count_launches(globals(), "K2_LAUNCHES")
    return hits


def _wide_sums(qcnt) -> tuple:
    """(smallest multiplicity, largest row sum, largest count of nonzero
    columns in a row) of (B, Gp) multiplicities: one read back."""
    if qcnt.shape[0] == 0:
        return 0, 0, 0
    q = qcnt.to(torch.int64)
    return tuple(torch.stack([q.min(), q.sum(1).max(), (q != 0).sum(1).max()]).tolist())


def _wide_parts(qcnt, top: int):
    """Splits (B, Gp) multiplicities whose largest row sum is ``top`` into
    K = ceil(top / WIDE_MAX_SUM) parts (at least one) that add up to
    ``qcnt``, each row of each part summing to at most WIDE_MAX_SUM: part k
    holds the row's multiplicity mass in [k * WIDE_MAX_SUM, (k + 1) *
    WIDE_MAX_SUM), columns in order, so an entry larger than the bound
    spreads over consecutive parts.  Yields (B, Gp) int32 parts."""
    m = WIDE_MAX_SUM
    if top <= m:
        yield qcnt
        return
    hi = qcnt.to(torch.int64).cumsum(1)
    lo = hi - qcnt
    for k in range(-(-top // m)):
        yield (hi.clamp(max=(k + 1) * m) - lo.clamp(min=k * m)).clamp(min=0).to(torch.int32)


def _check_wide(qcnt, planes) -> tuple:
    """``_check`` for K2w, which takes tile-major tables and multiplicities
    >= 0 whose row sums stay below 2^31.  Returns (largest row sum, largest
    count of nonzero columns in a row), one read back from the device.
    Raises on anything else."""
    if planes.ndim != 3:
        raise ValueError(f"planes must be tile-major (ntiles, Gp, {BLKB}), got "
                         f"{tuple(planes.shape)}")
    _check(qcnt, planes)
    lo, top, nnz = _wide_sums(qcnt)
    if lo < 0 or top >= _WIDE_SUM_LIMIT:
        raise ValueError(f"multiplicities must be >= 0 and sum to < 2^31 a row, got "
                         f"min {lo}, largest sum {top}")
    return top, nnz


def bitmap_hits_wide(qcnt, planes):
    """qcnt (B, Gp) multiplicities (integer values >= 0, each row summing to
    less than 2^31, else ValueError)  x  planes, int8 packed incidence,
    tile-major (ntiles, Gp, BLKB)  ->  hits (B, ntiles*TILE_LANES) int32 in
    term order: K2's hits without the <= 127 bound (the hits of the
    reference's ``candidates_bitmap_impl`` scan).

    CUDA tensors launch the K2w kernel once per part of ``_wide_parts``
    (the first part stores, each later one adds into the hits in place);
    CPU tensors run the plain version once per part."""
    global K2W_REF_CALLS
    top, width = _check_wide(qcnt, planes)
    if planes.device.type == "cpu":
        hits = None
        for part in _wide_parts(qcnt, top):
            K2W_REF_CALLS += 1
            h = bitmap_hits_wide_ref(part, planes)
            hits = h if hits is None else hits.add_(h)
        return hits
    b = qcnt.shape[0]
    ntiles, gp = table_shape(planes)
    hits = torch.empty((b, ntiles * TILE_LANES), dtype=torch.int32,
                       device=planes.device)
    if b == 0 or ntiles == 0:
        return hits
    lib = _lib("bitmap_hits")
    for k, part in enumerate(_wide_parts(qcnt, top)):
        rows, mults = _cuda_operands(part, planes, width)
        with torch.cuda.device(planes.device):
            stream = torch.cuda.current_stream(planes.device).cuda_stream
            err = lib.bitmap_hits_wide_launch(
                planes.data_ptr(), rows.data_ptr(), mults.data_ptr(),
                hits.data_ptr(), b, gp, ntiles, rows.shape[1], int(k > 0), stream,
            )
        if err != 0:
            raise RuntimeError(f"bitmap_hits_wide kernel launch failed: cuda error {err}")
        count_launches(globals(), "K2W_LAUNCHES")
    return hits


def bitmap_hits_ref(qcnt, planes, chunk_tiles: int = 16):
    """Plain PyTorch version of ``bitmap_hits``: unpack the planes and take
    a float32 product, at most ``chunk_tiles`` layout tiles at a time (fewer
    where the unpacked operand would pass 1 GB).  Exact: operands are 0/1
    bits and integer counts whose sums stay <= 127 (TF32 is switched off
    for the product and restored after)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _hits_plain(qcnt, planes, chunk_tiles)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def bitmap_hits_bmax_ref(qcnt, planes, chunk_tiles: int = 16):
    """Plain PyTorch version of ``bitmap_hits_bmax``: ``bitmap_hits_ref``
    and a max over each 128-term block."""
    hits = bitmap_hits_ref(qcnt, planes, chunk_tiles)
    b = qcnt.shape[0]
    bmax = hits.view(b, table_shape(planes)[0] * _SUBS, _BMAX_BLK).amax(dim=2)
    return hits, bmax


def bitmap_hits_wide_ref(qcnt, planes, chunk_tiles: int = 16):
    """Plain PyTorch version of ``bitmap_hits_wide``, whole, without the
    wrapper's split into parts: ``bitmap_hits_ref``'s product in float64,
    exact since every row sum stays below 2^31 < 2^53, cast to int32."""
    return _hits_plain(qcnt, planes, chunk_tiles, torch.int32, torch.float64)


def _hits_plain(qcnt, planes, chunk_tiles, dtype=torch.int8, acc=torch.float32):
    ntiles, gp = table_shape(planes)
    b = qcnt.shape[0]
    size = torch.finfo(acc).bits // 8
    step = max(1, min(chunk_tiles, _PLAIN_CHUNK_BYTES // (size * gp * TILE_LANES)))
    q = qcnt.to(acc)
    hits = torch.empty((b, ntiles * TILE_LANES), dtype=dtype,
                       device=planes.device)
    shifts = torch.arange(8, dtype=torch.uint8, device=planes.device)
    for t0 in range(0, ntiles, step):
        t1 = min(t0 + step, ntiles)
        t = tile_columns(planes, t0, t1).view(torch.uint8)  # (Gp, nt, BLKB)
        bits = (t[:, :, None, :] >> shifts[None, None, :, None]) & 1
        m = bits.reshape(gp, (t1 - t0) * TILE_LANES)
        hits[:, t0 * TILE_LANES : t1 * TILE_LANES] = (q @ m.to(acc)).to(dtype)
    return hits


def gather_rows(planes, rows):
    """Gram-row gather of a packed table in either layout: row-major (G, NB)
    -> (Gc, NB), tile-major (ntiles, G, BLKB) -> (ntiles, Gc, BLKB), with
    ``out[..., i, :] = planes[..., rows[i], :]`` (rows (Gc,) integer, each
    in [0, G), else IndexError; duplicates allowed).

    CUDA tensors launch the gather kernel (csrc/gather_rows.cu); CPU
    tensors run the plain version."""
    global G_REF_CALLS
    if planes.ndim not in (2, 3):
        raise ValueError(f"planes must be (G, NB) or (ntiles, G, {BLKB}), "
                         f"got {tuple(planes.shape)}")
    if planes.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"planes must be int8, got {planes.dtype}")
    if rows.ndim != 1 or rows.is_floating_point():
        raise ValueError(f"rows must be a 1-D integer tensor, got {tuple(rows.shape)}")
    if rows.device != planes.device:
        raise ValueError(f"rows on {rows.device}, planes on {planes.device}")
    if planes.device.type == "cpu":
        G_REF_CALLS += 1
        return gather_rows_ref(planes, rows)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    outer = 1 if planes.ndim == 2 else planes.shape[0]
    g, c = planes.shape[-2:]
    gc = rows.shape[0]
    if c % 16 or not planes.is_contiguous() or planes.data_ptr() % 16:
        raise ValueError("planes must be contiguous, 16-byte aligned, with a "
                         "row length that is a multiple of 16 bytes")
    out = torch.empty((*planes.shape[:-2], gc, c), dtype=planes.dtype,
                      device=planes.device)
    if outer == 0 or gc == 0 or c == 0:
        return out
    rows32 = rows.to(torch.int32).contiguous()
    # the kernel reads rows unchecked; a captured chain reads nothing back,
    # and its caller builds the rows in range on the host
    if not torch.cuda.is_current_stream_capturing():
        lo, hi = (int(v) for v in torch.aminmax(rows32))
        if lo < 0 or hi >= g:
            raise IndexError(f"rows must lie in [0, {g}), got [{lo}, {hi}]")
    lib = _lib("gather_rows")
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.gather_rows_launch(
            planes.data_ptr(), rows32.data_ptr(), out.data_ptr(), outer, g,
            gc, c // 16, stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: cuda error {err}")
    count_launches(globals(), "G_LAUNCHES")
    return out


def gather_rows_ref(planes, rows):
    """Plain PyTorch version of ``gather_rows``: ``index_select`` on the
    gram axis."""
    return planes.index_select(planes.ndim - 2, rows.long())


def gather_rows_pallas(table, rows):
    """Row gather out[i] = table[rows[i]] of a row-major (G, NB) table with
    NB % 128 == 0 (the reference's K4 contract)."""
    _, nb = table.shape
    assert nb % 128 == 0, nb
    return gather_rows(table, rows)


def gather_rows_dma(table, rows):
    """Row gather out[i] = table[rows[i]] of a row-major (G, NB) table with
    NB % 1024 == 0, as the PAD_LANES term padding builds it (the reference's
    K3 contract)."""
    _, nb = table.shape
    assert nb % 1024 == 0, nb
    return gather_rows(table, rows)
