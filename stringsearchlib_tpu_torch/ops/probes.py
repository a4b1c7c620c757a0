"""The K1 probes P1-P9 on Hopper: the Pallas kernels of the reference's
probe tools, as hand-written CUDA kernels with plain PyTorch versions.

The reference measured K1 (``bitmap_hits_bmax``) on the TPU with variants
that live as closures in its tools (``tools/probe_*.py``); here each is a
function with the TPU kernel's contract, bit for bit:

  P1 ``pl_stream``    tools/probe_bandwidth.py:87-101   column max, row-major
  P2 ``stream_row``   tools/probe_layout_r5.py:127-149  the same, max with r
  P3 ``stream_tile``  tools/probe_layout_r5.py:152-174  tile-major, with r
  P4-P7 ``pair``      tools/probe_layout_r5.py:215-317  K1's pair-dot kernel:
                      ``row`` / ``tile`` tables, ``tile_q2`` (two query
                      blocks sharing one table read), ``tile_o3`` (output
                      tile-major (ntiles, B, 4096))
  P8 ``raw_hits``     tools/probe_kernel_raw.py:136-182 the five undecoded
                      accumulators, int16 or int32
  P9 ``bisect_run``   tools/probe_kernel_bisect.py:141-210 one part removed
                      per variant (``BISECT_VARIANTS``)

P1-P3 launch ``csrc/probe_stream.cu``, P4-P9 ``csrc/probe_hits.cu``, whose
instances share K1's counting body (``csrc/bitmap_hits.cuh``) and differ in
their epilogues.  The TPU kernels take five int8 dots per layout tile,
``acc[m] = q . (t & PAIR_MASKS[m])``, and decode them (``decode_planes``);
the CUDA kernel counts the plane hits ``h_p`` as K1 does and forms the
same accumulators from them (``acc0 = h0 + 32 h5``, ``acc1 = 2 h1 + 64 h6``,
``acc2 = 4 h2 - 128 h7``, ``acc3 = 8 h3``, ``acc4 = 16 h4``; ``noand``'s
signed dot is ``sum_p w_p h_p``, ``w = (1, 2, ..., 64, -128)``), exact for
the contract: ``q`` holds non-negative integer counts, each row summing to
at most 127 (the JAX tools cast ``q`` to int8).  The decode and the casts
to int8 / int16 wrap as in JAX, above 31 windows too, where the TPU's
paired fields carry.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version (masked float32 products on the unpacked
bytes, exact here: integer operands, sums below 2^24).  ``LAUNCHES`` and
``REF_CALLS`` count both, by probe id; callers may reset them.
"""

from __future__ import annotations

import torch

from .bitmap_matmul import (
    BLKB,
    _check,
    _cuda_operands,
    table_shape,
    tile_columns,
)
from .kernels import lib as _lib

PAIR_MASKS = (0b100001, 0b1000010, -124, 8, 16)
# pair's variants and their probe ids
PAIR_PROBE = {"row": "P4", "tile": "P5", "tile_q2": "P6", "tile_o3": "P7"}
PAIR_VARIANTS = tuple(PAIR_PROBE)
BISECT_VARIANTS = ("base", "onedot", "nodecode", "rawi32", "onestore", "noand")
# csrc/probe_hits.cu's epilogues: (its enum value, slots of BLKB elements
# per layout tile, element type)
EPILOGUES = {
    "pair": (0, 8, torch.int8),
    "raw16": (1, 5, torch.int16),
    "raw32": (2, 5, torch.int32),
    "onedot": (3, 8, torch.int8),
    "nodecode": (4, 5, torch.int8),
    "noand": (5, 5, torch.int8),
    "onestore": (6, 1, torch.int8),
}
BISECT_EPILOGUE = {"base": "pair", "onedot": "onedot", "nodecode": "nodecode",
                    "rawi32": "raw32", "onestore": "onestore", "noand": "noand"}

# launches of each probe's CUDA kernel, and calls of its plain version made
# by a wrapper for CPU tensors
LAUNCHES = dict.fromkeys(("P1", "P2", "P3", "P4", "P5", "P6", "P7", "P8", "P9"), 0)
REF_CALLS = dict.fromkeys(LAUNCHES, 0)
# bytes of the float32 operand (or int32 rows) the plain versions hold at a time
_PLAIN_CHUNK_BYTES = 1 << 30


def _stream_shape(t):
    """(ntiles, G, row stride, tile stride) of a stream probe's table, in
    bytes: row-major (G, NB) or tile-major (ntiles, G, BLKB)."""
    if t.dtype != torch.int8:
        raise TypeError(f"the table must be int8, got {t.dtype}")
    nt, g = table_shape(t)
    if g == 0 or nt == 0:
        raise ValueError(f"empty table {tuple(t.shape)}")
    return (nt, g, BLKB, g * BLKB) if t.ndim == 3 else (nt, g, nt * BLKB, BLKB)


def _stream(probe: str, t, r):
    nt, g, row_stride, tile_stride = _stream_shape(t)
    if r is not None:
        if r.shape != (1, BLKB) or r.dtype != torch.int32:
            raise ValueError(f"r must be (1, {BLKB}) int32, got {tuple(r.shape)} {r.dtype}")
        if r.device != t.device:
            raise ValueError(f"r on {r.device}, the table on {t.device}")
    if t.device.type == "cpu":
        REF_CALLS[probe] += 1
        return stream_ref(t, r)
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("the table must be contiguous and 16-byte aligned")
    out = torch.empty((1, nt * BLKB) if t.ndim == 2 else (nt, 1, BLKB),
                      dtype=torch.int32, device=t.device)
    rc = r.contiguous() if r is not None else None
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = _lib("probe_stream").probe_stream_launch(
            t.data_ptr(), rc.data_ptr() if rc is not None else None,
            out.data_ptr(), g, nt, row_stride, tile_stride, stream,
        )
    if err != 0:
        raise RuntimeError(f"probe_stream kernel launch failed: cuda error {err}")
    LAUNCHES[probe] += 1
    return out


def pl_stream(t):
    """P1: t (G, NB) int8 row-major -> (1, NB) int32, ``out[0, j] =
    max_g int32(t[g, j])`` (signed bytes).  The TPU tool applied ``t ^ r``
    in XLA before its kernel; that copy is not the kernel's and is left out."""
    if t.ndim != 2:
        raise ValueError(f"pl_stream takes a row-major (G, NB) table, got {tuple(t.shape)}")
    return _stream("P1", t, None)


def stream_row(t, r):
    """P2: t (G, NB) int8 row-major, r (1, 512) int32 -> (1, NB) int32,
    ``out[0, j] = max(max_g int32(t[g, j]), r[0, j % 512])``."""
    if t.ndim != 2:
        raise ValueError(f"stream_row takes a row-major (G, NB) table, got {tuple(t.shape)}")
    return _stream("P2", t, r)


def stream_tile(t, r):
    """P3: t (ntiles, G, 512) int8 tile-major, r (1, 512) int32 ->
    (ntiles, 1, 512) int32, ``out[j, 0, k] = max(max_g int32(t[j, g, k]),
    r[0, k])``."""
    if t.ndim != 3:
        raise ValueError(f"stream_tile takes a tile-major table, got {tuple(t.shape)}")
    return _stream("P3", t, r)


def stream_ref(t, r=None):
    """Plain PyTorch version of P1-P3 (either layout, ``r`` optional): the
    rows widened to int32 a chunk at a time, then a max."""
    nt, g, _, _ = _stream_shape(t)
    step = max(1, _PLAIN_CHUNK_BYTES // (4 * nt * BLKB))
    out = torch.full((nt, BLKB), -128, dtype=torch.int32, device=t.device)
    for g0 in range(0, g, step):
        cols = tile_columns(t, 0, nt)[g0 : g0 + step]  # (rows, nt, BLKB)
        out = torch.maximum(out, cols.to(torch.int32).amax(dim=0))
    if r is not None:
        out = torch.maximum(out, r.to(out.device))
    return out.view(1, nt * BLKB) if t.ndim == 2 else out.view(nt, 1, BLKB)


def _hits_probe(probe: str, q, planes, epi: str, *, out_tile_major=False, qpb=16):
    _check(q, planes)
    if planes.dtype != torch.int8:
        raise TypeError(f"planes must be int8, got {planes.dtype}")
    if planes.device.type == "cpu":
        REF_CALLS[probe] += 1
        return hits_probe_ref(q, planes, epi, out_tile_major=out_tile_major)
    code, w, dtype = EPILOGUES[epi]
    nt, gp = table_shape(planes)
    b = q.shape[0]
    if out_tile_major:
        out = torch.empty((nt, b, w * BLKB), dtype=dtype, device=planes.device)
        q_stride, t_stride = w * BLKB, b * w * BLKB
    else:
        out = torch.empty((b, nt * w * BLKB), dtype=dtype, device=planes.device)
        q_stride, t_stride = nt * w * BLKB, w * BLKB
    if b == 0 or nt == 0:
        return out
    rows, mults = _cuda_operands(q, planes)
    row_stride, tile_stride = (BLKB, gp * BLKB) if planes.ndim == 3 else (nt * BLKB, BLKB)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = _lib("probe_hits").probe_hits_launch(
            planes.data_ptr(), rows.data_ptr(), mults.data_ptr(), out.data_ptr(),
            b, nt, rows.shape[1], row_stride, tile_stride, q_stride, t_stride,
            code, qpb, stream,
        )
    if err != 0:
        raise RuntimeError(f"probe_hits kernel ({epi}) launch failed: cuda error {err}")
    LAUNCHES[probe] += 1
    return out


def pair(q, t, *, variant: str):
    """P4-P7, the reference's pair-dot kernel: q (B, Gp) counts x t ->
    ``out[b, j*4096 + s*512 + k] = int8(decode_planes(accs)[s])`` for layout
    tile j, ``accs[m] = sum_g q[b, g] * (t[g, j*512 + k] & PAIR_MASKS[m])``.
    ``variant``: ``row`` (t row-major (Gp, NB)), ``tile`` (t tile-major),
    ``tile_q2`` (the same for 2 x bq queries; one block reads a tile's rows
    for 32 queries), ``tile_o3`` (tile-major t, out (ntiles, B, 4096))."""
    if variant not in PAIR_PROBE:
        raise ValueError(f"variant must be one of {PAIR_VARIANTS}, got {variant!r}")
    if (t.ndim == 2) != (variant == "row"):
        raise ValueError(f"pair {variant!r} takes a {'row' if variant == 'row' else 'tile'}"
                         f"-major table, got {tuple(t.shape)}")
    return _hits_probe(PAIR_PROBE[variant], q, t, "pair",
                       out_tile_major=variant == "tile_o3",
                       qpb=32 if variant == "tile_q2" else 16)


def raw_hits(qcnt, planes, *, i16: bool = True):
    """P8: the five accumulators undecoded, slot s of tile j at
    ``[b, j*2560 + s*512 + k]``, int16 (``i16``, wrapping) or int32; planes
    in either layout."""
    return _hits_probe("P8", qcnt, planes, "raw16" if i16 else "raw32")


def bisect_run(qcnt, planes, *, variant: str):
    """P9, the reference's bisect kernel ``run``: ``base`` (P4's output),
    ``onedot`` (decode of ``[accs[0]] * 5``), ``nodecode`` (``acc & 127``,
    5 int8 slots), ``rawi32`` (5 int32 slots), ``onestore`` (the 8 decoded
    planes summed, ``& 127``, 1 slot), ``noand`` (five copies of the signed
    dot ``q . int8(t)``, ``& 127``); out (B, ntiles * width * 512)."""
    if variant not in BISECT_EPILOGUE:
        raise ValueError(f"variant must be one of {BISECT_VARIANTS}, got {variant!r}")
    return _hits_probe("P9", qcnt, planes, BISECT_EPILOGUE[variant])


def decode_planes(accs):
    """tools/probe_layout_r5.py:185-191: five int32 accumulators -> the
    eight decoded planes (arithmetic shifts)."""
    p0, p1, p27, p3, p4 = accs
    h7 = (127 - p27) >> 7
    return [
        p0 & 31, (p1 >> 1) & 31, (p27 + h7 * 128) >> 2,
        p3 >> 3, p4 >> 4, p0 >> 5, p1 >> 6, h7,
    ]


def probe_accs(q, planes, t0: int, t1: int, *, signed: bool = False):
    """The TPU kernels' dots over layout tiles [t0, t1), each (B, (t1 - t0)
    * 512) int32 in column order: ``q @ (t & m)`` for each of PAIR_MASKS, or
    with ``signed`` five copies of ``q @ t`` (``noand``)."""
    gp = table_shape(planes)[1]
    cols = tile_columns(planes, t0, t1).reshape(gp, (t1 - t0) * BLKB)
    qf = q.to(torch.float32)
    if signed:
        return [(qf @ cols.to(torch.float32)).to(torch.int32)] * 5
    return [(qf @ (cols & m).to(torch.float32)).to(torch.int32) for m in PAIR_MASKS]


def _epilogue_values(epi: str, accs):
    if epi == "pair":
        return decode_planes(accs)
    if epi == "onedot":
        return decode_planes([accs[0]] * 5)
    if epi in ("raw16", "raw32"):
        return accs
    if epi in ("nodecode", "noand"):
        return [a & 127 for a in accs]
    return [sum(decode_planes(accs)) & 127]  # onestore


def hits_probe_ref(q, planes, epi: str, *, out_tile_major: bool = False,
                   chunk_tiles: int = 64):
    """Plain PyTorch version of P4-P9: the TPU kernel's masked products
    (``probe_accs``) and epilogue in int32, then the cast, at most
    ``chunk_tiles`` layout tiles at a time (fewer where the float32 operand
    would pass 1 GB).  TF32 is switched off for the products and restored."""
    _, w, dtype = EPILOGUES[epi]
    nt, gp = table_shape(planes)
    b = q.shape[0]
    out = torch.empty((b, nt, w, BLKB), dtype=dtype, device=planes.device)
    step = max(1, min(chunk_tiles, _PLAIN_CHUNK_BYTES // (4 * max(gp, 1) * BLKB)))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for t0 in range(0, nt, step):
            t1 = min(t0 + step, nt)
            accs = probe_accs(q, planes, t0, t1, signed=epi == "noand")
            vals = _epilogue_values(epi, accs)
            out[:, t0:t1] = torch.stack(
                [v.view(b, t1 - t0, BLKB) for v in vals], dim=2).to(dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if out_tile_major:
        return out.permute(1, 0, 2, 3).reshape(nt, b, w * BLKB)
    return out.view(b, nt * w * BLKB)


def pair_ref(q, t, *, variant: str):
    """Plain PyTorch version of ``pair``."""
    return hits_probe_ref(q, t, "pair", out_tile_major=variant == "tile_o3")


def raw_hits_ref(qcnt, planes, *, i16: bool = True):
    """Plain PyTorch version of ``raw_hits``."""
    return hits_probe_ref(qcnt, planes, "raw16" if i16 else "raw32")


def bisect_ref(qcnt, planes, *, variant: str):
    """Plain PyTorch version of ``bisect_run``."""
    return hits_probe_ref(qcnt, planes, BISECT_EPILOGUE[variant])
