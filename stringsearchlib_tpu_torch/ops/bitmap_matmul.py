"""Hit counts from a bit-packed gram incidence: kernel K1 on Hopper.

PyTorch counterpart of ``stringsearchlib_tpu.ops.bitmap_matmul``.  The
layout helpers are the reference's, so tables are byte-identical:
bytes are grouped into tiles of ``BLKB``; bit ``p`` of byte ``j*BLKB + k``
holds term ``j*8*BLKB + p*BLKB + k``; resident tables are tile-major
``(ntiles, Gp, BLKB)`` int8 (HostIndex.bitmap_tables).

``bitmap_hits_bmax`` keeps the reference's signature and layouts.  On a
CUDA tensor it launches the hand-written kernel in ``csrc/bitmap_hits.cu``
(built with nvcc for sm_90a into ``build/kernels/`` at first use, bound
with ctypes); on a CPU tensor it runs ``bitmap_hits_bmax_ref``, the plain
PyTorch version.  Nothing else chooses between the two: a CUDA tensor
launches the kernel or raises.

The reference's pair dots, 31-window gate, G tiling and VMEM budget exist
for the TPU's matrix unit and VMEM; the Hopper kernel accumulates every
query's counts in integer registers for any Gp multiple of 32, so only the
<= 127 count contract remains (int8 hits).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

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
# most nonzero qcnt columns a query can hold under the <= 127 contract
_VMAX = 127

# launches of the CUDA kernel, and calls of the plain version made by the
# wrapper for CPU tensors; plain integers that callers may reset
KERNEL_LAUNCHES = 0
REF_CALLS = 0

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
_SRC = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "csrc", "bitmap_hits.cu")
)
_OUT_DIR = os.path.join(_ROOT, "build", "kernels")
_LIB = None
_LIB_LOCK = threading.Lock()


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


def build_kernel() -> str:
    """Compile csrc/bitmap_hits.cu for sm_90a (when the .so is missing or
    older than the source) and return the library path.  Raises when nvcc
    is absent or the compile fails."""
    os.makedirs(_OUT_DIR, exist_ok=True)
    so = os.path.abspath(os.path.join(_OUT_DIR, "libbitmap_hits.so"))
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(_SRC):
        return so
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the K1 kernel cannot be built")
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, _SRC,
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    return so


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_kernel())
            fn = lib.bitmap_hits_bmax_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p
            ]
            fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _compact_qcnt(qcnt):
    """(B, Gp) multiplicities -> zero-terminated (B, V) int32 row and
    multiplicity lists, nonzero columns first in row order.  The <= 127
    contract bounds a query's nonzero columns by 127."""
    gp = qcnt.shape[1]
    v = min(gp, _VMAX)
    zero = (qcnt == 0).to(torch.uint8)
    order = torch.argsort(zero, dim=1, stable=True)[:, :v]
    rows = order.to(torch.int32).contiguous()
    mults = qcnt.gather(1, order).to(torch.int32).contiguous()
    return rows, mults


def _check(qcnt, planes):
    if planes.ndim != 3 or planes.shape[2] != BLKB:
        raise ValueError(f"planes must be (ntiles, Gp, {BLKB}), got {tuple(planes.shape)}")
    if planes.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"planes must be int8, got {planes.dtype}")
    if qcnt.ndim != 2 or qcnt.shape[1] != planes.shape[1]:
        raise ValueError(
            f"qcnt {tuple(qcnt.shape)} does not match planes {tuple(planes.shape)}"
        )
    if planes.shape[1] % 32:
        raise ValueError(f"Gp must be a multiple of 32, got {planes.shape[1]}")
    if qcnt.device != planes.device:
        raise ValueError(f"qcnt on {qcnt.device}, planes on {planes.device}")


def bitmap_hits_bmax(qcnt, planes):
    """qcnt (B, Gp) gram multiplicities (any numeric dtype; integer values,
    each row summing to <= 127)  x  planes (ntiles, Gp, BLKB) int8 packed
    incidence  ->  (hits (B, ntiles*TILE_LANES) int8 in term order,
    bmax (B, ntiles*32) int8 per-128-term block maxima).

    CUDA tensors launch the K1 kernel; CPU tensors run the plain version."""
    global KERNEL_LAUNCHES, REF_CALLS
    _check(qcnt, planes)
    if planes.device.type == "cpu":
        REF_CALLS += 1
        return bitmap_hits_bmax_ref(qcnt, planes)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    if not planes.is_contiguous() or planes.data_ptr() % 16:
        raise ValueError("planes must be contiguous and 16-byte aligned")
    b = qcnt.shape[0]
    ntiles, gp, _ = planes.shape
    hits = torch.empty((b, ntiles * TILE_LANES), dtype=torch.int8,
                       device=planes.device)
    bmax = torch.empty((b, ntiles * _SUBS), dtype=torch.int8,
                       device=planes.device)
    if b == 0 or ntiles == 0:
        return hits, bmax
    rows, mults = _compact_qcnt(qcnt)
    lib = _lib()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.bitmap_hits_bmax_launch(
            planes.data_ptr(), rows.data_ptr(), mults.data_ptr(),
            hits.data_ptr(), bmax.data_ptr(), b, gp, ntiles,
            rows.shape[1], stream,
        )
    if err != 0:
        raise RuntimeError(f"bitmap_hits_bmax kernel launch failed: cuda error {err}")
    KERNEL_LAUNCHES += 1
    return hits, bmax


def bitmap_hits_bmax_ref(qcnt, planes, chunk_tiles: int = 16):
    """Plain PyTorch version of ``bitmap_hits_bmax``: unpack the planes and
    take a float32 product, ``chunk_tiles`` layout tiles at a time.  Exact:
    operands are 0/1 bits and integer counts whose sums stay <= 127 (TF32
    is switched off for the product and restored after)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _hits_bmax_plain(qcnt, planes, chunk_tiles)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _hits_bmax_plain(qcnt, planes, chunk_tiles):
    ntiles, gp, _ = planes.shape
    b = qcnt.shape[0]
    q = qcnt.to(torch.float32)
    hits = torch.empty((b, ntiles * TILE_LANES), dtype=torch.int8,
                       device=planes.device)
    shifts = torch.arange(8, dtype=torch.uint8, device=planes.device)
    for t0 in range(0, ntiles, chunk_tiles):
        t1 = min(t0 + chunk_tiles, ntiles)
        t = planes[t0:t1].view(torch.uint8)  # (nt, Gp, BLKB)
        bits = (t[:, :, None, :] >> shifts[None, None, :, None]) & 1
        m = bits.permute(1, 0, 2, 3).reshape(gp, (t1 - t0) * TILE_LANES)
        hits[:, t0 * TILE_LANES : t1 * TILE_LANES] = (
            q @ m.to(torch.float32)
        ).to(torch.int8)
    bmax = hits.view(b, ntiles * _SUBS, _BMAX_BLK).amax(dim=2)
    return hits, bmax
