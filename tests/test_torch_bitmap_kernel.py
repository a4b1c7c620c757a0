"""K1 (bitmap_hits_bmax) in the PyTorch port against the JAX package.

The port's plain version must be bit-identical to the JAX Pallas kernel
(interpret mode, both int8 dot modes, single-block and G-tiled) and to the
JAX whole-table reference, on a real index table and on random tables.
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringsearchlib_tpu.config import IndexConfig
from stringsearchlib_tpu.index.build import build_index
from stringsearchlib_tpu.ops import bitmap_matmul as jbm
from stringsearchlib_tpu_torch.ops import bitmap_matmul as pbm


def _corpus(n, seed=21):
    rng = random.Random(seed)
    syll = ["ka", "lo", "me", "ri", "su", "ta", "ve", "nor", "bel"]
    return [
        "".join(rng.choice(syll) for _ in range(rng.randint(2, 5)))
        for _ in range(n)
    ]


@pytest.fixture(scope="module")
def real_table():
    host = build_index(_corpus(2500), 1, None, IndexConfig())
    bm, _ = host.bitmap_tables()
    assert bm.ndim == 3
    return host, bm


def _qcnt(rng, b, gp, n_cols, total=None, hi=3, g_live=None):
    """(b, gp) float32 multiplicities: ``n_cols`` distinct columns per row
    (within the first ``g_live``), each 1..hi-1, or summing to ``total``."""
    q = np.zeros((b, gp), np.float32)
    g_live = gp if g_live is None else g_live
    for r in range(b):
        cols = rng.choice(g_live, size=n_cols, replace=False)
        if total is None:
            q[r, cols] = rng.integers(1, hi, size=n_cols)
        else:
            cuts = np.sort(rng.choice(np.arange(1, total), n_cols - 1, replace=False))
            q[r, cols] = np.diff(np.concatenate([[0], cuts, [total]]))
            assert q[r].sum() == total
    return q


def _port(q, planes):
    return pbm.bitmap_hits_bmax_ref(
        torch.from_numpy(q), torch.from_numpy(np.array(planes))
    )


def _assert_same(port, jax_hits, jax_bmax=None):
    hits, bmax = port
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jax_hits))
    if jax_bmax is not None:
        np.testing.assert_array_equal(bmax.numpy(), np.asarray(jax_bmax))


@pytest.mark.parametrize("dots", [True, "pair"])
def test_plain_matches_jax_kernel_real_table(real_table, dots):
    host, bm = real_table
    gp = int(bm.shape[1])
    rng = np.random.default_rng(17)
    # <= 31 windows per query (the JAX pair mode's exactness condition)
    q = _qcnt(rng, 16, gp, 12, g_live=host.n_grams)
    assert q.sum(1).max() <= 31
    qj = jnp.asarray(q, dtype=jnp.bfloat16)
    jh, jb = jbm.bitmap_hits_bmax(qj, bm, interpret=True, int8_dots=dots)
    port = _port(q, bm)
    _assert_same(port, jh, jb)
    _assert_same(port, jbm.bitmap_hits_ref(qj, bm))


@pytest.mark.parametrize("total", [31, 127])
def test_plain_matches_jax_kernel_random_tables(total):
    """Random bytes (bit 7 set, the int8 sign bit), duplicate grams
    (multiplicities > 1) and rows summing to exactly 31 and 127."""
    rng = np.random.default_rng(total)
    gp, ntiles = 256, 2
    planes = rng.integers(0, 256, size=(ntiles, gp, jbm.BLKB), dtype=np.uint8)
    planes = planes.view(np.int8)
    assert (planes < 0).any()
    q = _qcnt(rng, 8, gp, 20, total=total)
    assert (q > 1).any()
    qj = jnp.asarray(q, dtype=jnp.bfloat16)
    port = _port(q, planes)
    dots = ["pair", True] if total <= 31 else [True]
    for d in dots:
        jh, jb = jbm.bitmap_hits_bmax(
            qj, jnp.asarray(planes), interpret=True, int8_dots=d
        )
        _assert_same(port, jh, jb)
    _assert_same(port, jbm.bitmap_hits_ref(qj, jnp.asarray(planes)))


@pytest.mark.parametrize("dots", [True, "pair"])
def test_plain_matches_jax_kernel_gtiled(monkeypatch, dots):
    """Gp above the JAX kernel's single-block ceiling (forced small) runs
    its G-tiled accumulation; the port has one form for every Gp."""
    monkeypatch.setattr(jbm, "SBLK_MAX", 128)
    monkeypatch.setattr(jbm, "GBLK", 128)
    host = build_index(_corpus(1500, seed=41), 1, None, IndexConfig())
    bm, _ = host.bitmap_tables()
    gp = int(bm.shape[1])
    assert gp % 128 == 0 and gp // 128 > 1
    rng = np.random.default_rng(23)
    q = _qcnt(rng, 8, gp, 10, g_live=host.n_grams)
    qj = jnp.asarray(q, dtype=jnp.bfloat16)
    jh, jb = jbm.bitmap_hits_bmax(qj, bm, interpret=True, int8_dots=dots)
    _assert_same(_port(q, bm), jh, jb)


def test_layout_helpers_match(real_table):
    _, bm = real_table
    terms = np.arange(0, 3 * jbm.TILE_LANES, 37)
    for a, b in zip(pbm.plane_coords(terms), jbm.plane_coords(terms)):
        np.testing.assert_array_equal(a, b)
    for g in (1, 127, 128, 2752, 4096, 4097, 47000):
        assert pbm.g_padding(g) == jbm.g_padding(g)
    assert (pbm.BLKB, pbm.TILE_LANES, pbm.PAD_LANES) == (
        jbm.BLKB, jbm.TILE_LANES, jbm.PAD_LANES
    )
    t3 = torch.from_numpy(np.array(bm))
    rm = pbm.from_tile_major(t3)
    np.testing.assert_array_equal(
        rm.numpy(), np.asarray(jbm.from_tile_major(bm))
    )
    assert torch.equal(pbm.to_tile_major(rm), t3)


def test_wrapper_on_cpu_runs_plain_version(real_table):
    _, bm = real_table
    gp = int(bm.shape[1])
    q = torch.from_numpy(_qcnt(np.random.default_rng(3), 4, gp, 9))
    planes = torch.from_numpy(np.array(bm))
    before = (pbm.REF_CALLS, pbm.KERNEL_LAUNCHES)
    hits, bmax = pbm.bitmap_hits_bmax(q, planes)
    assert (pbm.REF_CALLS, pbm.KERNEL_LAUNCHES) == (before[0] + 1, before[1])
    rh, rb = pbm.bitmap_hits_bmax_ref(q, planes)
    assert torch.equal(hits, rh) and torch.equal(bmax, rb)
    assert hits.dtype == bmax.dtype == torch.int8
    assert bmax.shape == (4, planes.shape[0] * 32)


def test_wrapper_rejects_bad_inputs(real_table):
    _, bm = real_table
    planes = torch.from_numpy(np.array(bm))
    gp = planes.shape[1]
    with pytest.raises(ValueError):
        pbm.bitmap_hits_bmax(torch.zeros(2, gp + 1), planes)
    with pytest.raises(ValueError):
        pbm.bitmap_hits_bmax(torch.zeros(2, gp), planes[:, :, :256])
    with pytest.raises(TypeError):
        pbm.bitmap_hits_bmax(torch.zeros(2, gp), planes.to(torch.int32))
