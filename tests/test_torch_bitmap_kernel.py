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
    before = (pbm.K1_REF_CALLS, pbm.K1_LAUNCHES)
    hits, bmax = pbm.bitmap_hits_bmax(q, planes)
    assert (pbm.K1_REF_CALLS, pbm.K1_LAUNCHES) == (before[0] + 1, before[1])
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


# -- the CUDA kernel's counting scheme, emulated on uint32 words ------------
#
# csrc/bitmap_hits.cu keeps, per 32-bit word of a row slice, NS bit-sliced
# counters (slice j = bit j of the 32 counts), NS = 4..7 picked by the
# query's multiplicity sum.  Rows of multiplicity 1 enter 8, 4, 2, 1 at a
# time through full adders (carry-save), the rest as a ripple-carry add of
# m * word; an 8 x 8 bit transpose per byte gives the SWAR-byte planes.


def _fa(s, a, b):
    return s ^ a ^ b, (s & a) | (s & b) | (a & b)


def _carry_in(s, c, level):
    for j in range(level, len(s) - 1):
        s[j], c = s[j] ^ c, s[j] & c
    s[-1] = s[-1] ^ c


def _n_slices(total):
    return 4 if total <= 15 else 5 if total <= 31 else 6 if total <= 63 else 7


def _to_planes(s):
    t = list(s) + [np.zeros_like(s[0])] * (8 - len(s))
    for d, mask, pairs in (
        (4, 0x0F0F0F0F, ((0, 4), (1, 5), (2, 6), (3, 7))),
        (2, 0x33333333, ((0, 2), (1, 3), (4, 6), (5, 7))),
        (1, 0x55555555, ((0, 1), (2, 3), (4, 5), (6, 7))),
    ):
        for a, b in pairs:
            x = ((t[a] >> np.uint32(d)) ^ t[b]) & np.uint32(mask)
            t[b] = t[b] ^ x
            t[a] = t[a] ^ (x << np.uint32(d))
    return t


def _emulate_kernel(q, planes):
    """hits and block maxima as the CUDA kernel computes them, from the
    wrapper's own row lists (``_compact_qcnt``), all tiles at once."""
    rows, mults = (a.numpy() for a in pbm._compact_qcnt(torch.from_numpy(q)))
    words = np.ascontiguousarray(planes).view(np.uint32)  # (ntiles, Gp, 128)
    nt = words.shape[0]
    out = np.zeros((q.shape[0], nt, 8, 128), np.uint32)
    for b in range(q.shape[0]):
        n, n1 = int((mults[b] != 0).sum()), int((mults[b] == 1).sum())
        assert (mults[b, :n1] == 1).all() and (mults[b, n:] == 0).all()
        x = [words[:, r, :] for r in rows[b, :n]]
        s = [np.zeros((nt, 128), np.uint32)] * _n_slices(int(mults[b].sum()))
        v = 0
        while v + 8 <= n1:
            s[0], a1 = _fa(s[0], x[v], x[v + 1])
            s[0], b1 = _fa(s[0], x[v + 2], x[v + 3])
            s[1], a2 = _fa(s[1], a1, b1)
            s[0], c1 = _fa(s[0], x[v + 4], x[v + 5])
            s[0], d1 = _fa(s[0], x[v + 6], x[v + 7])
            s[1], b2 = _fa(s[1], c1, d1)
            s[2], a3 = _fa(s[2], a2, b2)
            _carry_in(s, a3, 3)
            v += 8
        if v + 4 <= n1:
            s[0], a1 = _fa(s[0], x[v], x[v + 1])
            s[0], b1 = _fa(s[0], x[v + 2], x[v + 3])
            s[1], a2 = _fa(s[1], a1, b1)
            _carry_in(s, a2, 2)
            v += 4
        if v + 2 <= n1:
            s[0], a1 = _fa(s[0], x[v], x[v + 1])
            _carry_in(s, a1, 1)
            v += 2
        if v < n1:
            _carry_in(s, x[v], 0)
            v += 1
        for r in range(v, n):  # multiplicity > 1: m * word, bit by bit of m
            c = np.zeros_like(x[r])
            for j in range(len(s)):
                bj = x[r] if (int(mults[b, r]) >> j) & 1 else np.zeros_like(x[r])
                if j < len(s) - 1:
                    s[j], c = _fa(s[j], bj, c)
                else:
                    s[j] = s[j] ^ bj ^ c
        out[b] = np.stack(_to_planes(s), axis=1)
    hits = out.view(np.uint8).reshape(q.shape[0], nt * jbm.TILE_LANES).view(np.int8)
    return hits, hits.reshape(q.shape[0], nt * 32, 128).max(axis=2)


def _edge_case(case, rng):
    gp, ntiles = 256, 2
    planes = rng.integers(0, 256, size=(ntiles, gp, jbm.BLKB), dtype=np.uint8)
    q = np.zeros((6, gp), np.float32)
    if case in ("sum31", "sum127"):
        total = 31 if case == "sum31" else 127
        q = _qcnt(rng, 6, gp, 20, total=total)
        q[1] = _qcnt(rng, 1, gp, min(total, 40), total=total)[0]  # mostly ones
    elif case == "mixed":  # ones, twos and a few large multiplicities
        for r in range(6):
            cols = rng.choice(gp, size=9 + r, replace=False)
            q[r, cols] = rng.choice([1, 1, 1, 2, 3, 5], size=cols.size)
        q[4, 9:12] = [17, 33, 2]
        q[5] = 0
        q[5, :3] = [64, 32, 31]  # sum 127 in 3 rows of multiplicity > 1
    elif case == "all_ones_127":  # every bit set: every count is 127
        planes[:] = 255
        q[0, 7] = 127
        q[1, :127] = 1
        q[2, 100:104] = [100, 20, 4, 3]
        q[3:, 1:8] = 1
    return q, planes.view(np.int8)


@pytest.mark.parametrize("case", ["sum31", "sum127", "mixed", "all_ones_127"])
def test_kernel_scheme_matches_plain_and_jax(case):
    """The counting scheme of the CUDA kernel, emulated in numpy on uint32
    words (slice counts, the carry-save schedule, the multiplicity entry,
    the bit transpose), equals the plain version and the JAX kernel."""
    q, planes = _edge_case(case, np.random.default_rng(len(case)))
    assert q.sum(1).max() <= 127
    hits, bmax = _emulate_kernel(q, planes)
    if case == "all_ones_127":
        assert (hits[:3] == 127).all()
    _assert_same(_port(q, planes), hits, bmax)
    jh, jb = jbm.bitmap_hits_bmax(
        jnp.asarray(q, dtype=jnp.bfloat16), jnp.asarray(planes),
        interpret=True, int8_dots=True,
    )
    np.testing.assert_array_equal(np.asarray(jh), hits)
    np.testing.assert_array_equal(np.asarray(jb), bmax)


def test_row_lists_put_ones_first():
    q = torch.tensor([[0, 3, 1, 0, 1, 2], [1, 0, 0, 0, 0, 0]], dtype=torch.float32)
    q = torch.nn.functional.pad(q, (0, 26))  # Gp 32
    rows, mults = pbm._compact_qcnt(q)
    assert rows.dtype == mults.dtype == torch.int32 and rows.shape == (2, 32)
    assert rows[0, :4].tolist() == [2, 4, 1, 5] and mults[0, :5].tolist() == [1, 1, 3, 2, 0]
    assert rows[1, 0] == 0 and mults[1].tolist() == [1] + [0] * 31
