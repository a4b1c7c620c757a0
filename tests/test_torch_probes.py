"""The K1 probes P1-P9 in the PyTorch port against the reference's Pallas
kernels, and K1/K2 on row-major tables.

The reference's probe kernels are closures inside each tool's ``main()``,
so they cannot be imported: each ``pallas_call`` below restates its tool's
kernel and call verbatim (file and lines cited; only ``interpret=True`` is
added and the closed-over shapes become arguments), run in interpret mode
at small shapes: Gp 128 and 256, 3-4 layout tiles, 8-16 queries, rows
summing to 31 and to 127, random signed tables and the all-bits-set and
-128 edges.  The port's plain versions (``ops.probes``) must be
bit-identical to them; the CUDA kernels are held against the plain versions
on the card (tests/test_torch_gpu.py, chip_smoke.py).  A numpy model of the
CUDA kernels' epilogue arithmetic (accumulators from plane counts) is held
against the masked products.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stringsearchlib_tpu.config import IndexConfig
from stringsearchlib_tpu.index.build import build_index
from stringsearchlib_tpu.ops import bitmap_matmul as jbm
from stringsearchlib_tpu_torch.ops import bitmap_matmul as pbm
from stringsearchlib_tpu_torch.ops import probes

BLKB, TILE_LANES = jbm.BLKB, jbm.TILE_LANES
PAIR_MASKS = (0b100001, 0b1000010, -124, 8, 16)


# -- the reference's kernels, restated ----------------------------------------


@jax.jit
def jax_pl_stream(t, r):
    """tools/probe_bandwidth.py:84-101 (kern, pl_stream)."""
    g, nb = t.shape
    blkb = 512

    def kern(t_ref, o_ref):
        o_ref[:, :] = jnp.max(
            t_ref[:].astype(jnp.int32), axis=0, keepdims=True
        )

    ntiles = nb // blkb
    return pl.pallas_call(
        kern,
        grid=(ntiles,),
        in_specs=[pl.BlockSpec((g, blkb), lambda j: (0, j))],
        out_specs=pl.BlockSpec((1, blkb), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((1, nb), jnp.int32),
        interpret=True,
    )(t ^ jnp.int8(r))


def _stream_cost(gp, nb):
    """tools/probe_layout_r5.py:122-124."""
    return pl.CostEstimate(
        flops=gp * nb, bytes_accessed=gp * nb + nb, transcendentals=0
    )


@jax.jit
def jax_stream_row(t, r):
    """tools/probe_layout_r5.py:126-149."""
    gp, nb = t.shape
    ntiles = nb // BLKB
    return pl.pallas_call(
        lambda r_ref, t_ref, o_ref: o_ref.__setitem__(
            (slice(None), slice(None)),
            jnp.maximum(
                jnp.max(
                    t_ref[:].astype(jnp.int32), axis=0, keepdims=True
                ),
                r_ref[:],
            ),
        ),
        grid=(ntiles,),
        in_specs=[
            pl.BlockSpec((1, BLKB), lambda j: (0, 0)),
            pl.BlockSpec((gp, BLKB), lambda j: (0, j)),
        ],
        out_specs=pl.BlockSpec((1, BLKB), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((1, nb), jnp.int32),
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",),
        ),
        cost_estimate=_stream_cost(gp, nb),
        interpret=True,
    )(r, t)


@jax.jit
def jax_stream_tile(t, r):
    """tools/probe_layout_r5.py:151-174."""
    ntiles, gp, _ = t.shape
    return pl.pallas_call(
        lambda r_ref, t_ref, o_ref: o_ref.__setitem__(
            (slice(None), slice(None), slice(None)),
            jnp.maximum(
                jnp.max(
                    t_ref[:].astype(jnp.int32), axis=1, keepdims=True
                ),
                r_ref[:][None],
            ),
        ),
        grid=(ntiles,),
        in_specs=[
            pl.BlockSpec((1, BLKB), lambda j: (0, 0)),
            pl.BlockSpec((1, gp, BLKB), lambda j: (j, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, 1, BLKB), lambda j: (j, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((ntiles, 1, BLKB), jnp.int32),
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",),
        ),
        cost_estimate=_stream_cost(gp, ntiles * BLKB),
        interpret=True,
    )(r, t)


def decode_planes(accs):
    """tools/probe_layout_r5.py:185-191 (the same at
    probe_kernel_bisect.py:132-139)."""
    p0, p1, p27, p3, p4 = accs
    h7 = (np.int32(127) - p27) >> 7
    return [
        p0 & 31, (p1 >> 1) & 31, (p27 + (h7 << 7)) >> 2,
        p3 >> 3, p4 >> 4, p0 >> 5, p1 >> 6, h7,
    ]


def _body(q, t, store):
    """tools/probe_layout_r5.py:193-199."""
    accs = [
        jnp.dot(q, t & np.int8(m), preferred_element_type=jnp.int32)
        for m in PAIR_MASKS
    ]
    for s, p in enumerate(decode_planes(accs)):
        store(s, p.astype(jnp.int8))


def _pair_params(b, gp, ntiles):
    """tools/probe_layout_r5.py:201-212."""
    nb = ntiles * BLKB
    return dict(
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",),
        ),
        cost_estimate=pl.CostEstimate(
            flops=2 * b * gp * ntiles * TILE_LANES,
            bytes_accessed=2 * b * gp + gp * nb
            + b * ntiles * TILE_LANES,
            transcendentals=0,
        ),
        interpret=True,
    )


@functools.partial(jax.jit, static_argnames=("variant",))
def jax_pair(q, t, *, variant):
    """tools/probe_layout_r5.py:214-318; ``bq`` (closed over there) is half
    of q's rows for tile_q2."""
    b = q.shape[0]
    if variant == "row":
        gp, nb = t.shape
        ntiles = nb // BLKB

        def kernel(q_ref, t_ref, o_ref):
            _body(
                q_ref[:], t_ref[:],
                lambda s, v: o_ref.__setitem__(
                    (slice(None), slice(s * BLKB, (s + 1) * BLKB)), v
                ),
            )

        return pl.pallas_call(
            kernel,
            grid=(ntiles,),
            in_specs=[
                pl.BlockSpec((b, gp), lambda j: (0, 0)),
                pl.BlockSpec((gp, BLKB), lambda j: (0, j)),
            ],
            out_specs=pl.BlockSpec((b, TILE_LANES), lambda j: (0, j)),
            out_shape=jax.ShapeDtypeStruct(
                (b, ntiles * TILE_LANES), jnp.int8
            ),
            **_pair_params(b, gp, ntiles),
        )(q, t)
    ntiles, gp, _ = t.shape
    if variant == "tile":
        def kernel(q_ref, t_ref, o_ref):
            _body(
                q_ref[:], t_ref[0],
                lambda s, v: o_ref.__setitem__(
                    (slice(None), slice(s * BLKB, (s + 1) * BLKB)), v
                ),
            )

        return pl.pallas_call(
            kernel,
            grid=(ntiles,),
            in_specs=[
                pl.BlockSpec((b, gp), lambda j: (0, 0)),
                pl.BlockSpec((1, gp, BLKB), lambda j: (j, 0, 0)),
            ],
            out_specs=pl.BlockSpec((b, TILE_LANES), lambda j: (0, j)),
            out_shape=jax.ShapeDtypeStruct(
                (b, ntiles * TILE_LANES), jnp.int8
            ),
            **_pair_params(b, gp, ntiles),
        )(q, t)
    if variant == "tile_q2":
        bq = b // 2

        # q is (2*bq, gp); both query blocks resident, one table read
        def kernel(q_ref, t_ref, o_ref):
            t = t_ref[0]
            for qi in range(2):
                _body(
                    q_ref[qi * bq:(qi + 1) * bq, :], t,
                    lambda s, v, qi=qi: o_ref.__setitem__(
                        (
                            slice(qi * bq, (qi + 1) * bq),
                            slice(s * BLKB, (s + 1) * BLKB),
                        ),
                        v,
                    ),
                )

        return pl.pallas_call(
            kernel,
            grid=(ntiles,),
            in_specs=[
                pl.BlockSpec((2 * bq, gp), lambda j: (0, 0)),
                pl.BlockSpec((1, gp, BLKB), lambda j: (j, 0, 0)),
            ],
            out_specs=pl.BlockSpec(
                (2 * bq, TILE_LANES), lambda j: (0, j)
            ),
            out_shape=jax.ShapeDtypeStruct(
                (2 * bq, ntiles * TILE_LANES), jnp.int8
            ),
            **_pair_params(2 * bq, gp, ntiles),
        )(q, t)
    assert variant == "tile_o3", variant

    # tile-major OUT: (ntiles, b, 8*BLKB), contiguous 1 MB writes
    def kernel(q_ref, t_ref, o_ref):
        _body(
            q_ref[:], t_ref[0],
            lambda s, v: o_ref.__setitem__(
                (0, slice(None), slice(s * BLKB, (s + 1) * BLKB)),
                v,
            ),
        )

    return pl.pallas_call(
        kernel,
        grid=(ntiles,),
        in_specs=[
            pl.BlockSpec((b, gp), lambda j: (0, 0)),
            pl.BlockSpec((1, gp, BLKB), lambda j: (j, 0, 0)),
        ],
        out_specs=pl.BlockSpec(
            (1, b, TILE_LANES), lambda j: (j, 0, 0)
        ),
        out_shape=jax.ShapeDtypeStruct(
            (ntiles, b, TILE_LANES), jnp.int8
        ),
        **_pair_params(b, gp, ntiles),
    )(q, t)


NSLOT = 5  # tools/probe_kernel_raw.py:134


def make_raw_kernel(store_i16: bool):
    """tools/probe_kernel_raw.py:136-156."""
    def kernel(q_ref, bm_ref, out_ref):
        q = q_ref[:]
        t = bm_ref[:]

        def st(s, acc):
            sl = slice(s * BLKB, (s + 1) * BLKB)
            out_ref[:, sl] = acc.astype(
                jnp.int16 if store_i16 else jnp.int32
            )

        for s, mask in enumerate((0b100001, 0b1000010)):
            op = t & np.int8(mask)
            st(s, jnp.dot(q, op, preferred_element_type=jnp.int32))
        op = t & np.int8(-124)  # (2,7) signed
        st(2, jnp.dot(q, op, preferred_element_type=jnp.int32))
        for i, p in enumerate((3, 4)):
            op = t & np.int8(1 << p)
            st(3 + i, jnp.dot(q, op, preferred_element_type=jnp.int32))

    return kernel


@functools.partial(jax.jit, static_argnames=("i16",))
def jax_raw_hits(qcnt, planes, *, i16=True):
    """tools/probe_kernel_raw.py:158-182."""
    gp, nb = planes.shape
    ntiles = nb // BLKB
    bq = qcnt.shape[0]
    return pl.pallas_call(
        make_raw_kernel(i16),
        grid=(ntiles,),
        in_specs=[
            pl.BlockSpec((bq, gp), lambda j: (0, 0)),
            pl.BlockSpec((gp, BLKB), lambda j: (0, j)),
        ],
        out_specs=pl.BlockSpec((bq, NSLOT * BLKB), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct(
            (bq, ntiles * NSLOT * BLKB),
            jnp.int16 if i16 else jnp.int32,
        ),
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",),
        ),
        cost_estimate=pl.CostEstimate(
            flops=2 * bq * gp * ntiles * TILE_LANES,
            bytes_accessed=2 * bq * gp + gp * nb
            + 2 * bq * ntiles * NSLOT * BLKB,
            transcendentals=0,
        ),
        interpret=True,
    )(qcnt.astype(jnp.int8), planes)


def make_bisect_kernel(variant):
    """tools/probe_kernel_bisect.py:141-179."""
    def kernel(q_ref, bm_ref, out_ref):
        q = q_ref[:]
        t = bm_ref[:]
        if variant == "noand":
            accs = [
                jnp.dot(q, t, preferred_element_type=jnp.int32)
                for _ in range(5)
            ]
        else:
            accs = [
                jnp.dot(
                    q, t & np.int8(m), preferred_element_type=jnp.int32
                )
                for m in PAIR_MASKS
            ]
        if variant == "onedot":
            accs = [accs[0]] * 5

        def st(s, v, dt=jnp.int8):
            out_ref[:, s * BLKB : (s + 1) * BLKB] = v.astype(dt)

        if variant in ("nodecode", "noand"):
            for s, acc in enumerate(accs):
                st(s, acc & 127)  # bound to i8 range, no field decode
        elif variant == "rawi32":
            for s, acc in enumerate(accs):
                st(s, acc, jnp.int32)
        elif variant == "onestore":
            planes = decode_planes(accs)
            tot = planes[0]
            for p in planes[1:]:
                tot = tot + p
            st(0, tot & 127)
        else:  # base / onedot: full decode + 8 stores
            for s, p in enumerate(decode_planes(accs)):
                st(s, p)

    return kernel


WIDTH = {  # tools/probe_kernel_bisect.py:181-185
    "base": 8, "onedot": 8, "nodecode": 5, "noand": 5, "rawi32": 5,
    "onestore": 1,
}
DTYPE = {"rawi32": jnp.int32}


@functools.partial(jax.jit, static_argnames=("variant",))
def jax_bisect_run(qcnt, planes, *, variant):
    """tools/probe_kernel_bisect.py:187-210."""
    gp, nb = planes.shape
    ntiles = nb // BLKB
    bq = qcnt.shape[0]
    w = WIDTH[variant]
    dt = DTYPE.get(variant, jnp.int8)
    return pl.pallas_call(
        make_bisect_kernel(variant),
        grid=(ntiles,),
        in_specs=[
            pl.BlockSpec((bq, gp), lambda j: (0, 0)),
            pl.BlockSpec((gp, BLKB), lambda j: (0, j)),
        ],
        out_specs=pl.BlockSpec((bq, w * BLKB), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((bq, ntiles * w * BLKB), dt),
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",),
        ),
        cost_estimate=pl.CostEstimate(
            flops=2 * bq * gp * ntiles * TILE_LANES,
            bytes_accessed=2 * bq * gp + gp * nb
            + bq * ntiles * w * BLKB,
            transcendentals=0,
        ),
        interpret=True,
    )(qcnt.astype(jnp.int8), planes)


# -- inputs ----------------------------------------------------------------------


def _table(rng, gp, ntiles, kind="random"):
    """(gp, ntiles * 512) int8 row-major: random signed bytes, every bit set
    (-1), or only bit 7 (-128)."""
    if kind == "random":
        t = rng.integers(-128, 128, size=(gp, ntiles * BLKB), dtype=np.int8)
        assert (t < 0).any()
        return t
    return np.full((gp, ntiles * BLKB), -1 if kind == "ones" else -128, np.int8)


def _counts(rng, b, gp, total):
    """(b, gp) float32 counts summing to ``total`` per row over 2-40
    distinct columns (multiplicities above 1 among them)."""
    q = np.zeros((b, gp), np.float32)
    for r in range(b):
        k = int(rng.integers(2, min(40, total) + 1))
        cols = rng.choice(gp, size=k, replace=False)
        cuts = np.sort(rng.choice(np.arange(1, total), k - 1, replace=False))
        q[r, cols] = np.diff(np.concatenate([[0], cuts, [total]]))
    assert (q.sum(1) == total).all()
    return q


def _to_tile_major(t):
    gp, nb = t.shape
    return np.ascontiguousarray(t.reshape(gp, nb // BLKB, BLKB).transpose(1, 0, 2))


def _eq(got, want):
    want = np.asarray(want)
    assert got.dtype == {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
                         np.dtype(np.int32): torch.int32}[want.dtype]
    np.testing.assert_array_equal(got.numpy(), want)


# -- P1-P3 ---------------------------------------------------------------------


@pytest.mark.parametrize("probe", ["P1", "P2", "P3"])
@pytest.mark.parametrize("gp,kind", [(128, "random"), (256, "random"), (128, "min")])
def test_stream_probes_match_jax(probe, gp, kind):
    rng = np.random.default_rng(gp + len(probe) + len(kind))
    t = _table(rng, gp, 3, kind)
    if probe == "P1":
        # the tool's `t ^ r` is an XLA pass before the kernel: the port's
        # kernel takes the table it makes
        r = 5
        want = jax_pl_stream(jnp.asarray(t), r)
        got = probes.pl_stream(torch.from_numpy(t ^ np.int8(r)))
    else:
        r = rng.integers(-130, 10, size=(1, BLKB)).astype(np.int32)
        if probe == "P2":
            want = jax_stream_row(jnp.asarray(t), jnp.asarray(r))
            got = probes.stream_row(torch.from_numpy(t), torch.from_numpy(r))
        else:
            t3 = _to_tile_major(t)
            want = jax_stream_tile(jnp.asarray(t3), jnp.asarray(r))
            got = probes.stream_tile(torch.from_numpy(t3), torch.from_numpy(r))
    _eq(got, want)
    assert torch.equal(probes.stream_ref(torch.from_numpy(t)).view(-1),
                       probes.stream_ref(torch.from_numpy(_to_tile_major(t))).view(-1))


# -- P4-P7 ---------------------------------------------------------------------


@pytest.mark.parametrize("variant", list(probes.PAIR_VARIANTS))
@pytest.mark.parametrize("total,kind", [(31, "random"), (127, "random"), (127, "ones")])
def test_pair_matches_jax(variant, total, kind):
    rng = np.random.default_rng(total + len(variant) + len(kind))
    gp = 256 if total == 127 else 128
    t = _table(rng, gp, 3, kind)
    q = _counts(rng, 16 if variant == "tile_q2" else 8, gp, total).astype(np.int8)
    tj = jnp.asarray(t if variant == "row" else _to_tile_major(t))
    want = jax_pair(jnp.asarray(q), tj, variant=variant)
    got = probes.pair(torch.from_numpy(q), torch.from_numpy(np.array(tj)), variant=variant)
    _eq(got, want)


def test_pair_tile_variants_agree_with_row():
    """The reference tool's own parity (probe_layout_r5.py:339-349) on the
    port: tile, tile_q2 and tile_o3 reproduce row."""
    rng = np.random.default_rng(3)
    t = _table(rng, 128, 4)
    q = torch.from_numpy(_counts(rng, 16, 128, 31))
    ref = probes.pair(q[:8], torch.from_numpy(t), variant="row")
    t3 = torch.from_numpy(_to_tile_major(t))
    assert torch.equal(probes.pair(q[:8], t3, variant="tile"), ref)
    assert torch.equal(probes.pair(q, t3, variant="tile_q2")[:8], ref)
    o3 = probes.pair(q[:8], t3, variant="tile_o3")
    assert torch.equal(o3.permute(1, 0, 2).reshape(8, -1), ref)
    # under 31 windows the decode is K1's hits
    assert torch.equal(ref, pbm.bitmap_hits(q[:8], t3))


# -- P8-P9 ---------------------------------------------------------------------


@pytest.mark.parametrize("i16", [True, False])
@pytest.mark.parametrize("total", [31, 127])
def test_raw_hits_matches_jax(i16, total):
    rng = np.random.default_rng(total + i16)
    gp = 128 if i16 else 256
    t = _table(rng, gp, 3)
    q = _counts(rng, 8, gp, total)
    want = jax_raw_hits(jnp.asarray(q), jnp.asarray(t), i16=i16)
    _eq(probes.raw_hits(torch.from_numpy(q), torch.from_numpy(t), i16=i16), want)
    # either layout
    _eq(probes.raw_hits(torch.from_numpy(q), torch.from_numpy(_to_tile_major(t)), i16=i16),
        want)


@pytest.mark.parametrize("variant", list(probes.BISECT_VARIANTS))
@pytest.mark.parametrize("total,kind", [(31, "random"), (127, "random"), (127, "min")])
def test_bisect_matches_jax(variant, total, kind):
    rng = np.random.default_rng(total + len(variant) + len(kind))
    gp = 128 if total == 31 else 256
    t = _table(rng, gp, 3, kind)
    q = _counts(rng, 8, gp, total)
    want = jax_bisect_run(jnp.asarray(q), jnp.asarray(t), variant=variant)
    _eq(probes.bisect_run(torch.from_numpy(q), torch.from_numpy(t), variant=variant), want)


@pytest.mark.parametrize("probe", ["P8_i32", "P9_rawi32"])
@pytest.mark.parametrize("b", [13, 33])
@pytest.mark.parametrize("total,kind", [(31, "random"), (127, "random"), (127, "ones")])
def test_int32_raw_ragged_queries_match_jax(probe, b, total, kind):
    """P8 i32 and P9 rawi32 (one int32 epilogue on the card) at query counts
    that are no multiple of 16 (the kernel's query groups), in both table
    layouts, against the reference's kernels in interpret mode."""
    rng = np.random.default_rng(b + total + len(kind) + len(probe))
    gp = 128
    t = _table(rng, gp, 3, kind)
    q = _counts(rng, b, gp, total)
    if probe == "P8_i32":
        want = jax_raw_hits(jnp.asarray(q), jnp.asarray(t), i16=False)
    else:
        want = jax_bisect_run(jnp.asarray(q), jnp.asarray(t), variant="rawi32")
    qt = torch.from_numpy(q)
    for tt in (torch.from_numpy(t), torch.from_numpy(_to_tile_major(t))):
        if probe == "P8_i32":
            _eq(probes.raw_hits(qt, tt, i16=False), want)
        else:
            _eq(probes.bisect_run(qt, tt, variant="rawi32"), want)


def _swizzle(q):
    """csrc/probe_hits.cu store_raw32_staged: the shared-memory place of
    16-byte chunk q of a warp's 2 KB slot."""
    return q ^ ((q >> 3) & 3)


def test_staged_store_model_matches_strided_layout():
    """numpy model of the int32 epilogue's staged store: each lane writes its
    16 words of a slot as chunks 4 lane + c at their swizzled places, then
    store c of the warp reads chunks 32 c + lane back and writes them to
    consecutive 16-byte places.  The slot comes out in term order, as the
    other epilogues' ``store_slots`` lays it out; every store writes 512
    contiguous bytes; the swizzle is a permutation of the 128 chunks, and
    each quarter warp's writes and reads meet the 8 bank groups once each."""
    lanes = np.arange(32)
    words = (16 * lanes[:, None] + np.arange(16)[None]).astype(np.int64)  # term t of lane l
    assert sorted(_swizzle(q) for q in range(128)) == list(range(128))
    stage = np.full((128, 4), -1, np.int64)
    for c in range(4):
        q = lanes * 4 + c
        stage[_swizzle(q)] = words[:, 4 * c : 4 * c + 4]
        for quarter in range(4):
            group = _swizzle(q[8 * quarter : 8 * quarter + 8]) % 8
            assert sorted(group) == list(range(8))
    out = np.full((128, 4), -1, np.int64)
    for c in range(4):
        q = c * 32 + lanes
        for quarter in range(4):
            group = _swizzle(q[8 * quarter : 8 * quarter + 8]) % 8
            assert sorted(group) == list(range(8))
        assert np.array_equal(q, np.arange(32 * c, 32 * c + 32))  # 512 contiguous bytes
        out[q] = stage[_swizzle(q)]
    np.testing.assert_array_equal(out.reshape(-1), np.arange(512))


# -- the CUDA kernels' epilogue arithmetic ------------------------------------


def _plane_counts(q, t):
    """h[p] (b, nb) int64: sum_g q[b, g] * bit p of t[g, k], bit 7 included."""
    bits = (t.view(np.uint8)[None] >> np.arange(8, dtype=np.uint8)[:, None, None]) & 1
    return np.einsum("bg,pgk->pbk", q.astype(np.int64), bits.astype(np.int64))


@pytest.mark.parametrize("total", [31, 127])
def test_epilogue_model_matches_masked_products(total):
    """csrc/probe_hits.cu forms every accumulator from K1's plane counts:
    acc0 = h0 + 32 h5, acc1 = 2 h1 + 64 h6, acc2 = 4 h2 - 128 h7,
    acc3 = 8 h3, acc4 = 16 h4, and noand's q . t = sum_p w_p h_p with
    w = (1, 2, ..., 64, -128); then the epilogues in int32 with wrapping
    casts.  Held against the masked products and every plain version."""
    rng = np.random.default_rng(total)
    gp, nt = 128, 3
    t = _table(rng, gp, nt)
    t[:4] = -1  # all-bits-set and -128 rows among the random ones
    t[4:8] = -128
    q = _counts(rng, 12, gp, total).astype(np.int64)
    q[0] = 0
    q[0, 0], q[0, 4] = total - 2, 2  # every count at the row's sum
    h = _plane_counts(q, t)
    assert h.max() <= 127 and h.min() >= 0
    accs = [h[0] + 32 * h[5], 2 * h[1] + 64 * h[6], 4 * h[2] - 128 * h[7],
            8 * h[3], 16 * h[4]]
    for acc, m in zip(accs, PAIR_MASKS):
        np.testing.assert_array_equal(acc, q @ (t & np.int8(m)).astype(np.int64))
    dot = sum(w * h[p] for p, w in enumerate((1, 2, 4, 8, 16, 32, 64, -128)))
    np.testing.assert_array_equal(dot, q @ t.astype(np.int64))

    def slots(vals):  # (b, nb) per slot -> (b, nt * W * 512) term order
        v = np.stack([x.reshape(12, nt, BLKB) for x in vals], axis=2)
        return v.reshape(12, -1)

    a32 = [a.astype(np.int32) for a in accs]
    dec = decode_planes(a32)
    model = {
        "base": slots(dec).astype(np.int8),
        "onedot": slots(decode_planes([a32[0]] * 5)).astype(np.int8),
        "nodecode": slots([a & 127 for a in a32]).astype(np.int8),
        "noand": slots([dot.astype(np.int32) & 127] * 5).astype(np.int8),
        "rawi32": slots(a32),
        "onestore": slots([sum(dec) & 127]).astype(np.int8),
    }
    qt, tt = torch.from_numpy(q.astype(np.float32)), torch.from_numpy(t)
    for variant, want in model.items():
        _eq(probes.bisect_ref(qt, tt, variant=variant), want)
    _eq(probes.raw_hits_ref(qt, tt), slots(a32).astype(np.int16))
    if total == 31:  # the decode is exact: the planes are the hits
        _eq(probes.pair_ref(qt, tt, variant="row"),
            slots([h[p].astype(np.int32) for p in range(8)]).astype(np.int8))


# -- wrappers ---------------------------------------------------------------------


def test_wrappers_on_cpu_run_plain_versions():
    rng = np.random.default_rng(5)
    t = torch.from_numpy(_table(rng, 128, 2))
    t3 = torch.from_numpy(_to_tile_major(t.numpy()))
    q = torch.from_numpy(_counts(rng, 4, 128, 31))
    r = torch.zeros((1, BLKB), dtype=torch.int32)
    before = dict(probes.REF_CALLS), dict(probes.LAUNCHES)
    probes.pl_stream(t)
    probes.stream_row(t, r)
    probes.stream_tile(t3, r)
    for v in probes.PAIR_VARIANTS:
        probes.pair(q, t if v == "row" else t3, variant=v)
    probes.raw_hits(q, t)
    probes.bisect_run(q, t, variant="onestore")
    after = probes.REF_CALLS
    assert {k: after[k] - before[0][k] for k in after} == {
        "P1": 1, "P2": 1, "P3": 1, "P4": 1, "P5": 1, "P6": 1, "P7": 1, "P8": 1, "P9": 1}
    assert probes.LAUNCHES == before[1]


def test_wrappers_reject_bad_inputs():
    rng = np.random.default_rng(6)
    t = torch.from_numpy(_table(rng, 128, 2))
    t3 = torch.from_numpy(_to_tile_major(t.numpy()))
    q = torch.from_numpy(_counts(rng, 4, 128, 31))
    with pytest.raises(ValueError):
        probes.pl_stream(t3)  # P1 is row-major
    with pytest.raises(ValueError):
        probes.stream_tile(t, torch.zeros((1, BLKB), dtype=torch.int32))
    with pytest.raises(ValueError):
        probes.stream_row(t, torch.zeros((1, 256), dtype=torch.int32))
    with pytest.raises(ValueError):
        probes.pair(q, t3, variant="row")
    with pytest.raises(ValueError):
        probes.pair(q, t, variant="tile")
    with pytest.raises(ValueError):
        probes.pair(q, t, variant="tile_q3")
    with pytest.raises(ValueError):
        probes.bisect_run(q, t, variant="nostore")
    with pytest.raises(ValueError):
        probes.raw_hits(q[:, :64], t)
    with pytest.raises(TypeError):
        probes.raw_hits(q, t.view(torch.uint8))


# -- K1 / K2 on row-major tables ---------------------------------------------------


@pytest.mark.parametrize("total", [31, 127])
def test_row_major_k1_k2_match_jax_random(total):
    rng = np.random.default_rng(40 + total)
    t = _table(rng, 256, 3)
    q = _counts(rng, 8, 256, total)
    qj = jnp.asarray(q, dtype=jnp.bfloat16)
    jh, jb = jbm.bitmap_hits_bmax(qj, jnp.asarray(t), interpret=True, int8_dots=True)
    hits, bmax = pbm.bitmap_hits_bmax(torch.from_numpy(q), torch.from_numpy(t))
    _eq(hits, jh)
    _eq(bmax, jb)
    _eq(pbm.bitmap_hits(torch.from_numpy(q), torch.from_numpy(t)),
        jbm.bitmap_hits(qj, jnp.asarray(t), interpret=True, int8_dots=True))
    assert torch.equal(hits, pbm.bitmap_hits_ref(
        torch.from_numpy(q), torch.from_numpy(_to_tile_major(t))))


@pytest.mark.parametrize("dots", [True, "pair"])
def test_row_major_k1_k2_match_jax_real_table(dots):
    words = ["".join(np.random.default_rng(i).choice(list("abcdefgh"), 3 + i % 6))
             for i in range(1200)]
    host = build_index(words, 1, None, IndexConfig())
    rm = np.asarray(jbm.from_tile_major(host.bitmap_tables()[0]))
    gp = rm.shape[0]
    rng = np.random.default_rng(9)
    q = np.zeros((8, gp), np.float32)
    for r in range(8):
        q[r, rng.choice(host.n_grams, 12, replace=False)] = 1
    qj = jnp.asarray(q, dtype=jnp.bfloat16)
    jh, jb = jbm.bitmap_hits_bmax(qj, jnp.asarray(rm), interpret=True, int8_dots=dots)
    hits, bmax = pbm.bitmap_hits_bmax(torch.from_numpy(q), torch.from_numpy(rm))
    _eq(hits, jh)
    _eq(bmax, jb)
    _eq(pbm.bitmap_hits(torch.from_numpy(q), torch.from_numpy(rm)),
        jbm.bitmap_hits(qj, jnp.asarray(rm), interpret=True, int8_dots=dots))
