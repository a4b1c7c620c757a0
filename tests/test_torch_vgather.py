"""The filled table gather of the PyTorch port (the plain version of kernel
K6, ``ops.vgather.gather_tables``) against the TPU kernel
``tools.experimental.vgather.gather_tables`` in interpret mode; the
postings expansion (``ops.vgather.expand_postings``) against a numpy oracle
of the JAX package's expression and against the TPU kernel at the
reference's indices, with a numpy model of the expansion kernel's chunked
scan and run walk; and the dense path's ``search.overlap.gather_hits``
against the JAX package's.

Tolerance: none - int32 outputs and the bits of float32 outputs must be
identical.  The CUDA kernel is held against the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringsearchlib_tpu.search import overlap as jov
from stringsearchlib_tpu_torch.ops import vgather as pvg
from stringsearchlib_tpu_torch.search import overlap as pov
from tools.experimental import vgather as jvg


@pytest.fixture
def interpret():
    old = jvg.INTERPRET
    jvg.INTERPRET = True
    yield
    jvg.INTERPRET = old


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("t_total", [100, 4096, 5000])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_plain_matches_vgather(interpret, t_total, order):
    """int32 and float32 tables at shared indices, out of range on both
    sides, against the TPU kernel (interpret mode)."""
    rng = np.random.default_rng(t_total + len(order))
    tab_f = rng.standard_normal(t_total).astype(np.float32)
    tab_i = rng.integers(-2**31, 2**31 - 1, t_total, dtype=np.int64).astype(np.int32)
    idx = rng.integers(-7, t_total + 7, (4, 128)).astype(np.int32)
    if order == "sorted":
        idx.sort(axis=1)
    fills = (-0.5, 2**31 - 1)
    want = jvg.gather_tables(jnp.asarray(idx), [jnp.asarray(tab_f), jnp.asarray(tab_i)],
                             fills, tile=1024)
    calls = pvg.K6_REF_CALLS
    got = pvg.gather_tables(torch.from_numpy(idx),
                            [torch.from_numpy(tab_f), torch.from_numpy(tab_i)], fills)
    assert pvg.K6_REF_CALLS == calls + 1
    for g, w in zip(got, want):
        assert g.dtype in (torch.float32, torch.int32) and g.shape == idx.shape
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_int64_indices_and_one_table(interpret):
    rng = np.random.default_rng(3)
    tab = rng.integers(0, 1 << 30, 777, dtype=np.int64).astype(np.int32)
    idx = rng.integers(-3, 780, (3, 257))
    (want,) = jvg.gather_tables(jnp.asarray(idx.astype(np.int32)), [jnp.asarray(tab)], (777,))
    (got,) = pvg.gather_tables(torch.from_numpy(idx), [torch.from_numpy(tab)], [777])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_contracts():
    tab = torch.arange(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        pvg.gather_tables(torch.zeros((2, 2)), [tab], [0])
    with pytest.raises(TypeError):
        pvg.gather_tables(torch.zeros((2, 2), dtype=torch.int32), [tab.long()], [0])
    with pytest.raises(ValueError):
        pvg.gather_tables(torch.zeros((2, 2), dtype=torch.int32), [tab] * 5, [0] * 5)
    with pytest.raises(ValueError):
        pvg.gather_tables(torch.zeros((2, 2), dtype=torch.int32), [tab, tab[:5]], [0, 0])
    (empty,) = pvg.gather_tables(torch.tensor([[0, -1]], dtype=torch.int32),
                                 [tab[:0]], [9])
    assert empty.tolist() == [[9, 9]]


_FILLS = {  # (float32 fill, int32 fill)
    "nan_and_int32_min": (float("nan"), -(1 << 31)),
    "negative_zero_and_int32_max": (-0.0, (1 << 31) - 1),
    "inf_and_zero": (float("inf"), 0),
}


@pytest.mark.parametrize("fills", list(_FILLS))
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_fills_and_index_types_match_vgather(interpret, fills, idx_dtype):
    """float32 NaN, -0.0 and inf fills, int32 min / max fills, int32 and
    int64 indices (the TPU kernel takes int32), a ragged (3, 131) shape:
    every output bit against the TPU kernel in interpret mode."""
    rng = np.random.default_rng(len(fills) + np.dtype(idx_dtype).itemsize)
    t_total = 3000
    tab_f = rng.standard_normal(t_total).astype(np.float32)
    tab_i = rng.integers(-2**31, 2**31 - 1, t_total, dtype=np.int64).astype(np.int32)
    idx = rng.integers(-9, t_total + 9, (3, 131))
    f_fill, i_fill = _FILLS[fills]
    want = jvg.gather_tables(jnp.asarray(idx.astype(np.int32)),
                             [jnp.asarray(tab_f), jnp.asarray(tab_i)],
                             (f_fill, i_fill), tile=1024)
    got = pvg.gather_tables(torch.from_numpy(idx.astype(idx_dtype)),
                            [torch.from_numpy(tab_f), torch.from_numpy(tab_i)],
                            [f_fill, i_fill])
    for g, w in zip(got, want):
        assert g.shape == idx.shape
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_empty_table_gives_the_fills(idx_dtype):
    """T = 0: every element is out of range, so every output is its fill,
    bit for bit (NaN and -0.0 keep their patterns)."""
    idx = torch.tensor([[0, -1, 5], [2, 1, 0]], dtype=idx_dtype)
    fills = [float("nan"), -0.0, -(1 << 31)]
    tabs = [torch.zeros(0, dtype=torch.float32)] * 2 + [torch.zeros(0, dtype=torch.int32)]
    got = pvg.gather_tables(idx, tabs, fills)
    for g, f, t in zip(got, fills, tabs):
        want = np.full(idx.shape, f, np.float32 if t.dtype == torch.float32 else np.int32)
        assert g.dtype == t.dtype
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(want))


@pytest.mark.parametrize("fill", [float("nan"), -0.0, float("inf"), -1.5, 1e39, -1e39,
                                  3.4028235e38, 1e-46, 7])
def test_fill_word_matches_numpy_float32(fill):
    """The wrapper's fill word without numpy: the float32 cast's bits,
    rounded to nearest, infinite past float32's range."""
    with np.errstate(over="ignore"):
        want = int(np.asarray(fill, dtype=np.float32).view(np.uint32))
    assert pvg._fill_word(fill, torch.float32) == want


@pytest.mark.parametrize("fill", [-(1 << 31), (1 << 31) - 1, 0, -1, 2.9, -2.9, True,
                                  np.int64(-5)])
def test_fill_word_matches_numpy_int32(fill):
    assert pvg._fill_word(fill, torch.int32) == int(
        np.asarray(fill).astype(np.int32).view(np.uint32))


@pytest.mark.parametrize("fill", [1 << 31, -(1 << 31) - 1])
def test_fill_word_rejects_int32_overflow(fill):
    with pytest.raises(OverflowError):
        pvg._fill_word(fill, torch.int32)


@pytest.mark.parametrize("shape", [(4, 16), (3, 131), (1, 1)])
def test_outputs_are_views_of_one_allocation(shape):
    """The wrapper's outputs on the card are views of one allocation, one
    per table in its dtype, each table's B * C words padded to a multiple of
    4, so every view starts 16 bytes aligned (the kernel then stores 16-byte
    vectors whatever B * C)."""
    idx = torch.zeros(shape, dtype=torch.int32)
    tabs = [torch.zeros(5, dtype=torch.int32), torch.zeros(5, dtype=torch.float32),
            torch.zeros(5, dtype=torch.float32), torch.zeros(5, dtype=torch.int32)]
    for n in (1, 2, 4):
        outs = pvg._outputs(idx, tabs[:n])
        assert [o.dtype for o in outs] == [t.dtype for t in tabs[:n]]
        assert all(o.shape == shape and o.is_contiguous() for o in outs)
        base = outs[0].untyped_storage().data_ptr()
        assert all(o.untyped_storage().data_ptr() == base for o in outs)
        nbytes = 4 * outs[0].numel() if n == 1 else 16 * -(-outs[0].numel() // 4)
        assert [o.data_ptr() - outs[0].data_ptr() for o in outs] == [
            k * nbytes for k in range(n)]
        assert nbytes % 16 == 0 or n == 1
        assert outs[0].untyped_storage().nbytes() == n * nbytes


@pytest.mark.parametrize("shape,index_bytes,want", [
    ((256, 1024), 8, (256, 1024)), ((256, 65536), 8, (256, 65536)),
    ((64, 65536), 4, (64, 65536)), ((256, 1024), 4, (256, 1024)),
    ((256, 512), 8, (256, 512)), ((256, 511), 8, (1, 256 * 511)),
    ((256, 1020), 4, (1, 256 * 1020)), ((7, 4099), 4, (1, 7 * 4099)),
    ((3, 1), 8, (1, 3)), ((5, 6), 8, (1, 30)), ((5, 8), 4, (1, 40)),
    ((1 << 20, 4), 4, (1, 1 << 22)), ((2, 3, 2048), 4, (6, 2048)), ((4,), 8, (1, 4)),
    ((0, 1024), 4, (0, 1024)), ((16, 0), 4, (1, 0)),
])
def test_grid_rows_matches_numpy_model(shape, index_bytes, want):
    """The one pass's block order: the rows of the index matrix (the last
    axis a row) where a row is a whole number of 16-byte index vectors and
    at least a block's 256 of them, else one row of every index."""
    n = int(np.prod(shape))
    row_bytes = shape[-1] * index_bytes
    model = (n // shape[-1], shape[-1]) if row_bytes % 16 == 0 and row_bytes >= 4096 else (1, n)
    assert pvg._grid_rows(shape, index_bytes) == model == want


@pytest.mark.parametrize("entry", ["gather_tables"])
def test_gather_entries_reject_bad_operands(entry):
    """Operands the kernel does not take raise before any plain call."""
    fn = getattr(pvg, entry)
    tab = torch.arange(10, dtype=torch.int32)
    idx = torch.zeros((2, 2), dtype=torch.int32)
    for args, err in (((idx.float(), [tab], [0]), TypeError),
                      ((idx, [tab.long()], [0]), TypeError),
                      ((idx, [tab] * 5, [0] * 5), ValueError),
                      ((idx, [tab, tab], [0]), ValueError),
                      ((idx, [tab, tab[:5]], [0, 0]), ValueError),
                      ((idx, [tab[None]], [0]), ValueError),
                      ((idx.to("meta"), [tab], [0]), ValueError)):
        calls = pvg.K6_REF_CALLS
        with pytest.raises(err):
            fn(*args)
        assert pvg.K6_REF_CALLS == calls


def test_gather_takes_iterables_of_tables_and_fills():
    """Tables and fills may come as any iterable, generators included."""
    idx = torch.tensor([[0, 3], [-1, 10]], dtype=torch.int64)
    tabs = [torch.arange(10, dtype=torch.int32), torch.arange(10, dtype=torch.float32)]
    got = pvg.gather_tables(idx, (t for t in tabs), (f for f in (-7, 0.5)))
    want = pvg.gather_tables_ref(idx, tabs, [-7, 0.5])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_gather_hits_matches_jax():
    """The dense path's postings expansion (K6 with index -1 and fill n_long
    on invalid lanes, then a scatter-add) against the JAX package's, on a
    random CSR with repeated and absent gram slots."""
    rng = np.random.default_rng(11)
    g, n_long = 50, 300
    lens = rng.integers(0, 20, g)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    terms = np.concatenate([
        np.sort(rng.choice(n_long, k, replace=False)) for k in lens
    ]).astype(np.int32)
    slots = rng.integers(-1, g, (6, 9)).astype(np.int32)
    slots[0, 3] = slots[0, 4] = slots[0, 5]  # a gram's multiplicity
    s_cap = 256
    want = np.asarray(jax_hits(ptr, terms, slots, n_long, s_cap))
    got = pov.gather_hits(torch.from_numpy(ptr), torch.from_numpy(terms),
                          torch.from_numpy(slots), n_long, s_cap).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_hits_distinct_slots_match_jax():
    """Each row's distinct slots expand once, weighted by their
    multiplicity, into lanes sized for the distinct posting mass; the hits
    equal the JAX package's expansion of every repeat."""
    rng = np.random.default_rng(12)
    g, n_long = 40, 500
    lens = rng.integers(0, 30, g)
    lens[5] = 0
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    terms = np.concatenate([
        np.sort(rng.choice(n_long, k, replace=False)) for k in lens
    ]).astype(np.int32)
    slots = rng.integers(-1, g, (5, 300)).astype(np.int32)
    slots[0] = 7  # one gram 300 times
    slots[1, ::2] = 5  # an empty posting list, repeated
    slots[2] = -1
    slots[3, :200] = np.arange(200) % 3
    mass = [sum(int(lens[x]) for x in set(r.tolist()) if x >= 0) for r in slots]
    full = [sum(int(lens[x]) for x in r.tolist() if x >= 0) for r in slots]
    want = np.asarray(jax_hits(ptr, terms, slots, n_long, max(full)))
    got = pov.gather_hits(torch.from_numpy(ptr), torch.from_numpy(terms),
                          torch.from_numpy(slots), n_long, max(mass)).numpy()
    np.testing.assert_array_equal(got, want)
    # rows in which every slot owns lanes (no absent, empty or repeated one)
    own = np.flatnonzero(lens)
    slots = np.stack([rng.permutation(own)[:20] for _ in range(3)]).astype(np.int32)
    mass = max(int(lens[r].sum()) for r in slots)
    want = np.asarray(jax_hits(ptr, terms, slots, n_long, mass))
    got = pov.gather_hits(torch.from_numpy(ptr), torch.from_numpy(terms),
                          torch.from_numpy(slots), n_long, mass).numpy()
    np.testing.assert_array_equal(got, want)


def jax_hits(ptr, terms, slots, n_long, s_cap):
    import jax

    return jax.vmap(lambda row: jov.gather_hits(
        jnp.asarray(ptr), jnp.asarray(terms), row, n_long, s_cap
    ))(jnp.asarray(slots))


# ---------------------------------------------------------------------------
# the postings expansion
# ---------------------------------------------------------------------------


def _reference_src(ptr, slots, s_cap):
    """numpy form of the JAX package's CSR expand (stringsearchlib_tpu/search/
    overlap.py:36-47, one row at a time): per row, the source position of
    every lane and whether the lane lies inside the row's posting mass."""
    b, qmax = slots.shape
    src = np.zeros((b, s_cap), np.int64)
    valid = np.zeros((b, s_cap), bool)
    pos = np.arange(s_cap)
    for r in range(b):
        present = slots[r] >= 0
        slots_c = np.maximum(slots[r], 0)
        lens = np.where(present, ptr[slots_c + 1].astype(np.int64) - ptr[slots_c], 0)
        ends = np.cumsum(lens)
        rank_c = np.minimum(np.searchsorted(ends, pos, side="right"), qmax - 1)
        starts = ends - lens
        src[r] = ptr[slots_c[rank_c]] + (pos - starts[rank_c])
        valid[r] = pos < ends[-1]
    return src, valid


def _oracle(ptr, terms, slots, s_cap, fill):
    """The JAX expression's lanes: gram_terms at the clipped source where
    the lane is valid, the fill elsewhere."""
    src, valid = _reference_src(ptr, slots, s_cap)
    if terms.size == 0:
        return np.full((slots.shape[0], s_cap), fill, np.int32)
    ids = terms[np.clip(src, 0, terms.size - 1)]
    return np.where(valid, ids, fill).astype(np.int32)


def _csr(rng, g, max_len, zero_every=0):
    lens = rng.integers(0, max_len + 1, g)
    if zero_every:
        lens[::zero_every] = 0
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    terms = rng.integers(0, 1 << 30, int(ptr[-1])).astype(np.int32)
    return ptr, terms


def _expand_case(name):
    """(gram_ptr, gram_terms, slots, s_cap, fill) of one named case, made
    from a seed with numpy."""
    rng = np.random.default_rng(sum(map(ord, name)))
    ptr, terms = _csr(rng, 40, 12)
    fill = 777
    if name == "qmax_1":
        slots = rng.integers(-1, 40, (5, 1)).astype(np.int32)
        slots[0, 0] = int(np.argmax(np.diff(ptr)))
        return ptr, terms, slots, 16, fill
    if name == "all_absent":
        return ptr, terms, np.full((4, 9), -1, np.int32), 128, fill
    if name == "zero_length_runs":
        ptr, terms = _csr(rng, 40, 6, zero_every=2)
        slots = rng.integers(0, 40, (4, 16)).astype(np.int32)
        slots[:, ::3] = 0  # slot 0 has no postings
        return ptr, terms, slots, 128, fill
    if name == "repeated_gram":
        slots = rng.integers(-1, 40, (3, 10)).astype(np.int32)
        slots[0, 2:7] = slots[1, 0] = slots[1, 9] = 5
        return ptr, terms, slots, 256, fill
    if name in ("mass_equals_s_cap", "mass_below_s_cap", "mass_above_s_cap"):
        slots = rng.integers(0, 40, (3, 12)).astype(np.int32)
        mass = int((ptr[slots + 1] - ptr[slots]).sum(1).max())
        s_cap = {"mass_equals_s_cap": mass, "mass_below_s_cap": mass + 37,
                 "mass_above_s_cap": mass - 5}[name]
        return ptr, terms, slots, s_cap, fill
    if name == "empty_gram_terms":
        ptr = np.zeros(41, np.int32)
        return ptr, terms[:0], rng.integers(-1, 40, (3, 7)).astype(np.int32), 64, fill
    if name == "padding_rows":
        slots = np.full((16, 14), -1, np.int32)
        slots[:3] = rng.integers(-1, 40, (3, 14))
        return ptr, terms, slots, 1024, -1
    raise KeyError(name)


_EXPAND_CASES = ["qmax_1", "all_absent", "zero_length_runs", "repeated_gram",
                 "mass_equals_s_cap", "mass_below_s_cap", "mass_above_s_cap",
                 "empty_gram_terms", "padding_rows"]


@pytest.mark.parametrize("case", _EXPAND_CASES)
def test_expand_postings_matches_oracle_and_vgather(interpret, case):
    """The port's expansion on CPU tensors (its plain version) bit for bit
    against the numpy oracle of the JAX expression and against the TPU
    kernel in interpret mode at the reference's indices."""
    ptr, terms, slots, s_cap, fill = _expand_case(case)
    want = _oracle(ptr, terms, slots, s_cap, fill)
    calls, launches = pvg.K6_REF_CALLS, pvg.EXPAND_LAUNCHES
    got = pvg.expand_postings(torch.from_numpy(ptr), torch.from_numpy(terms),
                              torch.from_numpy(slots), s_cap, fill)
    assert (pvg.K6_REF_CALLS, pvg.EXPAND_LAUNCHES) == (calls + 1, launches)
    assert got.dtype == torch.int32 and got.shape == (slots.shape[0], s_cap)
    np.testing.assert_array_equal(got.numpy(), want)
    if terms.size:  # the TPU kernel takes no empty table
        src, valid = _reference_src(ptr, slots, s_cap)
        idx = np.where(valid, src, -1).astype(np.int32)
        (tpu,) = jvg.gather_tables(jnp.asarray(idx), [jnp.asarray(terms)], (fill,))
        np.testing.assert_array_equal(got.numpy(), np.asarray(tpu))


# csrc/gather_tables.cu's expand_postings_kernel: lanes per tile (4 a
# thread), slots per scan chunk (one a thread)
_TILE, _CHUNK = 1024, 256


def _kernel_model(ptr, terms, slots, s_cap, fill, grid_x):
    """numpy model of expand_postings_kernel's schedule: a block per (row,
    blockIdx.x < grid_x) strides over the row's tiles; in a tile the row's
    run lengths are scanned in chunks of _CHUNK slots with the offset
    carried, a chunk scanned again only when it is not the one held; the
    chunk's lanes of the tile are found by a binary search for each
    thread's first lane and a forward walk for the next three, the rest
    left at the fill."""
    b, qmax = slots.shape
    out = np.full((b, s_cap), fill, np.int64)
    n_grams, n_post = ptr.size - 1, terms.size
    n_tiles = -(-s_cap // _TILE)
    for row in range(b):
        for bx in range(min(grid_x, n_tiles)):
            scanned, ends, off = -1, None, None
            for lo in range(bx * _TILE, s_cap, grid_x * _TILE):
                hi = min(lo + _TILE, s_cap)
                carry, q0 = 0, 0
                while q0 < qmax and carry < hi:
                    if q0 != scanned:
                        s = np.full(_CHUNK, -1, np.int64)
                        s[: min(_CHUNK, qmax - q0)] = slots[row, q0 : q0 + _CHUNK]
                        ok = (s >= 0) & (s < n_grams)
                        sc = np.where(ok, s, 0)
                        p0 = np.where(ok, ptr[sc], 0).astype(np.int64)
                        lens = np.where(ok, ptr[np.minimum(sc + 1, n_grams)] - p0, 0)
                        ends = carry + np.cumsum(lens)
                        off = p0 - (ends - lens)
                        scanned = q0
                    a, e = max(lo, carry), min(hi, int(ends[-1]))
                    for t in range(_CHUNK):
                        g = lo + t * 4
                        if g + 4 <= a or g >= e:
                            continue
                        r = int(np.searchsorted(ends, max(g, a), side="right"))
                        for c in range(g, g + 4):
                            if c < a or c >= e:
                                continue
                            while ends[r] <= c:
                                r += 1
                            src = int(off[r]) + c
                            out[row, c] = terms[src] if 0 <= src < n_post else fill
                    carry = int(ends[-1])
                    q0 += _CHUNK
    return out.astype(np.int32)


@pytest.mark.parametrize("case", _EXPAND_CASES + [
    "chunks_qmax_300", "chunks_qmax_700", "runs_across_tiles"])
def test_expansion_kernel_model_matches_oracle(case):
    """The CUDA kernel's schedule, modelled in numpy, gives the JAX
    expression's lanes, with a block per tile and with blocks striding over
    2 and 5 tiles: on the named cases, on rows of 300 and 700 slots (scan
    chunks with a carried offset, scanned again per tile) and on long runs
    that cross the 1,024-lane tiles."""
    if case.startswith("chunks"):
        rng = np.random.default_rng(300)
        ptr, terms = _csr(rng, 90, 9, zero_every=7)
        qmax = int(case.rsplit("_", 1)[1])
        slots = rng.integers(-1, 90, (3, qmax)).astype(np.int32)
        slots[2, 250:260] = 11  # a repeated gram astride the first chunk's end
        # at 300 slots the first chunk's mass passes s_cap: the scan stops
        s_cap = 8192 if qmax == 700 else 900
        fill = 5
    elif case == "runs_across_tiles":
        rng = np.random.default_rng(4096)
        ptr, terms = _csr(rng, 6, 3000)
        slots = np.array([[0, 1, 2, -1, 3], [5, 5, 5, 4, -1]], np.int32)
        s_cap, fill = 3 * _TILE + 7, -9
    else:
        ptr, terms, slots, s_cap, fill = _expand_case(case)
    want = _oracle(ptr, terms, slots, s_cap, fill)
    for grid_x in (1 << 30, 2, 5):
        np.testing.assert_array_equal(
            _kernel_model(ptr, terms, slots, s_cap, fill, grid_x), want)


def _bad_args(case):
    ptr = torch.tensor([0, 2, 5], dtype=torch.int32)
    terms = torch.arange(5, dtype=torch.int32)
    slots = torch.tensor([[0, 1]], dtype=torch.int32)
    return {
        "slots_int64": ((ptr, terms, slots.long(), 8, 0), TypeError),
        "terms_float32": ((ptr, terms.float(), slots, 8, 0), TypeError),
        "ptr_int64": ((ptr.long(), terms, slots, 8, 0), TypeError),
        "slots_1d": ((ptr, terms, slots[0], 8, 0), ValueError),
        "ptr_2d": ((ptr[None], terms, slots, 8, 0), ValueError),
        "device_mismatch": ((ptr.to("meta"), terms, slots, 8, 0), ValueError),
        "s_cap_0": ((ptr, terms, slots, 0, 0), ValueError),
        "qmax_0": ((ptr, terms, slots[:, :0], 8, 0), ValueError),
        "fill_not_int32": ((ptr, terms, slots, 8, 1 << 31), ValueError),
    }[case]


@pytest.mark.parametrize("case", ["slots_int64", "terms_float32", "ptr_int64",
                                  "slots_1d", "ptr_2d", "device_mismatch",
                                  "s_cap_0", "qmax_0", "fill_not_int32"])
def test_expand_postings_contracts(case):
    args, err = _bad_args(case)
    calls = pvg.K6_REF_CALLS
    with pytest.raises(err):
        pvg.expand_postings(*args)
    assert pvg.K6_REF_CALLS == calls
