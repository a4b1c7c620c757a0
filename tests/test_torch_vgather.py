"""The filled table gather of the PyTorch port (the plain version of kernel
K6, ``ops.vgather.gather_tables``) against the TPU kernel
``tools.experimental.vgather.gather_tables`` in interpret mode, and the
postings expansion that calls it (``search.overlap.gather_hits``) against
the JAX package's.

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


def jax_hits(ptr, terms, slots, n_long, s_cap):
    import jax

    return jax.vmap(lambda row: jov.gather_hits(
        jnp.asarray(ptr), jnp.asarray(terms), row, n_long, s_cap
    ))(jnp.asarray(slots))
