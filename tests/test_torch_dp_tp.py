"""The PyTorch port's 2-D DP x TP engine (parallel.dp_tp) against the JAX
package's on the CPU: the reference's tests/test_dp_tp.py mirrored - the
JAX engine on the virtual 8-device mesh, the port on ``make_mesh_2d(st, sg,
device="cpu")`` - plus the 2-D postings split bit for bit and the
conversion of the reference's 2-D state."""

import random

import numpy as np
import pytest
import torch

from stringsearchlib_tpu.config import IndexConfig as JConfig
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.parallel import dp_tp as jdp_tp
from stringsearchlib_tpu_torch.config import IndexConfig
from stringsearchlib_tpu_torch.index.build import build_index
from stringsearchlib_tpu_torch.index.convert import (
    dp_tp_index_from_arrays, sharded_index_from_arrays,
)
from stringsearchlib_tpu_torch.parallel.dp_tp import (
    DpTpEngine, make_mesh_2d, shard_index_2d,
)
from stringsearchlib_tpu_torch.search.engine import SearchEngine


def _corpus(n, seed=13):
    rng = random.Random(seed)
    syll = ["ka", "lo", "me", "ri", "su", "ta", "ve", "nor", "bel", "qu"]
    return [
        "".join(rng.choice(syll) for _ in range(rng.randint(1, 6)))
        for _ in range(n)
    ]


def _norm(res):
    return sorted((round(float(s), 5), len(k)) for k, s in zip(*res))


def _queries(words):
    rng = random.Random(5)
    queries = []
    for i in range(40):
        w = words[rng.randrange(len(words))]
        if i % 5 == 0:
            queries.append(w)  # exact -> promotion to 100
        elif i % 5 == 1:
            queries.append(w[:2])  # brute-short tier
        else:
            j = rng.randrange(max(len(w) - 1, 1))
            queries.append(w[:j] + "x" + w[j + 1 :])
    return queries + ["*", "", "!!!@@@##"]


@pytest.fixture(scope="module")
def setup():
    words = _corpus(3000)
    w = np.ones(len(words))
    w[::7] = 0.5  # weighted edges exercise the wmax/propagation path
    host = build_index(words, 1, w, IndexConfig(), device="cpu")
    jhost = jbuild(words, 1, w, JConfig(), to_device=False)
    return words, host, jhost, SearchEngine(host)


@pytest.mark.parametrize("st,sg", [(4, 2), (2, 4)])
def test_dp_tp_parity(setup, st, sg):
    words, host, jhost, ref = setup
    eng = DpTpEngine(shard_index_2d(host, st, sg), make_mesh_2d(st, sg, device="cpu"))
    jeng = jdp_tp.DpTpEngine(jdp_tp.shard_index_2d(jhost, st, sg),
                             jdp_tp.make_mesh_2d(st, sg))
    queries = _queries(words)
    got = eng.search_batch(queries, 0.25, 10)
    want = ref.search_batch(queries, 0.25, 10, mode="dense")
    jgot = jeng.search_batch(queries, 0.25, 10)
    for q, g, w_, jg in zip(queries, got, want, jgot):
        assert _norm(g) == _norm(w_), (q, g, w_)
        assert g == (list(jg[0]), list(jg[1])), q


def test_dp_tp_postings_split_covers_everything(setup):
    _, host, jhost, _ = setup
    dx = shard_index_2d(host, 2, 4)
    # every (term shard, gram) posting count must be preserved by the split
    ptr = dx.sx.leaves["gram_ptr"].astype(np.int64)
    lens_1d = np.diff(ptr, axis=1)  # (St, G)
    assert dx.lens3.sum(axis=1).astype(np.int64).tolist() == \
        lens_1d.astype(np.int64).tolist()
    # slice CSR offsets are consistent with slice contents
    st, sg, _ = dx.gram_ptr2.shape
    for i in range(st):
        for j in range(sg):
            total = int(dx.gram_ptr2[i, j, -1])
            assert total <= dx.gram_terms2.shape[2]
    # and the split equals the reference's bit for bit
    jdx = jdp_tp.shard_index_2d(jhost, 2, 4)
    assert (dx.sg, dx.g_c) == (jdx.sg, jdx.g_c)
    for name in ("gram_ptr2", "gram_terms2", "lens3"):
        assert getattr(dx, name).dtype == getattr(jdx, name).dtype, name
        assert np.array_equal(getattr(dx, name), getattr(jdx, name)), name


def test_dp_tp_index_from_arrays(setup):
    words, host, jhost, _ = setup
    jdx = jdp_tp.shard_index_2d(jhost, 2, 2)
    jsx = jdx.sx
    sx = sharded_index_from_arrays(
        host, jsx.leaves, dict(n_shards=2, ts_c=jsx.ts_c, tl_c=jsx.tl_c),
        jsx.host_shard_posting_lens,
    )
    dx = dp_tp_index_from_arrays(
        sx, dict(gram_ptr2=jdx.gram_ptr2, gram_terms2=jdx.gram_terms2, lens3=jdx.lens3),
        dict(sg=jdx.sg, g_c=jdx.g_c),
    )
    own = DpTpEngine(shard_index_2d(host, 2, 2), make_mesh_2d(2, 2, device="cpu"))
    eng = DpTpEngine(dx, make_mesh_2d(2, 2, device="cpu"))
    queries = _queries(words)[:12]
    assert eng.search_batch(queries, 0.25, 10) == own.search_batch(queries, 0.25, 10)
    with pytest.raises(KeyError):
        dp_tp_index_from_arrays(sx, {"gram_ptr2": jdx.gram_ptr2}, dict(sg=2, g_c=1))


def test_make_mesh_2d_defaults_to_the_card():
    m = make_mesh_2d(2, 3, device="cpu")
    assert m.shape == (2, 3) and len(m.devices) == 6
    assert list(m.shard_ids) == [0, 1] and len(m.row_devices) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh_2d(1, 2)
