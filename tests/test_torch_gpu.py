"""Tests of the PyTorch port that need a CUDA card: the hand-written K1, K2
and row-gather kernels against their plain versions, and the index build
and the search (bitmap-kernel, gathered-row, weighted-bitmap and sketch
routes) on the card against the same on the CPU.  They import no jax, so on a machine
with a card and no jax they run with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

and skip (with a reason) where no card is present."""

import random

import numpy as np
import pytest
import torch

from stringsearchlib_tpu_torch.config import IndexConfig
from stringsearchlib_tpu_torch.index.arrays import FIELDS
from stringsearchlib_tpu_torch.index.build import build_index
from stringsearchlib_tpu_torch.ops import bitmap_matmul as pbm
from stringsearchlib_tpu_torch.search.engine import SearchEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU form)")
    return torch.device("cuda")


def _corpus(n, seed=21):
    rng = random.Random(seed)
    syll = ["ka", "lo", "me", "ri", "su", "ta", "ve", "nor", "bel"]
    return [
        "".join(rng.choice(syll) for _ in range(rng.randint(2, 5)))
        for _ in range(n)
    ]


def _qcnt(rng, b, gp, n_cols, total):
    q = np.zeros((b, gp), np.int32)
    for r in range(b):
        cols = rng.choice(gp, size=n_cols, replace=False)
        cuts = np.sort(rng.choice(np.arange(1, total), n_cols - 1, replace=False))
        q[r, cols] = np.diff(np.concatenate([[0], cuts, [total]]))
    return torch.from_numpy(q)


@pytest.mark.parametrize("gp", [128, 2816])
def test_cuda_kernel_matches_plain_version(cuda, gp):
    rng = np.random.default_rng(gp)
    planes = torch.from_numpy(
        rng.integers(0, 256, size=(5, gp, pbm.BLKB), dtype=np.uint8).view(np.int8)
    ).to(cuda)
    for total in (31, 127):
        q = _qcnt(rng, 64, gp, 16, total).to(cuda)
        launches = pbm.K1_LAUNCHES
        hits, bmax = pbm.bitmap_hits_bmax(q, planes)
        rh, rb = pbm.bitmap_hits_bmax_ref(q, planes)
        torch.cuda.synchronize()
        assert pbm.K1_LAUNCHES == launches + 1
        assert torch.equal(hits, rh) and torch.equal(bmax, rb)


def test_build_on_cuda_matches_cpu(cuda):
    words = _corpus(3000, seed=7)
    on_cpu = build_index(words, 1, None, IndexConfig(), device="cpu")
    on_gpu = build_index(
        words, 1, None, IndexConfig(), device=cuda, device_postings=True
    )
    back = on_gpu.device.to("cpu")
    for f in FIELDS:
        assert torch.equal(getattr(on_cpu.device, f), getattr(back, f)), f
    assert torch.equal(on_cpu.bitmap_tables()[0], on_gpu.bitmap_tables()[0].cpu())


@pytest.mark.parametrize("kb", [(4, 8), (1, 1)])
def test_search_on_cuda_matches_cpu(cuda, kb):
    words = _corpus(3000, seed=31)
    engines = []
    for dev in ("cpu", cuda):
        eng = SearchEngine(build_index(words, 1, None, IndexConfig(), device=dev))
        eng.CAND_MIN_TERMS = 100
        eng.HSTAR_KB1, eng.HSTAR_KB2 = kb
        engines.append(eng)
    rng = random.Random(5)
    queries = [
        w[:-1] + "x" if i % 2 else w
        for i, w in enumerate(rng.choice(words) for _ in range(40))
    ] + ["ka", "*", "", "!!!"]
    launches = pbm.K1_LAUNCHES
    got = engines[1].search_batch(queries, 0.25, 10, mode="candidates")
    assert pbm.K1_LAUNCHES > launches
    assert engines[1].last_routing["variant"] == "bitmap_kernel"
    want = engines[0].search_batch(queries, 0.25, 10, mode="candidates")
    dense = engines[1].search_batch(queries, 0.25, 10, mode="dense")
    assert got == want
    for g, d in zip(got, dense):
        assert sorted(zip(g[1], g[0])) == sorted(zip(d[1], d[0]))
    for q in queries[:4]:
        assert engines[1].search(q, 0.3, 20) == engines[0].search(q, 0.3, 20)


@pytest.mark.parametrize("gp,ntiles", [(128, 5), (8192, 3)])
def test_cuda_k2_matches_plain_version(cuda, gp, ntiles):
    rng = np.random.default_rng(gp + 1)
    planes = torch.from_numpy(
        rng.integers(0, 256, size=(ntiles, gp, pbm.BLKB), dtype=np.uint8).view(np.int8)
    ).to(cuda)
    for total in (31, 127):
        q = _qcnt(rng, 96, gp, 24, total).to(cuda)
        launches = (pbm.K2_LAUNCHES, pbm.K1_LAUNCHES)
        hits = pbm.bitmap_hits(q, planes)
        want = pbm.bitmap_hits_ref(q, planes)
        torch.cuda.synchronize()
        assert (pbm.K2_LAUNCHES, pbm.K1_LAUNCHES) == (launches[0] + 1, launches[1])
        assert torch.equal(hits, want)
        assert torch.equal(hits, pbm.bitmap_hits_bmax(q, planes)[0])


def test_sketch_route_on_cuda_matches_cpu(cuda):
    rng = random.Random(9)
    words, weights = [], []
    for w in _corpus(2400, seed=17):
        words += [w, w[::-1] + rng.choice(["ka", "lo", "nor"])]
        weights += [1.0, 0.4]
    engines = []
    for dev in ("cpu", cuda):
        host = build_index(words, 2, weights, IndexConfig(), device=dev)
        eng = SearchEngine(host)
        eng.BITMAP_BUDGET = eng.SKETCH_MIN_TERMS = eng.CAND_MIN_TERMS = 0
        engines.append(eng)
    queries = [w[:-1] + "x" for w in rng.sample(words, 40)]
    launches = pbm.K2_LAUNCHES
    got = engines[1].search_batch(queries, 0.3, 10, mode="candidates")
    assert pbm.K2_LAUNCHES > launches
    assert engines[1].last_routing["variant"] == "sketch_packed"
    assert got == engines[0].search_batch(queries, 0.3, 10, mode="candidates")
    dense = engines[1].search_batch(queries, 0.3, 10, mode="dense")
    for g, d in zip(got, dense):
        assert sorted(zip(g[1], g[0])) == sorted(zip(d[1], d[0]))
    for a, b in zip(engines[0].host.sketch_tables(), engines[1].host.sketch_tables()):
        assert a == b if isinstance(a, int) else torch.equal(a, b.cpu())


@pytest.mark.parametrize("layout", ["row_major_1024", "row_major_128", "tile_major"])
def test_cuda_gather_matches_plain_version(cuda, layout):
    rng = np.random.default_rng(len(layout))
    shape = {"row_major_1024": (300, 3 * 1024), "row_major_128": (300, 5 * 128),
             "tile_major": (7, 2816, pbm.BLKB)}[layout]
    table = torch.from_numpy(
        rng.integers(0, 256, size=shape, dtype=np.uint8).view(np.int8)
    ).to(cuda)
    g = shape[-2]
    for gc in (32, 128, 512):
        rows = np.zeros(gc, np.int32)
        rows[: gc // 2] = rng.choice(g, gc // 2)  # duplicates, then padding
        rows_d = torch.from_numpy(rows).to(cuda)
        launches = pbm.G_LAUNCHES
        got = pbm.gather_rows(table, rows_d)
        want = pbm.gather_rows_ref(table, rows_d)
        if layout == "row_major_1024":
            assert torch.equal(pbm.gather_rows_dma(table, rows_d), want)
        if layout.startswith("row_major"):
            assert torch.equal(pbm.gather_rows_pallas(table, rows_d), want)
        torch.cuda.synchronize()
        assert pbm.G_LAUNCHES > launches
        assert torch.equal(got, want)
    with pytest.raises(IndexError):  # checked before the kernel reads them
        pbm.gather_rows(table, torch.tensor([0, g], dtype=torch.int32, device=cuda))


def _weighted_corpus(n=3000, seed=41):
    words = _corpus(n, seed=seed)
    weights = np.ones(n)
    weights[::5] = 0.4
    weights[::11] = 0.0
    return words, weights


@pytest.mark.parametrize("case", ["weighted_kernel", "gather_uniform", "gather_weighted"])
def test_bitmap_routes_on_cuda_match_cpu(cuda, case):
    if case == "gather_uniform":
        words, weights = _corpus(3000, seed=43), None
    else:
        words, weights = _weighted_corpus()
    engines = []
    for dev in ("cpu", cuda):
        eng = SearchEngine(build_index(words, 1, weights, IndexConfig(), device=dev))
        eng.CAND_MIN_TERMS = 100
        eng.BITMAP_GATHER_TMAJ = case != "weighted_kernel"
        if case == "gather_uniform":
            eng.HSTAR_KB1, eng.HSTAR_KB2 = 4, 8
        engines.append(eng)
    rng = random.Random(11)
    n = 24 if case == "weighted_kernel" else 8
    queries = [w[:-1] + "x" if i % 2 else w
               for i, w in enumerate(rng.choice(words) for _ in range(n))]
    counts = (pbm.K1_LAUNCHES, pbm.K2_LAUNCHES, pbm.G_LAUNCHES)
    refs = (pbm.K1_REF_CALLS, pbm.K2_REF_CALLS, pbm.G_REF_CALLS)
    got = engines[1].search_batch(queries, 0.25, 10, mode="candidates")
    rt = engines[1].last_routing
    assert (pbm.K1_REF_CALLS, pbm.K2_REF_CALLS, pbm.G_REF_CALLS) == refs
    if case == "weighted_kernel":
        assert rt["variant"] == "bitmap_kernel" and rt["hstar"] is False
        assert pbm.K2_LAUNCHES > counts[1]
    else:
        assert rt["variant"] == "bitmap_gather" and rt["gather_rows"] >= 32
        assert rt["hstar"] is (case == "gather_uniform")
        assert pbm.G_LAUNCHES > counts[2] and pbm.K1_LAUNCHES > counts[0]
    assert got == engines[0].search_batch(queries, 0.25, 10, mode="candidates")
    dense = engines[1].search_batch(queries, 0.25, 10, mode="dense")
    for g, d in zip(got, dense):
        assert sorted(zip(g[1], g[0])) == sorted(zip(d[1], d[0]))
