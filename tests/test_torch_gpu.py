"""Tests of the PyTorch port that need a CUDA card: the hand-written K1
kernel against its plain version, and the index build and the search on
the card against the same on the CPU.  They import no jax, so on a machine
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
        pytest.skip("needs a CUDA device (the K1 kernel has no CPU form)")
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
        launches = pbm.KERNEL_LAUNCHES
        hits, bmax = pbm.bitmap_hits_bmax(q, planes)
        rh, rb = pbm.bitmap_hits_bmax_ref(q, planes)
        torch.cuda.synchronize()
        assert pbm.KERNEL_LAUNCHES == launches + 1
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
    launches = pbm.KERNEL_LAUNCHES
    got = engines[1].search_batch(queries, 0.25, 10, mode="candidates")
    assert pbm.KERNEL_LAUNCHES > launches
    assert engines[1].last_routing["variant"] == "bitmap_kernel"
    want = engines[0].search_batch(queries, 0.25, 10, mode="candidates")
    dense = engines[1].search_batch(queries, 0.25, 10, mode="dense")
    assert got == want
    for g, d in zip(got, dense):
        assert sorted(zip(g[1], g[0])) == sorted(zip(d[1], d[0]))
    for q in queries[:4]:
        assert engines[1].search(q, 0.3, 20) == engines[0].search(q, 0.3, 20)
