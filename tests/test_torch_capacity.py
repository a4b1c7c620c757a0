"""100M-key capacity plan on the H100 (utils.capacity, the reference's
byte model) and the sharded machinery at 100M SHAPE on the CPU: the
reference's tests/test_capacity.py mirrored for the PyTorch port.

The reference pins 8 term shards on a 16 GB v5e.  On one NVIDIA H100
80GB HBM3 (``H100_HBM_BYTES``) the same byte model puts the whole 100M-key
plan on one card: 1 term shard."""

import random

import numpy as np
import pytest

from stringsearchlib_tpu.utils import capacity as jcap
from stringsearchlib_tpu_torch.utils.capacity import (
    H100_HBM_BYTES, ShardPlan, estimate_shard_hbm,
)

# the fewest term shards whose 100M plan fits one H100 (worked out from
# the byte model; the reference's v5e plan needs 8)
H100_SHARDS_100M = 1


@pytest.mark.parametrize("shards", [1, 2, 8, 13])
def test_byte_model_matches_reference(shards):
    got = estimate_shard_hbm(100_000_000, shards=shards)
    want = jcap.estimate_shard_hbm(100_000_000, shards=shards)
    assert got == ShardPlan(**{f: getattr(want, f) for f in ShardPlan.__dataclass_fields__})
    assert got.breakdown() == want.breakdown()


def test_100m_plan_fits_an_h100():
    plans = [estimate_shard_hbm(100_000_000, shards=s) for s in range(1, 9)]
    need = next(s for s, p in enumerate(plans, 1) if p.total <= H100_HBM_BYTES)
    assert need == H100_SHARDS_100M
    one = plans[0]
    assert one.total <= H100_HBM_BYTES  # the planned deployment fits
    # the v5e's 8-shard plan, and its headroom, hold on the H100 too
    eight = plans[7]
    assert eight.total <= jcap.V5E_HBM_BYTES < H100_HBM_BYTES
    assert eight.total <= 10 << 30
    # the bitmap table dominates residency at every shard count
    for p in plans:
        assert p.bitmap > p.resident * 0.5
    # the H100 holds ~5x a v5e: a plan that needs 8 shards there needs 1-2 here
    assert H100_HBM_BYTES > 4 * jcap.V5E_HBM_BYTES


def test_100m_shape_sharded_parity():
    """Downscaled-but-100M-SHAPED run: 8 strided term shards over
    ``make_mesh(8, device="cpu")``, gram-dense corpus, candidate path +
    merge, parity with the port's single engine and the JAX package's
    sharded engine on its virtual mesh."""
    import bench
    from stringsearchlib_tpu.config import IndexConfig as JConfig
    from stringsearchlib_tpu.index.build import build_index as jbuild
    from stringsearchlib_tpu.parallel import dist as jdist
    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index.build import build_index
    from stringsearchlib_tpu_torch.parallel.dist import (
        ShardedEngine, make_mesh, shard_index,
    )
    from stringsearchlib_tpu_torch.search.engine import SearchEngine

    words = bench._product_names(20_000)
    host = build_index(words, 1, None, IndexConfig(), device="cpu")
    sx = shard_index(host, 8)
    # shard posting mass balanced within 5% (strided long tier)
    mass = sx.host_shard_posting_lens.sum(axis=1).astype(np.float64)
    assert mass.max() <= mass.mean() * 1.05
    eng = ShardedEngine(sx, make_mesh(8, device="cpu"))
    ref = SearchEngine(host)
    jhost = jbuild(words, 1, None, JConfig(), to_device=False)
    jeng = jdist.ShardedEngine(jdist.shard_index(jhost, 8), jdist.make_mesh(8))
    rng = random.Random(3)
    queries = [bench._mutate(rng, rng.choice(words)) for _ in range(32)]
    got = eng.search_batch(queries, 0.3, 100)
    assert eng.last_routing["variant"] == "matmul"
    want = ref.search_batch(queries, 0.3, 100)
    jgot = jeng.search_batch(queries, 0.3, 100)
    for q, g, w, jg in zip(queries, got, want, jgot):
        gs = sorted((round(float(s), 5), len(k)) for k, s in zip(*g))
        ws = sorted((round(float(s), 5), len(k)) for k, s in zip(*w))
        assert gs == ws, q
        assert g == (list(jg[0]), list(jg[1])), q
