"""Tests of the PyTorch port that need a CUDA card: the hand-written K1, K2
(both table layouts), K2w, row-gather, edit-distance (K5), table-gather
(K6), postings-expansion and K1-probe (P1-P9) kernels against their plain
versions, and the index build and the search (bitmap-kernel, bitmap-scan,
gathered-row, weighted-bitmap, packed and unpacked sketch, gram-matrix and
sorted-runs routes) on the card against the same on the CPU; ``torch._int_mm`` of the
unpacked sketch against the CPU product; save/load and the C ABI on the
card.  They import no jax, so on a machine
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
from stringsearchlib_tpu_torch.ops import dp_match as pdp
from stringsearchlib_tpu_torch.ops import vgather as pvg
from stringsearchlib_tpu_torch.search import candidates as pc
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


def _count_case(rng, case, gp):
    """(B, gp) multiplicities at the edges of the kernel's bit-sliced
    counters: random rows summing to 31 / 127; multiplicities of 2 and more
    summing to exactly 127; 127 distinct rows of multiplicity 1; B = 1;
    B = 33 (a ragged last group of 32 queries)."""
    if case in ("sum31", "sum127"):
        return _qcnt(rng, 64, gp, min(16, gp), 31 if case == "sum31" else 127)
    if case == "mults_127":
        q = np.zeros((40, gp), np.int32)
        for r in range(40):
            k = int(rng.integers(2, min(gp, 20) + 1))
            extra = np.bincount(rng.integers(0, k, 127 - 2 * k), minlength=k)
            q[r, rng.choice(gp, size=k, replace=False)] = 2 + extra
        return torch.from_numpy(q)
    if case == "ones_127":
        q = np.zeros((16, gp), np.int32)
        for r in range(16):
            q[r, rng.choice(gp, size=127, replace=False)] = 1
        return torch.from_numpy(q)
    return _qcnt(rng, 1 if case == "b1" else 33, gp, min(24, gp), 127 if case == "b1" else 31)


_CASES = ["sum31", "sum127", "mults_127", "ones_127", "b1", "b33"]


@pytest.mark.parametrize("gp,case", [(gp, c) for gp in (32, 128, 2816) for c in _CASES
                                     if gp >= 128 or c != "ones_127"])
def test_cuda_kernel_matches_plain_version(cuda, gp, case):
    rng = np.random.default_rng(gp + len(case))
    planes = torch.from_numpy(
        rng.integers(0, 256, size=(5, gp, pbm.BLKB), dtype=np.uint8).view(np.int8)
    ).to(cuda)
    q = _count_case(rng, case, gp).to(cuda)
    assert int(q.sum(1).max()) <= 127
    launches = pbm.K1_LAUNCHES
    hits, bmax = pbm.bitmap_hits_bmax(q, planes)
    rh, rb = pbm.bitmap_hits_bmax_ref(q, planes)
    torch.cuda.synchronize()
    assert pbm.K1_LAUNCHES == launches + 1
    assert torch.equal(hits, rh) and torch.equal(bmax, rb)


def test_cuda_kernels_every_bit_set(cuda):
    """A table with every bit set: every count is the query's sum, 127 at
    the contract's edge, through each way a row enters the counters."""
    planes = torch.full((2, 256, pbm.BLKB), -1, dtype=torch.int8, device=cuda)
    q = torch.zeros((4, 256), dtype=torch.int32)
    q[0, 7] = 127
    q[1, :127] = 1
    q[2, 100:104] = torch.tensor([100, 20, 4, 3])
    q[3, 3:12] = 1
    q = q.to(cuda)
    hits, bmax = pbm.bitmap_hits_bmax(q, planes)
    torch.cuda.synchronize()
    want = q.sum(1).to(torch.int8)[:, None]
    assert torch.equal(hits, want.expand_as(hits)) and torch.equal(bmax, want.expand_as(bmax))
    assert torch.equal(pbm.bitmap_hits(q, planes), hits)


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
        eng.GM_BUDGET = 0
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


@pytest.mark.parametrize("gp,ntiles,case", [(128, 5, "sum31"), (128, 5, "sum127"),
                                           (8192, 3, "sum31"), (8192, 3, "sum127"),
                                           (32, 2, "sum31"), (2816, 2, "mults_127"),
                                           (2816, 2, "ones_127"), (2816, 2, "b1"),
                                           (2816, 2, "b33")])
def test_cuda_k2_matches_plain_version(cuda, gp, ntiles, case):
    rng = np.random.default_rng(gp + 1 + len(case))
    planes = torch.from_numpy(
        rng.integers(0, 256, size=(ntiles, gp, pbm.BLKB), dtype=np.uint8).view(np.int8)
    ).to(cuda)
    q = _count_case(rng, case, gp).to(cuda)
    launches = (pbm.K2_LAUNCHES, pbm.K1_LAUNCHES)
    hits = pbm.bitmap_hits(q, planes)
    want = pbm.bitmap_hits_ref(q, planes)
    torch.cuda.synchronize()
    assert (pbm.K2_LAUNCHES, pbm.K1_LAUNCHES) == (launches[0] + 1, launches[1])
    assert torch.equal(hits, want)
    assert torch.equal(hits, pbm.bitmap_hits_bmax(q, planes)[0])


def test_cuda_k2_sketch_bucket_collisions(cuda):
    """Gp = 8192 bucket counts as the sketch builds them: gram slots that
    hash to one bucket and repeated grams give multiplicities above 1."""
    from stringsearchlib_tpu_torch.search.sketch import bucket_of

    rng = np.random.default_rng(8192)
    pool = torch.arange(200_000, dtype=torch.int32)
    bk = bucket_of(pool, 13)
    order = torch.argsort(bk, stable=True)
    sbk, spool = bk[order], pool[order]
    shared = torch.nonzero(sbk[1:] == sbk[:-1]).flatten() + 1
    pick = shared[torch.from_numpy(rng.integers(0, shared.numel(), (64, 24)))]
    slots = torch.cat([spool[pick - 1], spool[pick],
                       torch.from_numpy(rng.integers(0, 200_000, (64, 40)).astype(np.int32))], 1)
    slots[:, 80:] = slots[:, :8]
    q = pc.query_counts(bucket_of(slots, 13), 1 << 13)
    assert int((q > 1).sum(1).min()) > 0 and int(q.sum(1).max()) <= 127
    planes = torch.from_numpy(
        rng.integers(0, 256, size=(2, 8192, pbm.BLKB), dtype=np.uint8).view(np.int8))
    want = pbm.bitmap_hits_ref(q, planes)
    got = pbm.bitmap_hits(q.to(cuda), planes.to(cuda))
    assert torch.equal(got.cpu(), want)


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
        eng.GM_BUDGET = eng.BITMAP_BUDGET = 0
        eng.SKETCH_MIN_TERMS = eng.CAND_MIN_TERMS = 0
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
        eng.GM_BUDGET = 0
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


def _dp_case(rng, n, w, b, qp, wide):
    """Random terms (lengths 0..W, a few over-long and negative ones) over a
    small alphabet so matches happen, and queries with qlen 0, 1 and Qp."""
    alpha = 6 if not wide else 40000
    lo = 1 if not wide else 0x4E00
    tokens = rng.integers(lo, lo + alpha, size=(n, w))
    lengths = rng.integers(0, w + 1, size=n)
    lengths[:3] = [0, w, w + 5][: min(n, 3)]
    tokens[np.arange(w)[None, :] >= lengths[:, None]] = 0
    lengths[3:4] = -1
    qtok = rng.integers(lo, lo + alpha, size=(b, qp))
    qlens = rng.integers(0, qp + 1, size=b)
    qlens[: min(b, 3)] = [0, 1, qp][: min(b, 3)]
    qtok[np.arange(qp)[None, :] >= qlens[:, None]] = 0
    dt = np.int32 if wide else np.uint8
    return (torch.from_numpy(tokens.astype(dt)), torch.from_numpy(lengths.astype(np.int32)),
            torch.from_numpy(qtok.astype(np.int32)), torch.from_numpy(qlens.astype(np.int32)))


@pytest.mark.parametrize("n,w,b,qp,wide", [
    (3000, 8, 64, 16, False),     # short tier, 8-byte rows
    (2000, 40, 16, 16, False),    # 40-byte rows: 4-byte loads
    (1500, 100, 8, 80, True),     # wide tokens, three words per query
    (700, 200, 4, 130, False),    # five words per query
    (2000, 16, 8, 128, False),    # long queries over a short tier
    (1, 5, 1, 1, False),
    (3000, 32, 1, 8, False),      # chunks of one query: one word
    (1500, 100, 1, 40, True),     # two words, wide tokens
    (700, 200, 1, 130, False),    # the 8-word instance
])
def test_cuda_dp_match_matches_plain_version(cuda, n, w, b, qp, wide):
    args = _dp_case(np.random.default_rng(n + w), n, w, b, qp, wide)
    launches = pdp.K5_LAUNCHES
    got = pdp.dp_match(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert pdp.K5_LAUNCHES == launches + 1
    assert torch.equal(got.cpu(), pdp.dp_match_ref(*args))


@pytest.mark.parametrize("qp,m,wide", [
    (33, (32, 33), False),     # one word / two words
    (65, (64, 65), False),     # two words / three, in the 4-word instance
    (129, (128, 129), False),  # four words / five, in the 8-word instance
    (257, (256, 257), False),  # eight words / the scratch kernel
    (65, (32, 33, 64, 65), True),
])
def test_cuda_dp_match_word_boundaries(cuda, qp, m, wide):
    """Queries on both sides of each word-count boundary against W = 200
    terms (a few over-long, one of negative length), uint8 and int32."""
    args = list(_dp_case(np.random.default_rng(qp + wide), 600, 200, 12, qp, wide))
    rng = np.random.default_rng(qp)
    qlens = args[3].numpy().copy()
    qlens[3:3 + len(m)] = m
    qlens[-1] = qp + 4  # qlen past Qp counts Qp characters
    qtok = args[2].numpy().copy()
    lo = 0x4E00 if wide else 1
    for i in range(3, 3 + len(m)):
        qtok[i, : m[i - 3]] = rng.integers(lo, lo + 6, size=m[i - 3])
    args[2], args[3] = torch.from_numpy(qtok), torch.from_numpy(qlens)
    launches = pdp.K5_LAUNCHES
    got = pdp.dp_match(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert pdp.K5_LAUNCHES == launches + 1
    assert torch.equal(got.cpu(), pdp.dp_match_ref(*args))


def test_cuda_dp_match_contracts(cuda):
    args = [a.to(cuda) for a in _dp_case(np.random.default_rng(3), 40, 8, 4, 8, False)]
    assert pdp.dp_match(args[0][:0], args[1][:0], args[2], args[3]).shape == (4, 0)
    with pytest.raises(TypeError):
        pdp.dp_match(args[0].long(), *args[1:])
    with pytest.raises(ValueError):
        pdp.dp_match(args[0], args[1][:5], args[2], args[3])


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_tables", [1, 3])
def test_cuda_gather_tables_matches_plain_version(cuda, idx_dtype, n_tables):
    rng = np.random.default_rng(n_tables)
    t_len = 100_003
    tables = [torch.from_numpy(rng.integers(-2**31, 2**31 - 1, t_len, dtype=np.int64)
                               .astype(np.int32))]
    tables += [torch.from_numpy(rng.standard_normal(t_len).astype(np.float32))
               for _ in range(n_tables - 1)]
    fills = [7, -1.5, float("inf")][:n_tables]
    for shape in ((8, 4099), (3, 1), (257, 64)):
        idx = rng.integers(-50, t_len + 50, size=shape)
        idx[0, :: 2] = np.sort(idx[0, :: 2])
        idx = torch.from_numpy(idx).to(idx_dtype)
        launches = pvg.K6_LAUNCHES
        got = pvg.gather_tables(idx.to(cuda), [t.to(cuda) for t in tables], fills)
        torch.cuda.synchronize()
        assert pvg.K6_LAUNCHES == launches + 1
        want = pvg.gather_tables_ref(idx, tables, fills)
        for g, wnt in zip(got, want):
            assert g.dtype == wnt.dtype and torch.equal(g.cpu(), wnt)


def _bits32(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_tables", [1, 4])
def test_cuda_gather_tables_passes_match_plain_version(cuda, idx_dtype, n_tables):
    """The one pass on T = 10,000: indices -1 and >= T, sorted and unsorted
    rows, ragged tails (B * C not a multiple of 4, each table's output
    still 16-byte aligned), rows of 1.5 and 3 chunks (the row block order),
    fills NaN, -0.0 and int32 min; every output bit equal to the plain
    version's, and the outputs views of one allocation."""
    from stringsearchlib_tpu_torch.ops import vgather as k6

    rng = np.random.default_rng(n_tables * 10 + idx_dtype.itemsize)
    t_len = 10_000
    tables = [torch.from_numpy(rng.integers(-2**31, 2**31 - 1, t_len, dtype=np.int64)
                               .astype(np.int32))]
    tables += [torch.from_numpy(rng.standard_normal(t_len).astype(np.float32))
               for _ in range(n_tables - 1)]
    fills = [-(1 << 31), float("nan"), -0.0, 7.5][:n_tables]
    for shape in ((7, 4099), (3, 1), (64, 256), (5, 1536)):
        idx = rng.integers(-50, t_len + 50, size=shape)
        idx[0] = np.sort(idx[0])
        idx[-1, -3:] = [-1, t_len, t_len - 1][-shape[1]:]
        idx = torch.from_numpy(idx).to(idx_dtype)
        tc = [t.to(cuda) for t in tables]
        launches = k6.K6_LAUNCHES
        got = k6.gather_tables(idx.to(cuda), tc, fills)
        torch.cuda.synchronize()
        assert k6.K6_LAUNCHES == launches + 1
        want = k6.gather_tables_ref(idx, tables, fills)
        base = got[0].untyped_storage().data_ptr()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.untyped_storage().data_ptr() == base and g.data_ptr() % 16 == 0
            assert torch.equal(_bits32(g.cpu()), _bits32(w))


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("order", ["sorted_rows", "unsorted"])
def test_cuda_gather_tables_over_the_l2(cuda, idx_dtype, order):
    """Two tables of 8M words (64 MB, over an H100's L2) at 4M indices: the
    one pass in its row order and in the chunks' order, each equal to the
    plain version."""
    from stringsearchlib_tpu_torch.ops import vgather as k6

    gen = torch.Generator(device=cuda).manual_seed(11)
    t_len = 8 << 20
    tables = [torch.randint(-2**31, 2**31 - 1, (t_len,), generator=gen, device=cuda,
                            dtype=torch.int32),
              torch.randn(t_len, generator=gen, device=cuda)]
    idx = torch.randint(-100, t_len + 100, (64, 1 << 16), generator=gen, device=cuda)
    if order == "sorted_rows":
        idx = idx.sort(dim=1).values
    idx = idx.to(idx_dtype).contiguous()
    fills = [-3, float("nan")]
    assert k6._grid_rows(idx.shape, idx.element_size()) == (64, 1 << 16)
    want = k6.gather_tables_ref(idx, tables, fills)
    for got in (k6.gather_tables(idx, tables, fills),
                k6.gather_tables(idx.reshape(1, -1), tables, fills)):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(_bits32(g).view(-1), _bits32(w).view(-1))


def test_cuda_gather_tables_empty_table_and_no_indices(cuda):
    from stringsearchlib_tpu_torch.ops import vgather as k6

    idx = torch.tensor([[0, -1, 5], [2, 1, 0]], dtype=torch.int64, device=cuda)
    tabs = [torch.zeros(0, dtype=torch.float32, device=cuda),
            torch.zeros(0, dtype=torch.int32, device=cuda)]
    got = k6.gather_tables(idx, tabs, [float("nan"), -(1 << 31)])
    torch.cuda.synchronize()
    assert torch.equal(_bits32(got[0].cpu()),
                       torch.full((2, 3), 0x7FC00000, dtype=torch.int32))
    assert torch.equal(got[1].cpu(), torch.full((2, 3), -(1 << 31), dtype=torch.int32))
    launches = k6.K6_LAUNCHES
    out = k6.gather_tables(idx[:0], tabs, [0.0, 0])
    assert [o.shape for o in out] == [(0, 3), (0, 3)] and k6.K6_LAUNCHES == launches


def _expand_case(rng, b, qmax, s_cap, kind):
    """A random CSR and (b, qmax) slots of one kind: ``mixed`` (absent slots,
    zero-length runs, repeated grams), ``long_runs`` (runs of up to 40k
    postings crossing the kernel's 1,024-lane tiles), ``padding`` (all but
    the first rows without a present slot); s_cap None: the largest row's
    posting mass, so that row fills every lane."""
    g = 64 if kind == "long_runs" else 5000
    lens = rng.integers(0, 40_000 if kind == "long_runs" else 60, g)
    lens[::9] = 0
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    terms = rng.integers(-2**31, 2**31 - 1, int(ptr[-1]), dtype=np.int64).astype(np.int32)
    slots = rng.integers(-1, g, (b, qmax)).astype(np.int32)
    slots[:, ::7] = -1
    if qmax > 3:
        slots[0, 1:4] = slots[-1, 0]  # a repeated gram
    if kind == "padding":
        slots[2:] = -1
    if s_cap is None:
        sc = np.maximum(slots, 0)
        s_cap = int(np.where(slots >= 0, lens[sc], 0).sum(1).max())
    return [torch.from_numpy(x) for x in (ptr, terms, slots)] + [s_cap]


@pytest.mark.parametrize("b,qmax,s_cap,kind", [
    (1, 1, 128, "mixed"),
    (16, 127, 4096, "mixed"),
    (16, 128, 4097, "padding"),       # s_cap % 4 != 0: scalar stores
    (256, 30, 1024, "mixed"),         # the wide g3 route's shape
    (256, 300, 8192, "padding"),      # two scan chunks
    (16, 300, None, "mixed"),         # posting mass == s_cap
    (1, 1100, 1 << 17, "mixed"),      # five scan chunks
    (8, 14, 1 << 20, "long_runs"),    # the tiny-runs width
    (16, 254, None, "long_runs"),     # mass == s_cap, runs across tiles
    (4, 6, 5000, "long_runs"),        # mass past s_cap: cut
])
def test_cuda_expand_postings_matches_plain_version(cuda, b, qmax, s_cap, kind):
    rng = np.random.default_rng(b * 7 + qmax)
    ptr, terms, slots, s_cap = _expand_case(rng, b, qmax, s_cap, kind)
    args = [t.to(cuda) for t in (ptr, terms, slots)]
    counts = (pvg.K6_LAUNCHES, pvg.EXPAND_LAUNCHES, pvg.K6_REF_CALLS)
    got = pvg.expand_postings(*args, s_cap, -7)
    torch.cuda.synchronize()
    assert (pvg.K6_LAUNCHES, pvg.EXPAND_LAUNCHES, pvg.K6_REF_CALLS) == (
        counts[0] + 1, counts[1] + 1, counts[2])
    want = pvg.expand_postings_ref(*args, s_cap, -7)
    assert got.dtype == torch.int32 and got.shape == (b, s_cap)
    assert torch.equal(got, want)


def test_cuda_expand_postings_contracts(cuda):
    ptr, terms, slots, _ = _expand_case(np.random.default_rng(2), 4, 8, 64, "mixed")
    ptr, terms, slots = ptr.to(cuda), terms.to(cuda), slots.to(cuda)
    with pytest.raises(ValueError):
        pvg.expand_postings(ptr, terms, slots[:, ::2], 64, 0)
    with pytest.raises(ValueError):
        pvg.expand_postings(ptr.cpu(), terms, slots, 64, 0)
    launches = pvg.EXPAND_LAUNCHES
    assert pvg.expand_postings(ptr, terms, slots[:0], 64, 0).shape == (0, 64)
    assert pvg.EXPAND_LAUNCHES == launches
    empty = pvg.expand_postings(torch.zeros_like(ptr), terms[:0], slots, 100, 3)
    torch.cuda.synchronize()
    assert torch.equal(empty, torch.full((4, 100), 3, dtype=torch.int32, device=cuda))


def test_build_index_defaults_to_cuda(cuda):
    host = build_index(_corpus(500, seed=3), 1, None, IndexConfig())
    assert host.device.gram_terms.device.type == "cuda"


@pytest.mark.parametrize("route", ["matmul", "runs", "tiny_runs"])
def test_runs_and_matmul_routes_on_cuda_match_cpu(cuda, route):
    words, weights = _weighted_corpus(3000, seed=45)
    engines = []
    for dev in ("cpu", cuda):
        eng = SearchEngine(build_index(words, 1, weights, IndexConfig(), device=dev))
        eng.CAND_MIN_TERMS = 100
        if route != "matmul":
            eng.GM_BUDGET = eng.BITMAP_BUDGET = 0
            eng.SKETCH_MIN_TERMS = 10**9 if route == "runs" else 1
        engines.append(eng)
    rng = random.Random(13)
    n = 24 if route != "tiny_runs" else 6
    queries = [w[:-1] + "x" if i % 2 else w
               for i, w in enumerate(rng.choice(words) for _ in range(n))]
    counts = (pdp.K5_LAUNCHES, pvg.K6_LAUNCHES, pvg.EXPAND_LAUNCHES)
    refs = (pdp.K5_REF_CALLS, pvg.K6_REF_CALLS)
    got = engines[1].search_batch(queries, 0.25, 10, mode="candidates")
    assert engines[1].last_routing["variant"] == route
    assert (pdp.K5_REF_CALLS, pvg.K6_REF_CALLS) == refs
    assert pdp.K5_LAUNCHES > counts[0]
    if route != "matmul":
        assert pvg.K6_LAUNCHES > counts[1] and pvg.EXPAND_LAUNCHES > counts[2]
    assert got == engines[0].search_batch(queries, 0.25, 10, mode="candidates")
    dense = engines[1].search_batch(queries, 0.25, 10, mode="dense")
    for g, d in zip(got, dense):
        assert sorted(zip(g[1], g[0])) == sorted(zip(d[1], d[0]))


@pytest.mark.parametrize("qmax", [12, 200])
def test_gram_hits_on_cuda_match_cpu(cuda, qmax):
    """torch._int_mm over base-128 digits of the multiplicities (two
    products past 127) against the CPU's int32 product."""
    host = build_index(_corpus(2000, seed=19), 1, None, IndexConfig(), device="cpu")
    gm = host.gram_matrix()
    rng = np.random.default_rng(qmax)
    for b in (1, 17, 40):
        slots = torch.from_numpy(rng.integers(-1, host.n_grams, (b, qmax)).astype(np.int32))
        slots[0, :] = 5
        want = pc.gram_hits(slots, gm)
        got = pc.gram_hits(slots.to(cuda), gm.to(cuda))
        assert torch.equal(got.cpu(), want)


# -- K1 / K2 on row-major tables, and the K1 probes P1-P9 -------------------


@pytest.mark.parametrize("gp,case", [(128, "sum31"), (128, "sum127"), (2816, "mults_127"),
                                     (2816, "ones_127"), (32, "b33")])
def test_cuda_k1_k2_row_major_match_plain_version(cuda, gp, case):
    rng = np.random.default_rng(gp + 7 + len(case))
    planes = torch.from_numpy(
        rng.integers(0, 256, size=(gp, 5 * pbm.BLKB), dtype=np.uint8).view(np.int8)
    ).to(cuda)
    q = _count_case(rng, case, gp).to(cuda)
    launches = (pbm.K1_LAUNCHES, pbm.K2_LAUNCHES)
    hits, bmax = pbm.bitmap_hits_bmax(q, planes)
    k2 = pbm.bitmap_hits(q, planes)
    rh, rb = pbm.bitmap_hits_bmax_ref(q, planes)
    torch.cuda.synchronize()
    assert (pbm.K1_LAUNCHES, pbm.K2_LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    assert torch.equal(hits, rh) and torch.equal(bmax, rb) and torch.equal(k2, rh)
    assert torch.equal(hits, pbm.bitmap_hits(q, pbm.to_tile_major(planes)))


def _probe_table(rng, gp, ntiles, kind):
    """(gp, ntiles * 512) int8: random signed bytes, every bit set, or -128."""
    if kind == "random":
        t = rng.integers(-128, 128, size=(gp, ntiles * pbm.BLKB), dtype=np.int8)
    else:
        t = np.full((gp, ntiles * pbm.BLKB), -1 if kind == "ones" else -128, np.int8)
    return torch.from_numpy(t)


@pytest.mark.parametrize("gp", [37, 128, 2816])
@pytest.mark.parametrize("kind", ["random", "ones", "min"])
def test_cuda_stream_probes_match_plain_version(cuda, gp, kind):
    from stringsearchlib_tpu_torch.ops import probes

    rng = np.random.default_rng(gp + len(kind))
    t = _probe_table(rng, gp, 3, kind).to(cuda)
    t3 = pbm.to_tile_major(t)
    r = torch.from_numpy(rng.integers(-130, 10, size=(1, pbm.BLKB)).astype(np.int32)).to(cuda)
    before = dict(probes.LAUNCHES)
    got = [probes.pl_stream(t), probes.stream_row(t, r), probes.stream_tile(t3, r)]
    want = [probes.stream_ref(t), probes.stream_ref(t, r), probes.stream_ref(t3, r)]
    torch.cuda.synchronize()
    assert [probes.LAUNCHES[p] - before[p] for p in ("P1", "P2", "P3")] == [1, 1, 1]
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)


@pytest.mark.parametrize("variant", ["row", "tile", "tile_q2", "tile_o3"])
@pytest.mark.parametrize("total,kind", [(31, "random"), (127, "random"), (127, "ones"),
                                        (127, "min")])
def test_cuda_pair_probes_match_plain_version(cuda, variant, total, kind):
    from stringsearchlib_tpu_torch.ops import probes

    rng = np.random.default_rng(total + len(variant) + len(kind))
    gp = 2816 if kind == "random" else 128
    t = _probe_table(rng, gp, 3, kind).to(cuda)
    if variant != "row":
        t = pbm.to_tile_major(t)
    q = _qcnt(rng, 48 if variant == "tile_q2" else 33, gp, min(24, gp), total).to(cuda)
    probe = probes.PAIR_PROBE[variant]
    before = probes.LAUNCHES[probe]
    got = probes.pair(q, t, variant=variant)
    want = probes.pair_ref(q, t, variant=variant)
    torch.cuda.synchronize()
    assert probes.LAUNCHES[probe] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant", ["raw16", "raw32", "base", "onedot", "nodecode",
                                     "onestore", "noand"])
@pytest.mark.parametrize("layout", ["row", "tile"])
@pytest.mark.parametrize("total", [31, 127])
def test_cuda_raw_and_bisect_probes_match_plain_version(cuda, variant, layout, total):
    from stringsearchlib_tpu_torch.ops import probes

    rng = np.random.default_rng(total + len(variant) + len(layout))
    t = _probe_table(rng, 2816, 3, "random")
    t[:4] = -1  # all-bits-set and -128 rows among the random ones
    t[4:8] = -128
    t = t.to(cuda)
    if layout == "tile":
        t = pbm.to_tile_major(t)
    q = _qcnt(rng, 33, 2816, 24, total)
    q[0] = 0
    q[0, 0], q[0, 4] = total - 2, 2  # every count at the row's sum
    q = q.to(cuda)
    probe = "P8" if variant.startswith("raw") and variant != "rawi32" else "P9"
    before = probes.LAUNCHES[probe]
    if probe == "P8":
        got = probes.raw_hits(q, t, i16=variant == "raw16")
        want = probes.raw_hits_ref(q, t, i16=variant == "raw16")
    else:
        got = probes.bisect_run(q, t, variant=variant)
        want = probes.bisect_ref(q, t, variant=variant)
    torch.cuda.synchronize()
    assert probes.LAUNCHES[probe] == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("b", [13, 33, 256])
@pytest.mark.parametrize("layout", ["row", "tile"])
def test_cuda_int32_store_paths_match_plain_version(cuda, b, layout):
    """P8 i32 / P9 rawi32's staged store at ragged and full query groups,
    against the plain version, bit for bit."""
    from stringsearchlib_tpu_torch.ops import probes

    rng = np.random.default_rng(b + len(layout))
    t = _probe_table(rng, 2816, 3, "random")
    t[:4] = -1
    t[4:8] = -128
    t = t.to(cuda)
    if layout == "tile":
        t = pbm.to_tile_major(t)
    q = _qcnt(rng, b, 2816, 24, 127).to(cuda)
    want = probes.raw_hits_ref(q, t, i16=False)
    for got in (probes.raw_hits(q, t, i16=False),
                probes.bisect_run(q, t, variant="rawi32")):
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want)


def test_cuda_probe_contracts(cuda):
    from stringsearchlib_tpu_torch.ops import probes

    t = torch.zeros((128, 2 * pbm.BLKB), dtype=torch.int8, device=cuda)
    q = torch.ones((4, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        probes.pair(q.cpu(), t, variant="row")  # devices differ
    with pytest.raises(ValueError):
        probes.pl_stream(t[:, : pbm.BLKB + 16])  # NB % 512
    with pytest.raises(ValueError):
        probes.stream_row(t, torch.zeros((1, pbm.BLKB), dtype=torch.int32))  # r on the CPU
    assert probes.pl_stream(t).device.type == "cuda"


# ---------------------------------------------------------------------------
# the unpacked sketch (torch._int_mm), persistence and the C ABI on the card
# ---------------------------------------------------------------------------


def test_cuda_unpacked_hits_digits_and_slabs(cuda, monkeypatch):
    """One and two base-128 digits of the bucket counts, over column slabs
    of the incidence (strided views), exact against the CPU product."""
    from stringsearchlib_tpu_torch.search import sketch as psk

    rng = np.random.default_rng(3)
    inc = torch.from_numpy(rng.integers(0, 2, size=(256, 3 * psk._TILE), dtype=np.int8))
    for b, vmax in ((5, 127), (40, 127), (33, 300), (256, 16383)):
        q = torch.from_numpy(rng.integers(0, vmax + 1, size=(b, 256)).astype(np.int32))
        if vmax == 127:
            q = q % 2
        want = psk.unpacked_hits(q, inc, vmax)
        # row-major, and column-major as unpack_sketch stores it
        for inc_d in (inc.to(cuda), inc.t().contiguous().to(cuda).t()):
            for slab in (1 << 30, 4 * 24 * psk._TILE):
                monkeypatch.setattr(psk, "_MM_SLAB_BYTES", slab)
                calls = pc.INT_MM_CALLS
                got = psk.unpacked_hits(q.to(cuda), inc_d, vmax)
                torch.cuda.synchronize()
                assert pc.INT_MM_CALLS > calls
                assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


def test_unpacked_sketch_route_on_cuda_matches_cpu(cuda):
    from stringsearchlib_tpu_torch.search import sketch as psk

    rng = random.Random(11)
    words, weights = [], []
    for w in _corpus(2400, seed=19):
        words += [w, w[::-1] + rng.choice(["ka", "lo", "nor"])]
        weights += [1.0, 0.4]
    engines = []
    for dev in ("cpu", cuda):
        host = build_index(words, 2, weights, IndexConfig(), device=dev)
        eng = SearchEngine(host)
        eng.GM_BUDGET = eng.BITMAP_BUDGET = 0
        eng.SKETCH_MIN_TERMS = eng.CAND_MIN_TERMS = 0
        eng.RUNS_TINY_BATCH = 0
        eng.SKETCH_PACKED = False
        engines.append(eng)
    short = [w[:-1] + "x" for w in rng.sample(words, 40)]
    long_q = [" ".join(rng.sample(words, 14)) for _ in range(20)]
    for queries in (short, long_q):
        calls = pc.INT_MM_CALLS
        got = engines[1].search_batch(queries, 0.3, 10, mode="candidates")
        assert pc.INT_MM_CALLS > calls
        assert engines[1].last_routing["variant"] == "sketch"
        assert got == engines[0].search_batch(queries, 0.3, 10, mode="candidates")
        dense = engines[1].search_batch(queries, 0.3, 10, mode="dense")
        for g, d in zip(got, dense):
            assert sorted(zip(g[1], g[0])) == sorted(zip(d[1], d[0]))
    for a, b in zip(engines[0].host.sketch_tables(packed=False),
                    engines[1].host.sketch_tables(packed=False)):
        assert a == b if isinstance(a, int) else torch.equal(a, b.cpu())
    assert engines[1].host.sketch_tables(packed=False)[0].stride()[0] == 1


def test_save_load_round_trip_on_cuda(cuda, tmp_path):
    from stringsearchlib_tpu_torch import StringSearchIndex

    words = _corpus(3000, seed=23)
    idx = StringSearchIndex(words, device=cuda)
    path = tmp_path / "idx.npz"
    idx.save(path)
    on_card = StringSearchIndex.load(path)
    on_cpu = StringSearchIndex.load(path, device="cpu")
    assert on_card.host.device.device.type == "cuda"
    for f in FIELDS:
        a = getattr(idx.host.device, f)
        assert torch.equal(getattr(on_card.host.device, f), a), f
        assert torch.equal(getattr(on_cpu.host.device, f), a.cpu()), f
    queries = [w[:-1] + "q" for w in words[:64]]
    want = idx.engine.search_batch(queries, 0.3, 10)
    assert on_card.engine.search_batch(queries, 0.3, 10) == want
    assert on_cpu.engine.search_batch(queries, 0.3, 10) == want
    assert on_card.score(words[5], 0.5) == idx.score(words[5], 0.5)


def test_cabi_function_table_on_cuda(cuda, tmp_path):
    import ctypes as ct

    from stringsearchlib_tpu_torch.api import cabi, capi

    words = [w.encode() for w in _corpus(400, seed=29)]
    arr = (ct.c_char_p * len(words))(*words)
    tbl = cabi.function_table()
    index_n = ct.cast(tbl["indexN"][1], cabi._INDEXN_SIG)
    score = ct.cast(tbl["score"][1], cabi._SCORE_SIG)
    h = index_n(arr, len(words), 1, None)
    entry = capi.GLOBAL_REGISTRY.get(h)
    assert entry.host.device.device.type == "cuda"
    res = ct.POINTER(ct.c_char_p)()
    sc = ct.POINTER(ct.c_float)()
    n = score(h, words[3], ct.byref(res), ct.byref(sc), ct.c_float(0.5), 0)
    want = capi.score(h, words[3].decode(), 0.5, 0)
    assert [res[i].decode() for i in range(n)] == want[0]
    assert [sc[i] for i in range(n)] == pytest.approx(want[1])
    ct.cast(tbl["release"][1], cabi._RELEASE_SIG)(h, res, sc)
    assert capi.saveIndex(h, tmp_path / "c.npz")
    h2 = capi.loadIndex(tmp_path / "c.npz")
    assert capi.GLOBAL_REGISTRY.get(h2).host.device.device.type == "cuda"
    assert capi.score(h2, words[3].decode(), 0.5, 0) == want
    ct.cast(tbl["dispose"][1], cabi._DISPOSE_SIG)(h)
    capi.dispose(h2)
    assert capi.getSize(h) == 0


# -- the sharded engines on the card ------------------------------------------


def _sharded_queries(words, n, seed):
    rng = random.Random(seed)
    return [w[:-1] + "x" if i % 2 else w
            for i, w in enumerate(rng.choice(words) for _ in range(n))]


def test_meshes_default_to_cuda(cuda):
    from stringsearchlib_tpu_torch.parallel.dist import make_mesh

    mesh = make_mesh(1)
    assert mesh.devices[0].type == "cuda"
    assert make_mesh(4, device="cuda").devices == (mesh.devices[0],) * 4


@pytest.mark.parametrize("front", ["matmul", "runs"])
def test_sharded_engine_on_cuda_matches_cpu(cuda, front):
    """ShardedEngine on four shards of one card against the same on the
    CPU: the candidate fronts (torch._int_mm or K6's expansion per shard),
    the brute tier (K5 per shard), the dense retry and the wildcard."""
    from stringsearchlib_tpu_torch.parallel.dist import (
        ShardedEngine, make_mesh, shard_index,
    )

    words, weights = _weighted_corpus(3000, seed=47)
    host = build_index(words, 2, weights[: len(words)], IndexConfig(), device="cpu")
    sx = shard_index(host, 4)
    engines = [ShardedEngine(sx, make_mesh(4, device=d)) for d in ("cpu", cuda)]
    if front == "runs":
        for e in engines:
            e.GM_BUDGET = 0
    queries = _sharded_queries(words, 32, 17) + ["ka", "lo", "*", "me ri"]
    counts = (pdp.K5_LAUNCHES, pvg.EXPAND_LAUNCHES, pc.INT_MM_CALLS)
    refs = (pdp.K5_REF_CALLS, pvg.K6_REF_CALLS)
    got = engines[1].search_batch(queries, 0.25, 10)
    torch.cuda.synchronize()
    assert engines[1].last_routing["variant"] == front
    assert (pdp.K5_REF_CALLS, pvg.K6_REF_CALLS) == refs
    assert pdp.K5_LAUNCHES > counts[0]  # the brute queries' tiers
    if front == "runs":
        assert pvg.EXPAND_LAUNCHES >= counts[1] + 4
    else:
        assert pc.INT_MM_CALLS >= counts[2] + 4
    assert got == engines[0].search_batch(queries, 0.25, 10)
    assert engines[1].search_batch(queries[:8], 0.3, 0) == \
        engines[0].search_batch(queries[:8], 0.3, 0)


def test_tp_and_dp_tp_on_cuda_match_cpu(cuda):
    """GramShardedEngine and DpTpEngine on one card against the CPU: the
    summed per-shard expansions (K6) and the dense and brute tiers (K5)."""
    from stringsearchlib_tpu_torch.parallel.dist import make_mesh
    from stringsearchlib_tpu_torch.parallel.dp_tp import (
        DpTpEngine, make_mesh_2d, shard_index_2d,
    )
    from stringsearchlib_tpu_torch.parallel.tp import (
        GramShardedEngine, shard_index_by_grams,
    )

    words, weights = _weighted_corpus(2000, seed=49)
    host = build_index(words, 1, weights, IndexConfig(), device="cpu")
    gx = shard_index_by_grams(host, 4)
    dx = shard_index_2d(host, 2, 2)
    queries = _sharded_queries(words, 24, 19) + ["ka", "su", "*"]
    for mk in (lambda d: GramShardedEngine(gx, make_mesh(4, "grams", device=d)),
               lambda d: DpTpEngine(dx, make_mesh_2d(2, 2, device=d))):
        cpu, card = mk("cpu"), mk(cuda)
        launches = (pvg.EXPAND_LAUNCHES, pdp.K5_LAUNCHES)
        for mode in ("auto", "candidates", "dense"):
            got = card.search_batch(queries, 0.2, 10, mode=mode)
            torch.cuda.synchronize()
            assert got == cpu.search_batch(queries, 0.2, 10, mode=mode), mode
        assert pvg.EXPAND_LAUNCHES > launches[0] and pdp.K5_LAUNCHES > launches[1]


def test_multihost_on_cuda_over_gloo(cuda, tmp_path):
    """Two processes x two shards on the one card over gloo (the
    collectives staged through host memory) equal the CPU engine."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from stringsearchlib_tpu_torch.parallel.dist import (
        ShardedEngine, make_mesh, shard_index,
    )

    here = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    outs = [str(tmp_path / f"w{i}.json") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "test_torch_multihost.py"), "--worker",
         "--coordinator", f"127.0.0.1:{port}", "--nprocs", "2", "--pid", str(i),
         "--out", outs[i], "--shards-per-proc", "2", "--device", "cuda:0"],
        env=env, cwd=os.path.dirname(here)) for i in range(2)]
    try:
        assert [p.wait(timeout=120) for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    res = [json.load(open(o)) for o in outs]
    sys.path.insert(0, here)
    import test_torch_multihost as mh

    host = build_index(mh.WORDS, 1, None, IndexConfig(), device="cpu")
    want = mh._rounded(ShardedEngine(shard_index(host, 4), make_mesh(4, device="cpu"))
                       .search_batch(mh.QUERIES, 0.2, 10))
    assert res[0]["results"] == res[1]["results"] == want


def test_bench_run_config_on_cuda(cuda):
    """The port's bench on the card: launches counted, no plain version."""
    from stringsearchlib_tpu_torch.tools import bench as pbench

    out = pbench._run_config(pbench._product_names(3000), 64, 0.3, 100, 1,
                             singles=4)
    launches = out["launches"]
    assert sum(v for k, v in launches.items() if k.endswith("_LAUNCHES")) > 0
    assert not any(v for k, v in launches.items() if k.endswith("_REF_CALLS"))
    assert out["n_keys"] == 3000 and out["qps"] > 0
    assert out["single_query_p50_ms"] > 0


def _wide_qcnt(rng, b, gp, total):
    """(B, gp) multiplicities, every row summing to ``total``: even rows over
    min(gp, total) columns (multiplicity 1 where gp allows), odd rows over
    at most 24 (higher multiplicities), every third row one column of
    multiplicity ``total`` (a repeated-character query)."""
    q = np.zeros((b, gp), np.int32)
    for r in range(b):
        k = 1 if r % 3 == 2 else min(gp, total) if r % 2 == 0 else min(gp, 24, total)
        cols = rng.choice(gp, size=k, replace=False)
        cuts = np.sort(rng.choice(np.arange(1, total), k - 1, replace=False))
        q[r, cols] = np.diff(np.concatenate([[0], cuts, [total]]))
    return torch.from_numpy(q)


@pytest.mark.parametrize("total", [127, 128, 255, 256, 511, 512])
@pytest.mark.parametrize("gp", [128, 2816, 8192])
@pytest.mark.parametrize("b", [1, 33, 64])
def test_cuda_k2w_matches_plain_version(cuda, b, gp, total):
    """K2w bit for bit against its plain version at ragged batches and at
    the edges of its counter slices (8 up to 255, 9 up to 511, 10 at 512)."""
    rng = np.random.default_rng(b * 7919 + gp + total)
    planes = torch.from_numpy(
        rng.integers(0, 256, size=(3, gp, pbm.BLKB), dtype=np.uint8).view(np.int8)
    ).to(cuda)
    q = _wide_qcnt(rng, b, gp, total).to(cuda)
    launches, refs = pbm.K2W_LAUNCHES, pbm.K2W_REF_CALLS
    hits = pbm.bitmap_hits_wide(q, planes)
    want = pbm.bitmap_hits_wide_ref(q, planes)
    torch.cuda.synchronize()
    assert (pbm.K2W_LAUNCHES, pbm.K2W_REF_CALLS) == (launches + 1, refs)
    assert hits.dtype == torch.int32 and torch.equal(hits, want)


def test_cuda_k2w_every_bit_set(cuda):
    """A table with every bit set: every count is the query's sum, up to the
    per-launch bound of 65,535 (16 slices) and past it in parts (one entry
    of 70,000 and 200,001, spread rows of 65,536 and 131,071), through each
    way a row enters the counters."""
    planes = torch.full((2, 2816, pbm.BLKB), -1, dtype=torch.int8, device=cuda)
    q = torch.zeros((10, 2816), dtype=torch.int32)
    q[0, 7] = pbm.WIDE_MAX_SUM
    q[1, :2816] = 1
    q[2, 100:104] = torch.tensor([40000, 20000, 5000, 535])
    q[3, 3:12] = 1
    q[4, :1000] = 1
    q[4, 1000:1010] = 300
    q[5, 2000] = 256
    q[6, 9] = 70_000
    q[7, 2815] = 200_001
    q[8, :2816] = 1
    q[8, 0] = pbm.WIDE_MAX_SUM + 1 - 2815
    q[9, 100:104] = torch.tensor([65_535, 65_535, 1, 0])
    q = q.to(cuda)
    launches = pbm.K2W_LAUNCHES
    hits = pbm.bitmap_hits_wide(q, planes)
    torch.cuda.synchronize()
    assert pbm.K2W_LAUNCHES == launches + 4  # ceil(200,001 / 65,535)
    assert torch.equal(hits, q.sum(1, dtype=torch.int32)[:, None].expand_as(hits))


def test_cuda_k2w_accumulate_matches_plain(cuda):
    """K2w's accumulating launch adds its counts into the int32 hits in
    place: random tables, random hits already there (negative ones too),
    bit for bit against the plain version plus those hits."""
    from stringsearchlib_tpu_torch.ops import kernels

    rng = np.random.default_rng(5)
    launch = kernels.lib("bitmap_hits").bitmap_hits_wide_launch
    for b, gp, total in ((1, 128, 300), (33, 2816, 65_535), (64, 8192, 1000)):
        planes = torch.from_numpy(
            rng.integers(0, 256, size=(3, gp, pbm.BLKB), dtype=np.uint8).view(np.int8)
        ).to(cuda)
        q = _wide_qcnt(rng, b, gp, total).to(cuda)
        rows, mults = pbm._compact_qcnt(q, int((q != 0).sum(1).max()))
        before = torch.from_numpy(
            rng.integers(-2**20, 2**20, size=(b, 3 * pbm.TILE_LANES), dtype=np.int32)
        ).to(cuda)
        hits = before.clone()
        err = launch(planes.data_ptr(), rows.data_ptr(), mults.data_ptr(), hits.data_ptr(),
                     b, gp, 3, rows.shape[1], 1, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0
        assert torch.equal(hits, before + pbm.bitmap_hits_wide_ref(q, planes))


def test_cuda_k2w_contracts(cuda):
    """K2w takes row sums past 65,535 (in parts) and raises at 2^31, on
    negative multiplicities and on a row-major table; an empty batch
    launches nothing."""
    planes = torch.zeros((2, 128, pbm.BLKB), dtype=torch.int8, device=cuda)
    q = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    q[1, 5] = pbm.WIDE_MAX_SUM + 1
    launches = pbm.K2W_LAUNCHES
    assert not pbm.bitmap_hits_wide(q, planes).any()
    assert pbm.K2W_LAUNCHES == launches + 2
    q[1, 4:6] = torch.tensor([2**30, 2**30], dtype=torch.int32)
    with pytest.raises(ValueError):
        pbm.bitmap_hits_wide(q, planes)
    q[1, 4] = 0
    q[1, 5] = -1
    with pytest.raises(ValueError):
        pbm.bitmap_hits_wide(q, planes)
    with pytest.raises(ValueError):
        pbm.bitmap_hits_wide(q[:, :128].abs(), pbm.from_tile_major(planes).contiguous())
    launches = pbm.K2W_LAUNCHES
    out = pbm.bitmap_hits_wide(q[:0], planes)
    assert out.shape == (0, 2 * pbm.TILE_LANES) and pbm.K2W_LAUNCHES == launches


def test_cuda_gather_hits_distinct_slots(cuda):
    """The dense path's expansion of each row's distinct gram slots, weighted
    by multiplicity (K6's expansion, then a weighted scatter-add), on the
    card equals the CPU's and the plain count of one posting list per
    window (K6's expansion of every repeat and a scatter-add of ones)."""
    from stringsearchlib_tpu_torch.search import overlap as pov

    rng = np.random.default_rng(8)
    g, n_long = 300, 20_000
    lens = rng.integers(0, 400, g)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    terms = np.concatenate([np.sort(rng.choice(n_long, k, replace=False))
                            for k in lens]).astype(np.int32)
    slots = rng.integers(-1, g, (16, 5000)).astype(np.int32)
    slots[0] = 7
    slots[1, :4000] = np.arange(4000) % 5
    args = [torch.from_numpy(a) for a in (ptr, terms, slots)]
    cuda_args = [a.to(cuda) for a in args]
    mass = max(sum(int(lens[x]) for x in set(r.tolist()) if x >= 0) for r in slots)
    full = max(sum(int(lens[x]) for x in r.tolist() if x >= 0) for r in slots)
    got = pov.gather_hits(*cuda_args, n_long, mass)
    assert torch.equal(got.cpu(), pov.gather_hits(*args, n_long, mass))
    ids = pvg.expand_postings(*cuda_args, full, n_long).long()
    want = torch.zeros((16, n_long + 1), dtype=torch.int32, device=cuda)
    want.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.int32))
    assert torch.equal(got, want[:, :n_long])


def test_scan_route_on_cuda_matches_cpu(cuda):
    """Queries of more than 127 gram windows on an index whose packed table
    fits: ``bitmap_scan`` (K2w + the dense-hits finish) on the card equals
    the same route on the CPU and the dense path."""
    from stringsearchlib_tpu_torch.tools import bench as pbench

    words = pbench._product_names(3000, seed=3)
    engines = []
    for dev in ("cpu", cuda):
        eng = SearchEngine(build_index(words, 1, None, IndexConfig(), device=dev))
        eng.GM_BUDGET = 0
        eng.CAND_MIN_TERMS = 0
        eng.RUNS_TINY_BATCH = 0
        engines.append(eng)
    rng = random.Random(17)
    queries = []
    for i in range(20):
        q = pbench._mutate(rng, rng.choice(words))
        while len(q) < 131:
            q += " " + (q.split(" ")[0] if i % 4 == 3 else pbench._mutate(rng, rng.choice(words)))
        queries.append(q[:254])
    queries += ["1" * 300, "0" * 140]
    launches, refs = pbm.K2W_LAUNCHES, pbm.K2W_REF_CALLS
    got = engines[1].search_batch(queries, 0.1, 20, mode="candidates")
    assert engines[1].last_routing["variant"] == "bitmap_scan"
    assert pbm.K2W_LAUNCHES > launches and pbm.K2W_REF_CALLS == refs
    assert got == engines[0].search_batch(queries, 0.1, 20, mode="candidates")
    dense = engines[1].search_batch(queries, 0.1, 20, mode="dense")
    for g, d in zip(got, dense):
        assert sorted(zip(g[1], g[0])) == sorted(zip(d[1], d[0]))
