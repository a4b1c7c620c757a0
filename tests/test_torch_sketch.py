"""The packed bucket-sketch route of the PyTorch port against the JAX package.

Bucket hashing, the packed sketch tables (device and host builds), K2's
plain version (against the JAX Pallas kernel in interpret mode), the batched
sketch front end, and the engine's ``sketch_packed`` rung with its
escalation ladder on weighted 2-D rows - against the JAX engine, the oracle
and the port's own dense path.  Integer tensors are compared bit for bit and
float32 scores exactly.  The CUDA kernel is held against the plain version
on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from stringsearchlib_tpu.config import IndexConfig
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.ops import bitmap_matmul as jbm
from stringsearchlib_tpu.search import sketch as jsk
from stringsearchlib_tpu.search.engine import SearchEngine as JEngine
from stringsearchlib_tpu.utils.oracle import OracleIndex
from stringsearchlib_tpu_torch.index.build import build_index as pbuild
from stringsearchlib_tpu_torch.ops import bitmap_matmul as pbm
from stringsearchlib_tpu_torch.search import candidates as pc
from stringsearchlib_tpu_torch.search import sketch as psk
from stringsearchlib_tpu_torch.search.engine import SearchEngine as PEngine

_NEG_INF = np.float32(-np.inf)


def _corpus(n, seed=3, alpha="ABCDEFGHIJKLMNOP", lo=4, hi=20):
    rng = np.random.default_rng(seed)
    return [
        "".join(rng.choice(list(alpha), size=rng.integers(lo, hi)))
        for _ in range(n)
    ]


def _rows2d(n, seed=5):
    """bench.py's 2-D layout at a small size: (product name, gram-rich
    description) rows with weights [1.0, 0.4]."""
    rows = bench._product_names(n, seed=seed)
    descs = bench._rich_names(n, seed=seed + 1)
    words = [x for kv in zip(rows, descs) for x in kv]
    return words, np.tile(np.array([1.0, 0.4]), n)


def _rows3(n=1200, seed=31):
    """Row size 3 with zero and negative weights."""
    words = _corpus(n, seed=seed)
    rng = np.random.default_rng(seed)
    weights = rng.choice(
        [1.0, 0.5, 2.0, 0.0, -0.5], size=n, p=[0.5, 0.2, 0.15, 0.1, 0.05]
    )
    return words, weights


def _tl_pad(host):
    tl = int(host.device.long_lengths.shape[0])
    return -(-tl // psk._TILE) * psk._TILE


def _budget(host, d_log2):
    """SKETCH_BUDGET that makes sketch_tables pick ``d_log2``."""
    return (1 << d_log2) * _tl_pad(host) // 8


def _groups(res):
    out: dict = {}
    for k, s in zip(*res):
        out.setdefault((round(float(s), 5), len(k)), set()).add(k)
    return out



# ---------------------------------------------------------------------------
# bucket hashing and the table builds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d_log2", [7, 9, 13])
def test_bucket_of_matches_jax(d_log2):
    """uint32 wraparound of the Knuth hash: every slot >= 2 wraps."""
    rng = np.random.default_rng(d_log2)
    slots = np.concatenate([
        np.arange(-3, 50_000, dtype=np.int32),
        rng.integers(0, 2**31 - 1, size=4096, dtype=np.int64).astype(np.int32),
        np.array([2**31 - 1, 2**30, 47_040], np.int32),
    ]).reshape(2, -1)
    got = psk.bucket_of(torch.from_numpy(slots), d_log2).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jsk.bucket_of(jnp.asarray(slots), d_log2)))
    np.testing.assert_array_equal(got, jsk.bucket_of_np(slots, d_log2))
    assert (got[slots < 0] == -1).all() and got.max() == (1 << d_log2) - 1


def _collides(tg, d_log2):
    """Whether two distinct gram slots of one term share a bucket."""
    b = np.sort(jsk.bucket_of_np(tg, d_log2), axis=1)
    return bool(((b[:, 1:] == b[:, :-1]) & (b[:, 1:] >= 0)).any())


@pytest.fixture(scope="module")
def narrow_pair():
    words = _corpus(2500, seed=11)
    jh = jbuild(words, 1, None, IndexConfig())
    ph = pbuild(words, 1, None, IndexConfig(), device="cpu")
    return jh, ph


@pytest.mark.parametrize("d_log2", [7, 9])
def test_packed_build_matches_jax(narrow_pair, d_log2):
    jh, ph = narrow_pair
    d = jh.device
    tlp = _tl_pad(ph)
    tgw = int(d.long_tokens.shape[1]) - 2
    inc_j, tg_j = jsk.build_sketch_device_packed(
        d.long_tokens, d.long_lengths, jnp.asarray(jh.gram_ids.astype(np.int32)),
        gram_size=3, d_log2=d_log2, tl_pad=tlp, tgw=tgw,
    )
    want_inc = np.asarray(jbm.to_tile_major(inc_j))
    tg_j = np.asarray(tg_j)
    assert _collides(tg_j, d_log2)
    pd = ph.device
    inc_p, tg_p = psk.build_sketch_device_packed(
        pd.long_tokens, pd.long_lengths,
        torch.from_numpy(ph.gram_ids.astype(np.int32)),
        gram_size=3, d_log2=d_log2, tl_pad=tlp, tgw=tgw,
    )
    np.testing.assert_array_equal(tg_p.numpy(), tg_j)
    assert inc_p.dtype == torch.int8 and inc_p.shape == want_inc.shape
    np.testing.assert_array_equal(inc_p.numpy(), want_inc)
    # through the index: the budget picks d_log2, wmax_pad follows (both
    # packages cache one table per index)
    ph._sketch_cache = jh._sketch_cache = None
    inc, tg, wmax_pad, got_d = ph.sketch_tables(_budget(ph, d_log2))
    assert got_d == d_log2
    np.testing.assert_array_equal(inc.numpy(), want_inc)
    np.testing.assert_array_equal(tg.numpy(), tg_j)
    jsk_tables = jh.sketch_tables(_budget(ph, d_log2), packed=True)
    np.testing.assert_array_equal(wmax_pad.numpy(), np.asarray(jsk_tables[2]))
    np.testing.assert_array_equal(inc.numpy(), np.asarray(jsk_tables[0]))
    ph._sketch_cache = jh._sketch_cache = None


@pytest.mark.parametrize("cfg", [IndexConfig(wide=True), IndexConfig(gram_size=4)],
                         ids=["wide_g3", "narrow_g4"])
def test_host_build_matches_jax(cfg):
    """Wide strings and g = 4 build ``tg`` from numpy gram ids."""
    rng = np.random.default_rng(23)
    alpha = list("ABCDEFÉÜ中文日本") if cfg.wide else list("ABCDEFGH")
    words = ["".join(rng.choice(alpha, size=rng.integers(5, 16))) for _ in range(700)]
    jh = jbuild(words, 1, None, cfg)
    ph = pbuild(words, 1, None, cfg, device="cpu")
    d = jh.device
    tlp = _tl_pad(ph)
    tgw = int(d.long_tokens.shape[1]) - cfg.gram_size + 1
    args = (cfg.gram_size, cfg.wide, jh.vocab, 7, tlp, tgw)
    inc_j, tg_j = jsk.build_sketch_host(
        np.asarray(d.long_tokens), np.asarray(d.long_lengths),
        jh.lookup_gram_slots, *args,
    )
    inc_j, tg_j = np.asarray(inc_j), np.asarray(tg_j)
    assert _collides(tg_j, 7)
    packed_j = jsk.pack_inc_np(inc_j)
    np.testing.assert_array_equal(psk.pack_inc_np(inc_j), packed_j)
    want = np.asarray(jbm.to_tile_major(packed_j))
    pd = ph.device
    inc_p, tg_p = psk.build_sketch_host(
        pd.long_tokens.numpy(), pd.long_lengths.numpy(), ph.lookup_gram_slots,
        cfg.gram_size, cfg.wide, ph.vocab, 7, tlp, tgw, device="cpu",
    )
    np.testing.assert_array_equal(tg_p.numpy(), tg_j)
    np.testing.assert_array_equal(inc_p.numpy(), want)
    sk = ph.sketch_tables(_budget(ph, 7))
    assert sk[3] == 7
    np.testing.assert_array_equal(sk[0].numpy(), want)


def test_sketch_tables_declines():
    """None when even 128 buckets pass the budget, in each form (8x the
    bytes per bucket unpacked); each form is cached apart."""
    ph = pbuild(_corpus(600, seed=2), 1, None, IndexConfig(), device="cpu")
    assert ph.sketch_tables(_budget(ph, 7) - 1) is None
    assert ph.sketch_tables(8 * _budget(ph, 7) - 1, packed=False) is None
    ph._sketch_cache = None
    packed = ph.sketch_tables(8 * _budget(ph, 7))
    unpacked = ph.sketch_tables(8 * _budget(ph, 7), packed=False)
    assert packed[3] == 10 and unpacked[3] == 7
    assert unpacked[0].shape == (1 << 7, _tl_pad(ph))
    assert ph.sketch_tables(packed=False) is unpacked


# ---------------------------------------------------------------------------
# K2: the plain version against the JAX kernel (interpret mode)
# ---------------------------------------------------------------------------


def _qcnt(rng, b, gp, n_cols, total):
    q = np.zeros((b, gp), np.float32)
    for r in range(b):
        cols = rng.choice(gp, size=n_cols, replace=False)
        cuts = np.sort(rng.choice(np.arange(1, total), n_cols - 1, replace=False))
        q[r, cols] = np.diff(np.concatenate([[0], cuts, [total]]))
    return q


def _jax_k2(q, planes):
    return np.asarray(jbm.bitmap_hits(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(planes), interpret=True,
        int8_dots=True,
    ))


@pytest.mark.parametrize("gp,ntiles,total", [
    (128, 2, 31), (128, 2, 127), (512, 2, 31), (512, 2, 127), (8192, 1, 127),
])
def test_plain_k2_matches_jax_kernel_random(gp, ntiles, total):
    """Random bytes (bit 7 set), multiplicities above 1, rows summing to 31
    and 127; Gp 8192 runs the JAX kernel's G-tiled accumulation."""
    rng = np.random.default_rng(gp + total)
    planes = rng.integers(0, 256, size=(ntiles, gp, pbm.BLKB), dtype=np.uint8).view(np.int8)
    q = _qcnt(rng, 8, gp, 20, total)
    assert (q > 1).any() and (planes < 0).any()
    got = pbm.bitmap_hits_ref(torch.from_numpy(q), torch.from_numpy(planes))
    assert got.dtype == torch.int8 and got.shape == (8, ntiles * pbm.TILE_LANES)
    np.testing.assert_array_equal(got.numpy(), _jax_k2(q, planes))


def test_plain_k2_matches_jax_kernel_real_sketch(narrow_pair):
    """A real sketch table with real queries' bucket counts, where windows
    colliding in one bucket add up to multiplicities above 1."""
    jh, ph = narrow_pair
    jh._sketch_cache = None
    inc, _, _, d_log2 = jh.sketch_tables(_budget(ph, 9), packed=True)
    jh._sketch_cache = None
    eng = JEngine(jh)
    words = _corpus(2500, seed=11)
    items = []
    for pos, w in enumerate(words[:16]):
        qnorm, qlen = eng._normalize_query(w + w[:5])
        items.append((pos, qnorm, qlen, None))
    _, _, _, slots, _, _, _ = eng._prep_rows(items, 32)
    qcnt = pc.query_counts(psk.bucket_of(torch.from_numpy(slots), d_log2), 1 << d_log2)
    assert int(qcnt.max()) > 1
    planes = torch.from_numpy(np.array(inc))
    got = pbm.bitmap_hits_ref(qcnt, planes)
    np.testing.assert_array_equal(got.numpy(), _jax_k2(qcnt.numpy(), inc))
    calls = (pbm.K2_REF_CALLS, pbm.K2_LAUNCHES, pbm.K1_REF_CALLS)
    assert torch.equal(pbm.bitmap_hits(qcnt, planes), got)
    assert (pbm.K2_REF_CALLS, pbm.K2_LAUNCHES, pbm.K1_REF_CALLS) == (
        calls[0] + 1, calls[1], calls[2]
    )
    with pytest.raises(ValueError):
        pbm.bitmap_hits(qcnt[:, :-32], planes)


# ---------------------------------------------------------------------------
# the sketch front end against the JAX one
# ---------------------------------------------------------------------------


THRESHOLD = np.float32(0.25)
LIMIT = 10
TOP_K = 16


@pytest.fixture(scope="module")
def front_case():
    """A weighted 2-D index over two superblocks of terms, built by both
    packages; JAX's packed sketch tables carried over as numpy; 24 queries
    prepared by the JAX engine's host front end."""
    words, weights = _rows2d(9000, seed=7)
    # every 20th description cut to a short-tier term (< 6 characters)
    for i in range(1, len(words), 40):
        words[i] = words[i][: 3 + i % 3]
    jh = jbuild(words, 2, weights, IndexConfig())
    ph = pbuild(words, 2, weights, IndexConfig(), device="cpu")
    assert _tl_pad(ph) // psk._TILE == 2 and ph.device.n_short > 0
    inc, tg, wmax_pad, d_log2 = jh.sketch_tables(_budget(ph, 9), packed=True)
    tables = [np.array(x) for x in (inc, tg, wmax_pad)] + [d_log2]
    eng = JEngine(jh)
    rng = random.Random(7)
    queries = [bench._mutate(rng, rng.choice(words)) for _ in range(18)]
    queries += [words[i] + "x" for i in range(41, 400, 80)]  # short tier
    queries += ["acme nova valve"]
    items = []
    for pos, q in enumerate(queries):
        qnorm, qlen = eng._normalize_query(q)
        if qlen > 3:
            items.append((pos, qnorm, qlen, jh.promo_key_ids(qnorm, qlen)))
    b, qtok, qlens, slots, nqg, use_short, _ = eng._prep_rows(items, 32)
    promo = np.full((b, eng.PROMO_KEYS), -1, np.int32)
    for r, it in enumerate(items):
        promo[r, : it[3].size] = it[3]
    promo_t, promo_w = eng._promo_tables(promo)
    lim = np.full((b,), LIMIT, np.int32)
    host = dict(qtok=qtok, qlens=qlens, slots=slots, nqg=nqg, use_short=use_short,
                promo=promo, promo_t=promo_t, promo_w=promo_w, lim=lim)
    return jh, ph, tables, host


_KEYS = ("qtok", "qlens", "slots", "nqg", "use_short", "promo", "promo_t",
         "promo_w", "lim")


def _straddles(v, k):
    """A top-k over ``v`` may keep different equal values: the k-th largest
    is finite and more than k values reach it."""
    if k >= v.size:
        return False
    vk = np.sort(v)[::-1][k - 1]
    return bool(vk > _NEG_INF and (v >= vk).sum() > k)


def _kept(v, k):
    """Indices a top-k keeps among finite values when no tie straddles."""
    if k >= v.size:
        return np.flatnonzero(v > _NEG_INF)
    vk = np.sort(v)[::-1][k - 1]
    return np.flatnonzero((v >= vk) & (v > _NEG_INF))


def _tie_rows(ph, tables, h, kw):
    """Rows where a selection tie straddles a cutoff (superblocks, blocks,
    lanes or the short tier), recomputed in numpy from the same hits: only
    there may the two packages' exact flags or counts differ."""
    inc, tg, wmax_pad, d_log2 = tables
    slots = torch.from_numpy(h["slots"])
    nqg = torch.from_numpy(h["nqg"])
    nq_f = torch.clamp(nqg.float(), min=1.0)
    qcnt = pc.query_counts(psk.bucket_of(slots, d_log2), 1 << d_log2)
    hits = pbm.bitmap_hits_ref(qcnt, torch.from_numpy(inc))
    bm = psk._sketch_blockmax(
        hits, nqg, nq_f, torch.from_numpy(wmax_pad), float(THRESHOLD)
    ).numpy()
    s = hits.numpy().astype(np.float32) / nq_f.numpy()[:, None]
    u = np.where((hits.numpy() > 0) & (h["nqg"][:, None] > 0) & (s >= THRESHOLD),
                 wmax_pad[None, :] * s, _NEG_INF)
    if kw["compute_short"]:
        qlen_f = torch.clamp(torch.from_numpy(h["qlens"]).float(), min=1.0)
        u_short = pc._short_tier(
            ph.device, torch.from_numpy(h["qtok"]), torch.from_numpy(h["qlens"]),
            torch.from_numpy(h["use_short"]), float(THRESHOLD), qlen_f,
        )[2].numpy()
    ties = set()
    for r in range(bm.shape[0]):
        sbm = bm[r].reshape(-1, psk._SUPER)
        if _straddles(sbm.max(1), kw["ksb"]):
            ties.add(r)
            continue
        blocks = (_kept(sbm.max(1), kw["ksb"])[:, None] * psk._SUPER
                  + np.arange(psk._SUPER)).ravel()
        if _straddles(bm[r][blocks], kw["kb"]):
            ties.add(r)
            continue
        kept = blocks[_kept(bm[r][blocks], kw["kb"])]
        lanes = (kept[:, None] * psk._BLK + np.arange(psk._BLK)).ravel()
        if _straddles(u[r][lanes], kw["n_cand"]):
            ties.add(r)
        elif kw["compute_short"] and _straddles(u_short[r], kw["n_short_cand"]):
            ties.add(r)
    return ties


@pytest.mark.parametrize("compute_short", [True, False], ids=["short", "long"])
@pytest.mark.parametrize("ksb,kb,n_cand,n_short", [
    (2, 256, 4096, 0), (1, 2, 16, 16), (1, 1, 4, 4),
], ids=["wide", "starved", "tied"])
def test_candidates_sketch_matches_jax(front_case, compute_short, ksb, kb,
                                       n_cand, n_short):
    jh, ph, tables, h = front_case
    h = dict(h)
    if not compute_short:
        h["use_short"] = np.zeros_like(h["use_short"])
    inc, tg, wmax_pad, d_log2 = tables
    kw = dict(d_log2=d_log2, compute_short=compute_short, n_cand=n_cand,
              n_short_cand=n_short or ph.device.n_short, ksb=ksb, kb=kb,
              n_edge=64, top_k=TOP_K)
    pt_j, xt_j = jh.prim_tables()
    want = [np.asarray(x) for x in jsk.candidates_sketch(
        jh.device, jnp.asarray(inc), jnp.asarray(tg), jnp.asarray(wmax_pad),
        pt_j, xt_j, *[jnp.asarray(h[k]) for k in _KEYS], THRESHOLD,
        packed=True, interpret=True, **kw,
    )]
    pt_p, xt_p = ph.prim_tables()
    got = [x.numpy() for x in psk.candidates_sketch(
        ph.device, *[torch.from_numpy(x) for x in (inc, tg, wmax_pad)],
        pt_p, xt_p, *[torch.from_numpy(np.ascontiguousarray(h[k])) for k in _KEYS],
        THRESHOLD, **kw,
    )]
    ties = _tie_rows(ph, tables, h, kw)
    n_rows = int((h["qlens"] > 0).sum())
    differ = set(np.flatnonzero((got[4] != want[4]) | (got[0] != want[0])))
    assert differ <= ties, (sorted(differ), sorted(ties))
    both = np.flatnonzero(got[4] & want[4])
    assert both.size
    if ksb == 2:
        assert got[4][:n_rows].all()
    else:
        assert not got[4][:n_rows].all(), "starved budgets should fail some guards"
    for r in both:
        n = min(int(got[0][r]), LIMIT)
        assert min(int(want[0][r]), LIMIT) == n
        g = sorted(zip(-got[2][r][:n], got[3][r][:n], got[1][r][:n]))
        w = sorted(zip(-want[2][r][:n], want[3][r][:n], want[1][r][:n]))
        assert g == w, r


# ---------------------------------------------------------------------------
# the engine's sketch_packed rung
# ---------------------------------------------------------------------------


def _sketch_engine(eng, host, d_log2=9):
    eng.GM_BUDGET = 0
    eng.BITMAP_BUDGET = 0
    eng.SKETCH_MIN_TERMS = 0
    eng.CAND_MIN_TERMS = 0
    eng.SKETCH_BUDGET = _budget(host, d_log2)
    return eng


@pytest.mark.parametrize("case", ["rows2_w1_0.4", "rows3_mixed"])
def test_sketch_route_matches_jax_and_oracle(case):
    if case == "rows2_w1_0.4":
        words, weights = _rows2d(1500, seed=5)
        row = 2
    else:
        words, weights = _rows3()
        row = 3
    ph = pbuild(words, row, weights.tolist(), IndexConfig(), device="cpu")
    jh = jbuild(words, row, weights.tolist(), IndexConfig())
    assert not ph.uniform_weights
    pe = _sketch_engine(PEngine(ph), ph)
    je = JEngine(jh)
    oracle = OracleIndex(words, row_size=row, weights=weights.tolist())
    rng = random.Random(7)
    queries = [bench._mutate(rng, rng.choice(words)) for _ in range(40)]
    for thr, lim in ((0.3, 10), (0.0, 100)):
        calls = pbm.K2_REF_CALLS
        got = pe.search_batch(queries, thr, lim, mode="candidates")
        assert pe.last_routing["variant"] == "sketch_packed"
        assert pbm.K2_REF_CALLS > calls
        dense = pe.search_batch(queries, thr, lim, mode="dense")
        want = je.search_batch(queries, thr, lim, mode="dense")
        for q, g, d, w in zip(queries, got, dense, want):
            assert _groups(g) == _groups(d) == _groups(w), q
            assert _groups(g) == _groups(oracle.search(q, thr, lim)), q


def test_sketch_escalation_ladder(monkeypatch):
    """Starved first-pass budgets and 128 buckets: guard failures take one
    full second pass at CAND_TERMS-scale budgets (retry_full), the rest go
    dense, and every result stays exact."""
    words = _corpus(2000, seed=11)
    ph = pbuild(words, 1, None, IndexConfig(), device="cpu")
    pe = _sketch_engine(PEngine(ph), ph, d_log2=7)
    pe.SK_KSB = pe.SK_KB = 1
    pe.RUNS_TINY_BATCH = 0
    passes = []
    orig = pe._cand_pass

    def spy(items, *a):
        res = orig(items, *a)
        passes.append((len(items), a[-1], pe.last_routing["variant"], len(res[0])))
        return res

    monkeypatch.setattr(pe, "_cand_pass", spy)
    rng = np.random.default_rng(13)
    queries = []
    for _ in range(48):
        w = words[rng.integers(len(words))]
        lo = rng.integers(0, max(len(w) - 4, 1))
        queries.append(w[lo : lo + rng.integers(4, 14)])
    got = pe.search_batch(queries, 0.0, 10, mode="candidates")
    rt = pe.last_routing
    assert rt["retry_fast"] > 0 and "retry_full" in rt
    assert len(passes) == 2
    assert passes[0][1:3] == (pe.CAND_TERMS_FAST, "sketch_packed")
    assert passes[1][0] == rt["retry_fast"]
    assert passes[1][1:3] == (pe.CAND_TERMS, "sketch_packed")
    assert rt["retry_full"] == passes[1][3]
    want = pe.search_batch(queries, 0.0, 10, mode="dense")
    assert got == want


def test_sketch_gates_route_dense():
    """Batches the reference sends elsewhere leave the packed sketch: a
    table that fits BITMAP_BUDGET takes the bitmap route (weighted: no h*);
    a tiny batch takes the sorted runs (tiny_runs); queries over 127 gram
    windows take the unpacked sketch where it fits, else the sorted runs."""
    words, weights = _rows2d(600, seed=9)
    ph = pbuild(words, 2, weights, IndexConfig(), device="cpu")
    pe = _sketch_engine(PEngine(ph), ph)
    queries = words[:24:2]
    want = pe.search_batch(queries, 0.3, 10, mode="dense")
    pe.BITMAP_BUDGET = 6 << 30
    assert pe.search_batch(queries, 0.3, 10, mode="candidates") == want
    assert pe.last_routing["variant"] == "bitmap_kernel"
    assert pe.last_routing["hstar"] is False
    pe.BITMAP_BUDGET = 0
    ph._bitmap_cache = None  # the table is cached per index, whatever the budget
    assert pe.search_batch(queries[:8], 0.3, 10, mode="candidates") == want[:8]
    assert pe.last_routing["variant"] == "tiny_runs"
    assert pe.search_batch(queries, 0.3, 10, mode="candidates") == want
    assert pe.last_routing["variant"] == "sketch_packed"
    # each query-length bucket of these is a tiny batch, which the tiny
    # runs take before the sketch gate: close that gate to reach it.  The
    # unpacked sketch needs 128 buckets of tl_pad bytes; below that budget
    # the reference falls through to the sorted runs
    pe.RUNS_TINY_BATCH = 0
    long_q = [q * 12 for q in queries[:10]]
    got = pe.search_batch(long_q, 0.1, 10, mode="candidates")
    assert pe.last_routing["variant"] == "runs"
    assert got == pe.search_batch(long_q, 0.1, 10, mode="dense")
    pe.SKETCH_BUDGET = _budget(ph, 10)
    ph._sketch_cache = None  # cached per index and mode, a miss too
    got = pe.search_batch(long_q, 0.1, 10, mode="candidates")
    assert pe.last_routing["variant"] == "sketch"
    assert got == pe.search_batch(long_q, 0.1, 10, mode="dense")
