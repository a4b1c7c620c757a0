"""The bitmap scan route of the PyTorch port (queries of more than 127 gram
windows on an index whose packed table fits BITMAP_BUDGET) against the JAX
package: K2w's plain version (``bitmap_hits_wide_ref``) against a numpy
model and the reference's unpacked rows, the row lists at any width, the
``candidates_bitmap`` front end against the reference's jitted one, and the
engine's ``bitmap_scan`` route - which the JAX engine takes on the CPU at
every window count - against the JAX engine, the port's dense path and the
port's oracle.

Tolerances: integer tensors bit-identical, float32 scores exactly equal,
result ids equal.  ``torch.topk`` and ``lax.top_k`` may keep different
equal values, so a front-end row's exact flag and count may differ only
where a numpy recomputation shows a selection tie straddling a cutoff (the
rule of tests/test_torch_bitmap_finish.py, row by row); rows exact in both
packages agree entry for entry.  The kernel itself is held against its
plain version on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from stringsearchlib_tpu.config import IndexConfig as JConfig
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.search import candidates as jc
from stringsearchlib_tpu.search.engine import SearchEngine as JEngine
from stringsearchlib_tpu_torch.config import IndexConfig
from stringsearchlib_tpu_torch.index.build import build_index as pbuild
from stringsearchlib_tpu_torch.ops import bitmap_matmul as pbm
from stringsearchlib_tpu_torch.search import candidates as pc
from stringsearchlib_tpu_torch.search import engine as pemod
from stringsearchlib_tpu_torch.search.engine import SearchEngine as PEngine
from stringsearchlib_tpu_torch.utils.oracle import OracleIndex as POracle
from test_torch_bitmap_finish import (
    LIMIT, THRESHOLD, TOP_K, _assert_agree, _dense_tie_rows, _weighted,
)


def _groups(res):
    out: dict = {}
    for k, s in zip(*res):
        out.setdefault((round(float(s), 5), len(k)), set()).add(k)
    return out


# ---------------------------------------------------------------------------
# K2w's plain version and the row lists
# ---------------------------------------------------------------------------


def _table(rng, ntiles, gp):
    return rng.integers(-128, 128, size=(ntiles, gp, pbm.BLKB), dtype=np.int8)


def _numpy_hits(qcnt, planes):
    """hits[b, t] = sum_g qcnt[b, g] * bit(g, t) in int64, bit(g, t) read
    through the plane-tiled layout's coordinates."""
    ntiles, gp, _ = planes.shape
    terms = np.arange(ntiles * pbm.TILE_LANES)
    byte, bit = pbm.plane_coords(terms)
    rowmajor = planes.transpose(1, 0, 2).reshape(gp, -1).view(np.uint8)
    bits = (rowmajor[:, byte] >> bit[None, :]) & 1
    return qcnt.astype(np.int64) @ bits.astype(np.int64)


def _sum_rows(rng, b, gp, total):
    """(b, gp) multiplicities summing to ``total`` a row: spread rows,
    rows over few columns, and one column holding all of it (above 127 on
    one row wherever ``total`` is)."""
    q = np.zeros((b, gp), np.int32)
    for r in range(b):
        k = 1 if r % 3 == 2 else min(gp, total) if r % 2 == 0 else min(gp, 9, total)
        cols = rng.choice(gp, size=k, replace=False)
        cuts = np.sort(rng.choice(np.arange(1, total), k - 1, replace=False))
        q[r, cols] = np.diff(np.concatenate([[0], cuts, [total]]))
    return q


@pytest.mark.parametrize("total", [
    128, 255, 256, 1000, 4096, pbm.WIDE_MAX_SUM, pbm.WIDE_MAX_SUM + 1,
    3 * pbm.WIDE_MAX_SUM + 7, 2 * pbm.WIDE_MAX_SUM + 5,
])
def test_wide_plain_matches_numpy_and_reference_scan(total):
    """bitmap_hits_wide_ref == the numpy model == the reference's scan step
    (one unpacked row per query gram slot, int32 accumulation), and the
    wrapper on CPU tensors runs it once per part of at most WIDE_MAX_SUM a
    row.  Past the bound, every third row holds the whole sum in one entry
    (split across parts) and the rest spread it over 9 or 128 columns."""
    rng = np.random.default_rng(total)
    planes = _table(rng, 2, 128)
    q = _sum_rows(rng, 6, 128, total)
    assert (q.max(1) > 127).any()
    want = _numpy_hits(q, planes)
    got = pbm.bitmap_hits_wide_ref(torch.from_numpy(q), torch.from_numpy(planes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    calls = pbm.K2W_REF_CALLS
    wrapped = pbm.bitmap_hits_wide(torch.from_numpy(q), torch.from_numpy(planes))
    parts = -(-total // pbm.WIDE_MAX_SUM)
    assert pbm.K2W_REF_CALLS == calls + parts and torch.equal(wrapped, got)
    # the reference's accumulator, row by row of each query's gram slots
    rows = jc._unpack_planes(jnp.asarray(planes.transpose(1, 0, 2).reshape(128, -1)))
    rows = np.asarray(rows).astype(np.int64)
    np.testing.assert_array_equal(q.astype(np.int64) @ rows, want)


@pytest.mark.parametrize("total", [1, 31, 127])
def test_wide_plain_equals_int8_plain_to_127(total):
    rng = np.random.default_rng(100 + total)
    planes = torch.from_numpy(_table(rng, 3, 256))
    q = torch.from_numpy(_sum_rows(rng, 8, 256, total) if total > 1
                         else np.eye(8, 256, dtype=np.int32))
    wide = pbm.bitmap_hits_wide_ref(q, planes)
    assert torch.equal(wide, pbm.bitmap_hits_ref(q, planes).to(torch.int32))


@pytest.mark.parametrize("width", [256, 512])
def test_compact_qcnt_any_width(width):
    """Row lists as wide as the slot matrix: every nonzero column, those of
    multiplicity 1 first, each group in row order, then zeros."""
    rng = np.random.default_rng(width)
    gp = 1024
    q = np.zeros((5, gp), np.int32)
    for r, n in enumerate((width, width - 3, 1, 0, width // 2)):
        cols = np.sort(rng.choice(gp, size=n, replace=False))
        q[r, cols] = rng.choice([1, 1, 2, 300], size=n)
    rows, mults = pbm._compact_qcnt(torch.from_numpy(q), width)
    assert rows.shape == mults.shape == (5, width)
    assert rows.dtype == mults.dtype == torch.int32
    for r in range(5):
        nz = np.flatnonzero(q[r])
        ones, more = nz[q[r, nz] == 1], nz[q[r, nz] > 1]
        order = np.concatenate([ones, more])
        np.testing.assert_array_equal(rows[r, : nz.size].numpy(), order)
        np.testing.assert_array_equal(mults[r, : nz.size].numpy(), q[r, order])
        assert not mults[r, nz.size :].any()


def test_compact_qcnt_of_each_part():
    """Each part of a split is a row list the kernel takes: the parts add up
    to the counts, every row of every part sums to at most WIDE_MAX_SUM,
    and no part lists more columns than the row has nonzero."""
    rng = np.random.default_rng(3)
    m = pbm.WIDE_MAX_SUM
    q = np.zeros((4, 256), np.int64)
    q[0, 7] = 2 * m + 5
    q[1] = _sum_rows(rng, 1, 256, 3 * m + 7)[0]
    q[2, :9] = m
    q[3, 100] = 1
    parts = list(pbm._wide_parts(torch.from_numpy(q), int(q.sum(1).max())))
    assert len(parts) == 9
    total = torch.zeros_like(parts[0])
    for part in parts:
        assert part.dtype == torch.int32 and int(part.sum(1).max()) <= m
        assert ((part != 0).sum(1) <= torch.from_numpy((q != 0).sum(1))).all()
        total += part
    np.testing.assert_array_equal(total.numpy(), q)


def test_wide_wrapper_rejects_what_the_kernel_does_not_take():
    """Sums past WIDE_MAX_SUM are taken (in parts); negative multiplicities,
    row sums of 2^31 or more, row-major tables and a Gp that does not match
    are not."""
    planes = torch.zeros((2, 128, pbm.BLKB), dtype=torch.int8)
    q = torch.zeros((2, 128), dtype=torch.int32)
    q[1, :2] = torch.tensor([pbm.WIDE_MAX_SUM, 1])
    assert pbm.bitmap_hits_wide(q, planes).shape == (2, 2 * pbm.TILE_LANES)
    q[1, :3] = torch.tensor([2**30, 2**30 - 1, 0])
    assert pbm._check_wide(q, planes) == (2**31 - 1, 2)  # 32,769 parts
    q[1, 2] = 1
    with pytest.raises(ValueError, match="2\\^31"):
        pbm.bitmap_hits_wide(q, planes)
    q[1, :3] = 0
    q[0, 3] = -1
    with pytest.raises(ValueError):
        pbm.bitmap_hits_wide(q, planes)
    q[0, 3] = 0
    with pytest.raises(ValueError, match="tile-major"):
        pbm.bitmap_hits_wide(q, pbm.from_tile_major(planes).contiguous())
    with pytest.raises(ValueError):
        pbm.bitmap_hits_wide(q[:, :96], planes)


# ---------------------------------------------------------------------------
# the front end against the reference's jitted candidates_bitmap
# ---------------------------------------------------------------------------


def _long_queries(rng, words, n, lo=130, hi=250):
    """Joined mutated keys of ``lo``..``hi`` characters: more than 127 gram
    windows; every third one a key repeated (row multiplicities above 1)."""
    out = []
    for i in range(n):
        base = bench._mutate(rng, rng.choice(words))
        q = base
        while len(q) < lo:
            q += " " + (base if i % 3 == 2 else bench._mutate(rng, rng.choice(words)))
        out.append(q[:hi])
    return out


@pytest.fixture(scope="module", params=["uniform", "weighted"])
def front_case(request):
    """One index built by both packages, 16 queries at Qp 256 (12 of more
    than 127 windows, one a repeated syllable whose hits pass 127; 4 short
    ones for the short tier) prepared by the JAX engine's host front end."""
    words, weights = _weighted(2500, seed=21)
    if request.param == "uniform":
        weights = None
    jh = jbuild(words, 1, weights, JConfig())
    ph = pbuild(words, 1, weights, IndexConfig(), device="cpu")
    eng = JEngine(jh)
    rng = random.Random(29)
    queries = (_long_queries(rng, words, 11) + ["ka" * 120]
               + ["kalo", "rime", "sut", "nor"])
    items = []
    for pos, q in enumerate(queries):
        qnorm, qlen = eng._normalize_query(q)
        items.append((pos, qnorm, qlen, jh.promo_key_ids(qnorm, qlen)))
    b, qtok, qlens, slots, nqg, use_short, _ = eng._prep_rows(items, 256)
    assert slots.shape[1] > 127 and use_short.any()
    promo = np.full((b, eng.PROMO_KEYS), -1, np.int32)
    for r, it in enumerate(items):
        promo[r, : it[3].size] = it[3]
    promo_t, promo_w = eng._promo_tables(promo)
    bm_p, _ = ph.bitmap_tables()
    qcnt = pc.query_counts(torch.from_numpy(slots), int(bm_p.shape[1]))
    hits = pbm.bitmap_hits_wide_ref(qcnt, bm_p).numpy()
    assert hits.max() > 127
    host = dict(
        qtok=qtok, qlens=qlens, nqg=nqg, use_short=use_short, promo=promo,
        promo_t=promo_t, promo_w=promo_w, lim=np.full((b,), LIMIT, np.int32),
        slots=slots, hits=hits,
    )
    return jh, ph, host


_FRONT_KEYS = ("qtok", "qlens", "slots", "nqg", "use_short", "promo", "promo_t",
               "promo_w", "lim")


@pytest.mark.parametrize("compute_short", [True, False], ids=["short", "long"])
@pytest.mark.parametrize("block_sel,n_cand", [(False, 4096), (True, 16)],
                         ids=["plain", "block_sel"])
def test_candidates_bitmap_matches_jax(front_case, compute_short, block_sel, n_cand):
    jh, ph, h = front_case
    h = dict(h)
    if not compute_short:
        h["use_short"] = np.zeros_like(h["use_short"])
    kw = dict(compute_short=compute_short, n_cand=n_cand, n_edge=32, top_k=TOP_K,
              block_sel=block_sel)
    bm_j, _ = jh.bitmap_tables()
    bm_p, _ = ph.bitmap_tables()
    pt_j, xt_j = jh.prim_tables()
    pt_p, xt_p = ph.prim_tables()
    want = [np.asarray(x) for x in jc.candidates_bitmap(
        jh.device, bm_j, pt_j, xt_j, *[jnp.asarray(h[k]) for k in _FRONT_KEYS],
        THRESHOLD, **kw,
    )]
    calls = pbm.K2W_REF_CALLS
    got = [x.numpy() for x in pc.candidates_bitmap(
        ph.device, bm_p, pt_p, xt_p,
        *[torch.from_numpy(np.ascontiguousarray(h[k])) for k in _FRONT_KEYS],
        THRESHOLD, **kw,
    )]
    assert pbm.K2W_REF_CALLS == calls + 1
    ties = _dense_tie_rows(ph, h, h["hits"], compute_short, n_cand, block_sel)
    _assert_agree(got, want, ties, all_exact=n_cand == 4096)


# ---------------------------------------------------------------------------
# the engine's bitmap_scan route
# ---------------------------------------------------------------------------


def _gate(eng):
    eng.GM_BUDGET = 0
    eng.CAND_MIN_TERMS = 0
    eng.RUNS_TINY_BATCH = 0
    return eng


def _scan_queries(rng, words, g):
    """Joined keys (128 to 254 windows at Qp 256), repeated keys, and
    repeated characters of the corpus (one term's count past 127 and 255)."""
    joined = _long_queries(rng, words, 6, lo=130, hi=250)
    repeated = [" ".join([rng.choice(words)] * 40)[:300] for _ in range(3)]
    chars = sorted({c for w in words for c in w if c != " "})
    reps = [chars[0] * 200, chars[-1] * 300, (chars[1] * (g + 1) + " ") * 60]
    return joined + repeated + reps


@pytest.mark.parametrize("gram,wide", [(2, False), (3, False), (4, False), (3, True)],
                         ids=["g2", "g3", "g4", "wide_g3"])
def test_engine_scan_route_matches_jax_dense_and_oracle(gram, wide):
    if wide:
        from test_torch_bitmap_finish import _wide_words

        words = _wide_words(1500, seed=5)
    else:
        words = bench._product_names(1500, seed=gram)
    cfg_j, cfg_p = JConfig(wide=wide, gram_size=gram), IndexConfig(wide=wide, gram_size=gram)
    jh = jbuild(words, 1, None, cfg_j)
    ph = pbuild(words, 1, None, cfg_p, device="cpu")
    je, pe = _gate(JEngine(jh)), _gate(PEngine(ph))
    queries = _scan_queries(random.Random(gram + 10 * wide), words, gram)
    # a joined query of short wide keys scores each key below 0.1
    thr = 0.03 if wide else 0.1
    passes = []
    orig = pe._cand_pass

    def spy(items, *a):
        res = orig(items, *a)
        passes.append(dict(pe.last_routing))
        return res

    pe._cand_pass = spy
    calls = pbm.K2W_REF_CALLS
    got = pe.search_batch(queries, thr, 20, mode="candidates")
    want = je.search_batch(queries, thr, 20, mode="candidates")
    assert passes and all(p["variant"] == "bitmap_scan" for p in passes), passes
    assert pbm.K2W_REF_CALLS > calls
    for k in ("variant", "step", "n_cand", "block_sel", "hstar", "fused_bmax"):
        assert pe.last_routing[k] == je.last_routing[k], k
    assert pe.last_routing["variant"] == "bitmap_scan"
    dense = pe.search_batch(queries, thr, 20, mode="dense")
    oracle = POracle(words, row_size=1, gram_size=gram, wide=wide)
    for q, g, w, d in zip(queries, got, want, dense):
        assert _groups(g) == _groups(w) == _groups(d) == _groups(oracle.search(q, thr, 20)), q
    assert sum(len(g[0]) > 0 for g in got) >= len(queries) // 2


def test_engine_past_k2w_bound_goes_dense(monkeypatch):
    """Slot matrices whose row sums pass K2w's per-launch bound keep
    ``bitmap_scan`` (they went dense before the bound was lifted): K2w
    counts them in parts, at least two per chunk.  The bound is lowered so
    a Qp 256 batch meets it; results equal the JAX engine's (which scans
    at any width), the port's dense path's and the port's oracle's, and
    the routing keys the JAX engine's."""
    words = bench._product_names(1200, seed=3)
    jh = jbuild(words, 1, None, JConfig())
    pe = _gate(PEngine(pbuild(words, 1, None, IndexConfig(), device="cpu")))
    je = _gate(JEngine(jh))
    queries = _long_queries(random.Random(3), words, 4, lo=236, hi=250)
    monkeypatch.setattr(pbm, "WIDE_MAX_SUM", 200)
    wrapper_calls, orig = [], pbm.bitmap_hits_wide

    def spy(qcnt, planes):
        wrapper_calls.append(int(qcnt.sum(1).max()))
        return orig(qcnt, planes)

    monkeypatch.setattr(pbm, "bitmap_hits_wide", spy)
    calls = pbm.K2W_REF_CALLS
    got = pe.search_batch(queries, 0.1, 20, mode="candidates")
    want = je.search_batch(queries, 0.1, 20, mode="candidates")
    assert pe.last_routing["variant"] == "bitmap_scan"
    assert wrapper_calls and min(wrapper_calls) > 200, wrapper_calls
    assert pbm.K2W_REF_CALLS - calls >= 2 * len(wrapper_calls)
    for k in ("variant", "step", "n_cand", "block_sel", "hstar", "fused_bmax"):
        assert pe.last_routing[k] == je.last_routing[k], k
    dense = pe.search_batch(queries, 0.1, 20, mode="dense")
    oracle = POracle(words, row_size=1, gram_size=3)
    for q, g, w, d in zip(queries, got, want, dense):
        assert _groups(g) == _groups(w) == _groups(d) == _groups(oracle.search(q, 0.1, 20)), q
    assert all(len(g[0]) for g in got)


def test_engine_scan_past_65536_windows():
    """A pasted document of more than 65,536 characters (mutated keys
    joined by spaces) and a run of 70,000 of one digit whose trigram the
    index holds (one multiplicity of 69,998, split across parts) on an
    index of 1,000 keys: ``bitmap_scan`` at Qp 131,072, K2w in two parts,
    results equal to the port's dense path's (which expands each distinct
    gram slot once) and oracle's as tie groups.  The JAX engine is not run
    here: on the CPU its scan is a 131,070-step ``lax.scan`` per chunk;
    ``test_engine_past_k2w_bound_goes_dense`` holds the split against it
    at a lowered bound."""
    words = bench._product_names(1000, seed=4)
    pe = _gate(PEngine(pbuild(words, 1, None, IndexConfig(), device="cpu")))
    rng = random.Random(4)
    doc = bench._mutate(rng, rng.choice(words))
    while len(doc) < 80_000:
        doc += " " + bench._mutate(rng, rng.choice(words))
    digit = next(d for d in "0123456789" if any(d * 3 in w for w in words))
    queries = [doc, digit * 70_000]
    passes = []
    orig = pe._cand_pass

    def spy(items, *a):
        res = orig(items, *a)
        passes.append(dict(pe.last_routing))
        return res

    pe._cand_pass = spy
    calls = pbm.K2W_REF_CALLS
    got = pe.search_batch(queries, 0.03, 20, mode="candidates")
    assert passes and all(p["variant"] == "bitmap_scan" for p in passes), passes
    assert pbm.K2W_REF_CALLS - calls >= 2 * len(passes)
    dense = pe.search_batch(queries, 0.03, 20, mode="dense")
    oracle = POracle(words, row_size=1, gram_size=3)
    for q, g, d in zip(queries, got, dense):
        assert len(g[0]) and _groups(g) == _groups(d) == _groups(oracle.search(q, 0.03, 20))


def test_dense_lanes_count_distinct_slots():
    """The dense path lays out each row's distinct gram slots once: a run
    of 3,000 of one digit expands one posting list, not 2,998 copies, and
    scores as the JAX engine's dense path and the oracle do."""
    words = bench._product_names(1000, seed=4)
    ph = pbuild(words, 1, None, IndexConfig(), device="cpu")
    pe, je = PEngine(ph), JEngine(jbuild(words, 1, None, JConfig()))
    digit = next(d for d in "0123456789" if any(d * 3 in w for w in words))
    run = digit * 3000
    items = [(0, *pe._normalize_query(run), None)]
    slots = pe._prep_rows(items, 4096)[3]
    full, mass = pe._slot_mass(slots)
    posting = int(ph.host_posting_lens[slots[0, 0]])
    assert mass == posting and full == 2998 * posting
    got = pe.search_batch([run, run[:40]], 0.5, 0, mode="dense")
    want = je.search_batch([run, run[:40]], 0.5, 0, mode="dense")
    oracle = POracle(words, row_size=1, gram_size=3)
    for q, g, w in zip([run, run[:40]], got, want):
        assert len(g[0]) and _groups(g) == _groups(w) == _groups(oracle.search(q, 0.5, 0))
    assert _groups(pe.search(run, 0.5, 0)) == _groups(got[0])
