"""The gathered-row small-batch route of the PyTorch port against the JAX
package: the row gather (the plain version of the CUDA kernel that replaces
K3 ``gather_rows_dma`` and K4 ``gather_rows_pallas``) against both JAX
kernels in interpret mode, ``_gather_rows_plan``, the front end
``candidates_bitmap_gather`` with h* on and off, and the engine's forced
``bitmap_gather`` route (uniform and weighted) against the JAX engine (its
kernels in interpret mode, its backend patched to "tpu" as the JAX
package's own tests do) and the port's dense path.

Tolerances: gathered tables and hit counts bit-identical; float32 scores
exactly equal; results equal as (score, key length) tie groups.  The CUDA
kernel is held against the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringsearchlib_tpu.config import IndexConfig as JConfig
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.ops import bitmap_matmul as jbm
from stringsearchlib_tpu.search import candidates as jc
from stringsearchlib_tpu.search import engine as jemod
from stringsearchlib_tpu.search.engine import SearchEngine as JEngine
from stringsearchlib_tpu_torch.config import IndexConfig
from stringsearchlib_tpu_torch.index.build import build_index as pbuild
from stringsearchlib_tpu_torch.ops import bitmap_matmul as pbm
from stringsearchlib_tpu_torch.search import candidates as pc
from stringsearchlib_tpu_torch.search.engine import SearchEngine as PEngine

THRESHOLD = np.float32(0.25)
LIMIT = 10
TOP_K = 16


def _corpus(n, seed=21):
    rng = random.Random(seed)
    syll = ["ka", "lo", "me", "ri", "su", "ta", "ve", "nor", "bel"]
    return [
        "".join(rng.choice(syll) for _ in range(rng.randint(2, 5)))
        for _ in range(n)
    ]


def _groups(res):
    out: dict = {}
    for k, s in zip(*res):
        out.setdefault((round(float(s), 5), len(k)), set()).add(k)
    return out


@pytest.fixture(scope="module")
def pair():
    words = _corpus(2500)
    jh = jbuild(words, 1, None, JConfig())
    ph = pbuild(words, 1, None, IndexConfig(), device="cpu")
    return words, jh, ph


# ---------------------------------------------------------------------------
# the row gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gc,dup", [(48, False), (64, True), (512, True)])
def test_gather_rows_matches_jax_kernels(pair, gc, dup):
    """Row-major tables from the resident table: the plain version against
    K3 (pipelined DMAs) and K4 (one grid step per row) in interpret mode,
    with duplicate rows and padding rows (row 0) as the route plans them."""
    _, jh, ph = pair
    rm_j = jbm.from_tile_major(jh.bitmap_tables()[0])
    rm_p = pbm.from_tile_major(ph.bitmap_tables()[0]).contiguous()
    np.testing.assert_array_equal(rm_p.numpy(), np.asarray(rm_j))
    g = int(rm_p.shape[0])
    rng = np.random.default_rng(gc)
    rows = np.zeros(gc, np.int32)
    n_used = gc // 2 if dup else gc
    rows[:n_used] = rng.choice(g, n_used, replace=dup)
    calls = (pbm.G_REF_CALLS, pbm.G_LAUNCHES)
    got = pbm.gather_rows_ref(rm_p, torch.from_numpy(rows))
    assert torch.equal(pbm.gather_rows_dma(rm_p, torch.from_numpy(rows)), got)
    assert torch.equal(pbm.gather_rows_pallas(rm_p, torch.from_numpy(rows)), got)
    assert (pbm.G_REF_CALLS, pbm.G_LAUNCHES) == (calls[0] + 2, calls[1])
    rows_j = jnp.asarray(rows)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbm.gather_rows_dma(rm_j, rows_j, interpret=True))
    )
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbm.gather_rows_pallas(rm_j, rows_j, interpret=True))
    )


def test_gather_rows_tile_major_and_contracts(pair):
    """On the resident tile-major table the gather is the route's
    ``jnp.take(bitmap, rows, axis=1)``; the K3/K4 entries keep the
    reference's row-major width asserts."""
    _, jh, ph = pair
    bm_j = jh.bitmap_tables()[0]
    bm_p = ph.bitmap_tables()[0]
    rows = np.arange(0, 3 * 32, 3, dtype=np.int32)
    got = pbm.gather_rows(bm_p, torch.from_numpy(rows))
    assert got.shape == (bm_p.shape[0], 32, pbm.BLKB)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.take(bm_j, jnp.asarray(rows), axis=1))
    )
    odd = torch.zeros((8, 3 * 128), dtype=torch.int8)
    assert pbm.gather_rows_pallas(odd, torch.tensor([1, 1])).shape == (2, 384)
    with pytest.raises(AssertionError):
        pbm.gather_rows_dma(odd, torch.tensor([1]))
    with pytest.raises(AssertionError):
        pbm.gather_rows_pallas(torch.zeros((8, 200), dtype=torch.int8), torch.tensor([1]))
    with pytest.raises(TypeError):
        pbm.gather_rows(odd.float(), torch.tensor([1]))


def test_gather_rows_plan_matches_jax(pair):
    _, jh, ph = pair
    pe, je = PEngine(ph), JEngine(jh)
    slots = np.array([[5, 900, -1, 5], [70, -1, 900, 2]], np.int32)
    got, want = pe._gather_rows_plan(slots), je._gather_rows_plan(slots)
    assert got[2] == want[2] == 32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    big = np.arange(600, dtype=np.int32)[None, :]
    assert pe._gather_rows_plan(big) is None and je._gather_rows_plan(big) is None
    assert pe._gather_rows_plan(np.full((2, 3), -1, np.int32)) is None


# ---------------------------------------------------------------------------
# the gathered front end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def front(pair):
    """8 queries prepared by the JAX engine's host front end (padded to 8
    rows as the route pads them) and their gathered-row plan."""
    words, jh, _ = pair
    eng = JEngine(jh)
    rng = random.Random(23)
    queries = []
    for i in range(8):
        w = words[rng.randrange(len(words))]
        queries.append(w if i % 2 else w[:-1] + "x")
    items = []
    for pos, q in enumerate(queries):
        qnorm, qlen = eng._normalize_query(q)
        items.append((pos, qnorm, qlen, jh.promo_key_ids(qnorm, qlen)))
    b, qtok, qlens, slots, nqg, use_short, _ = eng._prep_rows(items, 32, min_b=8)
    promo = np.full((b, eng.PROMO_KEYS), -1, np.int32)
    for r, it in enumerate(items):
        promo[r, : it[3].size] = it[3]
    promo_t, promo_w = eng._promo_tables(promo)
    rows, slots_g, gc = eng._gather_rows_plan(slots)
    return dict(
        qtok=qtok, qlens=qlens, slots=slots_g, nqg=nqg, use_short=use_short,
        promo=promo, promo_t=promo_t, promo_w=promo_w,
        lim=np.full((b,), LIMIT, np.int32), rows=rows, gc=gc,
    )


_KEYS = ("qtok", "qlens", "slots", "nqg", "use_short", "promo", "promo_t",
         "promo_w", "lim")


@pytest.mark.parametrize("hstar,block_sel", [(False, False), (False, True), (True, False)],
                         ids=["dense_hits", "blockmax", "hstar"])
def test_candidates_bitmap_gather_matches_jax(pair, front, monkeypatch, hstar,
                                              block_sel):
    """The port's gathered front end (gather, then K1 on the compact table:
    both plain versions on CPU) against the JAX one with its Pallas K1 in
    interpret mode, at budgets that cover every row: every row exact, the
    same counts and results, entry for entry."""
    _, jh, ph = pair
    h = front
    monkeypatch.setattr(jc.jax, "default_backend", lambda: "tpu")
    kw = dict(compute_short=True, n_cand=2048, n_edge=32, top_k=TOP_K,
              block_sel=block_sel)
    if hstar:
        kw.update(hstar=True, kb1=64, kb2=64)
    pt_j, xt_j = jh.prim_tables()
    want = [np.asarray(x) for x in jc.candidates_bitmap_gather(
        jh.device, jh.bitmap_tables()[0], jnp.asarray(h["rows"]), pt_j, xt_j,
        *[jnp.asarray(h[k]) for k in _KEYS], THRESHOLD, interpret=True,
        gather_impl="take", **kw,
    )]
    pt_p, xt_p = ph.prim_tables()
    calls = (pbm.G_REF_CALLS, pbm.K1_REF_CALLS, pbm.K2_REF_CALLS)
    got = [x.numpy() for x in pc.candidates_bitmap_gather(
        ph.device, ph.bitmap_tables()[0], torch.from_numpy(h["rows"]), pt_p, xt_p,
        *[torch.from_numpy(np.ascontiguousarray(h[k])) for k in _KEYS],
        THRESHOLD, **kw,
    )]
    assert (pbm.G_REF_CALLS, pbm.K1_REF_CALLS, pbm.K2_REF_CALLS) == (
        calls[0] + 1, calls[1] + 1, calls[2]
    )
    assert got[4].all() and want[4].all()
    np.testing.assert_array_equal(got[0], want[0])
    for r in range(got[0].shape[0]):
        n = min(int(got[0][r]), TOP_K)
        for i in (1, 2, 3):
            np.testing.assert_array_equal(got[i][r][:n], want[i][r][:n])


def test_gathered_hits_equal_full_table_hits(pair, front):
    """K1 on the compact table gives the full table's hits and block maxima
    (grams outside the batch's union carry zero multiplicity)."""
    _, _, ph = pair
    bm = ph.bitmap_tables()[0]
    rows = torch.from_numpy(front["rows"])
    slots_g = torch.from_numpy(front["slots"])
    slots_full = torch.where(slots_g >= 0, rows.long()[slots_g.clamp(min=0).long()], -1)
    h_c, m_c = pbm.bitmap_hits_bmax(
        pc.query_counts(slots_g, front["gc"]), pbm.gather_rows(bm, rows)
    )
    h_f, m_f = pbm.bitmap_hits_bmax(pc.query_counts(slots_full, bm.shape[1]), bm)
    assert torch.equal(h_c, h_f) and torch.equal(m_c, m_f)


# ---------------------------------------------------------------------------
# the engine's forced gathered route
# ---------------------------------------------------------------------------


def _jax_gather_engine(monkeypatch, jh):
    monkeypatch.setattr(jc, "GATHER_IMPL", "take")
    monkeypatch.setattr(
        jc, "candidates_bitmap_gather",
        functools.partial(jc.candidates_bitmap_gather, interpret=True),
    )
    monkeypatch.setattr(
        jc, "candidates_bitmap_mxu",
        functools.partial(jc.candidates_bitmap_mxu, interpret=True),
    )
    monkeypatch.setattr(jemod.jax, "default_backend", lambda: "tpu")
    je = JEngine(jh)
    je.GM_BUDGET = 0
    je.CAND_MIN_TERMS = 100
    je.BITMAP_GATHER_TMAJ = True
    return je


_ROUTE_KEYS = ("variant", "hstar", "block_sel", "n_cand", "fused_bmax",
               "gather_rows")


@pytest.mark.parametrize("weighted", [False, True], ids=["uniform", "weighted"])
def test_engine_gather_route_matches_jax(monkeypatch, weighted):
    """Batches of 1, 2 and 8 queries route ``bitmap_gather`` (h* on the
    uniform index, off on the weighted one) with the JAX engine's routing,
    and equal the JAX engine's and the port's dense results; 9 queries
    leave the route."""
    words = _corpus(3000, seed=61)
    weights = None
    if weighted:
        weights = np.ones(len(words))
        weights[::7] = 0.4
        weights[::13] = 0.0
    jh = jbuild(words, 1, weights, JConfig())
    ph = pbuild(words, 1, weights, IndexConfig(), device="cpu")
    je = _jax_gather_engine(monkeypatch, jh)
    pe = PEngine(ph)
    pe.GM_BUDGET = 0
    pe.CAND_MIN_TERMS = 100
    pe.BITMAP_GATHER_TMAJ = True
    for eng in (je, pe):  # h* budgets the small lane space dwarfs
        eng.HSTAR_KB1, eng.HSTAR_KB2 = 4, 8
    rng = random.Random(3)
    for nq in (1, 2, 8, 9):
        queries = []
        for i in range(nq):
            w = words[rng.randrange(len(words))]
            queries.append(w if i % 2 else w[:-1] + "x")
        calls = (pbm.G_REF_CALLS, pbm.K1_REF_CALLS)
        got = pe.search_batch(queries, 0.25, 10, mode="candidates")
        want = je.search_batch(queries, 0.25, 10, mode="candidates")
        for k in _ROUTE_KEYS:
            assert pe.last_routing.get(k) == je.last_routing.get(k), (nq, k)
        if nq <= 8:
            assert pe.last_routing["variant"] == "bitmap_gather"
            assert pe.last_routing["gather_rows"] >= 32
            assert pe.last_routing["hstar"] is (not weighted)
            assert pbm.G_REF_CALLS > calls[0] and pbm.K1_REF_CALLS > calls[1]
        else:
            assert pe.last_routing["variant"] == "bitmap_kernel"
        dense = pe.search_batch(queries, 0.25, 10, mode="dense")
        for q, g, w, d in zip(queries, got, want, dense):
            assert _groups(g) == _groups(w) == _groups(d), (nq, q)


def test_engine_gather_retry_pass_pads_to_8(monkeypatch):
    """Starved h* budgets on the gathered route: guard-failed rows take the
    full second pass at CAND_TERMS-scale budgets (``retry_full``, no
    selection-only retry) on the gathered route again, in chunks padded to
    8 queries, and the results stay exact."""
    words = _corpus(3000, seed=47)
    ph = pbuild(words, 1, None, IndexConfig(), device="cpu")
    pe = PEngine(ph)
    pe.GM_BUDGET = 0
    pe.CAND_MIN_TERMS = 100
    pe.BITMAP_GATHER_TMAJ = True
    pe.HSTAR_KB1 = pe.HSTAR_KB2 = 1
    widths = []
    orig = pc._hstar_finish

    def spy(di, pt, xt, hits, *a, **kw):
        widths.append(int(hits.shape[0]))
        return orig(di, pt, xt, hits, *a, **kw)

    monkeypatch.setattr(pc, "_hstar_finish", spy)
    sel = []
    monkeypatch.setattr(pe, "_hstar_sel_retry", lambda *a: sel.append(1))
    rng = random.Random(7)
    queries = [w[:-1] + "x" for w in rng.sample(words, 5)]
    got = pe.search_batch(queries, 0.0, 10, mode="candidates")
    rt = pe.last_routing
    assert rt["variant"] == "bitmap_gather" and rt["hstar"] is True
    assert rt["retry_fast"] > 0 and "retry_full" in rt and not sel
    assert len(widths) == 2 and all(w == 8 for w in widths)
    assert got == pe.search_batch(queries, 0.0, 10, mode="dense")
