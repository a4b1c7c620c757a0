"""The weighted and non-h* bitmap finishes of the PyTorch port against the
JAX package: ``block_hmax``, ``_tight_bound``, ``_select_candidates``,
``_dense_hits_finish`` and ``_blockmax_finish`` fed the same hits (the JAX
kernel's output in interpret mode), the non-h* ``candidates_bitmap_mxu``
front end, and the engine's weighted and wide gSize-2 bitmap routes against
the JAX engine (its kernels in interpret mode, its backend patched to
"tpu" as the JAX package's own tests do) and the port's dense path.

Tolerances: integer tensors bit-identical, float32 scores and bounds
exactly equal, result ids equal.  ``torch.topk`` and ``lax.top_k`` may keep
different equal values, so a row's exact flag and count may differ only
where a numpy recomputation shows a selection tie straddling a cutoff;
rows exact in both packages must agree entry for entry."""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringsearchlib_tpu.config import IndexConfig as JConfig
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.ops.bitmap_matmul import bitmap_hits_bmax
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
_NEG_INF = np.float32(-np.inf)


def _corpus(n, seed=21):
    rng = random.Random(seed)
    syll = ["ka", "lo", "me", "ri", "su", "ta", "ve", "nor", "bel"]
    return [
        "".join(rng.choice(syll) for _ in range(rng.randint(2, 5)))
        for _ in range(n)
    ]


def _weighted(n=2500, seed=21):
    """Weights 1.0 / 0.4 / 0.0, and -0.5 on every key of 11+ characters:
    the long tier is length-sorted, so whole 128-term blocks carry only
    negative weights and take the blockmax finish's ``wblk * threshold``
    bound."""
    words = sorted(set(_corpus(n, seed=seed)))
    rng = np.random.default_rng(seed)
    weights = rng.choice([1.0, 0.4, 0.0], size=len(words), p=[0.6, 0.3, 0.1])
    weights[np.array([len(w) >= 11 for w in words])] = -0.5
    return words, weights


def _groups(res):
    out: dict = {}
    for k, s in zip(*res):
        out.setdefault((round(float(s), 5), len(k)), set()).add(k)
    return out


@pytest.fixture(scope="module")
def case():
    """One weighted index built by both packages, 16 queries prepared by the
    JAX engine's host front end (short, long and 11+ character ones), and
    the JAX kernel's hits and block maxima for them."""
    words, weights = _weighted()
    jh = jbuild(words, 1, weights, JConfig())
    ph = pbuild(words, 1, weights, IndexConfig(), device="cpu")
    assert not ph.uniform_weights
    wl = np.asarray(ph.device.term_wmax[ph.device.n_short:])
    blocks = wl[: wl.size // 128 * 128].reshape(-1, 128).max(1)
    assert (blocks < 0).any(), "no all-negative 128-term block"
    eng = JEngine(jh)
    rng = random.Random(13)
    longs = [w for w in words if len(w) >= 11]
    queries = [rng.choice(words) for _ in range(8)]
    queries = [q if i % 2 else q[:-1] + "x" for i, q in enumerate(queries)]
    queries += [w[:-2] for w in rng.sample(longs, 4)] + ["kalo", "rime", "sutave", "nor"]
    items = []
    for pos, q in enumerate(queries):
        qnorm, qlen = eng._normalize_query(q)
        items.append((pos, qnorm, qlen, jh.promo_key_ids(qnorm, qlen)))
    b, qtok, qlens, slots, nqg, use_short, _ = eng._prep_rows(items, 32)
    promo = np.full((b, eng.PROMO_KEYS), -1, np.int32)
    for r, it in enumerate(items):
        promo[r, : it[3].size] = it[3]
    promo_t, promo_w = eng._promo_tables(promo)
    bm, _ = jh.bitmap_tables()
    qcnt = np.zeros((b, int(bm.shape[1])), np.float32)
    for r in range(b):
        for s in slots[r]:
            if s >= 0:
                qcnt[r, s] += 1
    hits, hmax = bitmap_hits_bmax(
        jnp.asarray(qcnt, jnp.bfloat16), bm, interpret=True, int8_dots=True
    )
    host = dict(
        qtok=qtok, qlens=qlens, nqg=nqg, use_short=use_short, promo=promo,
        promo_t=promo_t, promo_w=promo_w, lim=np.full((b,), LIMIT, np.int32),
        slots=slots, hits=np.asarray(hits), hmax=np.asarray(hmax),
    )
    return jh, ph, host


_KEYS = ("qtok", "qlens", "nqg", "use_short", "promo", "promo_t", "promo_w",
         "lim")


def _run_jax(jh, h, fn, hits, **kw):
    pt, xt = jh.prim_tables()
    a = [jnp.asarray(h[k]) for k in _KEYS]
    out = fn(jh.device, pt, xt, jnp.asarray(hits), *a, THRESHOLD, **kw)
    return [np.asarray(x) for x in out]


def _run_port(ph, h, fn, hits, **kw):
    pt, xt = ph.prim_tables()
    a = [torch.from_numpy(np.ascontiguousarray(h[k])) for k in _KEYS]
    out = fn(ph.device, pt, xt, torch.from_numpy(hits), *a, THRESHOLD, **kw)
    return [x.numpy() for x in out]


# ---------------------------------------------------------------------------
# numpy recomputation of the selections: where may a tie straddle a cutoff
# ---------------------------------------------------------------------------


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


def _long_bounds(ph, h, hits):
    ts = ph.device.n_short
    tlp = hits.shape[1]
    wl = np.asarray(ph.device.term_wmax[ts:])
    wpad = np.concatenate([wl, np.zeros(tlp - wl.size, np.float32)])
    nqg_f = np.maximum(h["nqg"].astype(np.float32), np.float32(1.0))
    s = hits.astype(np.float32) / nqg_f[:, None]
    ok = (hits > 0) & (h["nqg"][:, None] > 0) & (s >= THRESHOLD)
    return np.where(ok, wpad[None, :] * s, _NEG_INF), wpad, nqg_f


def _short_bounds(ph, h):
    qlen_f = torch.clamp(torch.from_numpy(h["qlens"]).float(), min=1.0)
    return pc._short_tier(
        ph.device, torch.from_numpy(h["qtok"]), torch.from_numpy(h["qlens"]),
        torch.from_numpy(h["use_short"]), float(THRESHOLD), qlen_f,
    )[2].numpy()


def _dense_tie_rows(ph, h, hits, compute_short, n_cand, block_sel):
    u, _, _ = _long_bounds(ph, h, hits)
    if compute_short:
        u = np.concatenate([_short_bounds(ph, h), u], 1)
    ties = set()
    for r in range(u.shape[0]):
        if not block_sel:
            if _straddles(u[r], n_cand):
                ties.add(r)
            continue
        nb = -(-u.shape[1] // 128)
        up = np.full(nb * 128, _NEG_INF, np.float32)
        up[: u.shape[1]] = u[r]
        up = up.reshape(nb, 128)
        kb = min(n_cand, nb)
        if _straddles(up.max(1), kb):
            ties.add(r)
        elif _straddles(up[_kept(up.max(1), kb)].ravel(), min(n_cand, kb * 128)):
            ties.add(r)
    return ties


def _blockmax_tie_rows(ph, h, hits, hmax, compute_short, n_cand, blk, kb_lanes):
    ts = ph.device.n_short
    u, wpad, nqg_f = _long_bounds(ph, h, hits)
    nblk = hits.shape[1] // blk
    if hmax is None:
        hmax = hits.reshape(hits.shape[0], nblk, blk).max(2)
    smax = hmax.astype(np.float32) / nqg_f[:, None]
    wblk = wpad.reshape(nblk, blk).max(1)
    ok = (hmax > 0) & (h["nqg"][:, None] > 0) & (smax >= THRESHOLD)
    ub = np.where(wblk[None] >= 0, wblk[None] * smax, wblk[None] * THRESHOLD)
    bmax = np.where(ok, ub, _NEG_INF)
    kb = min(max(kb_lanes // blk, 16) if kb_lanes else n_cand, nblk)
    u_short = _short_bounds(ph, h) if compute_short else None
    ties = set()
    for r in range(hits.shape[0]):
        if _straddles(bmax[r], kb):
            ties.add(r)
            continue
        lanes = u[r].reshape(nblk, blk)[_kept(bmax[r], kb)].ravel()
        if compute_short:
            lanes = np.concatenate([u_short[r], lanes])
        if _straddles(lanes, min(n_cand, (ts if compute_short else 0) + kb * blk)):
            ties.add(r)
    return ties


def _assert_agree(got, want, ties, all_exact=False):
    differ = set(np.flatnonzero((got[4] != want[4]) | (got[0] != want[0])))
    assert differ <= ties, (sorted(differ), sorted(ties))
    both = np.flatnonzero(got[4] & want[4])
    assert both.size
    if all_exact:
        assert got[4].all() and want[4].all()
    for r in both:
        n = min(int(got[0][r]), LIMIT)
        assert min(int(want[0][r]), LIMIT) == n
        for i in (1, 2, 3):  # ids, float32 scores, key lengths: equal
            np.testing.assert_array_equal(got[i][r][:n], want[i][r][:n])


# ---------------------------------------------------------------------------
# block maxima, bounds and selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blk", [128, 256])
def test_block_hmax_matches_jax(case, blk):
    _, _, h = case
    hits = h["hits"]
    nblk = hits.shape[1] // blk
    got = pc.block_hmax(torch.from_numpy(hits), nblk, blk)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jc.block_hmax(jnp.asarray(hits), nblk, blk))
    )
    if blk == 128:  # K1's fused block maxima are the same reduction
        np.testing.assert_array_equal(got.numpy(), h["hmax"])


def test_tight_bound_matches_jax():
    """Ties at the cutoff: where more values reach the k-th than k, the
    bound stays the cutoff; where they do not, it drops below it."""
    v = np.array([
        [5.0, 4.0, 4.0, 3.0, -np.inf, 2.0],   # tie straddles k = 2
        [5.0, 4.0, 3.0, 3.0, 2.0, -np.inf],   # no straddle at k = 2
        [5.0, 5.0, 5.0, 5.0, 5.0, 5.0],       # all tied
        [1.0, -np.inf, -np.inf, -np.inf, -np.inf, -np.inf],  # nothing below
    ], np.float32)
    for k in (1, 2, 3):
        vmin = -np.sort(-v, 1)[:, k - 1]
        got = pc._tight_bound(torch.from_numpy(v), torch.from_numpy(vmin), k)
        want = np.asarray(jc._tight_bound(jnp.asarray(v), jnp.asarray(vmin), k))
        np.testing.assert_array_equal(got.numpy(), want)
    assert got[2].item() == 5.0 and got[3].item() == float("-inf")


@pytest.mark.parametrize("block_sel", [False, True])
def test_select_candidates_matches_jax(block_sel):
    """Distinct bounds (no ties): the same lanes, bounds and guard."""
    rng = np.random.default_rng(3)
    n, n_cand = 3000, 64
    u = rng.permutation(np.arange(6 * n, dtype=np.float32))[: 6 * n].reshape(6, n)
    u = u / np.float32(7.0)
    u[rng.random(u.shape) < 0.6] = _NEG_INF
    u[5, 40:] = _NEG_INF  # covered row
    n_pass = (u > _NEG_INF).sum(1).astype(np.int32)
    ub, sel, u_c, cov = pc._select_candidates(
        torch.from_numpy(u), torch.from_numpy(n_pass), n_cand=n_cand,
        block_sel=block_sel,
    )
    for r in range(u.shape[0]):
        w = jc._select_candidates(
            jnp.asarray(u[r]), jnp.asarray(n_pass[r]), n_cand=n_cand,
            block_sel=block_sel,
        )
        w = [np.asarray(x) for x in w]
        np.testing.assert_array_equal(ub[r].numpy(), w[0])
        fin = w[0] > _NEG_INF
        np.testing.assert_array_equal(sel[r].numpy()[fin], w[1][fin])
        assert u_c[r].item() == float(w[2]) and bool(cov[r]) == bool(w[3])
    assert bool(cov[5]) and not bool(cov[0])


# ---------------------------------------------------------------------------
# the two finishes on identical hits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compute_short", [True, False], ids=["short", "long"])
@pytest.mark.parametrize("block_sel,n_cand", [
    (False, 4096), (False, 16), (True, 4096), (True, 16),
], ids=["plain_wide", "plain_starved", "block_wide", "block_starved"])
def test_dense_hits_finish_matches_jax(case, compute_short, block_sel, n_cand):
    jh, ph, h = case
    h = dict(h)
    if not compute_short:
        h["use_short"] = np.zeros_like(h["use_short"])
    kw = dict(compute_short=compute_short, n_cand=n_cand, n_edge=32,
              top_k=TOP_K, block_sel=block_sel)
    want = _run_jax(jh, h, functools.partial(jc._dense_hits_finish, with_bound=False),
                    h["hits"], **kw)
    got = _run_port(ph, h, pc._dense_hits_finish, h["hits"], **kw)
    ties = _dense_tie_rows(ph, h, h["hits"], compute_short, n_cand, block_sel)
    _assert_agree(got, want, ties, all_exact=n_cand == 4096)
    if n_cand == 16:
        assert not got[4].all(), "starved selection should fail some guards"


@pytest.mark.parametrize("compute_short", [True, False], ids=["short", "long"])
@pytest.mark.parametrize("fused,blk,kb_lanes,n_cand", [
    (True, 128, 0, 4096), (False, 128, 0, 16), (False, 256, 0, 64),
    (True, 128, 4096, 64),
], ids=["k1_wide", "hmax_none_starved", "hmax_none_blk256", "k1_kb_lanes"])
def test_blockmax_finish_matches_jax(case, compute_short, fused, blk, kb_lanes,
                                     n_cand):
    jh, ph, h = case
    h = dict(h)
    if not compute_short:
        h["use_short"] = np.zeros_like(h["use_short"])
    hmax = h["hmax"] if fused else None
    kw = dict(compute_short=compute_short, n_cand=n_cand, n_edge=32,
              top_k=TOP_K, blk=blk, kb_lanes=kb_lanes)
    want = _run_jax(
        jh, h, functools.partial(
            jc._blockmax_finish, with_bound=False,
            hmax=None if hmax is None else jnp.asarray(hmax),
        ), h["hits"], **kw,
    )
    got = _run_port(
        ph, h, functools.partial(
            pc._blockmax_finish,
            hmax=None if hmax is None else torch.from_numpy(hmax),
        ), h["hits"], **kw,
    )
    ties = _blockmax_tie_rows(ph, h, h["hits"], hmax, compute_short, n_cand,
                              blk, kb_lanes)
    _assert_agree(got, want, ties, all_exact=n_cand == 4096)
    if n_cand == 16:
        assert not got[4].all(), "starved selection should fail some guards"


@pytest.mark.parametrize("block_sel,fused", [(False, False), (True, False), (True, True)],
                         ids=["dense_hits", "blockmax_k2", "blockmax_k1"])
def test_front_end_non_hstar_matches_jax(case, block_sel, fused):
    """candidates_bitmap_mxu without h* (K1's or K2's plain version on CPU)
    against the JAX front end with its kernel in interpret mode, at the
    reference test's budgets."""
    jh, ph, h = case
    bm_j, _ = jh.bitmap_tables()
    bm_p, _ = ph.bitmap_tables()
    pt_j, xt_j = jh.prim_tables()
    pt_p, xt_p = ph.prim_tables()
    keys = ("qtok", "qlens", "slots", "nqg", "use_short", "promo", "promo_t",
            "promo_w", "lim")
    kw = dict(compute_short=True, n_cand=64, n_edge=32, top_k=TOP_K,
              block_sel=block_sel, fused_bmax=fused)
    want = [np.asarray(x) for x in jc.candidates_bitmap_mxu(
        jh.device, bm_j, pt_j, xt_j, *[jnp.asarray(h[k]) for k in keys],
        THRESHOLD, interpret=True, **kw,
    )]
    calls = (pbm.K1_REF_CALLS, pbm.K2_REF_CALLS)
    got = [x.numpy() for x in pc.candidates_bitmap_mxu(
        ph.device, bm_p, pt_p, xt_p,
        *[torch.from_numpy(np.ascontiguousarray(h[k])) for k in keys],
        THRESHOLD, **kw,
    )]
    k1 = block_sel and fused
    assert (pbm.K1_REF_CALLS, pbm.K2_REF_CALLS) == (calls[0] + k1, calls[1] + (not k1))
    if block_sel:
        ties = _blockmax_tie_rows(ph, h, h["hits"], h["hmax"] if fused else None,
                                  True, 64, 128, 0)
    else:
        ties = _dense_tie_rows(ph, h, h["hits"], True, 64, False)
    _assert_agree(got, want, ties)


# ---------------------------------------------------------------------------
# the engine's weighted and wide bitmap routes
# ---------------------------------------------------------------------------


_ROUTE_KEYS = ("variant", "hstar", "block_sel", "n_cand", "fused_bmax")


def _jax_kernel_engine(monkeypatch, jh):
    """The JAX engine with its bitmap kernel in interpret mode and its
    backend reported as "tpu", as tests/test_candidates_bitmap.py drives it."""
    monkeypatch.setattr(
        jc, "candidates_bitmap_mxu",
        functools.partial(jc.candidates_bitmap_mxu, interpret=True),
    )
    monkeypatch.setattr(jemod.jax, "default_backend", lambda: "tpu")
    je = JEngine(jh)
    je.GM_BUDGET = 0
    je.CAND_MIN_TERMS = 100
    return je


def _queries(words, n, seed):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        w = words[rng.randrange(len(words))]
        j = rng.randrange(max(len(w) - 1, 1))
        out.append(w if i % 3 == 0 else w[:j] + "x" + w[j + 1:])
    return out


@pytest.mark.parametrize("setting", ["dense_hits", "blockmax_k2", "blockmax_k1"])
def test_engine_weighted_route_matches_jax(case, monkeypatch, setting):
    jh, ph, _ = case
    je = _jax_kernel_engine(monkeypatch, jh)
    pe = PEngine(ph)
    pe.GM_BUDGET = 0
    pe.CAND_MIN_TERMS = 100
    for eng in (je, pe):
        if setting != "dense_hits":  # lane space >= 4 * n_cand blocks
            eng.CAND_TERMS_FAST, eng.CAND_TERMS = 16, 64
        eng.BITMAP_FUSED_BMAX = setting == "blockmax_k1"
    words = ph.key_strings.tolist()
    queries = _queries(words, 24, seed=5)
    calls = (pbm.K1_REF_CALLS, pbm.K2_REF_CALLS)
    got = pe.search_batch(queries, 0.25, 10, mode="candidates")
    want = je.search_batch(queries, 0.25, 10, mode="candidates")
    for k in _ROUTE_KEYS:
        assert pe.last_routing[k] == je.last_routing[k], k
    assert pe.last_routing["variant"] == "bitmap_kernel"
    assert pe.last_routing["hstar"] is False
    assert pe.last_routing["block_sel"] is (setting != "dense_hits")
    k1 = setting == "blockmax_k1"
    assert pbm.K1_REF_CALLS > calls[0] if k1 else pbm.K2_REF_CALLS > calls[1]
    dense = pe.search_batch(queries, 0.25, 10, mode="dense")
    for q, g, w, d in zip(queries, got, want, dense):
        assert _groups(g) == _groups(w) == _groups(d), q


def _wide_words(n=1500, seed=3):
    """CJK and accented Latin strings (bench.py's wide corpus alphabet)."""
    rng = np.random.default_rng(seed)
    pool = [chr(c) for c in range(0x4E00, 0x4E18)] + list("àáâäåçèéêë") + list("abcdefghij ")
    lens = rng.integers(4, 14, n)
    out = ["".join(rng.choice(pool, size=k)).strip() or "pad" for k in lens]
    return sorted(set(out))


@pytest.mark.parametrize("block_sel", [False, True], ids=["dense_hits", "blockmax"])
def test_engine_wide_g2_route_matches_jax(monkeypatch, block_sel):
    """A wide gSize-2 index (uniform weights, a lane space under the h*
    budgets) routes bitmap_kernel without h*: K2 and the dense-hits finish,
    or - with the lane space over 4 * n_cand blocks - the blockmax finish on
    K1's block maxima (h* eligibility forces the fused epilogue)."""
    words = _wide_words()
    jh = jbuild(words, 1, None, JConfig(wide=True, gram_size=2))
    ph = pbuild(words, 1, None, IndexConfig(wide=True, gram_size=2), device="cpu")
    je = _jax_kernel_engine(monkeypatch, jh)
    pe = PEngine(ph)
    pe.GM_BUDGET = 0
    pe.CAND_MIN_TERMS = 100
    if block_sel:
        for eng in (je, pe):
            eng.CAND_TERMS_FAST, eng.CAND_TERMS = 16, 64
    queries = _queries(words, 20, seed=9)
    calls = (pbm.K1_REF_CALLS, pbm.K2_REF_CALLS)
    got = pe.search_batch(queries, 0.3, 10, mode="candidates")
    want = je.search_batch(queries, 0.3, 10, mode="candidates")
    for k in _ROUTE_KEYS:
        assert pe.last_routing[k] == je.last_routing[k], k
    assert pe.last_routing["variant"] == "bitmap_kernel"
    assert pe.last_routing["hstar"] is False and pe.last_routing["fused_bmax"] is True
    assert pe.last_routing["block_sel"] is block_sel
    if block_sel:
        assert pbm.K1_REF_CALLS > calls[0]
    else:
        assert pbm.K2_REF_CALLS > calls[1]
    dense = pe.search_batch(queries, 0.3, 10, mode="dense")
    for q, g, w, d in zip(queries, got, want, dense):
        assert _groups(g) == _groups(w) == _groups(d), q
