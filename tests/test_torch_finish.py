"""The integer h* finish and the selection-only retry in the PyTorch port
against the JAX package, fed the same hits and block maxima (the JAX
kernel's output in interpret mode)."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringsearchlib_tpu.config import IndexConfig
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.ops.bitmap_matmul import bitmap_hits_bmax
from stringsearchlib_tpu.search import candidates as jc
from stringsearchlib_tpu.search.engine import SearchEngine as JEngine
from stringsearchlib_tpu_torch.index.build import build_index as pbuild
from stringsearchlib_tpu_torch.search import candidates as pc

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


@pytest.fixture(scope="module")
def case():
    """One index built by both packages, 8 queries prepared by the JAX
    engine's host front end, and the JAX kernel's hits / block maxima."""
    words = _corpus(2500)
    jh = jbuild(words, 1, None, IndexConfig())
    ph = pbuild(words, 1, None, IndexConfig(), device="cpu")
    eng = JEngine(jh)
    rng = random.Random(13)
    queries = []
    for i in range(8):
        w = words[rng.randrange(len(words))]
        queries.append(w if i % 2 else w[:-1] + "x")
    items = []
    for pos, q in enumerate(queries):
        qnorm, qlen = eng._normalize_query(q)
        items.append((pos, qnorm, qlen, jh.promo_key_ids(qnorm, qlen)))
    b, qtok, qlens, slots, nqg, use_short, _ = eng._prep_rows(items, 32)
    promo = np.full((b, eng.PROMO_KEYS), -1, np.int32)
    for r, it in enumerate(items):
        promo[r, : it[3].size] = it[3]
    promo_t, promo_w = eng._promo_tables(promo)
    lim = np.full((b,), LIMIT, np.int32)
    bm, _ = jh.bitmap_tables()
    gp = int(bm.shape[1])
    qcnt = np.zeros((b, gp), np.float32)
    for r in range(b):
        for s in slots[r]:
            if s >= 0:
                qcnt[r, s] += 1
    hits, hmax = bitmap_hits_bmax(
        jnp.asarray(qcnt, jnp.bfloat16), bm, interpret=True, int8_dots=True
    )
    host = dict(
        qtok=qtok, qlens=qlens, nqg=nqg, use_short=use_short, promo=promo,
        promo_t=promo_t, promo_w=promo_w, lim=lim,
        hits=np.asarray(hits), hmax=np.asarray(hmax), vmax=int(slots.shape[1]),
        slots=slots,
    )
    return jh, ph, host


_KEYS = ("hits", "hmax", "qtok", "qlens", "nqg", "use_short", "promo",
         "promo_t", "promo_w", "lim")


def _call(fn, di, pt, xt, a, retry):
    # _hstar_finish takes (di, pt, xt, hits, hmax, ...), hstar_retry
    # (di, hits, hmax, pt, xt, ...) - in both packages
    if retry:
        return fn(di, a[0], a[1], pt, xt, *a[2:], THRESHOLD)
    return fn(di, pt, xt, *a, THRESHOLD)


def _run_jax(jh, h, rows, fn, retry=False):
    pt, xt = jh.prim_tables()
    a = [jnp.asarray(h[k][rows]) for k in _KEYS]
    return [np.asarray(x) for x in _call(fn, jh.device, pt, xt, a, retry)]


def _run_port(ph, h, rows, fn, retry=False):
    pt, xt = ph.prim_tables()
    a = [torch.from_numpy(np.ascontiguousarray(h[k][rows])) for k in _KEYS]
    return [x.numpy() for x in _call(fn, ph.device, pt, xt, a, retry)]


def _assert_agree(got, want, must_be_exact=False):
    """Equal exact flags; on exact rows equal counts (as the host emits
    them) and equal leading results."""
    np.testing.assert_array_equal(got[4], want[4])
    if must_be_exact:
        assert got[4].all()
    for r in np.flatnonzero(got[4]):
        assert min(int(got[0][r]), LIMIT) == min(int(want[0][r]), LIMIT)
        n = min(int(got[0][r]), LIMIT, got[1].shape[1])
        np.testing.assert_array_equal(got[1][r][:n], want[1][r][:n])
        np.testing.assert_array_equal(got[2][r][:n], want[2][r][:n])
        np.testing.assert_array_equal(got[3][r][:n], want[3][r][:n])


@pytest.mark.parametrize("compute_short", [True, False])
@pytest.mark.parametrize("kb1,kb2,n_cand", [(64, 64, 4096), (2, 4, 64)])
def test_hstar_finish_matches_jax(case, compute_short, kb1, kb2, n_cand):
    jh, ph, h = case
    h = dict(h)
    if not compute_short:
        h["use_short"] = np.zeros_like(h["use_short"])
    rows = np.arange(h["qtok"].shape[0])
    kw = dict(
        compute_short=compute_short, kb1=kb1, kb2=kb2, n_cand=n_cand,
        n_edge=32, top_k=TOP_K, vmax=h["vmax"], fill=2,
    )
    jfin = jax.jit(
        functools.partial(jc._hstar_finish, with_bound=False, **kw)
    )
    want = _run_jax(jh, h, rows, jfin)
    got = _run_port(ph, h, rows, functools.partial(pc._hstar_finish, **kw))
    _assert_agree(got, want, must_be_exact=kb1 == 64)
    if kb1 == 2:
        assert not got[4].all(), "starved budgets should fail some guards"


def test_hstar_retry_matches_jax(case):
    jh, ph, h = case
    rows = np.arange(h["qtok"].shape[0])
    first = _run_port(ph, h, rows, functools.partial(
        pc._hstar_finish, compute_short=True, kb1=1, kb2=1, n_cand=4096,
        n_edge=32, top_k=TOP_K, vmax=h["vmax"], fill=2,
    ))
    failed = np.flatnonzero(~first[4])
    assert failed.size, "starved budgets should fail at least one guard"
    kw = dict(
        compute_short=True, kb1=64, kb2=64, n_cand=4096, top_k=TOP_K,
        n_edge=32, vmax=h["vmax"],
    )
    want = _run_jax(
        jh, h, failed, functools.partial(jc.hstar_retry, **kw), retry=True
    )
    got = _run_port(
        ph, h, failed, functools.partial(pc.hstar_retry, **kw), retry=True
    )
    _assert_agree(got, want, must_be_exact=True)


def test_front_end_matches_jax_scan(case):
    """candidates_bitmap_mxu (K1's plain version on CPU + h*) against the
    JAX scan front end at generous budgets: every row exact, same results."""
    jh, ph, h = case
    bm_j, _ = jh.bitmap_tables()
    bm_p, _ = ph.bitmap_tables()
    pt_j, xt_j = jh.prim_tables()
    pt_p, xt_p = ph.prim_tables()
    keys = ("qtok", "qlens", "slots", "nqg", "use_short", "promo", "promo_t",
            "promo_w", "lim")
    base = dict(compute_short=True, n_cand=4096, n_edge=32, top_k=TOP_K)
    want = [np.asarray(x) for x in jc.candidates_bitmap(
        jh.device, bm_j, pt_j, xt_j, *[jnp.asarray(h[k]) for k in keys],
        THRESHOLD, **base,
    )]
    got = [x.numpy() for x in pc.candidates_bitmap_mxu(
        ph.device, bm_p, pt_p, xt_p,
        *[torch.from_numpy(np.ascontiguousarray(h[k])) for k in keys],
        THRESHOLD, hstar=True, kb1=64, kb2=64, hs_fill=2, keep_hits=True,
        **base,
    )]
    assert got[4].all()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[5], h["hits"])
    np.testing.assert_array_equal(got[6], h["hmax"])
    for r in range(got[0].shape[0]):
        n = min(int(got[0][r]), TOP_K)
        gs = sorted(zip(got[2][r][:n], got[3][r][:n]))
        ws = sorted(zip(want[2][r][:n], want[3][r][:n]))
        assert gs == ws
