"""The unpacked bucket sketch of the PyTorch port against the JAX package.

The (D, Tl) int8 incidence and the term->gram table (device and host
builds), the sketch hits and their block maxima at <= 127 and > 127 gram
windows (int8 and int32 counts), the batched sketch front end, and the
engine's ``sketch`` route - which the JAX engine takes on the CPU - against
the JAX engine, the oracle and the port's dense path.  Integer tensors are
compared bit for bit, float32 maxima and scores exactly.  ``torch._int_mm``
on the card is held against the CPU product in tests/test_torch_gpu.py and
chip_smoke.py."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from stringsearchlib_tpu.config import IndexConfig
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.search import sketch as jsk
from stringsearchlib_tpu.search.engine import SearchEngine as JEngine
from stringsearchlib_tpu.utils.oracle import OracleIndex
from stringsearchlib_tpu_torch.index.build import build_index as pbuild
from stringsearchlib_tpu_torch.ops import bitmap_matmul as pbm
from stringsearchlib_tpu_torch.search import candidates as pc
from stringsearchlib_tpu_torch.search import sketch as psk
from stringsearchlib_tpu_torch.search.engine import SearchEngine as PEngine
from stringsearchlib_tpu_torch.utils.oracle import OracleIndex as POracle

THRESHOLD = np.float32(0.25)


def _corpus(n, seed=3, alpha="ABCDEFGHIJKLMNOP", lo=4, hi=20):
    rng = np.random.default_rng(seed)
    return [
        "".join(rng.choice(list(alpha), size=rng.integers(lo, hi)))
        for _ in range(n)
    ]


def _rows2d(n, seed=5):
    """bench.py's 2-D layout at a small size: (product name, gram-rich
    description) rows with weights [1.0, 0.4]."""
    names = bench._product_names(n, seed=seed)
    descs = bench._rich_names(n, seed=seed + 1)
    return [x for kv in zip(names, descs) for x in kv], [1.0, 0.4] * n


def _tl_pad(host):
    tl = int(host.device.long_lengths.shape[0])
    return -(-tl // psk._TILE) * psk._TILE


def _budget(host, d_log2):
    """SKETCH_BUDGET that makes the unpacked sketch_tables pick d_log2."""
    return (1 << d_log2) * _tl_pad(host)


def _groups(res):
    out: dict = {}
    for k, s in zip(*res):
        out.setdefault((round(float(s), 5), len(k)), set()).add(k)
    return out


def _long_queries(rng, words, n, min_len=140):
    """Joined mutated rows: more than 127 gram windows each."""
    out = []
    while len(out) < n:
        q = " ".join(bench._mutate(rng, rng.choice(words)) for _ in range(12))
        if len(q) >= min_len:
            out.append(q[:200])
    return out


# ---------------------------------------------------------------------------
# the table builds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def narrow_pair():
    words = _corpus(2500, seed=11)
    return (jbuild(words, 1, None, IndexConfig()),
            pbuild(words, 1, None, IndexConfig(), device="cpu"), words)


@pytest.mark.parametrize("d_log2", [7, 10])
def test_unpacked_device_build_matches_jax(narrow_pair, d_log2):
    jh, ph, _ = narrow_pair
    d = jh.device
    tlp = _tl_pad(ph)
    tgw = int(d.long_tokens.shape[1]) - 2
    inc_j, tg_j = (np.asarray(x) for x in jsk.build_sketch_device(
        d.long_tokens, d.long_lengths, jnp.asarray(jh.gram_ids.astype(np.int32)),
        gram_size=3, d_log2=d_log2, tl_pad=tlp, tgw=tgw,
    ))
    pd = ph.device
    inc_p, tg_p = psk.build_sketch_device(
        pd.long_tokens, pd.long_lengths,
        torch.from_numpy(ph.gram_ids.astype(np.int32)),
        gram_size=3, d_log2=d_log2, tl_pad=tlp, tgw=tgw,
    )
    assert inc_p.dtype == torch.int8 and inc_p.shape == (1 << d_log2, tlp)
    assert inc_p.stride() == (1, 1 << d_log2)  # column-major, for _int_mm
    np.testing.assert_array_equal(inc_p.numpy(), inc_j)
    np.testing.assert_array_equal(tg_p.numpy(), tg_j)
    # through the index: the budget picks d_log2; both packages cache the
    # table per index and mode
    ph._sketch_cache = jh._sketch_cache = None
    got = ph.sketch_tables(_budget(ph, d_log2), packed=False)
    want = jh.sketch_tables(_budget(ph, d_log2), packed=False)
    assert got[3] == want[3] == d_log2
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert ph.sketch_tables(_budget(ph, d_log2), packed=False) is got
    ph._sketch_cache = jh._sketch_cache = None


@pytest.mark.parametrize("cfg", [IndexConfig(wide=True), IndexConfig(gram_size=4),
                                 IndexConfig(wide=True, gram_size=4)],
                         ids=["wide_g3", "narrow_g4", "wide_g4"])
def test_unpacked_host_build_matches_jax(cfg):
    """Wide strings and g = 4 build ``tg`` from numpy gram ids."""
    rng = np.random.default_rng(23)
    alpha = list("ABCDEFÉÜ中文日本") if cfg.wide else list("ABCDEFGH")
    words = ["".join(rng.choice(alpha, size=rng.integers(5, 16))) for _ in range(700)]
    jh = jbuild(words, 1, None, cfg)
    ph = pbuild(words, 1, None, cfg, device="cpu")
    got = ph.sketch_tables(_budget(ph, 8), packed=False)
    want = jh.sketch_tables(_budget(ph, 8), packed=False)
    assert got[3] == want[3] == 8
    assert got[0].shape == (256, _tl_pad(ph))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the hits and block maxima, captured from the reference's own front end
# ---------------------------------------------------------------------------


class _Captured(Exception):
    pass


def _jax_hits_blockmax(monkeypatch, jh, tables, h, **kw):
    """The reference's ``candidates_sketch_impl(packed=False)`` run up to
    its per-query body, whose batched inputs - the hits and the block
    maxima - are captured and returned."""
    inc, tg, wmax_pad, d_log2 = tables
    seen = {}

    class _Jax:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def vmap(fn, *a, **k):
            if getattr(fn, "__name__", "") != "one":
                return jax.vmap(fn, *a, **k)

            def grab(args):
                seen["hits"], seen["bmax"] = args[-2], args[-1]
                raise _Captured

            return grab

    monkeypatch.setattr(jsk, "jax", _Jax())
    pt, xt = jh.prim_tables()
    with pytest.raises(_Captured):
        jsk.candidates_sketch_impl(
            jh.device, jnp.asarray(inc), jnp.asarray(tg), jnp.asarray(wmax_pad),
            pt, xt, *[jnp.asarray(h[k]) for k in _KEYS], THRESHOLD,
            d_log2=d_log2, packed=False, **kw,
        )
    monkeypatch.undo()
    return np.asarray(seen["hits"]), np.asarray(seen["bmax"])


_KEYS = ("qtok", "qlens", "slots", "nqg", "use_short", "promo", "promo_t",
         "promo_w", "lim")


def _prep(eng, host, queries, qp, limit=10):
    """The JAX engine's host front end: the batch's device operands."""
    items = []
    for pos, q in enumerate(queries):
        qnorm, qlen = eng._normalize_query(q)
        items.append((pos, qnorm, qlen, host.promo_key_ids(qnorm, qlen)))
    b, qtok, qlens, slots, nqg, use_short, _ = eng._prep_rows(items, qp)
    promo = np.full((b, eng.PROMO_KEYS), -1, np.int32)
    for r, it in enumerate(items):
        promo[r, : it[3].size] = it[3]
    promo_t, promo_w = eng._promo_tables(promo)
    return dict(qtok=qtok, qlens=qlens, slots=slots, nqg=nqg, use_short=use_short,
                promo=promo, promo_t=promo_t, promo_w=promo_w,
                lim=np.full((b,), limit, np.int32))


@pytest.fixture(scope="module")
def front_case():
    """A weighted 2-D index over two superblocks of terms built by both
    packages; JAX's unpacked sketch tables carried over as numpy; short
    queries (<= 127 windows) and joined long ones (> 127)."""
    words, weights = _rows2d(9000, seed=7)
    for i in range(1, len(words), 40):  # some descriptions in the short tier
        words[i] = words[i][: 3 + i % 3]
    jh = jbuild(words, 2, weights, IndexConfig())
    ph = pbuild(words, 2, weights, IndexConfig(), device="cpu")
    assert _tl_pad(ph) // psk._TILE == 2 and ph.device.n_short > 0
    sk = jh.sketch_tables(_budget(ph, 9), packed=False)
    tables = [np.array(x) for x in sk[:3]] + [sk[3]]
    eng = JEngine(jh)
    rng = random.Random(7)
    short = [bench._mutate(rng, rng.choice(words)) for _ in range(20)]
    short += [words[i] + "x" for i in range(41, 400, 80)]
    long_q = _long_queries(rng, words, 12)
    return jh, ph, tables, {
        "short": _prep(eng, jh, short, 32), "long": _prep(eng, jh, long_q, 256),
    }


@pytest.mark.parametrize("width", ["short", "long"])
def test_unpacked_hits_and_blockmax_match_jax(monkeypatch, front_case, width):
    jh, ph, tables, cases = front_case
    h = cases[width]
    assert (h["slots"].shape[1] <= 127) == (width == "short")
    inc, tg, wmax_pad, d_log2 = tables
    want_h, want_b = _jax_hits_blockmax(
        monkeypatch, jh, tables, h, compute_short=True, n_cand=64,
        n_short_cand=16, ksb=2, kb=64, n_edge=64, top_k=16,
    )
    calls = pc.INT_MM_CALLS
    hits = psk.sketch_hits(
        torch.from_numpy(h["slots"]), torch.from_numpy(inc), d_log2, packed=False
    )
    assert pc.INT_MM_CALLS == calls  # the CPU product, not torch._int_mm
    assert hits.dtype == (torch.int8 if width == "short" else torch.int32)
    assert str(want_h.dtype) == str(hits.dtype).split(".")[1]
    np.testing.assert_array_equal(hits.numpy(), want_h)
    nqg = torch.from_numpy(h["nqg"])
    bmax = psk._sketch_blockmax(
        hits, nqg, torch.clamp(nqg.float(), min=1.0), torch.from_numpy(wmax_pad),
        float(THRESHOLD),
    )
    assert bmax.dtype == torch.float32
    np.testing.assert_array_equal(bmax.numpy(), want_b)
    if width == "long":
        assert int(h["nqg"].max()) > 127  # window counts past int8
    else:
        # the same bound through the packed sketch and K2's plain version
        packed = ph.sketch_tables(_budget(ph, 9) // 8)
        assert packed[3] == d_log2
        q = pc.query_counts(psk.bucket_of(torch.from_numpy(h["slots"]), d_log2),
                            1 << d_log2)
        assert torch.equal(pbm.bitmap_hits_ref(q, packed[0]), hits)
        ph._sketch_cache = None


def test_unpacked_hits_digits_and_slabs(monkeypatch):
    """Counts past 127 need two base-128 digits on the card; on the CPU the
    product runs in column slabs: both exact against a numpy product."""
    rng = np.random.default_rng(5)
    inc = torch.from_numpy(rng.integers(0, 2, size=(128, 3 * psk._TILE), dtype=np.int8))
    q = torch.from_numpy(rng.integers(0, 300, size=(5, 128)).astype(np.int32))
    want = q.numpy().astype(np.int64) @ inc.numpy().astype(np.int64)
    monkeypatch.setattr(psk, "_MM_SLAB_BYTES", 4 * (5 + 128) * psk._TILE)
    for layout in (inc, inc.t().contiguous().t()):  # row- and column-major
        got = psk.unpacked_hits(q, layout, 300)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    small = q % 2
    got8 = psk.unpacked_hits(small, inc, 127)
    assert got8.dtype == torch.int8
    np.testing.assert_array_equal(got8.numpy(), small.numpy() @ inc.numpy().astype(np.int32))


@pytest.mark.parametrize("width", ["short", "long"])
def test_candidates_sketch_unpacked_matches_jax(front_case, width):
    """The whole front end at budgets wide enough that no selection tie
    straddles a cutoff: equal exact flags, counts and result tie groups."""
    jh, ph, tables, cases = front_case
    h = cases[width]
    inc, tg, wmax_pad, d_log2 = tables
    kw = dict(d_log2=d_log2, compute_short=True, n_cand=4096,
              n_short_cand=ph.device.n_short, ksb=2, kb=256, n_edge=64, top_k=16)
    pt_j, xt_j = jh.prim_tables()
    want = [np.asarray(x) for x in jsk.candidates_sketch(
        jh.device, jnp.asarray(inc), jnp.asarray(tg), jnp.asarray(wmax_pad),
        pt_j, xt_j, *[jnp.asarray(h[k]) for k in _KEYS], THRESHOLD,
        packed=False, **kw,
    )]
    pt_p, xt_p = ph.prim_tables()
    got = [x.numpy() for x in psk.candidates_sketch(
        ph.device, *[torch.from_numpy(x) for x in (inc, tg, wmax_pad)],
        pt_p, xt_p, *[torch.from_numpy(np.ascontiguousarray(h[k])) for k in _KEYS],
        THRESHOLD, packed=False, **kw,
    )]
    n_rows = int((h["qlens"] > 0).sum())
    np.testing.assert_array_equal(got[4][:n_rows], want[4][:n_rows])
    np.testing.assert_array_equal(got[0][:n_rows], want[0][:n_rows])
    assert got[4][:n_rows].any()
    for r in np.flatnonzero(got[4][:n_rows]):
        n = min(int(got[0][r]), 10)
        g = sorted(zip(-got[2][r][:n], got[3][r][:n], got[1][r][:n]))
        w = sorted(zip(-want[2][r][:n], want[3][r][:n], want[1][r][:n]))
        assert g == w, r


# ---------------------------------------------------------------------------
# the engine's sketch route, as the JAX engine takes it on the CPU
# ---------------------------------------------------------------------------


def _gate(eng, host, d_log2):
    eng.GM_BUDGET = 0
    eng.BITMAP_BUDGET = 0
    eng.SKETCH_MIN_TERMS = 0
    eng.CAND_MIN_TERMS = 0
    eng.SKETCH_BUDGET = _budget(host, d_log2)
    # each query-width group of a batch is small: close the tiny-runs gate
    eng.RUNS_TINY_BATCH = 0
    return eng


@pytest.mark.parametrize("width,weighted", [
    ("short", True), ("long", True), ("short", False),
], ids=["short_2d", "long_2d", "short_uniform"])
def test_sketch_route_matches_jax_and_oracle(width, weighted):
    """The JAX engine on the CPU always takes the unpacked sketch; the port
    takes it with SKETCH_PACKED off, and for > 127 windows with it on."""
    if weighted:
        words, weights = _rows2d(1500, seed=5)
        row = 2
    else:
        words, weights, row = _corpus(3000, seed=9), None, 1
    jh = jbuild(words, row, weights, IndexConfig())
    ph = pbuild(words, row, weights, IndexConfig(), device="cpu")
    je = _gate(JEngine(jh), ph, 8)
    pe = _gate(PEngine(ph), ph, 8)
    pe.SKETCH_PACKED = width == "long"
    rng = random.Random(17)
    if width == "long":
        queries = _long_queries(rng, words, 12)
    else:
        queries = [bench._mutate(rng, rng.choice(words)) if weighted
                   else rng.choice(words)[:-1] + "x" for _ in range(24)]
    oracle = OracleIndex(words, row_size=row, weights=weights)
    port_oracle = POracle(words, row_size=row, weights=weights)
    for thr, lim in ((0.3, 10), (0.0, 100)):
        calls = pc.INT_MM_CALLS
        got = pe.search_batch(queries, thr, lim, mode="candidates")
        want = je.search_batch(queries, thr, lim, mode="candidates")
        assert pc.INT_MM_CALLS == calls
        for k in ("variant", "step", "n_cand", "block_sel"):
            assert pe.last_routing[k] == je.last_routing[k], k
        assert pe.last_routing["variant"] == "sketch"
        assert ph._sketch_cache.keys() == {False}
        dense = pe.search_batch(queries, thr, lim, mode="dense")
        for q, g, w, d in zip(queries, got, want, dense):
            o = oracle.search(q, thr, lim)
            assert _groups(g) == _groups(w) == _groups(d) == _groups(o), q
            assert port_oracle.search(q, thr, lim) == o, q
