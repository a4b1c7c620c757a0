"""End-to-end search through the PyTorch port against the JAX package and
the pure-Python oracle: the SearchTest anchors, the bitmap-kernel + h*
route with its selection and dense retries, and the edge queries."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

from stringsearchlib_tpu import StringSearchIndex as JIndex
from stringsearchlib_tpu.config import IndexConfig
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.search.engine import SearchEngine as JEngine
from stringsearchlib_tpu.utils.oracle import OracleIndex
from stringsearchlib_tpu_torch import StringSearchIndex as PIndex
from stringsearchlib_tpu_torch.index.build import build_index as pbuild
from stringsearchlib_tpu_torch.ops import bitmap_matmul as pbm
from stringsearchlib_tpu_torch.search.engine import SearchEngine as PEngine

FIXTURE = ["LWMS", "LWM", "LWMA", "LWYY", "L", "I", "GHRSDGSDGS Egdsrtg g"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus(n, seed=21):
    rng = random.Random(seed)
    syll = ["ka", "lo", "me", "ri", "su", "ta", "ve", "nor", "bel"]
    return [
        "".join(rng.choice(syll) for _ in range(rng.randint(2, 5)))
        for _ in range(n)
    ]


def _groups(res):
    """(score, key length) tie groups with their keys: the reference leaves
    the order inside a tie unspecified."""
    out: dict = {}
    for k, s in zip(*res):
        out.setdefault((round(float(s), 5), len(k)), set()).add(k)
    return out


def _counts(res):
    return sorted((round(float(s), 5), len(k)) for k, s in zip(*res))


def _queries(words, n, seed):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        w = words[rng.randrange(len(words))]
        j = rng.randrange(max(len(w) - 1, 1))
        out.append(w if i % 3 == 0 else w[:j] + "x" + w[j + 1:])
    return out


def test_search_test_anchors():
    idx = PIndex(FIXTURE, row_size=1, device="cpu")
    assert idx.size() == 7 and idx.lib_size() == 16
    strings, scores = idx.score("LWMS", 0.5, limit=0)
    assert len(strings) == 4 and strings[0] == "LWMS" and scores[0] == 100.0
    ref = JIndex(FIXTURE, row_size=1)
    assert _groups((strings, scores)) == _groups(ref.score("LWMS", 0.5, limit=0))
    assert idx.search("LWMS", 0.5, limit=0) == strings
    idx.set_valid_char("LWMS")
    ref.set_valid_char("LWMS")
    assert _groups(idx.score("LWxMS", 0.1, 0)) == _groups(ref.score("LWxMS", 0.1, 0))


@pytest.fixture(scope="module")
def pair():
    words = _corpus(3000, seed=31)
    jh = jbuild(words, 1, None, IndexConfig())
    ph = pbuild(words, 1, None, IndexConfig(), device="cpu")
    oracle = OracleIndex(words, row_size=1)
    return words, JEngine(jh), PEngine(ph), oracle


@pytest.mark.parametrize("kb", [(4, 8), (1, 1)])
def test_bitmap_kernel_route_matches_jax_and_oracle(pair, monkeypatch, kb):
    """The candidate route (K1's plain version on CPU, h*, selection-only
    retry, dense retry) against the JAX engine and the oracle."""
    words, je, pe, oracle = pair
    monkeypatch.setattr(pe, "GM_BUDGET", 0)
    monkeypatch.setattr(pe, "CAND_MIN_TERMS", 100)
    monkeypatch.setattr(pe, "HSTAR_KB1", kb[0])
    monkeypatch.setattr(pe, "HSTAR_KB2", kb[1])
    sel = []
    orig = pe._hstar_sel_retry

    def spy(ctx, threshold, limit, out):
        sel.append(len(ctx["fails"]))
        return orig(ctx, threshold, limit, out)

    monkeypatch.setattr(pe, "_hstar_sel_retry", spy)
    dense_rows = []
    orig_dense = pe._run_dense_chunks

    def spy_dense(items, *a):
        dense_rows.append(len(items))
        return orig_dense(items, *a)

    monkeypatch.setattr(pe, "_run_dense_chunks", spy_dense)
    queries = _queries(words, 24, seed=5)
    calls = pbm.K1_REF_CALLS
    got = pe.search_batch(queries, 0.25, 10, mode="candidates")
    assert pbm.K1_REF_CALLS > calls
    assert pe.last_routing["variant"] == "bitmap_kernel"
    assert pe.last_routing["hstar"] is True
    assert pe.last_routing["kb2"] == kb[1]
    if kb == (1, 1):
        assert sel and sel[0] > 0, "selection retry never ran"
        assert pe.last_routing["retry_sel"] >= 0
        assert dense_rows, "no row reached the dense retry"
    want = je.search_batch(queries, 0.25, 10, mode="dense")
    for q, g, w in zip(queries, got, want):
        assert _groups(g) == _groups(w), q
        assert _counts(g) == _counts(oracle.search(q, 0.25, 10)), q


def test_dense_and_single_search_match_jax(pair):
    words, je, pe, oracle = pair
    queries = _queries(words, 12, seed=9) + ["ka", "lo", "x", "kalo"]
    got = pe.search_batch(queries, 0.3, 10, mode="dense")
    want = je.search_batch(queries, 0.3, 10, mode="dense")
    for q, g, w in zip(queries, got, want):
        assert _groups(g) == _groups(w), q
        assert _counts(g) == _counts(oracle.search(q, 0.3, 10)), q
    for q in queries[:4] + ["me", "nor"]:
        g, w = pe.search(q, 0.3, 20), je.search(q, 0.3, 20)
        assert _groups(g) == _groups(w), q


def test_edge_queries_match_jax(pair):
    words, je, pe, oracle = pair
    for q in ("*", ""):
        g, w = pe.search(q, 0.0, 0), je.search(q, 0.0, 0)
        assert len(g[0]) == len(w[0]) == len(set(words))
        assert _groups(g) == _groups(w)
    assert pe.search("!!!###", 0.1, 10) == ([], [])
    # brute-force-short queries (qlen <= gram_size) and limit=0 (unbounded)
    qs = ["ka", "me", "bel", "t", "*", "!!!", "kaloveri"]
    got = pe.search_batch(qs, 0.5, 0)
    want = je.search_batch(qs, 0.5, 0)
    for q, g, w in zip(qs, got, want):
        assert _groups(g) == _groups(w), q
        if q not in ("*",):
            assert _counts(g) == _counts(oracle.search(q, 0.5, 0)), q


def test_weighted_index_takes_dense_route(monkeypatch):
    """A weighted index never takes h* (its guard bound needs every edge
    weight to be 1): its batches take the bitmap route with the dense-hits
    finish, and equal the JAX engine's dense results."""
    words = _corpus(1200, seed=33)
    w = np.ones(len(words))
    w[::7] = 0.5
    jh = jbuild(words, 1, w, IndexConfig())
    ph = pbuild(words, 1, w, IndexConfig(), device="cpu")
    assert not ph.uniform_weights
    pe, je = PEngine(ph), JEngine(jh)
    monkeypatch.setattr(pe, "GM_BUDGET", 0)
    monkeypatch.setattr(pe, "CAND_MIN_TERMS", 100)
    queries = [x[:-1] + "x" for x in words[:12]]
    got = pe.search_batch(queries, 0.25, 10, mode="candidates")
    assert pe.last_routing["variant"] == "bitmap_kernel"
    assert pe.last_routing["hstar"] is False
    assert pe.last_routing["block_sel"] is False
    want = je.search_batch(queries, 0.25, 10, mode="dense")
    for q, g, wnt in zip(queries, got, want):
        assert _groups(g) == _groups(wnt), q


def test_port_imports_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import stringsearchlib_tpu_torch as P;"
        "idx = P.StringSearchIndex(['LWMS', 'LWM', 'LWMA', 'LWYY', 'L', 'I'],"
        " device='cpu');"
        "r = idx.score('LWMS', 0.5, 0); assert r[0][0] == 'LWMS', r;"
        "assert 'jax' not in sys.modules, 'jax imported';"
        "print('ok')"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code, ROOT], capture_output=True, text=True,
        timeout=300, env=env, cwd=os.path.dirname(ROOT),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    pkg = os.path.join(ROOT, "stringsearchlib_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                assert "import jax" not in src and "from jax" not in src, f
