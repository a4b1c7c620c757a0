"""The PyTorch port's gram-axis split (parallel.tp) against the JAX
package's on the CPU: the reference's tests/test_tp.py mirrored - the JAX
engine on the virtual 8-device mesh, the port on ``make_mesh(8, "grams",
device="cpu")`` - plus the summed hits bit-identical to the single-card
``gather_hits`` and to the JAX package's psum, and the conversion of the
reference's gram-sharded state.  Results compare as identical ids and
scores (float32 in both packages, exactly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringsearchlib_tpu.config import IndexConfig as JConfig
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.parallel import tp as jtp
from stringsearchlib_tpu.parallel.dist import make_mesh as jmake_mesh
from stringsearchlib_tpu.search.overlap import gather_hits as jgather_hits
from stringsearchlib_tpu_torch.config import IndexConfig
from stringsearchlib_tpu_torch.index.build import build_index
from stringsearchlib_tpu_torch.index.convert import gram_sharded_index_from_arrays
from stringsearchlib_tpu_torch.parallel.dist import make_mesh, replicate
from stringsearchlib_tpu_torch.parallel.tp import (
    GramShardedEngine, _summed_hits, shard_index_by_grams,
)
from stringsearchlib_tpu_torch.search.engine import SearchEngine
from stringsearchlib_tpu_torch.search.overlap import gather_hits

AXIS = "grams"


def _corpus(n=800, seed=31):
    rng = np.random.default_rng(seed)
    syll = ["KA", "LO", "ME", "RI", "SU", "TA", "VE", "NOR", "BEL", "X Q"]
    return [
        "".join(rng.choice(syll, size=rng.integers(2, 6)))
        for _ in range(n)
    ]


QUERIES = [
    "KALOME", "NORBEL", "KA", "A", "SURI", "MEXX", "*", "", "ZZZZZZ",
    "X QKA", "BELNORTAVE",
]


def _same(got, want, what=""):
    assert list(got[0]) == list(want[0]), what
    assert list(got[1]) == list(want[1]), what


@pytest.fixture(scope="module")
def engines():
    words = _corpus()
    host = build_index(words, 1, None, IndexConfig(), device="cpu")
    jhost = jbuild(words, 1, None, JConfig(), to_device=False)
    gx = shard_index_by_grams(host, 8)
    jgx = jtp.shard_index_by_grams(jhost, 8)
    tp_eng = GramShardedEngine(gx, make_mesh(8, AXIS, device="cpu"))
    jtp_eng = jtp.GramShardedEngine(jgx, jmake_mesh(8, AXIS))
    return SearchEngine(host), tp_eng, jtp_eng, words


def test_tp_shards_cover_all_postings(engines):
    _, tp_eng, jtp_eng, _ = engines
    gx = tp_eng.gx
    total = int(gx.host_shard_posting_lens.sum())
    assert total == int(gx.host.device.gram_ptr[-1])
    # each gram's postings live on exactly one shard
    per_gram = gx.host_shard_posting_lens
    owners = (per_gram > 0).sum(axis=0)
    lens = np.diff(gx.host.device.gram_ptr.numpy())
    assert np.all(owners == (lens > 0).astype(owners.dtype))
    # and the split equals the reference's bit for bit
    assert gx.g_c == jtp_eng.gx.g_c
    assert set(gx.leaves) == set(jtp_eng.gx.leaves)
    for name, want in jtp_eng.gx.leaves.items():
        assert gx.leaves[name].dtype == want.dtype, name
        assert np.array_equal(gx.leaves[name], want), name
    assert np.array_equal(per_gram, jtp_eng.gx.host_shard_posting_lens)


@pytest.mark.parametrize("threshold,limit", [(0.0, 10), (0.3, 5), (0.2, 0)])
def test_tp_matches_single_chip(engines, threshold, limit):
    ref, tp_eng, jtp_eng, _ = engines
    got = tp_eng.search_batch(QUERIES, threshold, limit)
    jgot = jtp_eng.search_batch(QUERIES, threshold, limit)
    for q, g, jg in zip(QUERIES, got, jgot):
        _same(g, ref.search(q, threshold, limit), (q, threshold, limit))
        _same(g, jg, (q, threshold, limit))


def test_tp_dense_mode_matches(engines):
    ref, tp_eng, jtp_eng, _ = engines
    got = tp_eng.search_batch(QUERIES, 0.25, 8, mode="dense")
    jgot = jtp_eng.search_batch(QUERIES, 0.25, 8, mode="dense")
    for q, g, jg in zip(QUERIES, got, jgot):
        _same(g, ref.search(q, 0.25, 8), q)
        _same(g, jg, q)


def test_tp_candidates_mode_matches(engines):
    """The candidate back half on the summed hits (this corpus is below
    CAND_MIN_TERMS, so the reference's test reaches it only when forced)."""
    ref, tp_eng, jtp_eng, _ = engines
    got = tp_eng.search_batch(QUERIES, 0.25, 8, mode="candidates")
    jgot = jtp_eng.search_batch(QUERIES, 0.25, 8, mode="candidates")
    for q, g, jg in zip(QUERIES, got, jgot):
        _same(g, ref.search(q, 0.25, 8), q)
        _same(g, jg, q)


def test_tp_single_query_entry(engines):
    ref, tp_eng, jtp_eng, _ = engines
    for q in ("KALOME", "*", "A"):
        got = tp_eng.search(q, 0.1, 7)
        assert got == ref.search(q, 0.1, 7)
        _same(got, jtp_eng.search(q, 0.1, 7), q)


def test_tp_weighted_2d_rows():
    """2D rows with weights (multi-edge promo keys, weight-0 drops) must
    match the dense engine through the summed path."""
    words = _corpus(240, seed=41)
    flat, weights = [], []
    for j, k in enumerate(words):
        flat += [k, k[1:] + "X"]
        weights += [1.0, 0.0 if j % 5 == 0 else 0.5]
    host = build_index(flat, 2, weights, IndexConfig(), device="cpu")
    jhost = jbuild(flat, 2, weights, JConfig(), to_device=False)
    tp_eng = GramShardedEngine(
        shard_index_by_grams(host, 8), make_mesh(8, AXIS, device="cpu")
    )
    jtp_eng = jtp.GramShardedEngine(
        jtp.shard_index_by_grams(jhost, 8), jmake_mesh(8, AXIS)
    )
    ref = SearchEngine(host)
    qs = [words[0], words[3][1:] + "X", words[5][:-1], "*", "QQQQ"]
    got = tp_eng.search_batch(qs, 0.2, 12)
    jgot = jtp_eng.search_batch(qs, 0.2, 12)
    for q, g, jg in zip(qs, got, jgot):
        _same(g, ref.search(q, 0.2, 12), q)
        _same(g, jg, q)
    # exact-match promotion must reach 100 through the summed path
    assert got[0][1][0] == 100.0


def test_tp_summed_hits_bit_identical(engines):
    """Per-shard hits summed on the first device equal the single-card
    ``gather_hits`` on the whole index and the JAX package's psum."""
    ref, tp_eng, jtp_eng, words = engines
    items = []
    for pos, q in enumerate(["KALOME", "NORBEL", "X QKA", "BELNORTAVE",
                             "SURIKAVE", words[3], words[9], "ZZZZZZ"]):
        qn, ql = tp_eng._normalize_query(q)
        items.append((pos, qn, ql, None))
    qp = tp_eng._chunk_qp(items)
    b, qtok, qlens, slots, nqg, use_short, _, _ = tp_eng._prep_rows(items, qp)
    s_cap = tp_eng._s_cap(slots, len(items))
    shards = tp_eng._leaves()
    qbufs = replicate((qtok, qlens, slots, nqg, use_short), tp_eng.mesh.row_devices)
    got = _summed_hits(tp_eng.mesh, shards, qbufs, tp_eng.gx.g_c,
                       int(shards[0]["long_lengths"].shape[0]), s_cap)
    di = ref.host.device
    full_cap = 1 << max(int(np.ceil(np.log2(max(int(di.gram_ptr[-1]), 1)))), 10)
    want = gather_hits(di.gram_ptr, di.gram_terms, torch.from_numpy(slots),
                       di.n_long, full_cap)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(got.sum()) > 0

    # the reference's per-shard hits (its _local_hits at each axis index), summed
    jlv = jtp_eng.gx.leaves
    jsum = sum(
        np.asarray(jax.vmap(lambda row, i=i: jgather_hits(
            jnp.asarray(jlv["gram_ptr"][i]), jnp.asarray(jlv["gram_terms"][i]),
            row, di.n_long, s_cap))(jnp.asarray(np.where(
                (slots >= 0) & (slots - i * jtp_eng.gx.g_c >= 0)
                & (slots - i * jtp_eng.gx.g_c < jtp_eng.gx.g_c),
                slots - i * jtp_eng.gx.g_c, -1).astype(np.int32))))
        for i in range(8)
    )
    np.testing.assert_array_equal(got.numpy(), jsum)


def test_gram_sharded_index_from_arrays(engines):
    ref, tp_eng, jtp_eng, _ = engines
    jgx = jtp_eng.gx
    gx = gram_sharded_index_from_arrays(
        tp_eng.host, jgx.leaves, dict(n_shards=jgx.n_shards, g_c=jgx.g_c),
        jgx.host_shard_posting_lens,
    )
    eng = GramShardedEngine(gx, make_mesh(8, AXIS, device="cpu"))
    for g, w in zip(eng.search_batch(QUERIES, 0.2, 10),
                    tp_eng.search_batch(QUERIES, 0.2, 10)):
        _same(g, w)
    with pytest.raises(KeyError):
        gram_sharded_index_from_arrays(
            tp_eng.host, {k: v for k, v in jgx.leaves.items() if k != "xt"},
            dict(n_shards=8, g_c=jgx.g_c), jgx.host_shard_posting_lens,
        )


def test_gram_sharded_engine_defaults_to_the_card(engines):
    """No mesh: the CUDA cards, or a RuntimeError without one."""
    gx = engines[1].gx
    if torch.cuda.is_available():
        assert GramShardedEngine(shard_index_by_grams(gx.host, 1)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            GramShardedEngine(gx)
