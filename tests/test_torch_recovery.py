"""Failure recovery with the PyTorch port's term-sharded engine: search is
stateless per batch, so recovery = re-shard from host arrays (or reload
from a checkpoint through the port's ``save_index`` / ``load_index``) and
re-run; results must be identical - the reference's tests/test_recovery.py
mirrored on ``make_mesh(n, device="cpu")``, each also held against the JAX
package's sharded engine on the same words."""

import io

from stringsearchlib_tpu.config import IndexConfig as JConfig
from stringsearchlib_tpu.index.build import build_index as jbuild
from stringsearchlib_tpu.parallel import dist as jdist
from stringsearchlib_tpu_torch.config import IndexConfig
from stringsearchlib_tpu_torch.index.build import build_index
from stringsearchlib_tpu_torch.index.serialize import load_index, save_index
from stringsearchlib_tpu_torch.parallel.dist import (
    ShardedEngine, make_mesh, shard_index,
)

WORDS = [
    "telephone", "telegraph", "photograph", "telescope", "microphone",
    "phonograph", "graphite", "telephony", "phone", "graph", "tele",
    "LWMS", "LWM", "LWMA", "L", "a b c",
]
QUERIES = ["telephon", "graph", "LWMS", "tele", "micro phone"]


def _results(engine):
    return [engine.search(q, 0.2, 10) for q in QUERIES]


def _engine(host, n):
    return ShardedEngine(shard_index(host, n), make_mesh(n, device="cpu"))


def _jax_results(n):
    host = jbuild(WORDS, 1, None, JConfig(), to_device=False)
    eng = jdist.ShardedEngine(jdist.shard_index(host, n), jdist.make_mesh(n))
    return [(list(k), list(s)) for k, s in eng.search_batch(QUERIES, 0.2, 10)]


def test_reshard_reproduces_results():
    host = build_index(WORDS, 1, None, IndexConfig(), device="cpu")
    first = _results(_engine(host, 4))
    # simulate losing the sharded state: re-shard from the host index
    again = _results(_engine(host, 4))
    assert first == again
    assert first == _jax_results(4)


def test_checkpoint_then_reshard_reproduces_results():
    host = build_index(WORDS, 1, None, IndexConfig(), device="cpu")
    want = _results(_engine(host, 4))
    buf = io.BytesIO()
    save_index(host, buf)
    buf.seek(0)
    loaded = load_index(buf, device="cpu")
    got = _results(_engine(loaded, 4))
    assert got == want


def test_shard_count_change_reproduces_results():
    """Elastic recovery onto a different mesh size gives identical
    results (the global merge is a max; shard layout cannot matter)."""
    host = build_index(WORDS, 1, None, IndexConfig(), device="cpu")
    r2 = _results(_engine(host, 2))
    r8 = _results(_engine(host, 8))
    assert r2 == r8
    assert r8 == _jax_results(8)
