"""Each search chunk's device chain captured as a CUDA graph and replayed
(``search.graphs``).

On the CPU: the key is pure Python and holds the shapes and flags, never
the threshold or the limit; CPU tensors never take the graph path, and
``call.chunks`` counts every chunk while ``call.graph_chunks`` stays 0; the
chain fed its threshold as a 0-d float32 tensor, as a graph is, answers as
the eager chain does on every route; a key whose capture did not fit runs
the eager chain; a capture's launch tally leaves other threads' counts
alone; the collector stays off across overlapping captures. On a card (the
``gpu`` marker; run with ``python -m pytest --noconftest -p
no:cacheprovider -m gpu tests/test_torch_graphs.py``): graphed and eager
results equal element for element on each graphed route, keys replayed with
other queries, thresholds and limits, chunks left pending before one fetch,
the cache bound, the pool's budget, ``bitmap_scan`` and the h* first pass
eager, the launch counters counting replays, no collection while capturing,
threads sharing one engine, and two engines sharing the card."""

import collections
import gc
import random
import threading

import numpy as np
import pytest
import torch

from stringsearchlib_tpu_torch.config import IndexConfig
from stringsearchlib_tpu_torch.index.build import build_index
from stringsearchlib_tpu_torch.ops import bitmap_matmul as pbm
from stringsearchlib_tpu_torch.ops import dp_match as pdp
from stringsearchlib_tpu_torch.ops import kernels
from stringsearchlib_tpu_torch.ops import vgather as pvg
from stringsearchlib_tpu_torch.search.candidates import _f32
from stringsearchlib_tpu_torch.search.engine import SearchEngine
from stringsearchlib_tpu_torch.search.graphs import chain_key
from stringsearchlib_tpu_torch.utils import metrics


def _corpus(n, seed):
    rng = random.Random(seed)
    syll = ["ka", "lo", "me", "ri", "su", "ta", "ve", "nor", "bel"]
    return ["".join(rng.choice(syll) for _ in range(rng.randint(2, 5)))
            for _ in range(n)]


def _weighted(n, seed):
    words = _corpus(n, seed)
    weights = np.ones(n)
    weights[::5] = 0.4
    weights[::11] = 0.0
    return words, weights


def _edits(words, n, seed, lo=4, hi=32):
    """Corpus words with one character changed, of lo..hi characters."""
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        w = rng.choice(words)
        if lo <= len(w) <= hi:
            j = rng.randrange(len(w))
            out.append(w if len(out) % 3 == 0 else w[:j] + "x" + w[j + 1:])
    return out


def _joined(words, n, seed, lo=33, hi=64):
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        q = " ".join(rng.choice(words) for _ in range(5))[:hi]
        if len(q) >= lo:
            out.append(q)
    return out


# the routes the chains take, each as engine settings on a small index and
# its calls: (uniform index, settings, "batch" / "batch8" / "single" /
# "dense", query maker, the route its first graphed chain's key names).
# The h* first pass on bitmap_kernel keeps its hits for the selection retry
# and stays eager: its first graphed chain is that retry
ROUTES = {
    "bitmap_kernel_hstar": (True, dict(GM_BUDGET=0, CAND_MIN_TERMS=100, HSTAR_KB1=1,
                                       HSTAR_KB2=1), "batch", _edits, "hstar_retry"),
    "bitmap_kernel": (False, dict(GM_BUDGET=0, CAND_MIN_TERMS=100), "single", _edits,
                      "bitmap_kernel"),
    "bitmap_gather": (True, dict(GM_BUDGET=0, CAND_MIN_TERMS=100, BITMAP_GATHER_TMAJ=True,
                                 HSTAR_KB1=4, HSTAR_KB2=8), "batch8", _edits,
                      "bitmap_gather"),
    "matmul_hstar": (True, dict(CAND_MIN_TERMS=100, HSTAR_KB1=1, HSTAR_KB2=1), "batch",
                     _edits, "matmul"),
    "runs": (False, dict(CAND_MIN_TERMS=100, GM_BUDGET=0, BITMAP_BUDGET=0,
                         SKETCH_MIN_TERMS=10**9), "batch", _edits, "runs"),
    "tiny_runs": (False, dict(CAND_MIN_TERMS=100, GM_BUDGET=0, SKETCH_MIN_TERMS=1),
                  "single", _edits, "tiny_runs"),
    "sketch_packed": (False, dict(GM_BUDGET=0, BITMAP_BUDGET=0, SKETCH_MIN_TERMS=0,
                                  CAND_MIN_TERMS=0, RUNS_TINY_BATCH=0), "batch", _edits,
                      "sketch_packed"),
    "dense_single": (False, dict(CAND_MIN_TERMS=100, GM_BUDGET=0), "single", _joined,
                     "dense_single"),
    "dense": (False, dict(), "dense", _edits, "dense"),
    "brute": (False, dict(), "dense", lambda words, n, seed: [
        w[:3] for w in _edits(words, n, seed)], "brute"),
}


def _queries(route, words, seed):
    _, _, kind, make, _ = ROUTES[route]
    # the gathered route takes batches of at most GATHER_BATCH queries
    return make(words, 8 if kind == "batch8" else 12, seed)


def _engine(host, settings, graphs=True):
    eng = SearchEngine(host)
    for k, v in settings.items():
        setattr(eng, k, v)
    if not graphs:
        eng._graphs = None
    return eng


def _call(eng, kind, queries, threshold=0.3, limit=10):
    if kind == "single":
        return [eng.search(q, threshold, limit) for q in queries]
    if kind == "dense":
        return eng.search_batch(queries, threshold, limit, batch_bucket=8, mode="dense")
    bucket = 8 if kind == "batch8" else 16
    return eng.search_batch(queries, threshold, limit, batch_bucket=bucket,
                            mode="candidates")


# -- the key (CPU) -------------------------------------------------------------


def _arrays(b=16, qp=32, pe=2):
    return [np.zeros((b, qp), np.int32), np.zeros(b, np.int32), np.zeros((b, qp - 2), np.int32),
            np.zeros((b, 8, pe), np.float32), np.full(b, 10, np.int32)]


def test_key_is_pure_python_and_holds_shapes_and_flags():
    tables = (object(), object())
    flags = dict(compute_short=False, n_cand=1024, top_k=16, block_sel=True)
    key = chain_key("bitmap_kernel", _arrays(), tables, **flags)
    hash(key)
    # other values of the same shapes (queries, limits): the same key
    other = [a + 1 for a in _arrays()]
    other[-1][:] = 100
    assert chain_key("bitmap_kernel", other, tables, **flags) == key
    # any shape, dtype, flag, table or route changed: another key
    changed = [
        chain_key("bitmap_kernel", _arrays(b=32), tables, **flags),
        chain_key("bitmap_kernel", _arrays(qp=64), tables, **flags),
        chain_key("bitmap_kernel", _arrays(pe=4), tables, **flags),
        chain_key("bitmap_kernel", [a.astype(np.int64) for a in _arrays()], tables, **flags),
        chain_key("bitmap_kernel", _arrays(), (tables[0], object()), **flags),
        chain_key("tiny_runs", _arrays(), tables, **flags),
        *(chain_key("bitmap_kernel", _arrays(), tables, **{**flags, k: v})
          for k, v in [("compute_short", True), ("n_cand", 4096), ("top_k", 32),
                       ("block_sel", False), ("kb1", 4)]),
    ]
    assert len({key, *changed}) == len(changed) + 1
    # device tensors key alike by their shapes
    dev = [torch.from_numpy(a) for a in _arrays()]
    assert chain_key("r", dev, tables) == chain_key("r", [d + 1 for d in dev], tables)


def test_f32_passes_a_device_threshold_through():
    t = torch.tensor(0.3, dtype=torch.float32)
    assert _f32(t) is t
    assert _f32(0.3) == float(np.float32(0.3))


class _Recording:
    """A stand-in for ChainGraphs on the CPU: records each chain's key and
    runs the chain eagerly with its threshold a 0-d float32 tensor, as a
    graph's input is."""

    def __init__(self):
        self.keys = []

    def run(self, key, fn, arrays, threshold, dev_arrays=(), tables=()):
        self.keys.append(key)
        inputs = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays] + list(dev_arrays)
        return fn(inputs, torch.tensor(np.float32(threshold))), False


@pytest.fixture(scope="module")
def hosts():
    words = _corpus(3000, seed=61)
    ww, weights = _weighted(3000, seed=62)
    return {True: (words, build_index(words, 1, None, IndexConfig(), device="cpu")),
            False: (ww, build_index(ww, 1, weights, IndexConfig(), device="cpu"))}


def _reset_caches(host):
    host._gram_matrix_cache = None
    host._bitmap_cache = None
    host._sketch_cache = None


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_device_threshold_answers_as_the_eager_chain(hosts, route):
    """Every route's chain, fed the threshold as a 0-d float32 tensor (a
    graph's input), gives the eager chain's results element for element;
    its first graphed chain's key names the route and does not move with
    the threshold or the limit."""
    uniform, settings, kind, _, key_route = ROUTES[route]
    words, host = hosts[uniform]
    _reset_caches(host)
    queries = _queries(route, words, seed=7)
    eager = _engine(host, settings)
    assert eager._graphs is None  # a CPU engine never graphs
    rec = _engine(host, settings)
    rec._graphs = _Recording()
    firsts = []
    for thr, limit in ((0.3, 10), (0.5, 13)):
        want = _call(eager, kind, queries, thr, limit)
        rec._graphs.keys = []
        assert _call(rec, kind, queries, thr, limit) == want
        firsts.append(rec._graphs.keys[0])
    assert firsts[0][0] == key_route
    assert firsts[0] == firsts[1]
    _reset_caches(host)


def test_cpu_chunks_counted_and_never_graphed(hosts):
    words, host = hosts[True]
    _reset_caches(host)
    eng = _engine(host, dict(GM_BUDGET=0, CAND_MIN_TERMS=100))
    assert eng._graphs is None
    runs = []
    orig = eng._run_chain

    def counting(fn, *a, **k):
        runs.append(k["route"])
        return orig(fn, *a, **k)

    eng._run_chain = counting
    queries = _edits(words, 20, seed=3)
    # dense: 20 rows in chunks of 8
    eng.search_batch(queries, 0.3, 10, batch_bucket=8, mode="dense")
    assert eng.last_routing["call"]["chunks"] == 3 == len(runs)
    assert eng.last_routing["call"]["graph_chunks"] == 0
    # candidate passes, retries and the dense rows they leave: each chunk
    runs.clear()
    eng.search_batch(queries, 0.3, 10, batch_bucket=8, mode="candidates")
    call = eng.last_routing["call"]
    assert call["chunks"] == len(runs) >= 3 and call["graph_chunks"] == 0
    # a single on the dense path, and a brute-tier one
    for q in (" ".join(queries[:4]), "kal"):
        runs.clear()
        eng.search(q, 0.3, 10)
        assert eng.last_routing["call"]["chunks"] == len(runs) == 1
    _reset_caches(host)


def test_query_metrics_sum_the_chunk_counters():
    m = metrics.QueryMetrics()
    m.record(0.01, 1, {"queries": 1, "dense_rows": 0, "retry_fast": 0, "chunks": 2,
                       "graph_chunks": 1})
    m.record(0.02, 4, {"queries": 4, "dense_rows": 1, "retry_fast": 1, "chunks": 3,
                       "graph_chunks": 3})
    snap = m.snapshot()
    assert snap["chunks"] == 5 and snap["graph_chunks"] == 4
    # the sharded engines count queries only: left out
    m.reset()
    m.record(0.01, 1, {"queries": 1})
    assert "chunks" not in m.snapshot() and "graph_chunks" not in m.snapshot()


class _Declining(_Recording):
    """A stand-in for ChainGraphs whose every key's capture did not fit."""

    def run(self, key, fn, arrays, threshold, dev_arrays=(), tables=()):
        self.keys.append(key)
        return None, False


def test_a_key_left_eager_runs_the_eager_chain(hosts):
    """A key whose capture did not fit runs the eager chain: the same
    results, every chunk counted, none as replayed."""
    _, settings, kind, _, _ = ROUTES["bitmap_kernel"]
    words, host = hosts[False]
    _reset_caches(host)
    queries = _edits(words, 12, seed=9)
    want = _call(_engine(host, settings), kind, queries)
    eng = _engine(host, settings)
    eng._graphs = _Declining()
    assert _call(eng, kind, queries) == want
    call = eng.last_routing["call"]
    assert call["chunks"] >= 1 and call["graph_chunks"] == 0
    assert eng._graphs.keys and eng._graphs.keys[-1][0] == "bitmap_kernel"
    _reset_caches(host)


def test_no_collection_spans_overlapping_captures():
    """The collector is off from the first capture in progress to the end
    of the last (two engines' threads may overlap), then as it was."""
    from stringsearchlib_tpu_torch.search import graphs

    assert gc.isenabled()
    with graphs._no_collection():
        assert not gc.isenabled()
        inner = graphs._no_collection()
        inner.__enter__()  # another thread's capture starts
    assert not gc.isenabled()  # ... and has not ended
    inner.__exit__(None, None, None)
    assert gc.isenabled()
    gc.disable()
    try:
        with graphs._no_collection():
            pass
        assert not gc.isenabled()  # left off, as it was
    finally:
        gc.enable()


def test_capture_tally_leaves_other_threads_counts():
    """While one thread captures a chain, its launches go to the capture's
    tally, not to the counters; another thread's launches (another
    engine's, on the same card) go to the counters as they happen, and
    nothing is taken back when the capture ends."""
    start_k1, start_k6 = pbm.K1_LAUNCHES, pvg.K6_LAUNCHES
    inside, release = threading.Event(), threading.Event()
    tallies = []

    def capturer():
        with kernels.capturing() as tally:
            kernels.count_launches(vars(pbm), "K1_LAUNCHES")
            kernels.count_launches(vars(pvg), "K6_LAUNCHES", 2)
            inside.set()
            release.wait(timeout=30)
            kernels.count_launches(vars(pbm), "K1_LAUNCHES")
        tallies.append(tally)

    t = threading.Thread(target=capturer)
    t.start()
    assert inside.wait(timeout=30)
    for _ in range(5):  # the other engine's launches, inside the capture
        kernels.count_launches(vars(pbm), "K1_LAUNCHES")
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert pbm.K1_LAUNCHES == start_k1 + 5 and pvg.K6_LAUNCHES == start_k6
    assert tallies == [{(pbm.__name__, "K1_LAUNCHES"): 2,
                        (pvg.__name__, "K6_LAUNCHES"): 2}]
    # the capture over, this thread counts at once again
    kernels.count_launches(vars(pbm), "K1_LAUNCHES", 3)
    assert pbm.K1_LAUNCHES == start_k1 + 8


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the CUDA kernels have no CPU form)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cuda_hosts():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the CUDA kernels have no CPU form)")
    words = _corpus(3000, seed=61)
    ww, weights = _weighted(3000, seed=62)
    return {True: (words, build_index(words, 1, None, IndexConfig(), device="cuda")),
            False: (ww, build_index(ww, 1, weights, IndexConfig(), device="cuda"))}


def _replays(eng):
    """Counts each key's replays on ``eng`` from now on."""
    seen = collections.Counter()
    orig = eng._graphs.run

    def run(key, *a, **k):
        outs, replayed = orig(key, *a, **k)
        seen[key] += int(replayed)
        return outs, replayed

    eng._graphs.run = run
    return seen


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_graphed_equals_eager_on_the_card(cuda, cuda_hosts, route):
    """Each route's graphed results equal the eager chain's element for
    element, over calls that replay its first chain's key at least three
    times with other queries; then at other thresholds and limits."""
    uniform, settings, kind, _, key_route = ROUTES[route]
    words, host = cuda_hosts[uniform]
    _reset_caches(host)
    eager = _engine(host, settings, graphs=False)
    eng = _engine(host, settings)
    seen = _replays(eng)
    for rep in range(8):
        queries = _queries(route, words, seed=100 + rep)
        assert _call(eng, kind, queries) == _call(eager, kind, queries), rep
    assert max(n for k, n in seen.items() if k[0] == key_route) >= 3, seen
    queries = _queries(route, words, seed=100)
    for thr, limit in ((0.5, 13), (0.2, 11)):
        assert (_call(eng, kind, queries, thr, limit)
                == _call(eager, kind, queries, thr, limit))
    _reset_caches(host)


@pytest.mark.gpu
def test_one_key_with_two_thresholds_and_limits(cuda, cuda_hosts):
    _, settings, _, make, _ = ROUTES["bitmap_kernel"]
    words, host = cuda_hosts[False]
    _reset_caches(host)
    eager = _engine(host, settings, graphs=False)
    eng = _engine(host, settings)
    q = make(words, 1, seed=5)[0]
    eng.search(q, 0.3, 10)  # runs eagerly, then captures
    key = next(iter(eng._graphs._graphs))  # the first pass's chain
    assert key[0] == "bitmap_kernel"
    seen = _replays(eng)
    for thr, limit in ((0.3, 10), (0.6, 10), (0.3, 13), (0.6, 13)):
        assert eng.search(q, thr, limit) == eager.search(q, thr, limit)
    assert seen[key] == 4
    _reset_caches(host)


@pytest.mark.gpu
def test_chunks_pending_before_one_fetch(cuda, cuda_hosts):
    """Three chunks of one key queued before the pass's one fetch: each
    replay's answer is copied out before the next replay."""
    _, settings, _, make, _ = ROUTES["bitmap_kernel"]
    words, host = cuda_hosts[False]
    _reset_caches(host)
    eager = _engine(host, settings, graphs=False)
    eng = _engine(host, settings)
    seen = _replays(eng)
    captures = []
    # three batches, then the same three again: the second round's shapes
    # are all seen, so it captures nothing
    for rep in range(6):
        queries = make(words, 48, seed=200 + rep % 3)
        assert (eng.search_batch(queries, 0.3, 10, batch_bucket=16, mode="candidates")
                == eager.search_batch(queries, 0.3, 10, batch_bucket=16, mode="candidates"))
        assert eng.last_routing["step"] == 16
        captures.append(eng._graphs.captures)
    first = [n for k, n in seen.items() if k[0] == "bitmap_kernel"]
    assert max(first) >= 8  # 2 replays in the first call, 3 in each later one
    assert captures[2] == captures[5] > 0
    _reset_caches(host)


@pytest.mark.gpu
def test_bitmap_scan_stays_eager(cuda, cuda_hosts):
    words, host = cuda_hosts[True]
    _reset_caches(host)
    settings = dict(GM_BUDGET=0, CAND_MIN_TERMS=0, RUNS_TINY_BATCH=0)
    eager = _engine(host, settings, graphs=False)
    eng = _engine(host, settings)
    chains = []
    orig = eng._run_chain

    def recording(fn, *a, **k):
        chains.append((k["route"], k.get("graph", True)))
        return orig(fn, *a, **k)

    eng._run_chain = recording
    queries = [" ".join(_corpus(60, seed=300 + i))[:200] for i in range(8)]
    for _ in range(2):
        got = eng.search_batch(queries, 0.1, 10, mode="candidates")
        assert eng.last_routing["variant"] == "bitmap_scan"
        assert got == eager.search_batch(queries, 0.1, 10, mode="candidates")
    scans = [c for c in chains if c[0] == "bitmap_scan"]
    assert len(scans) >= 2 and not any(g for _, g in scans)
    assert all(k[0] != "bitmap_scan" for k in eng._graphs._graphs)
    _reset_caches(host)


@pytest.mark.gpu
def test_cache_bound_evicts_and_recaptures(cuda, cuda_hosts):
    _, settings, _, make, _ = ROUTES["dense"]
    words, host = cuda_hosts[False]
    _reset_caches(host)
    eager = _engine(host, settings, graphs=False)
    eng = _engine(host, settings)
    eng._graphs.MAX_GRAPHS = 2
    # three keys taken in turn: chunks of 16, 32 and 64 rows
    sizes = (16, 32, 64)
    for rep in range(3):
        for n in sizes:
            queries = make(words, n, seed=400 + rep)
            assert (eng.search_batch(queries, 0.3, 10, batch_bucket=n, mode="dense")
                    == eager.search_batch(queries, 0.3, 10, batch_bucket=n, mode="dense"))
            assert len(eng._graphs) <= 2
    assert eng._graphs.captures >= 3 * len(sizes)


@pytest.mark.gpu
def test_no_collection_while_capturing(cuda, cuda_hosts, monkeypatch):
    """The garbage collector is off while a chain is captured (a collection
    that frees a graph in a dead reference cycle, another engine's, makes a
    call a capture forbids) and on again after it."""
    _, settings, kind, make, _ = ROUTES["bitmap_kernel"]
    words, host = cuda_hosts[False]
    _reset_caches(host)
    seen = []
    count = pbm.count_launches

    def spy(*a, **k):
        seen.append((torch.cuda.is_current_stream_capturing(), gc.isenabled()))
        return count(*a, **k)

    monkeypatch.setattr(pbm, "count_launches", spy)
    assert gc.isenabled()
    eng = _engine(host, settings)
    queries = make(words, 4, seed=900)
    assert _call(eng, kind, queries) == _call(_engine(host, settings, graphs=False), kind,
                                              queries)
    captured = [on for capturing, on in seen if capturing]
    assert captured and not any(captured)
    assert all(on for capturing, on in seen if not capturing) and gc.isenabled()
    _reset_caches(host)


@pytest.mark.gpu
def test_pool_budget_leaves_large_chains_eager(cuda, cuda_hosts):
    """A capture that grows the graphs' pool past its budget drops every
    graph and returns the pool; that key runs eagerly from then on, with
    the eager chain's results, and the other keys are captured again."""
    _, settings, _, make, _ = ROUTES["dense"]
    words, host = cuda_hosts[False]
    _reset_caches(host)
    eager = _engine(host, settings, graphs=False)
    eng = _engine(host, settings)
    graphs = eng._graphs

    def run(e, queries):
        n = len(queries)
        return e.search_batch(queries, 0.3, 10, batch_bucket=n, mode="dense")

    small, large = make(words, 16, seed=800), make(words, 64, seed=801)
    assert run(eng, small) == run(eager, small)
    assert graphs.captures == 1 and len(graphs) == 1
    graphs.POOL_BUDGET = -1  # every capture is past it
    for _ in range(2):
        assert run(eng, large) == run(eager, large)
        call = eng.last_routing["call"]
        assert call["graph_chunks"] == 0 < call["chunks"]
    assert list(graphs._graphs.values()) == [None]  # the small key's graph went
    del graphs.POOL_BUDGET
    for rep in range(2):
        assert run(eng, small) == run(eager, small)
        assert eng.last_routing["call"]["graph_chunks"] == rep
    assert run(eng, large) == run(eager, large)
    assert eng.last_routing["call"]["graph_chunks"] == 0
    assert graphs.captures == 2
    _reset_caches(host)


@pytest.mark.gpu
@pytest.mark.parametrize("route,counter", [
    ("bitmap_gather", (pbm, "K1_LAUNCHES")),
    ("bitmap_gather", (pbm, "G_LAUNCHES")),
    ("bitmap_kernel", (pbm, "K2_LAUNCHES")),
    ("tiny_runs", (pvg, "K6_LAUNCHES")),
])
def test_launch_counters_count_replays(cuda, cuda_hosts, route, counter):
    uniform, settings, kind, make, _ = ROUTES[route]
    words, host = cuda_hosts[uniform]
    _reset_caches(host)
    eager = _engine(host, settings, graphs=False)
    eng = _engine(host, settings)
    mod, name = counter
    queries = make(words, 4, seed=500)

    def moved(e):
        before = getattr(mod, name)
        _call(e, kind, queries)
        return getattr(mod, name) - before

    want = moved(eager)
    assert want > 0
    # the first calls run eagerly and capture (a capture launches nothing)
    assert moved(eng) == want
    # every chain replayed
    assert moved(eng) == want
    call = eng.last_routing["call"]
    assert call["graph_chunks"] == call["chunks"] > 0
    _reset_caches(host)


@pytest.mark.gpu
def test_threads_share_one_engine(cuda, cuda_hosts):
    """Singles from four threads on one engine (as the flat API's readers
    share it) answer as the eager chain does."""
    _, settings, _, make, _ = ROUTES["bitmap_kernel"]
    words, host = cuda_hosts[False]
    _reset_caches(host)
    eager = _engine(host, settings, graphs=False)
    eng = _engine(host, settings)
    queries = make(words, 64, seed=600)
    want = [eager.search(q, 0.3, 10) for q in queries]
    got = [None] * len(queries)
    errors = []

    def worker(k):
        try:
            for i in range(k, len(queries), 4):
                got[i] = eng.search(queries[i], 0.3, 10)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert got == want
    _reset_caches(host)


@pytest.mark.gpu
def test_two_engines_count_every_launch(cuda, cuda_hosts):
    """Two engines on one card, each in a thread of its own, capturing and
    replaying their chains while the other launches: each answers as the
    eager chain does, and every launch counter moves by exactly the eager
    chains' launches, round for round."""
    words, host = cuda_hosts[False]
    _reset_caches(host)
    counters = ((pbm, "K2_LAUNCHES"), (pvg, "K6_LAUNCHES"), (pvg, "EXPAND_LAUNCHES"),
                (pdp, "K5_LAUNCHES"))

    def snap():
        return [getattr(m, n) for m, n in counters]

    cases, per_round = [], [0] * len(counters)
    for route in ("bitmap_kernel", "tiny_runs"):
        _, settings, kind, make, _ = ROUTES[route]
        queries = make(words, 6, seed=700)
        before = snap()
        want = _call(_engine(host, settings, graphs=False), kind, queries)
        per_round = [p + a - b for p, a, b in zip(per_round, snap(), before)]
        cases.append((_engine(host, settings), kind, queries, want))
    assert per_round[0] > 0 and per_round[1] > 0
    rounds = 6
    start = threading.Barrier(len(cases))
    errors = []

    def worker(eng, kind, queries, want):
        try:
            start.wait(timeout=60)
            for _ in range(rounds):
                assert _call(eng, kind, queries) == want
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    before = snap()
    threads = [threading.Thread(target=worker, args=c) for c in cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert [a - b for a, b in zip(snap(), before)] == [rounds * p for p in per_round]
    assert all(eng.last_routing["call"]["graph_chunks"] > 0 for eng, *_ in cases)
    _reset_caches(host)
