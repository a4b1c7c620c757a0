"""Observability of the PyTorch port on the CPU: index stats, the engine's
query-metrics hook and the torch.profiler context (the reference's
tests/test_metrics.py, mirrored), compared with the reference's counters
on the same words."""

import json
import os

from stringsearchlib_tpu import StringSearchIndex as JIndex
from stringsearchlib_tpu.utils import metrics as jmetrics
from stringsearchlib_tpu_torch import StringSearchIndex
from stringsearchlib_tpu_torch.api import capi
from stringsearchlib_tpu_torch.api.registry import GLOBAL_REGISTRY
from stringsearchlib_tpu_torch.utils import metrics

WORDS = ["LWMS", "LWM", "LWMA", "LWYY", "L", "I", "GHRSDGSDGS Egdsrtg g",
         "telephone", "telegraph", "photograph"]


def test_index_stats():
    idx = StringSearchIndex(WORDS, device="cpu")
    st = metrics.index_stats(idx.host)
    assert st["keys"] == len(WORDS)
    assert st["terms"] == 10
    assert st["grams"] > 0
    assert st["postings"] >= st["grams"]
    assert st["device_bytes"] > 0
    assert st["terms_short_tier"] + st["terms_long_tier"] == st["terms"]
    assert st["device"] == "cpu"
    json.dumps(st)  # must be JSON-serializable
    # the same counters, byte sizes included, as the reference's index
    want = jmetrics.index_stats(JIndex(WORDS).host)
    assert {k: st[k] for k in want} == want


def test_query_metrics_single_and_batch():
    idx = StringSearchIndex(WORDS, device="cpu")
    idx.engine.metrics = m = metrics.QueryMetrics()
    idx.engine.search("LWMS", 0.5, 10)
    idx.engine.search_batch(["telephon", "photogr"], 0.3, 10)
    snap = m.snapshot()
    assert snap["queries"] == 3
    assert snap["p50_ms"] >= 0.0
    assert snap["queries_per_sec"] > 0
    assert m.batched_queries == 2
    # the engine's call counters, summed: this small index answers densely
    assert snap["dense_rows"] == 3 and snap["retried_rows"] == 0
    m.reset()
    assert m.snapshot()["queries"] == 0


def test_metrics_no_double_count_on_fallback():
    idx = StringSearchIndex(WORDS, device="cpu")
    idx.engine.metrics = m = metrics.QueryMetrics()
    # wildcard + brute-force rows fall back to the single path internally
    idx.engine.search_batch(["*", "LW", "telephon"], 0.0, 5)
    assert m.snapshot()["queries"] == 3


def test_metrics_through_capi():
    GLOBAL_REGISTRY.clear()
    h = capi.indexN(WORDS, rowSize=1, device="cpu")
    GLOBAL_REGISTRY.get(h).engine.metrics = m = metrics.QueryMetrics(window=4)
    for q in WORDS:
        capi.score(h, q, 0.3, 10)
    snap = m.snapshot()
    assert snap["queries"] == len(WORDS) and snap["window"] == 4
    assert snap["p99_ms"] >= snap["p50_ms"] > 0.0
    GLOBAL_REGISTRY.clear()


def test_profile_noop():
    with metrics.profile(None):
        pass


def test_profile_writes_a_trace(tmp_path):
    idx = StringSearchIndex(WORDS, device="cpu")
    trace_dir = tmp_path / "trace"
    with metrics.profile(str(trace_dir)):
        idx.engine.search_batch(["telephon", "photogr"], 0.3, 10)
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    trace = json.load(open(trace_dir / files[0]))
    assert any(e.get("ph") == "X" for e in trace["traceEvents"])
    # the engine's own spans, the public call's root among them
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"sslib.search_batch", "sslib.front", "sslib.fetch"} <= names
