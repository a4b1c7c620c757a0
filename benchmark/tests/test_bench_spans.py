"""The readers of the program's spans and per-call counters: self times on
a hand-built trace, nested spans subtracted; None from a program that
opens no ``sslib.*`` span or keeps no counters (a program older than
them); and every one of them on the line of a traced CPU run."""

import pytest

from benchmark import loops, spans, spec
from benchmark.run import Run
from benchmark.trace import Trace
from test_bench_harness import _run

ROOT = spec.ROOT
SPAN_METRICS = {
    "front_us_per_query.batch": ("sslib.front", "sslib.prep"),
    "front_us_per_query.single": ("sslib.front", "sslib.prep"),
    "dispatch_us_per_query.batch": ("sslib.dispatch",),
    "dispatch_us_per_query.single": ("sslib.dispatch",),
    "emit_us_per_query.batch": ("sslib.emit",),
    "fetch_wait_us_per_query.batch": ("sslib.fetch",),
}
NEW = [*SPAN_METRICS, "dense_rows_per_1k.batch"]

# two calls of 10 queries each (microseconds); the benchmark's own spans and
# torch ops lie around and inside the program's.  sslib.inner and
# sslib.outer stand for any nesting below a layer's span: the helper reads
# every sslib.* name alike
HOST = [
    (0, 1000, "bench.window"),
    (10, 400, "bench.search_batch"),
    (10, 400, "sslib.search_batch"),
    (12, 60, "sslib.front"),
    (20, 50, "aten::copy_"),  # a torch op in a span counts as the span's own
    (60, 90, "sslib.prep"),
    (90, 200, "sslib.dispatch"),
    (100, 140, "sslib.inner"),  # nested: not the dispatch's own
    (200, 300, "sslib.fetch"),
    (300, 390, "sslib.emit"),
    (500, 900, "sslib.search_batch"),
    (500, 540, "sslib.front"),
    (540, 600, "sslib.outer"),
    (545, 560, "sslib.prep"),  # nested twice: the outer's, then its dispatch's
    (560, 590, "sslib.dispatch"),
    (570, 580, "sslib.prep"),
    (600, 700, "sslib.fetch"),
    (700, 880, "sslib.emit"),
]
WANT_SELF = {
    "sslib.search_batch": (390 - 48 - 30 - 110 - 100 - 90) + (400 - 40 - 60 - 100 - 180),
    "sslib.front": 48 + 40,
    "sslib.prep": 30 + 15 + 10,
    "sslib.dispatch": 70 + 20,
    "sslib.inner": 40,
    "sslib.fetch": 200,
    "sslib.emit": 90 + 180,
    "sslib.outer": 60 - 15 - 30,
}


def _fake_run(host, queries=20, failed=0, requests=()):
    trace = Trace(window=(0, 1000), device=[(100, 150, "kernel")], host=list(host))
    window = loops.Window([0.1, 0.1], queries, failed, 1.0, [], list(requests), False)
    return Run(cell=None, setup_s=1.0, build_s=1.0, window=window, trace=trace)


def _reader(name):
    return spec.part(ROOT, "metrics", name).read


def test_self_times_subtract_nested_spans():
    got = spans.self_us(_fake_run(HOST).trace)
    assert got == pytest.approx(WANT_SELF)
    # everything below the roots but their own gaps
    assert spans.covered_share(_fake_run(HOST).trace) == pytest.approx(
        (378 + 380) / (390 + 400))


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_readers(name):
    want = sum(WANT_SELF.get(n, 0) for n in SPAN_METRICS[name]) / 18
    assert _reader(name)(_fake_run(HOST, queries=20, failed=2)) == pytest.approx(want)
    # an older program: no sslib.* span in its trace; a run without a trace
    bench_only = [h for h in HOST if not h[2].startswith("sslib.")]
    assert _reader(name)(_fake_run(bench_only)) is None
    assert _reader(name)(Run(cell=None, setup_s=1.0, build_s=1.0,
                             window=_fake_run(HOST).window)) is None


def test_dense_rows_reader():
    read = _reader("dense_rows_per_1k.batch")
    calls = [{"queries": 512, "dense_rows": 3}, {"queries": 512, "dense_rows": 0}]
    reqs = [([], {"variant": "bitmap_kernel", "call": c}) for c in calls]
    assert read(_fake_run(HOST, requests=reqs)) == pytest.approx(1000 * 3 / 1024)
    # an older program's routing has no per-call counters
    assert read(_fake_run(HOST, requests=[([], {"variant": "bitmap_kernel"})] * 2)) is None


@pytest.mark.parametrize("workload", ["product_names_10m.batch", "rows2d_1m.single"])
def test_traced_cpu_run_reports_the_new_metrics(workload):
    cell = spec.cell(workload, ROOT)
    want = {m["name"] for m in cell.per_layer} & set(NEW)
    assert want
    line, *_ = _run(workload, trace=1)
    assert line["correct"] is True
    assert want <= set(line["metrics"])
    for name in want:
        assert line["metrics"][name]["value"] >= 0.0
