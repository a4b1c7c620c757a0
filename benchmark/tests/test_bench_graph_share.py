"""The readers of the share of chunk chains replayed from a captured CUDA
graph (``graph_chunk_share.single`` / ``.batch``): the program's per-call
counters summed over the traced requests; None from a program that keeps
no such counters (one older than them) or dispatched no chunk; and on the
line of a traced CPU run, where nothing is graphed (0%)."""

import pytest

from benchmark import loops, spec
from benchmark.run import Run
from test_bench_harness import _run

ROOT = spec.ROOT
NAMES = ("graph_chunk_share.single", "graph_chunk_share.batch")


def _fake_run(requests):
    window = loops.Window([0.1] * len(requests), len(requests), 0, 1.0, [],
                          list(requests), False)
    return Run(cell=None, setup_s=1.0, build_s=1.0, window=window)


def _reader(name):
    return spec.part(ROOT, "metrics", name).read


@pytest.mark.parametrize("name", NAMES)
def test_share_of_graphed_chunks(name):
    calls = [{"queries": 1, "chunks": 2, "graph_chunks": 1},
             {"queries": 1, "chunks": 3, "graph_chunks": 3},
             {"queries": 1, "chunks": 0, "graph_chunks": 0}]
    reqs = [([], {"variant": "bitmap_kernel", "call": c}) for c in calls]
    assert _reader(name)(_fake_run(reqs)) == pytest.approx(100.0 * 4 / 5)


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_counters(name):
    # an older program: per-call counters without chunks, or none at all
    older = [([], {"variant": "bitmap_kernel", "call": {"queries": 1, "dense_rows": 0}})]
    assert _reader(name)(_fake_run(older)) is None
    assert _reader(name)(_fake_run([([], {"variant": "bitmap_kernel"})])) is None
    # a program that dispatched nothing (wildcards only)
    none = [([], {"variant": None, "call": {"queries": 1, "chunks": 0, "graph_chunks": 0}})]
    assert _reader(name)(_fake_run(none)) is None


@pytest.mark.parametrize("workload,name", [("rows2d_1m.single", NAMES[0]),
                                           ("rows2d_1m.batch", NAMES[1])])
def test_traced_cpu_run_reports_the_share(workload, name):
    assert name in {m["name"] for m in spec.cell(workload, ROOT).per_layer}
    line, *_ = _run(workload, trace=1)
    assert line["correct"] is True
    # the CPU takes the eager chains only
    assert line["metrics"][name]["value"] == 0.0
