"""The harness end to end on the CPU at tiny sizes, through its test-only
device hook (``main(device="cpu", n_rows=...)``), each in a process of its
own: the contract's last line for each traffic kind, traced and not, the
import check, and planted faults that ``correct`` must catch."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from benchmark import run as runmod
from benchmark import spec

ROOT = spec.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "stringsearchlib_tpu"}

# faults planted under the harness, in the program's own answers
ALTER_BATCH = """
from stringsearchlib_tpu_torch.search import engine as E
_emit = E.SearchEngine._emit_row
def _emit_row(self, out, pos, *a, **k):
    _emit(self, out, pos, *a, **k)
    keys, scores = out[pos]
    if pos % 5 == 0 and scores:
        scores[0] = scores[0] * 1.001  # an answer altered where it is produced
E.SearchEngine._emit_row = _emit_row
"""
DROP_HALF = """
from stringsearchlib_tpu_torch.search import engine as E
_batch = E.SearchEngine.search_batch
def search_batch(self, queries, *a, **k):
    half = len(queries) // 2
    return _batch(self, queries[:half], *a, **k) + [None] * (len(queries) - half)
E.SearchEngine.search_batch = search_batch
"""
ALTER_SINGLE = """
from stringsearchlib_tpu_torch.search import engine as E
_search = E.SearchEngine.search
def search(self, query, *a, **k):
    keys, scores = _search(self, query, *a, **k)
    if keys:
        keys = [keys[0] + "x"] + keys[1:]  # an answer altered where it is produced
    return keys, scores
E.SearchEngine.search = search
"""


def _run(workload, trace=0, fault="", n_rows=900, seconds=1, root=ROOT):
    code = textwrap.dedent(f"""
        import json, sys
        from benchmark.run import main
        {textwrap.indent(fault, "        ").strip()}
        rc = main(["--workload", {workload!r}, "--seed", "3000000017", "--seconds",
                   "{seconds}", "--trace", "{trace}"], device="cpu", n_rows={n_rows},
                  root={root!r})
        print("LOADED " + json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})),
              file=sys.stderr)
        sys.exit(rc)
    """)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    loaded = set(json.loads(p.stderr.strip().splitlines()[-1].split(" ", 1)[1]))
    return line, loaded, p.stderr, p.stdout


def _check_line(line, cell, trace):
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == cell.chips
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("workload", ["product_names_10m.batch", "rows2d_1m.single"])
@pytest.mark.parametrize("trace", [0, 1])
def test_each_traffic_kind_end_to_end(workload, trace):
    cell = spec.cell(workload, ROOT)
    line, loaded, err, out = _run(workload, trace)
    _check_line(line, cell, trace)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    if trace:
        assert "build_s" in line["metrics"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        # every end-to-end metric of the cell is read on the CPU too
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert not loaded & FORBIDDEN
    assert "stringsearchlib_tpu_torch" in loaded
    # the line before the result: what the window saw of the host
    seen = json.loads(out.strip().splitlines()[-2])
    assert {"gc_s", "gc_passes", "host_probe_ms", "cpu_s", "involuntary_switches",
            "routes"} <= set(seen)
    assert sum(seen["routes"].values()) == seen["requests"] > 0
    # the numbers compared are the last lines on stderr, before the test's own
    tail = err.strip().splitlines()[-1 - len(line["checks"]):-1]
    assert [t.split()[1] for t in tail] == list(line["checks"])


@pytest.mark.parametrize("workload,fault", [
    ("rows2d_1m.batch", ALTER_BATCH),
    ("rows2d_1m.batch", DROP_HALF),
    ("rows2d_1m.single", ALTER_SINGLE),
])
def test_planted_faults_make_the_run_not_correct(workload, fault):
    line, *_ = _run(workload, 0, fault=fault)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_no_card_means_no_result():
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "rows2d_1m.single", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    fake = object()
    for name in ("stringsearchlib_tpu_torch.x", "jaxtyping", "flax_like.y"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert runmod.forbidden_modules() == sorted(FORBIDDEN & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "jaxlib.xla", fake)
    assert "jaxlib" in runmod.forbidden_modules()
