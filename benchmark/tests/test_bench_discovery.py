"""A configuration, a corpus column, a traffic mix, its generator and query
model, and a per-layer metric added as new files (and BENCHMARK.json
entries) in a copy of the benchmark are found by name and run, with no file
of the benchmark edited."""

import hashlib
import json
import os
import shutil
import textwrap

from benchmark import spec
from test_bench_harness import _run

ROOT = spec.ROOT

# a column of part codes, a query model that sends elements unedited, and a
# generator that repeats a few queries (the shape of a result-cache mix)
# through the closed loop's call and window
COLUMN = """
import numpy as np

def make(n, seed):
    rng = np.random.default_rng(seed)
    return [f"PN-{a:05d}-{b}" for a, b in zip(rng.integers(0, 99999, n).tolist(),
                                              rng.choice(list("ABCDEFGH"), n).tolist())]
"""
QUERIES = """
def draw(words, n, rng):
    return [rng.choice(words) for _ in range(n)]
"""
GENERATOR = """
from benchmark import spec

def _base(cell):
    return spec.part(cell.root, "generators", "closed_loop")

def make_inputs(cell, words, seed):
    inputs = _base(cell).make_inputs(cell, words, seed)
    inputs.pool = inputs.pool[: cell.traffic["distinct_queries"]] * 50
    return inputs

def caller(cell, engine):
    return _base(cell).caller(cell, engine)

def run_window(cell, *args, **kwargs):
    return _base(cell).run_window(cell, *args, **kwargs)
"""


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if f.endswith((".py", ".json")):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def _write(root, rel, text):
    with open(os.path.join(root, "benchmark", rel), "w") as f:
        f.write(textwrap.dedent(text).lstrip() if isinstance(text, str) else json.dumps(text))


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(root)

    _write(root, "columns/part_codes.py", COLUMN)
    _write(root, "queries/exact_element.py", QUERIES)
    _write(root, "generators/repeats.py", GENERATOR)
    _write(root, "configs/tiny_parts.json",
           {"corpus": {"columns": ["product_names", "part_codes"], "n_rows": 600,
                       "weights": [1.0, 0.5]},
            "gram_size": 3, "threshold": 0.4, "limit": 20, "assumed": ["a test"]})
    _write(root, "traffic/repeat64.json",
           {"generator": "repeats", "queries": "exact_element", "call": "search_batch",
            "batch": 64, "batch_bucket": 64, "warmup_requests": 1, "pool_queries": 2000,
            "distinct_queries": 128, "trace_requests": 3, "check_queries": 100})
    _write(root, "metrics/requests_traced.batch.py",
           "def read(run):\n    return len(run.window.latencies)\n")

    bench = spec.load(root)
    bench["configs"].append({"name": "tiny_parts", "source": "a test", "reduced": [],
                             "file": "benchmark/configs/tiny_parts.json", "why": "a test"})
    cell = "tiny_parts.repeat64"
    bench["workloads"].append({"name": cell, "config": "tiny_parts", "traffic": "repeat64",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "batch_qps":
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "requests_traced.batch", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "test",
                               "moves": "batch_qps", "workloads": [cell]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    loaded = spec.cell(cell, root)
    assert loaded.generator.__file__.endswith(os.path.join("generators", "repeats.py"))
    line, *_ = _run(cell, 0, n_rows=None, root=root)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"batch_qps", "setup_s"}
    line, *_ = _run(cell, 1, n_rows=None, root=root)
    assert line["correct"] is True
    assert line["metrics"]["requests_traced.batch"]["value"] == 3
    after = _digests(root)
    assert {k: after[k] for k in before} == before
