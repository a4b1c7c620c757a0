"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, the metrics each cell reports, and the files each entry names."""

import json
import math
import os
import re

import pytest

from benchmark import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    return spec.load(ROOT)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == TOP_KEYS
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(bench):
    groups = [bench["configs"], bench["workloads"], bench["end_to_end"], bench["per_layer"]]
    for g in groups:
        names = [e["name"] for e in g]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])


def test_bounds(bench):
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m


def test_cells_and_configs(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    assert 1 <= len(configs) <= 24 and 1 <= len(bench["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p.rstrip("/") + "/") for p in bench["paths"])
        assert os.path.exists(os.path.join(ROOT, f))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, math.floor(len(bench["workloads"]) / 4))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic", f"{w['traffic']}.json"))


def test_every_metric_has_its_reader(bench):
    for kind, group in (("end_to_end", "end_to_end"), ("metrics", "per_layer")):
        for m in bench[group]:
            assert os.path.exists(os.path.join(ROOT, "benchmark", kind, f"{m['name']}.py")), m


def test_each_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], ROOT)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]


def test_moves_is_reported_where_the_metric_is(bench):
    """Every per-layer metric's ``moves`` is an end-to-end metric reported by
    every cell that reports the per-layer metric."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e, m
        for c in m.get("workloads", cells):
            assert c in cells
            target = e2e[m["moves"]]
            assert "workloads" not in target or c in target["workloads"], (m["name"], c)


def test_metric_workloads_name_cells(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= cells, m


def test_layers_spelled_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    lowered = {layer.lower().strip() for layer in layers}
    assert len(lowered) == len(layers)


def test_config_files_are_json_with_what_a_run_reads(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        for key in ("corpus", "gram_size", "threshold", "limit", "assumed"):
            assert key in cfg, (c["name"], key)


def test_named_parts_exist(bench):
    """Each mix names a generator and a query model, each configuration its
    corpus columns, all as files found by name, with the functions the
    harness calls."""
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], ROOT)
        for fn in ("make_inputs", "caller", "run_window"):
            assert callable(getattr(cell.generator, fn)), (w["traffic"], fn)
        assert callable(spec.part(ROOT, "queries", cell.traffic["queries"]).draw)
        for col in cell.config["corpus"]["columns"]:
            assert callable(spec.part(ROOT, "columns", col).make), col
