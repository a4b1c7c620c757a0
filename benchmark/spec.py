"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix:
the configuration's ``file``, the mix's ``benchmark/traffic/<mix>.json``.
Everything else that belongs to one part sits in a file of its own under
``benchmark/<kind>/<name>.py``, loaded by ``part``:

  ``end_to_end`` / ``metrics``  one reader per metric, ``read(run)`` that
      returns a number or None (nothing to read: the metric is left out);
  ``generators``  the traffic generator a mix names (``generator``);
  ``queries``     the query model a mix names (``queries``);
  ``columns``     a corpus column a configuration names.

Adding a cell, a mix, a generator, a column or a metric adds files and
entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    root: str

    def reader(self, kind: str, name: str):
        """The ``read`` function of metric ``name`` (kind "end_to_end" or
        "metrics")."""
        return part(self.root, kind, name).read

    @property
    def generator(self):
        """The module of the mix's traffic generator."""
        return part(self.root, "generators", self.traffic["generator"])


def part(root: str, kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py`` under ``root``."""
    path = os.path.join(root, "benchmark", kind, f"{name}.py")
    mod_name = f"_bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` with its configuration, mix and metrics loaded."""
    bench = load(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root,
    )
