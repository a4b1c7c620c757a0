"""The benchmark on a CUDA card at a small corpus: each traffic kind runs
with its kernels (no plain version in their place) and comes out correct,
and the control comes out not correct.  They skip without a card; on the
card:

    python -m pytest -p no:cacheprovider -m gpu benchmark/tests/test_bench_card.py
"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import control, spec
from test_bench_harness import ROOT, _check_line

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port's kernels there")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", ["product_names_10m.batch", "rows2d_1m.batch",
                                      "rows2d_1m.single"])
def test_cell_on_the_card_at_a_small_corpus(cuda, workload):
    code = ("import sys; from benchmark.run import main; sys.exit(main(['--workload', "
            f"{workload!r}, '--seed', '4000000001', '--seconds', '2', '--trace', '0'], "
            "n_rows=20000))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    cell = spec.cell(workload, ROOT)
    _check_line(dict(line, device=dict(line["device"], platform="cpu")), cell, 0)
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
    assert line["checks"]["plain_calls"]["value"] == 0
    assert line["correct"] is True


def test_control_on_the_card(cuda):
    cell = spec.cell("product_names_10m.batch", ROOT)
    res = control.run_control(cell, 5, cuda, n_rows=20000)
    assert res["correct"] is False
