"""The port's benchmark entry point (``stringsearchlib_tpu_torch.tools.bench``)
against the reference's ``bench.py`` on the CPU: the same corpora and
queries, list for list; the same measurement dict (keys, ``n_keys``,
``n_grams``, ``hits_path``, build stages) on the same corpus; ``main``'s
final line and extras file at tiny sizes; a failed configuration's exit
code; and no default to the CPU."""

import json
import os
import random

import pytest
import torch

import bench
from stringsearchlib_tpu.config import IndexConfig as JIndexConfig
from stringsearchlib_tpu.index import build as jbuild
from stringsearchlib_tpu.search.engine import SearchEngine as JSearchEngine
from stringsearchlib_tpu_torch.config import IndexConfig
from stringsearchlib_tpu_torch.index import build as pbuild
from stringsearchlib_tpu_torch.search.engine import SearchEngine
from stringsearchlib_tpu_torch.tools import bench as pbench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINAL_KEYS = {"metric", "value", "unit", "vs_baseline", "build_s", "single_ms",
              "extra_file"}  # bench.py:349-363
CONFIGS = ("dense_1m", "rich_1m", "wide_100k_g2", "wide_100k_g3",
           "index2d_1m_rows", "headline")
COUNTERS = {"K1_LAUNCHES", "K1_REF_CALLS", "K2_LAUNCHES", "K2_REF_CALLS",
            "G_LAUNCHES", "G_REF_CALLS", "K5_LAUNCHES", "K5_REF_CALLS",
            "K6_LAUNCHES", "K6_REF_CALLS", "EXPAND_LAUNCHES"}
TINY = {"BENCH_KEYS": "1500", "BENCH_1M_KEYS": "1200", "BENCH_QUERIES": "16",
        "BENCH_REPS": "2", "BENCH_WIDE_KEYS": "300", "BENCH_2D_ROWS": "300"}


# ---------------------------------------------------------------------------
# corpora and queries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gen", ["_product_names", "_rich_names", "_wide_names"])
@pytest.mark.parametrize("n", [1, 257, 3000])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 6])
def test_corpora_equal_bench(gen, n, seed):
    assert getattr(pbench, gen)(n, seed) == getattr(bench, gen)(n, seed)


@pytest.mark.parametrize("gen, seed", [("_product_names", 0), ("_product_names", 2),
                                       ("_rich_names", 1), ("_wide_names", 3)])
def test_queries_equal_bench(gen, seed):
    """512 ``_mutate`` draws under ``random.Random(7)``, as each config
    draws its queries."""
    words = getattr(bench, gen)(3000, seed)
    got, want = random.Random(7), random.Random(7)
    assert ([pbench._mutate(got, got.choice(words)) for _ in range(512)]
            == [bench._mutate(want, want.choice(words)) for _ in range(512)])


def test_constants_equal_bench():
    assert pbench.TARGET_QPS == bench.TARGET_QPS
    for name in ("_SYLLABLES", "_BRANDS", "_TYPES", "_CJK", "_ACCENT"):
        assert getattr(pbench, name) == getattr(bench, name), name


# ---------------------------------------------------------------------------
# one configuration
# ---------------------------------------------------------------------------

# (corpus, run_config keyword arguments, engine budgets set to 0)
CASES = {
    "product_3000": ("product", {"singles": 4}, ()),
    "wide_500_g2": ("wide", {"gram": 2}, ()),
    "product_3000_bitmap": ("product", {}, ("GM_BUDGET",)),
    "product_3000_no_table": ("product", {}, ("GM_BUDGET", "BITMAP_BUDGET")),
    "wide_500_g3_no_table": ("wide", {"gram": 3}, ("GM_BUDGET", "BITMAP_BUDGET")),
    "product_3000_runs": ("product", {}, ("GM_BUDGET", "BITMAP_BUDGET", "SKETCH_BUDGET")),
}


def _corpus(kind):
    return bench._product_names(3000) if kind == "product" else bench._wide_names(500)


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_config_matches_bench(case, monkeypatch):
    kind, kw, zero = CASES[case]
    for name in zero:
        monkeypatch.setattr(SearchEngine, name, 0)
        monkeypatch.setattr(JSearchEngine, name, 0)
    gram = kw.get("gram")
    singles = kw.get("singles", 0)
    words = _corpus(kind)
    args = (words, 64, 0.3, 100, 1)
    got = pbench._run_config(
        *args, singles=singles, device="cpu",
        config=IndexConfig(wide=True, gram_size=gram) if gram else None)
    jbuild.LAST_BUILD_BREAKDOWN.clear()  # as the port's bench clears its own
    want = bench._run_config(
        *args, singles=singles,
        config=JIndexConfig(wide=True, gram_size=gram) if gram else None)

    assert set(got) == (set(want) - {"roofline"}) | {"launches"}
    for key in ("n_keys", "n_grams", "hits_path"):
        assert got[key] == want[key], key
    assert set(got["build_breakdown"]) == set(want["build_breakdown"])
    assert set(got["launches"]) == COUNTERS
    assert all(isinstance(v, int) and v >= 0 for v in got["launches"].values())
    assert got["qps"] > 0 and got["p50_latency_ms"] > 0 and got["build_s"] >= 0
    if singles:
        assert got["single_query_p50_ms"] > 0
        assert got["single_query_device_ms_est"] >= 0


def test_run_config_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is that card")
    with pytest.raises(RuntimeError, match="device"):
        pbench._run_config(bench._product_names(50), 4, 0.3, 100, 1)
    with pytest.raises(RuntimeError, match="device"):
        pbench.main()


def test_run_config_clears_a_stale_build_breakdown():
    pbuild.LAST_BUILD_BREAKDOWN["native_cpp"] = 99.0
    got = pbench._run_config(bench._wide_names(200), 8, 0.3, 100, 1, device="cpu",
                             config=IndexConfig(wide=True, gram_size=2))
    assert got["build_breakdown"] == {}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def _root_extra():
    path = os.path.join(ROOT, "BENCH_EXTRA.json")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return f.read()


def test_main_cpu_final_line_and_extras(monkeypatch, capsys, tmp_path):
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_THRESHOLD", raising=False)
    monkeypatch.delenv("BENCH_BATCH", raising=False)
    before = _root_extra()
    path = tmp_path / "extra" / "BENCH_EXTRA.json"
    pbench.main(device="cpu", extra_path=str(path))
    lines = capsys.readouterr().out.strip().splitlines()
    final = json.loads(lines[-1])
    assert set(final) == FINAL_KEYS
    assert final["metric"] == "queries_per_sec_per_chip_1k_keys_top100"
    assert final["unit"] == "queries/s"
    assert final["value"] > 0
    assert final["vs_baseline"] == round(final["value"] / bench.TARGET_QPS, 4)
    assert final["extra_file"] == str(path)
    printed = json.loads(lines[-2])["extra"]
    with open(path) as f:
        extra = json.load(f)
    assert extra == printed
    assert set(CONFIGS) <= set(extra)
    for name in CONFIGS:
        assert "error" not in extra[name], (name, extra[name])
        assert set(extra[name]["launches"]) == COUNTERS
    assert extra["headline"]["n_keys"] == 1500
    assert extra["index2d_1m_rows"]["n_rows"] == 300
    assert extra["device"] == {"name": "cpu", "power_limit": None}
    assert extra["threshold"] == 0.3
    assert final["single_ms"] == extra["headline"]["single_query_p50_ms"]
    assert "single_query_p50_ms" in extra["dense_1m"]
    assert "single_query_p50_ms" not in extra["rich_1m"]
    assert _root_extra() == before


def test_main_failed_config_prints_and_exits_1(monkeypatch, capsys, tmp_path):
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_WIDE_KEYS", "0")

    def broken(n, seed=1):
        raise ValueError("corpus generator failed")

    monkeypatch.setattr(pbench, "_rich_names", broken)
    before = _root_extra()
    path = tmp_path / "BENCH_EXTRA.json"
    with pytest.raises(SystemExit) as exc:
        pbench.main(device="cpu", extra_path=str(path))
    assert exc.value.code == 1
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(final) == FINAL_KEYS
    with open(path) as f:
        extra = json.load(f)
    for name in ("rich_1m", "index2d_1m_rows"):
        assert extra[name] == {"error": "ValueError: corpus generator failed"}
    assert "error" not in extra["dense_1m"] and "error" not in extra["headline"]
    assert "wide_100k_g2" not in extra
    assert _root_extra() == before
