"""The plain reference against the frozen oracle at tiny sizes, the
comparison that decides ``correct``, the control, and the roofline bound's
arithmetic counted by hand."""

import ast
import json
import os
import random
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import bounds, check, control, corpus, spec
from benchmark.reference.index import ReferenceIndex
from benchmark.reference.oracle import OracleIndex

ROOT = spec.ROOT
DRAW = spec.part(ROOT, "queries", "edited_element").draw


def _disagreements(words, row_size, weights, queries, threshold, limit):
    ref = ReferenceIndex(words, row_size, weights)
    ora = OracleIndex(words, row_size, weights)
    out = []
    for q, want in zip(queries, ref.search_many(queries, threshold, limit)):
        why = check.answer_differs(ora.search(q, threshold, limit), want)
        if why is not None:
            out.append((q, why))
    return out


@pytest.mark.parametrize("threshold,limit", [(0.3, 100), (0.0, 10), (0.6, 0)])
def test_product_names_match_the_oracle(threshold, limit):
    words, rs, w = corpus.make_corpus({"columns": ["product_names"], "n_rows": 1200}, 5)
    queries = DRAW(words, 60, random.Random(5)) + ["", "*", "ac", "a", "zzz", "!!!"]
    assert _disagreements(words, rs, w, queries, threshold, limit) == []


@pytest.mark.parametrize("threshold", [0.3, 0.0])
def test_2d_weighted_rows_match_the_oracle(threshold):
    words, rs, w = corpus.make_corpus(
        {"columns": ["product_names", "descriptions"], "n_rows": 700, "weights": [1.0, 0.4]}, 7)
    queries = DRAW(words, 60, random.Random(7))
    assert _disagreements(words, rs, w, queries, threshold, 100) == []


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_short_keys_and_odd_strings_match_the_oracle(threshold):
    words = (["LWMS", "LWM", "LWMA", "LWYY", "L", "I", "GHRSDGSDGS Egdsrtg g",
              "  ab ", "abc!d", "", None, "ACME x", "acme X", "x", "ZZ\tTOP", "%$@.."] * 2
             + ["ab%cd", "a b"])
    queries = ["LWMS", "lw", "l", "abc", "ACME X", "acme x", "ab", "*", "", "g", "xx yy",
               "zz top", "%$@", "lwmsxx"]
    assert _disagreements(words, 1, None, queries, threshold, 0) == []


def test_2d_short_terms_zero_weights_and_last_weight_written():
    words = ["k1", "LW", "k2", "abcdef", "k3", "zz", "KEY4", "lwms", "k1", "ABCDEFG",
             "k5", "abcdef", "k6", "lw"]
    weights = [1.0, 0.5, 1.0, 0.5, 0.0, 0.5, 1.0, 0.25, 1.0, 0.75, 2.0, 0.0, 0.5, 1.5]
    queries = ["lw", "abc", "k1", "abcdefg", "KEY4", "lwm", "abcdef", "*"]
    for thr in (0.0, 0.4):
        assert _disagreements(words, 2, weights, queries, thr, 0) == []


def test_comparison_catches_what_differs():
    want = ([("a", 1.0, 1), ("bb", 0.5, 2), ("cc", 0.5, 2), ("dd", 0.5, 2)], 3)
    assert check.answer_differs((["a", "cc", "bb"], [1.0, 0.5, 0.5]), want) is None
    assert check.answer_differs((["a", "dd", "cc"], [1.0, 0.5, 0.5]), want) is None
    assert check.answer_differs((["a", "bb"], [1.0, 0.5]), want) is not None
    assert check.answer_differs((["a", "bb", "bb"], [1.0, 0.5, 0.5]), want) is not None
    assert check.answer_differs((["a", "bb", "xx"], [1.0, 0.5, 0.5]), want) is not None
    assert check.answer_differs((["a", "bb", "cc"], [1.0, 0.5, 0.50001]), want) is not None
    assert check.answer_differs((["a", "bbb", "cc"], [1.0, 0.5, 0.5]), want) is not None


@pytest.mark.parametrize("workload", ["product_names_10m.batch", "rows2d_1m.single"])
def test_the_control_comes_out_not_correct(workload):
    """bfloat16 scores in the reference, judged as a run judges the program."""
    cell = spec.cell(workload, ROOT)
    cell.traffic = dict(cell.traffic, check_queries=64)
    res = control.run_control(cell, 11, "cpu", n_rows=800)
    assert res["correct"] is False
    assert res["checks"]["wrong"]["value"] > res["checks"]["wrong"]["limit"]


def test_hits_bound_counted_by_hand():
    """Three long-tier terms; a batch whose distinct corpus grams are BCD,
    CDE, DEF and ZZZ (ZZQ is not in the corpus): 4 rows of 3 bits, 1.5
    bytes, read at 3.35 TB/s."""
    ref = ReferenceIndex(["abcdefg", "xbcdefq", "zzzzzz", "qq"], 1)
    assert ref.n_long == 3
    rows = ref.gram_rows(torch.cat([ref.query_gram_codes(ref.normalize(q))
                                    for q in ["bcdef", "zzzq", "bcd"]]))
    assert int(torch.unique(rows).numel()) == 4
    assert bounds.hits_bytes(4, 3) == 1.5
    assert bounds.bytes_bound(1.5) == pytest.approx(1.5 / 3.35e12)
    # the metric's reader: that bound over 1 us of K1
    cell = spec.cell("product_names_10m.batch", ROOT)
    read = cell.reader("metrics", "hits_roofline.batch")
    trace = SimpleNamespace(device=[(0.0, 0.6, "void bitmap_hits_kernel<true>(x)"),
                                    (1.0, 1.4, "void bitmap_hits_kernel<true>(x)"),
                                    (2.0, 9.0, "void bitmap_hits_kernel<false>(x)")])
    run = SimpleNamespace(trace=trace, reference=ref,
                          window=SimpleNamespace(requests=[(["bcdef", "zzzq", "bcd"], {})]))
    assert read(run) == pytest.approx(100 * (1.5 / 3.35e12) / 1e-6)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref_dir, f))}
            assert not tops & {"stringsearchlib_tpu_torch", "stringsearchlib_tpu", "jax"}, f
    code = ("import sys, json; import benchmark.reference.index, benchmark.reference.oracle;"
            " print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert not set(json.loads(out)) & {"stringsearchlib_tpu_torch", "stringsearchlib_tpu", "jax"}


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for d, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(d, f)) if m}
                assert not tops & {"jax", "jaxlib", "flax", "stringsearchlib_tpu"}, f
