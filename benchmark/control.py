"""The control of the comparison that decides ``correct``: the reference put
in the program's place with its scores computed in bfloat16, the precision
below the library's float32, judged by the same comparison as a run.  It
has to come out not correct.  The benchmark's own runs never run it.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3

on the card (or ``--device cpu --rows N`` at a tiny size).  Per seed it
makes the cell's corpus and queries as a run does, builds the reference
once, answers the first ``check_queries`` queries of the window's draw in
float32 and in bfloat16, and prints the numbers compared with their
limits and whether the control passed (one JSON line a seed).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import check, corpus, spec
from .reference.index import ReferenceIndex


def control_answers(ref: ReferenceIndex, queries, threshold, limit,
                    dtype=torch.bfloat16) -> list:
    """The reference's answers in ``dtype``, shaped as the program's:
    (keys, scores) cut at the limit."""
    out = ref.search_many(queries, threshold, limit, score_dtype=dtype)
    return [([k for k, _, _ in r[:n]], [s for _, s, _ in r[:n]]) for r, n in out]


def run_control(cell: spec.Cell, seed: int, device, n_rows=None) -> dict:
    cfg, traffic = cell.config, cell.traffic
    t = time.perf_counter()
    words, row_size, weights = corpus.make_corpus(cfg["corpus"], seed, n_rows, cell.root)
    n = int(traffic["check_queries"])
    queries = cell.generator.make_inputs(cell, words, seed).pool[:n]  # the window's first
    ref = ReferenceIndex(words, row_size, weights, int(cfg["gram_size"]), device=device)
    thr, limit = float(cfg["threshold"]), int(cfg["limit"])
    want = ref.search_many(queries, thr, limit)
    got = control_answers(ref, queries, thr, limit)
    wrong = sum(check.answer_differs(g, w) is not None for g, w in zip(got, want))
    chk = check.checks(wrong, 0, len(queries), None)
    return {"workload": cell.name, "seed": seed, "control": "bfloat16 scores",
            "correct": check.passed(chk), "checked": len(queries),
            "seconds": time.perf_counter() - t, "checks": chk}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(run_control(cell, seed, torch.device(args.device), args.rows)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
