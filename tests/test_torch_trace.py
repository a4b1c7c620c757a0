"""The port's host spans and per-call counters on the CPU: ``sslib.*`` spans
under torch.profiler, nested in the public call's root span and recorded as
plain CPU ops (never user annotations, which the profiler copies onto a
card's timeline); nothing recorded with the profiler off; and
``last_routing["call"]`` summed over every group, pass and tier of a call."""

import json
import os
import random

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stringsearchlib_tpu_torch.config import IndexConfig
from stringsearchlib_tpu_torch.index.build import build_index
from stringsearchlib_tpu_torch.parallel.dist import ShardedEngine, make_mesh, shard_index
from stringsearchlib_tpu_torch.parallel.tp import GramShardedEngine, shard_index_by_grams
from stringsearchlib_tpu_torch.search import engine as engine_mod
from stringsearchlib_tpu_torch.search.engine import SearchEngine
from stringsearchlib_tpu_torch.utils import metrics

CHILDREN = ("sslib.front", "sslib.prep", "sslib.dispatch", "sslib.fetch", "sslib.emit")
CALL_KEYS = {"queries", "retry_fast", "dense_rows", "emit_slow_keys", "chunks",
             "graph_chunks"}


def _corpus(n, seed):
    rng = random.Random(seed)
    syll = ["ka", "lo", "me", "ri", "su", "ta", "ve", "nor", "bel"]
    return ["".join(rng.choice(syll) for _ in range(rng.randint(2, 5))) for _ in range(n)]


def _queries(words, n, seed):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        w = words[rng.randrange(len(words))]
        j = rng.randrange(max(len(w) - 1, 1))
        out.append(w if i % 3 == 0 else w[:j] + "x" + w[j + 1:])
    return out


def _long(words, n, seed):
    """Queries of more than 32 characters: four corpus words joined."""
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        q = " ".join(rng.choice(words) for _ in range(4))
        if 32 < len(q) <= 64:
            out.append(q)
    return out


@pytest.fixture(scope="module")
def words():
    return _corpus(3000, seed=31)


@pytest.fixture()
def engine(words):
    """A fresh index and engine whose batches take the candidate route
    (bitmap_kernel over the packed table, h* on these uniform weights)."""
    eng = SearchEngine(build_index(words, 1, None, IndexConfig(), device="cpu"))
    eng.GM_BUDGET = 0
    eng.CAND_MIN_TERMS = 100
    return eng


def _spans(prof):
    """[(start, end, name)] of the sslib.* events, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.name.startswith("sslib."))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _inside(span, root):
    return root[0] <= span[0] and span[1] <= root[1]


@pytest.mark.parametrize("call,root,want", [
    ("batch", "sslib.search_batch", CHILDREN),
    ("single_candidates", "sslib.search", CHILDREN),
    ("single_dense", "sslib.search", ("sslib.front", "sslib.dispatch", "sslib.fetch",
                                      "sslib.emit")),
])
def test_spans_nest_in_one_root(engine, words, call, root, want):
    qs = _queries(words, 40, seed=5)
    run = {
        "batch": lambda: engine.search_batch(qs, 0.3, 10),
        "single_candidates": lambda: engine.search(qs[1], 0.3, 10),
        "single_dense": lambda: engine.search(_long(words, 1, 3)[0], 0.3, 10),
    }[call]
    run()  # the resident tables, built outside the trace
    spans = _spans(_traced(run))
    roots = [s for s in spans if s[2] in ("sslib.search", "sslib.search_batch")]
    # a single routed into the batch path opens no second root
    assert [r[2] for r in roots] == [root]
    names = {s[2] for s in spans}
    assert set(want) <= names
    assert all(_inside(s, roots[0]) for s in spans)


def test_fetch_spans_match_the_fetch_count(engine, words, monkeypatch):
    """A retried batch fetches its first pass, its retry and its dense rows:
    one ``sslib.fetch`` span each."""
    monkeypatch.setattr(engine, "HSTAR_KB1", 1)
    monkeypatch.setattr(engine, "HSTAR_KB2", 1)
    qs = _queries(words, 40, seed=9)
    engine.search_batch(qs, 0.25, 10)
    fetches = []
    orig = engine_mod._fetch
    monkeypatch.setattr(engine_mod, "_fetch", lambda b: fetches.append(1) or orig(b))
    prof = _traced(lambda: engine.search_batch(qs, 0.25, 10))
    assert engine.last_routing["call"]["retry_fast"] > 0
    names = [s[2] for s in _spans(prof)]
    assert names.count("sslib.fetch") == len(fetches) >= 2


def test_no_span_is_a_user_annotation(engine, words, tmp_path):
    qs = _queries(words, 16, seed=11)
    engine.search_batch(qs, 0.3, 10)
    prof = _traced(lambda: engine.search_batch(qs, 0.3, 10))
    events = [e for e in prof.events() if e.name.startswith("sslib.")]
    assert events and not any(e.is_user_annotation for e in events)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        cats = {e.get("cat") for e in json.load(f)["traceEvents"]
                if str(e.get("name", "")).startswith("sslib.")}
    assert cats == {"cpu_op"}


def test_profiler_off_records_nothing(engine, words):
    off = metrics.span("sslib.front")
    assert off is metrics.span("sslib.emit")  # one shared no-op
    with off:
        pass
    qs = _queries(words, 16, seed=13)
    engine.search_batch(qs, 0.3, 10)  # before any profiler: nothing to record
    prof = _traced(lambda: None)
    assert _spans(prof) == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert metrics.span("sslib.front") is not off


def test_call_sums_both_query_width_groups(engine, words, monkeypatch):
    """A batch of queries of <= 32 and > 32 characters runs two candidate
    groups; the call counts the retried rows of both, the top-level keys
    the last group's."""
    monkeypatch.setattr(engine, "HSTAR_KB1", 1)
    monkeypatch.setattr(engine, "HSTAR_KB2", 1)
    groups = []  # (rows, retried rows) of each group
    orig = engine._run_candidate_chunks

    def spy(items, *a):
        still = orig(items, *a)
        groups.append((len(items), engine.last_routing["retry_fast"]))
        return still

    monkeypatch.setattr(engine, "_run_candidate_chunks", spy)
    qs = _queries(words, 30, seed=15) + _long(words, 12, seed=17)
    random.Random(19).shuffle(qs)
    engine.search_batch(qs, 0.25, 10)
    call = engine.last_routing["call"]
    assert set(call) == CALL_KEYS
    assert len(groups) == 2 and call["queries"] == len(qs)
    assert sum(n for n, _ in groups) == len(qs)
    assert all(r > 0 for _, r in groups)
    assert call["retry_fast"] == sum(r for _, r in groups)
    assert engine.last_routing["n_items"] == groups[-1][0]
    assert engine.last_routing["retry_fast"] == groups[-1][1]


@pytest.mark.parametrize("case", ["mode_dense", "retried", "brute"])
def test_call_counts_the_rows_the_dense_path_answered(engine, words, monkeypatch, case):
    dense, brute = [], []
    orig_dense, orig_brute = engine._run_dense_chunks, engine._run_brute_chunks
    monkeypatch.setattr(engine, "_run_dense_chunks",
                        lambda items, *a: dense.append(len(items)) or orig_dense(items, *a))
    monkeypatch.setattr(engine, "_run_brute_chunks",
                        lambda items, *a: brute.append(len(items)) or orig_brute(items, *a))
    qs = _queries(words, 40, seed=21)
    mode = "auto"
    if case == "mode_dense":
        mode = "dense"
    elif case == "retried":
        monkeypatch.setattr(engine, "HSTAR_KB1", 1)
        monkeypatch.setattr(engine, "HSTAR_KB2", 1)
    else:
        qs = qs[:10] + ["ka", "lo", "r"]
    engine.search_batch(qs, 0.25, 10, mode=mode)
    call = engine.last_routing["call"]
    assert call["dense_rows"] == sum(dense) and (dense or case == "brute")
    # the brute tier's rows are not dense rows
    assert sum(brute) == (3 if case == "brute" else 0)
    if case == "retried":
        assert 0 < call["dense_rows"] <= call["retry_fast"]
    if case == "mode_dense":
        assert call["dense_rows"] == len(qs) and call["retry_fast"] == 0


@pytest.mark.parametrize("kind", ["dense", "brute"])
def test_dense_single_sets_its_variant(engine, words, kind):
    engine.search_batch(_queries(words, 16, seed=23), 0.3, 10)
    assert engine.last_routing["variant"] == "bitmap_kernel"
    q = _long(words, 1, seed=25)[0] if kind == "dense" else "ka"
    engine.search(q, 0.3, 10)
    assert engine.last_routing["variant"] == kind
    call = engine.last_routing["call"]
    assert call["queries"] == 1 and call["retry_fast"] == 0
    assert call["dense_rows"] == (1 if kind == "dense" else 0)


def test_every_public_call_resets_the_routing(engine, words):
    engine.search_batch(_queries(words, 16, seed=27), 0.3, 10)
    assert "n_items" in engine.last_routing
    engine.search("*", 0.3, 10)
    assert set(engine.last_routing) == {"call"}
    assert engine.last_routing["call"]["queries"] == 1


def test_query_metrics_sum_the_call_counters(engine, words, monkeypatch):
    engine.metrics = m = metrics.QueryMetrics()
    monkeypatch.setattr(engine, "HSTAR_KB1", 1)
    monkeypatch.setattr(engine, "HSTAR_KB2", 1)
    qs = _queries(words, 40, seed=29)
    engine.search_batch(qs, 0.25, 10)
    first = dict(engine.last_routing["call"])
    engine.search(_long(words, 1, seed=31)[0], 0.3, 10)
    snap = m.snapshot()
    assert snap["queries"] == len(qs) + 1
    assert snap["dense_rows"] == first["dense_rows"] + 1
    assert snap["retried_rows"] == first["retry_fast"] > 0
    m.reset()
    # nothing counted since the reset: neither figure is reported
    assert not {"dense_rows", "retried_rows"} & set(m.snapshot())
    engine.search_batch(qs[:8], 0.3, 10, mode="dense")
    assert m.snapshot()["dense_rows"] == 8 and m.snapshot()["retried_rows"] == 0


def test_profile_dir_holds_the_spans(engine, words, tmp_path):
    qs = _queries(words, 16, seed=33)
    engine.search_batch(qs, 0.3, 10)
    with metrics.profile(str(tmp_path)):
        engine.search_batch(qs, 0.3, 10)
    (name,) = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    with open(tmp_path / name) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"sslib.search_batch", *CHILDREN} <= names
    assert torch.autograd.profiler._is_profiler_enabled is False


@pytest.mark.parametrize("kind", ["terms", "grams"])
def test_sharded_engines_report_only_what_they_count(words, kind):
    """The sharded passes count no retried or dense rows, so their calls
    report the queries alone, and QueryMetrics no zeros for the rest, even
    where rows were retried."""
    host = build_index(words, 1, None, IndexConfig(), device="cpu")
    if kind == "terms":
        eng = ShardedEngine(shard_index(host, 2), make_mesh(2, device="cpu"))
        eng.CAND_TERMS_FAST, eng.CAND_TERMS = 4, 8
    else:
        eng = GramShardedEngine(shard_index_by_grams(host, 2),
                                make_mesh(2, "grams", device="cpu"))
    eng.metrics = m = metrics.QueryMetrics()
    qs = _queries(words, 20, seed=35)
    eng.search_batch(qs, 0.0, 5, mode="candidates")
    if kind == "terms":
        assert eng.last_routing["retry_fast"] > 0
    assert eng.last_routing["call"] == {"queries": len(qs)}
    eng.search(qs[0], 0.3, 5)
    assert eng.last_routing["call"] == {"queries": 1}
    snap = m.snapshot()
    assert snap["queries"] == len(qs) + 1
    assert not {"dense_rows", "retried_rows"} & set(snap)
