"""Multi-process distributed search with the PyTorch port (parallel.multihost):
2 processes x 4 shards over gloo on localhost, the reference's
tests/test_multihost.py mirrored.

  * parity: both processes produce results identical to a one-process
    engine (the port's and the JAX package's) on the same corpus;
  * fault injection: SIGKILL one worker MID-BATCH, tear the job down,
    re-initialize a fresh pair and assert results identical to the golden
    run (stateless recovery: re-shard from host arrays, nothing persisted).

The two reference cases keep their ``slow`` marks; one quick 2 x 2 pair
runs unmarked.  This file is its own worker::

    python tests/test_torch_multihost.py --worker --coordinator HOST:PORT \\
        --nprocs 2 --pid 0 --out out.json [--shards-per-proc 4] [--device cpu]

and the worker imports neither jax nor the reference package."""

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

WORDS = [
    "telephone", "telegraph", "photograph", "telescope", "microphone",
    "phonograph", "graphite", "telephony", "phone", "graph", "tele",
    "scope", "micro", "mic", "LWMS", "LWM", "LWMA", "L", "a b c",
    "abc def ghi", "widget alpha", "widget beta", "gadget", "wdgt",
] + [f"item {i:04d} base" for i in range(200)]

QUERIES = ["telephon", "graph", "LWMS", "tele", "micro phone",
           "item 0042", "widget", "a", "*"]


def _rounded(outs):
    return [[list(k), [round(float(x), 6) for x in s]] for k, s in outs]


def _worker(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--shards-per-proc", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--heartbeat", default="")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch.distributed as tdist

    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index.build import build_index
    from stringsearchlib_tpu_torch.parallel.dist import shard_index
    from stringsearchlib_tpu_torch.parallel.multihost import (
        MultiHostShardedEngine, global_mesh, init_distributed,
    )

    nproc, rank = init_distributed(args.coordinator, args.nprocs, args.pid)
    assert (nproc, rank) == (args.nprocs, args.pid), (nproc, rank)
    host = build_index(WORDS, 1, None, IndexConfig(), device="cpu")
    mesh = global_mesh(args.shards_per_proc, device=args.device)
    engine = MultiHostShardedEngine(shard_index(host, mesh.size), mesh)

    def run_once():
        return _rounded(engine.search_batch(QUERIES, 0.2, 10))

    results = run_once()
    if args.loop:
        deadline = time.time() + 60
        i = 0
        while time.time() < deadline:
            got = run_once()
            assert got == results, "nondeterministic batch"
            i += 1
            if args.heartbeat:
                with open(args.heartbeat, "w") as f:
                    f.write(str(i))
    with open(args.out, "w") as f:
        json.dump({"pid": args.pid, "ndev": mesh.size,
                   "local_shards": list(mesh.shard_ids), "results": results,
                   "jax_loaded": "jax" in sys.modules}, f)
    tdist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # localhost only
    return env


def _launch(port, pid, out, log, spp=4, loop=False, heartbeat=""):
    cmd = [
        sys.executable, os.path.abspath(__file__), "--worker",
        "--coordinator", f"127.0.0.1:{port}", "--nprocs", "2",
        "--pid", str(pid), "--out", out, "--shards-per-proc", str(spp),
    ]
    if loop:
        cmd.append("--loop")
    if heartbeat:
        cmd += ["--heartbeat", heartbeat]
    with open(log, "w") as f:  # the child holds its own descriptor
        return subprocess.Popen(cmd, env=_env(), stdout=f,
                                stderr=subprocess.STDOUT, cwd=ROOT)


def _run_pair(tmp_path, tag, spp=4, timeout=300):
    port = _free_port()
    outs = [str(tmp_path / f"{tag}_{i}.json") for i in range(2)]
    logs = [str(tmp_path / f"{tag}_{i}.log") for i in range(2)]
    procs = [_launch(port, i, outs[i], logs[i], spp) for i in range(2)]
    try:
        for p, log in zip(procs, logs):
            if p.wait(timeout=timeout) != 0:
                with open(log) as f:
                    pytest.fail(f.read()[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    out = []
    for o in outs:
        with open(o) as f:
            out.append(json.load(f))
    return out


def _golden():
    """One-process results: the JAX package's engine and the port's."""
    sys.path.insert(0, ROOT)
    from stringsearchlib_tpu.config import IndexConfig as JConfig
    from stringsearchlib_tpu.index.build import build_index as jbuild
    from stringsearchlib_tpu.search.engine import SearchEngine as JEngine
    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index.build import build_index
    from stringsearchlib_tpu_torch.parallel.dist import (
        ShardedEngine, make_mesh, shard_index,
    )

    jax_res = _rounded(JEngine(jbuild(WORDS, 1, None, JConfig())).search_batch(
        QUERIES, 0.2, 10))
    host = build_index(WORDS, 1, None, IndexConfig(), device="cpu")
    one = _rounded(ShardedEngine(shard_index(host, 4), make_mesh(4, device="cpu"))
                   .search_batch(QUERIES, 0.2, 10))
    assert one == jax_res
    return jax_res


def test_global_mesh_needs_a_process_group():
    sys.path.insert(0, ROOT)
    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index.build import build_index
    from stringsearchlib_tpu_torch.parallel.dist import shard_index
    from stringsearchlib_tpu_torch.parallel.multihost import (
        MultiHostShardedEngine, global_mesh,
    )

    with pytest.raises(RuntimeError):
        global_mesh(2, device="cpu")
    sx = shard_index(build_index(WORDS, 1, None, IndexConfig(), device="cpu"), 2)
    with pytest.raises(RuntimeError):
        MultiHostShardedEngine(sx)


def test_two_process_parity_quick(tmp_path):
    """2 processes x 2 shards: both equal one process's engine."""
    t0 = time.time()
    results = _run_pair(tmp_path, "quick", spp=2, timeout=60)
    assert time.time() - t0 < 60
    assert [r["ndev"] for r in results] == [4, 4]
    assert [r["local_shards"] for r in results] == [[0, 1], [2, 3]]
    assert not any(r["jax_loaded"] for r in results)
    assert results[0]["results"] == results[1]["results"]
    assert results[0]["results"] == _golden()


@pytest.mark.slow
def test_two_process_parity(tmp_path):
    results = _run_pair(tmp_path, "pair")
    assert results[0]["ndev"] == 8
    assert results[0]["results"] == results[1]["results"]
    assert results[0]["results"] == _golden()


@pytest.mark.slow
def test_kill_one_host_midbatch_then_recover(tmp_path):
    port = _free_port()
    outs = [str(tmp_path / f"fault_{i}.json") for i in range(2)]
    logs = [str(tmp_path / f"fault_{i}.log") for i in range(2)]
    hb = str(tmp_path / "hb")
    procs = [
        _launch(port, i, outs[i], logs[i], loop=True,
                heartbeat=hb if i == 0 else "")
        for i in range(2)
    ]
    # wait until the pair is mid-work (heartbeat advancing), then kill
    deadline = time.time() + 240
    while time.time() < deadline and not os.path.exists(hb):
        if any(p.poll() not in (None, 0) for p in procs):
            pytest.fail("worker died before reaching steady state")
        time.sleep(0.5)
    assert os.path.exists(hb), "pair never reached steady state"
    procs[1].send_signal(signal.SIGKILL)  # exact child PID, never a pattern
    # the survivor is wedged in a collective against a dead peer: that IS
    # the failure mode; tear the job down like a supervisor would
    time.sleep(2)
    procs[0].kill()
    for p in procs:
        p.wait(timeout=60)

    # stateless recovery: fresh bring-up reproduces the golden results
    results = _run_pair(tmp_path, "recovered")
    assert results[0]["results"] == results[1]["results"]
    assert results[0]["results"] == _golden()


if __name__ == "__main__" and "--worker" in sys.argv:
    sys.exit(_worker(sys.argv[1:]))
