"""Multi-process distributed search over ``torch.distributed``.

PyTorch counterpart of ``stringsearchlib_tpu.parallel.multihost``.
``init_distributed`` joins a process group over TCP; ``global_mesh`` is a
process-major 1-D mesh (the shards of one process are adjacent), of which
each process holds only its own shards' devices; ``MultiHostShardedEngine``
is the term-sharded engine over it.  Every merge first stacks or folds this
process's shards on its first device, as the one-process engine does, then
makes one collective over the world group - ``all_gather`` for the top-k
triples, ``all_reduce`` (MAX / SUM) for the per-key vectors - so every
process ends with the same merged tensors and finishes identically: all
processes call the same search methods in the same order (an SPMD host
program), the reference's multi-host contract.

gloo's support for CUDA tensors differs by collective, so with the gloo
backend every collective's tensor is staged through host memory
explicitly; with NCCL (one card per process) the same calls take the card's
tensors.  NCCL will not place two ranks of one communicator on one card, so
several processes on one card run over gloo.

Deployment model (stateless recovery): every process builds (or loads) the
same HostIndex from source data, shards it identically, and places only its
own shards.  A failed process is recovered by restarting the group:
re-initialize, re-shard from the host arrays, re-run - the build is
deterministic, so results are identical.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as tdist

from .dist import AXIS, Mesh, ShardedEngine, ShardedIndex, _devices


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: str = "gloo",
) -> tuple[int, int]:
    """Join the process group of ``num_processes`` processes whose rank 0
    listens at ``coordinator_address`` (``host:port``), over TCP.
    ``backend``: "gloo" (any devices; one card shared by several processes)
    or "nccl" (one card per process).  Returns (process count, this
    process's rank)."""
    tdist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )
    return tdist.get_world_size(), tdist.get_rank()


class ProcessMesh(Mesh):
    """A process-major mesh across the process group: ``devices`` are this
    process's shards' devices, ``first_shard`` its first global shard.  The
    merges add one collective over the world group after the local one."""

    def __init__(self, devices, axis_name: str, world: int, rank: int):
        super().__init__(devices, (axis_name,), (world * len(devices),),
                         rank * len(devices))
        self.world = world
        self.staged = tdist.get_backend() == "gloo"

    def _on_wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t.contiguous()

    def stack(self, parts: list) -> torch.Tensor:
        local = self._on_wire(super().stack(parts))
        outs = [torch.empty_like(local) for _ in range(self.world)]
        tdist.all_gather(outs, local)
        return torch.cat(outs).to(self.device)

    def _all_reduce(self, local: torch.Tensor, op) -> torch.Tensor:
        t = self._on_wire(local)
        tdist.all_reduce(t, op=op)
        return t.to(self.device)

    def reduce_max(self, parts: list) -> torch.Tensor:
        return self._all_reduce(super().reduce_max(parts), tdist.ReduceOp.MAX)

    def reduce_sum(self, parts: list) -> torch.Tensor:
        return self._all_reduce(super().reduce_sum(parts), tdist.ReduceOp.SUM)


def global_mesh(shards_per_process: int, axis_name: str = AXIS,
                device=None) -> ProcessMesh:
    """1-D mesh over every process's shards, process-major: this process
    holds global shards [rank * n, (rank + 1) * n).  Its shards go to its
    own CUDA card (``rank % device_count``; a RuntimeError without one) by
    default, or to ``device`` (one device for all, or one per shard).
    Needs ``init_distributed`` first."""
    if not tdist.is_initialized():
        raise RuntimeError("init_distributed must run before global_mesh")
    world, rank = tdist.get_world_size(), tdist.get_rank()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device=\"cpu\" to shard "
                "on the CPU"
            )
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return ProcessMesh(_devices(shards_per_process, device), axis_name, world, rank)


class MultiHostShardedEngine(ShardedEngine):
    """ShardedEngine over a multi-process mesh.

    Identical query semantics; each process places only its own shards
    (``mesh.shard_ids``) and the merges gather the other processes' shards
    (``ProcessMesh``), so every process fetches identical results.
    ``mesh`` defaults to ``global_mesh`` with an equal share of the shards
    per process."""

    def __init__(self, sharded: ShardedIndex, mesh: Optional[ProcessMesh] = None):
        if mesh is None:
            if not tdist.is_initialized():
                raise RuntimeError("init_distributed must run before MultiHostShardedEngine")
            world = tdist.get_world_size()
            if sharded.n_shards % world:
                raise ValueError(
                    f"{sharded.n_shards} shards do not split over {world} processes"
                )
            mesh = global_mesh(sharded.n_shards // world)
        if not isinstance(mesh, ProcessMesh):
            raise TypeError("MultiHostShardedEngine needs a global_mesh()")
        super().__init__(sharded, mesh)
