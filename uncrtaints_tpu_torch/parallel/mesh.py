"""Data parallel over processes: one process per GPU, NCCL between them.

Port of uncrtaints_tpu/parallel/mesh.py. The JAX package replicates the
parameters over a 1-D ``data`` mesh of devices and shards the batch; the
gradient mean is a ``psum`` that XLA inserts. Here each GPU has a process of
its own (``torchrun --nproc_per_node N``), each process holds a full copy of
the model and the rows of the global batch that are its own
(:func:`shard_batch`), and the collectives are explicit: the train step
all-reduces its flattened gradients once, weighted by each rank's share of
the global rows (train/engine.py), and the train-mode batch norms all-reduce
their per-channel sums, so that their statistics are those of the global
batch, as under pjit (models/layers.py, models/ltae.py).

When a process group is initialised every collective runs, at world size 1
too. ``torch.distributed`` runs over NCCL on the GPU and over gloo when the
caller names the CPU (the tests). Spatial sharding (the JAX package's
``make_mesh_2d``, ``spatial_sharding``) has no counterpart yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 1-D ``data`` mesh: this process's ``rank`` among ``size`` ranks."""
    rank: int
    size: int
    axis_names: Tuple[str, ...] = ("data",)


def active() -> bool:
    """Whether a process group is initialised (then every collective runs)."""
    return dist.is_available() and dist.is_initialized()


def current_mesh() -> Mesh:
    """This process's place: the process group's, or rank 0 of 1."""
    if active():
        return Mesh(dist.get_rank(), dist.get_world_size())
    return Mesh(0, 1)


def _env_int(*names: str, default: int) -> int:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return default


def maybe_init_distributed(device="cuda") -> Tuple[int, int]:
    """Initialise the process group when the environment names one, and
    return ``(rank, world size)``; ``(0, 1)`` without one. Idempotent.

    Read, in order: torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` with
    ``MASTER_ADDR`` / ``MASTER_PORT``; or the JAX package's spelling
    (mesh.py:44-65), ``JAX_COORDINATOR_ADDRESS`` / ``COORDINATOR_ADDRESS``
    ("host:port") with ``JAX_NUM_PROCESSES`` / ``NUM_PROCESSES`` and
    ``JAX_PROCESS_ID`` / ``PROCESS_ID``. On a CUDA ``device`` the process
    takes the card ``LOCAL_RANK`` (else its rank modulo the cards) as its
    current device and joins over NCCL; on the CPU over gloo."""
    if active():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world, init = int(env["RANK"]), int(env["WORLD_SIZE"]), "env://"
    else:
        coord = env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS")
        if not coord:
            return 0, 1
        rank = _env_int("JAX_PROCESS_ID", "PROCESS_ID", default=0)
        world = _env_int("JAX_NUM_PROCESSES", "NUM_PROCESSES", default=1)
        init = f"tcp://{coord}"
    dev = torch.device(device)
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK", default=rank % max(1, torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method=init, rank=rank, world_size=world,
                                device_id=torch.device("cuda", local))
    elif dev.type == "cpu":
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    else:
        raise ValueError(f"maybe_init_distributed: no backend for device {device!r}")
    return rank, world


def make_mesh(n_devices=None) -> Mesh:
    """The 1-D data mesh over ``n_devices`` ranks (all of them when None).
    Raises when fewer ranks run: a silently smaller mesh would let a
    multi-GPU check pass on one card."""
    mesh = current_mesh()
    if n_devices is not None and mesh.size < n_devices:
        raise RuntimeError(
            f"make_mesh: requested {n_devices} ranks but only {mesh.size} run (start "
            f"one process per GPU: torchrun --nproc_per_node {n_devices})")
    return mesh


def row_split(n: int, rank: int, world: int) -> Tuple[int, int]:
    """(offset, count) of rank's rows when n rows are split over world ranks
    as evenly as can be, the first ``n % world`` ranks taking one more."""
    base, extra = divmod(n, world)
    return rank * base + min(rank, extra), base + (rank < extra)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """The rows of a global batch that are ``mesh.rank``'s (:func:`row_split`
    of the leading axis); values without a leading axis pass as they are."""
    n = next(len(v) for v in batch.values()
             if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0)
    off, cnt = row_split(n, mesh.rank, mesh.size)
    return {k: v[off:off + cnt] if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0
            else v for k, v in batch.items()}


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (the group must be initialised)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the output gradients over the
    ranks, since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_sum(t.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone())


def all_reduce_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """A differentiable sum over the ranks: the train-mode batch norms'
    statistics (their gradient reaches every rank's rows)."""
    return _AllReduceSum.apply(t)


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Copy rank ``src``'s parameters and buffers to every rank (the JAX
    CLI's replicated state)."""
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src)


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if active():
        dist.barrier()
