"""Data parallel over processes (one per GPU, NCCL between them), and the
2-D ``data x spatial`` mesh that also splits image rows over processes.

Port of uncrtaints_tpu/parallel/mesh.py. The JAX package replicates the
parameters over a 1-D ``data`` mesh of devices and shards the batch; the
gradient mean is a ``psum`` that XLA inserts. Here each GPU has a process of
its own (``torchrun --nproc_per_node N``), each process holds a full copy of
the model and the rows of the global batch that are its own
(:func:`shard_batch`), and the collectives are explicit: the train step
all-reduces its flattened gradients once, weighted by each rank's share of
the global pixels (train/engine.py), and the train-mode batch norms
all-reduce their per-channel sums, so that their statistics are those of the
global batch, as under pjit (models/layers.py, models/ltae.py).

When a process group is initialised every collective runs, at world size 1
too. ``torch.distributed`` runs over NCCL on the GPU (with gloo beside it for
the CPU tensors of an asynchronous checkpoint) and over gloo when the caller
names the CPU (the tests) or asks for it (two ranks that share one card).

The 2-D mesh (:func:`make_mesh_2d`, the JAX package's ``make_mesh_2d`` and
``spatial_sharding``) puts ``n_data x n_spatial`` ranks in data-major order:
rank ``d * n_spatial + s`` holds sample rows ``d`` of the batch and image row
band ``s`` of each sample. Where GSPMD inserts the halo exchanges and the
reductions over the spatial axis by itself, here each layer asks for them:
:func:`halo_exchange` gives a band its neighbours' edge rows (and sends
their gradients back), and :func:`spatial_sum` sums over the ranks of one
spatial group. The mesh made last is the module's current 2-D mesh
(:func:`spatial`), so the layers read it without new arguments down the
model; with ``n_spatial == 1`` nothing changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Optional, Tuple

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


def maybe_init_distributed(device="cuda", backend: Optional[str] = None) -> Tuple[int, int]:
    """Initialise the process group when the environment names one, and
    return ``(rank, world size)``; ``(0, 1)`` without one. Idempotent.

    Read, in order: torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` with
    ``MASTER_ADDR`` / ``MASTER_PORT``; or the JAX package's spelling
    (mesh.py:44-65), ``JAX_COORDINATOR_ADDRESS`` / ``COORDINATOR_ADDRESS``
    ("host:port") with ``JAX_NUM_PROCESSES`` / ``NUM_PROCESSES`` and
    ``JAX_PROCESS_ID`` / ``PROCESS_ID``. On a CUDA ``device`` the process
    takes the card ``LOCAL_RANK`` (else its rank) modulo the cards as its
    current device and joins over NCCL, with gloo beside it for CPU tensors
    (``torch.distributed.checkpoint.async_save`` needs one); on the CPU over
    gloo. ``backend="gloo"`` joins over gloo on the card too: NCCL refuses
    two ranks on one device."""
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
        # ranks beyond the cards share them (gloo only)
        local = _env_int("LOCAL_RANK", default=rank) % max(1, torch.cuda.device_count())
        torch.cuda.set_device(local)
        if backend == "gloo":
            dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
        else:
            dist.init_process_group(backend or "cpu:gloo,cuda:nccl", init_method=init,
                                    rank=rank, world_size=world,
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


def shard_batch(batch: Dict, mesh) -> Dict:
    """The rows of a global batch that are ``mesh.rank``'s (:func:`row_split`
    of the leading axis); values without a leading axis pass as they are. On
    a :class:`Mesh2D` the samples split over ``data`` and, in the arrays of
    four or more axes, the image rows (axis 2) over ``spatial`` into even
    bands (an uneven split is refused); ``dates`` stays whole."""
    if isinstance(mesh, Mesh2D):
        return _shard_2d(batch, mesh)
    n = next(len(v) for v in batch.values()
             if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0)
    off, cnt = row_split(n, mesh.rank, mesh.size)
    return {k: v[off:off + cnt] if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0
            else v for k, v in batch.items()}


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` (all of them when None) in
    place (the process group must be initialised)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of a group; the backward sums the output gradients
    over the same ranks, since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.group), None


def all_reduce_sum_grad(t: torch.Tensor, group=None) -> torch.Tensor:
    """A differentiable sum over the ranks of ``group`` (all of them when
    None): the train-mode batch norms' statistics over the world, the group
    norms' and the SE mean over a spatial group (their gradient reaches
    every rank's rows)."""
    return _AllReduceSum.apply(t, group)


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


# ------------------------------------------------------------ the 2-D mesh --

@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """The 2-D ``data x spatial`` mesh: this process's ``rank`` among
    ``n_data * n_spatial`` ranks in data-major order, and the process groups
    of its spatial group (the ranks that hold the bands of the same samples)
    and of its data group (the ranks that hold the same band)."""
    rank: int
    n_data: int
    n_spatial: int
    spatial_group: object = dataclasses.field(default=None, compare=False, repr=False)
    data_group: object = dataclasses.field(default=None, compare=False, repr=False)
    axis_names: Tuple[str, ...] = ("data", "spatial")

    @property
    def size(self) -> int:
        return self.n_data * self.n_spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.n_spatial

    @property
    def devices(self) -> np.ndarray:
        """The ranks laid out as ``mesh_utils.create_device_mesh((n_data,
        n_spatial))`` lays out devices: [n_data, n_spatial]."""
        return np.arange(self.size).reshape(self.n_data, self.n_spatial)


_CURRENT_2D: Optional[Mesh2D] = None


def make_mesh_2d(n_data: int, n_spatial: int) -> Mesh2D:
    """The 2-D ``data x spatial`` mesh over every rank of the process group
    (``n_data * n_spatial`` of them), made the module's current 2-D mesh.
    Raises on a shortfall, like :func:`make_mesh`, and when ranks would be
    left out: each process is one place of the mesh. Every rank must call it
    (it makes one process group for each spatial and each data group)."""
    global _CURRENT_2D
    need = n_data * n_spatial
    world = dist.get_world_size() if active() else 1
    if world < need:
        raise RuntimeError(
            f"make_mesh_2d: requested {n_data}x{n_spatial}={need} ranks but only {world} run "
            f"(start one process a place: torchrun --nproc_per_node {need})")
    if world > need:
        raise RuntimeError(f"make_mesh_2d: {n_data}x{n_spatial}={need} places for {world} "
                           f"ranks (every rank is one place of the mesh)")
    rank = dist.get_rank() if active() else 0
    sg = dg = None
    if active():
        for d in range(n_data):  # every rank makes every group, in one order
            g = dist.new_group([d * n_spatial + s for s in range(n_spatial)])
            if d == rank // n_spatial:
                sg = g
        for s in range(n_spatial):
            g = dist.new_group([d * n_spatial + s for d in range(n_data)])
            if s == rank % n_spatial:
                dg = g
    _CURRENT_2D = Mesh2D(rank, n_data, n_spatial, sg, dg)
    return _CURRENT_2D


def current_mesh_2d() -> Optional[Mesh2D]:
    """The current 2-D mesh, or None."""
    return _CURRENT_2D


@contextlib.contextmanager
def use_mesh_2d(m: Optional[Mesh2D]):
    """Run a block with ``m`` as the current 2-D mesh (None: as one process,
    every band a whole image), then restore the one before."""
    global _CURRENT_2D
    before, _CURRENT_2D = _CURRENT_2D, m
    try:
        yield m
    finally:
        _CURRENT_2D = before


def spatial() -> Optional[Mesh2D]:
    """The current 2-D mesh when it splits rows (``n_spatial > 1``), else
    None: the layers' test for the spatial path."""
    m = _CURRENT_2D
    return m if m is not None and m.n_spatial > 1 else None


@dataclasses.dataclass(frozen=True)
class SpatialSharding:
    """Where an array of ``ndim`` axes lives on a 2-D mesh: axis 0 over
    ``data`` (:func:`row_split` of the samples), axis ``h_axis`` over
    ``spatial`` (even bands), every other axis whole. ``shard(a)`` is this
    rank's block."""
    mesh: Mesh2D
    ndim: int
    h_axis: int = 2

    @property
    def spec(self) -> Tuple[Optional[str], ...]:
        return tuple("data" if i == 0 else "spatial" if i == self.h_axis else None
                     for i in range(self.ndim))

    def shard(self, a):
        m = self.mesh
        if a.ndim != self.ndim:
            raise ValueError(f"spatial_sharding: an array of {self.ndim} axes expected, got "
                             f"{tuple(a.shape)}")
        a = a[_samples(len(a), m)]
        H = a.shape[self.h_axis]
        if H % m.n_spatial:
            raise ValueError(f"spatial_sharding: {H} rows do not split into {m.n_spatial} "
                             f"even bands")
        band = H // m.n_spatial
        idx = [slice(None)] * a.ndim
        idx[self.h_axis] = slice(m.spatial_rank * band, (m.spatial_rank + 1) * band)
        return a[tuple(idx)]


def spatial_sharding(mesh: Mesh2D, ndim: int, h_axis: int = 2) -> SpatialSharding:
    """Batch on ``data``, image-row axis ``h_axis`` on ``spatial``, every
    other axis whole: h_axis=2 for the [B,T,H,W,C] inputs and the
    [B,1,H,W,C] targets."""
    return SpatialSharding(mesh, ndim, h_axis)


def _shard_2d(batch: Dict, m: Mesh2D) -> Dict:
    """:func:`shard_batch` on a 2-D mesh: arrays of four or more axes (the
    images, targets and masks) split axis 2 into bands as well, ``dates``
    and the other small arrays only their samples."""
    def piece(v):
        if not isinstance(v, (np.ndarray, torch.Tensor)) or v.ndim == 0:
            return v
        if v.ndim >= 4:
            return spatial_sharding(m, v.ndim, 2).shard(v)
        return v[_samples(len(v), m)]
    return {k: piece(v) for k, v in batch.items()}


def _samples(n: int, m: Mesh2D) -> slice:
    """This data rank's samples of n (:func:`row_split`); a rank without any
    could not join the collectives of the steps, so fewer samples than data
    ranks are refused."""
    if n < m.n_data:
        raise ValueError(f"shard_batch: {n} samples for {m.n_data} data ranks")
    off, cnt = row_split(n, m.data_rank, m.n_data)
    return slice(off, off + cnt)


def _gather(t: torch.Tensor, m: Mesh2D):
    """Every spatial rank's ``t`` (one shape on all), by all_gather over the
    spatial group; moved as raw bytes (uint8), so that any backend takes any
    dtype (gloo refuses bf16 and int16 on the card)."""
    raw = t.contiguous().view(torch.uint8)
    got = [torch.empty_like(raw) for _ in range(m.n_spatial)]
    dist.all_gather(got, raw, group=m.spatial_group)
    return [g.view(t.dtype) for g in got]


class _HaloExchange(torch.autograd.Function):
    """(top, bot): the last k rows of the band above and the first k rows of
    the band below (0 rows at the scene's edge). The backward sends each
    halo's gradient to the rank that owns those rows, which adds it to its
    own rows' gradient: an input row at a band's edge feeds its own outputs
    and its neighbour's, and both reach it."""

    @staticmethod
    def forward(ctx, x, k, h, m):
        ctx.k, ctx.h, ctx.m, ctx.shape = k, h, m, x.shape
        H, s, n = x.shape[h], m.spatial_rank, m.n_spatial
        got = _gather(torch.cat([x.narrow(h, 0, k), x.narrow(h, H - k, k)], h), m)
        top = got[s - 1].narrow(h, k, k).contiguous() if s > 0 else x.new_empty(0)
        bot = got[s + 1].narrow(h, 0, k).contiguous() if s < n - 1 else x.new_empty(0)
        return top, bot

    @staticmethod
    def backward(ctx, gtop, gbot):
        k, h, m = ctx.k, ctx.h, ctx.m
        s, n = m.spatial_rank, m.n_spatial
        shape = list(ctx.shape)
        shape[h] = k
        part = [gtop if s > 0 else gtop.new_zeros(shape),
                gbot if s < n - 1 else gbot.new_zeros(shape)]
        got = _gather(torch.cat(part, h), m)
        gx = gtop.new_zeros(ctx.shape)
        H = ctx.shape[h]
        if s > 0:  # the band above read my first k rows as its bottom halo
            gx.narrow(h, 0, k).add_(got[s - 1].narrow(h, k, k))
        if s < n - 1:  # the band below read my last k rows as its top halo
            gx.narrow(h, H - k, k).add_(got[s + 1].narrow(h, 0, k))
        return gx, None, None, None


def halo_exchange(x: torch.Tensor, k: int, h_axis: int = 1,
                  m: Optional[Mesh2D] = None):
    """(top, bot): the ``k`` rows (along ``h_axis``) that the band above
    ends with and that the band below starts with, or None at the scene's
    edge; differentiable (the backward adds the halos' gradients to the
    rows they came from, on their rank). A band needs at least ``k`` rows;
    a smaller one raises, as does a call without a spatial mesh."""
    m = m or spatial()
    if m is None:
        raise RuntimeError("halo_exchange: no 2-D mesh with a spatial split (make_mesh_2d)")
    h = h_axis % x.dim()
    if x.shape[h] < k:
        raise ValueError(f"halo_exchange: a band of {x.shape[h]} rows is too small for a halo "
                         f"of {k} rows")
    top, bot = _HaloExchange.apply(x, k, h, m)
    return (top if m.spatial_rank > 0 else None,
            bot if m.spatial_rank < m.n_spatial - 1 else None)


def spatial_sum(t: torch.Tensor, m: Optional[Mesh2D] = None) -> torch.Tensor:
    """Differentiable sum of ``t`` over the current spatial group (the ranks
    that hold the bands of the same samples)."""
    m = m or spatial()
    return all_reduce_sum_grad(t, m.spatial_group)


def spatial_all(mask: torch.Tensor, m: Optional[Mesh2D] = None) -> torch.Tensor:
    """Elementwise AND of a boolean tensor over the spatial group (an
    all-pixels test of a band becomes the scene's)."""
    m = m or spatial()
    n = all_reduce_sum((~mask).to(torch.int32), m.spatial_group)
    return n == 0

