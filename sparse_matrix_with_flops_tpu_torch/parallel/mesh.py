"""The shard layout of the distributed layer (the port of the JAX
package's ``parallel/mesh.py``).

The reference builds a ``jax`` mesh over the row axis ``"x"`` (and a
2-D ``("x", "y")`` one for the column-striped SpGEMM) over the devices of
every process, and runs one program per device under ``shard_map``.  The
port has two kinds of mesh:

* :class:`ShardMesh`, the shards stacked on one device, when no process
  group of more than one rank is up: every sharded tensor carries a
  leading shard axis of D, the per-shard bodies run as a Python loop over
  the shards, and the reference's collectives are views and index
  operations of the stack (``parallel/collectives.py``): on one card an
  all-gather moves no bytes;
* :class:`ProcessMesh`, one shard a process, when ``torch.distributed``
  is initialised with world size W > 1 (the mode follows from the
  process group, as ``jax.make_mesh`` spans every process's devices):
  rank r holds shard r of a 1-D mesh, or shard ``(x, y) = divmod(r, ny)``
  of a 2-D ``(nx, ny)`` one (row-major, the order in which
  ``jax.make_mesh((nx, ny), ("x", "y"))`` lays out its devices); its
  sharded tensors carry a leading axis of 1, the per-shard body runs
  once, and the collectives are ``torch.distributed``'s (all-gather,
  send / receive), with the backend the caller started the group with,
  along one axis of a 2-D mesh through the subgroups the mesh made when
  it was created.  Its device is ``cuda:(LOCAL_RANK % device_count())``,
  or the CPU when asked for.

The ring kernels (``parallel/ring_kernels.py``) follow the mesh: on a
stacked mesh one launch runs all D ranks, each writing its neighbour's
buffers through that rank's base pointer; on a process mesh each rank
launches its own part and reaches its neighbour's buffers through CUDA
IPC peer pointers (``parallel/peer.py``), on the same card or another.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

from ..config import resolve_device

ROW_AXIS = "x"
COL_AXIS = "y"


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """Shards stacked on one device: a 1-D mesh ``(D,)`` over
    :data:`ROW_AXIS`, or a 2-D ``(nx, ny)`` over ``("x", "y")``."""

    num_shards: int
    device: torch.device
    shape: tuple = ()
    axis_names: tuple = (ROW_AXIS,)

    def axis_size(self, axis: str) -> int:
        return (self.shape or (self.num_shards,))[self.axis_names.index(axis)]


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """One shard a process of the default process group, of which this
    process holds shard ``rank`` on ``device``: a 1-D mesh
    ``(num_shards,)`` over :data:`ROW_AXIS`, or a 2-D ``(nx, ny)`` over
    ``("x", "y")`` with rank r at ``(x, y) = divmod(r, ny)``.  ``groups``
    maps each axis of a 2-D mesh to the process group of the ranks that
    share this rank's other coordinate (None: no group of its own, the
    axis spans one rank or all of them)."""

    num_shards: int
    rank: int
    device: torch.device
    shape: tuple = ()
    axis_names: tuple = (ROW_AXIS,)
    groups: dict = dataclasses.field(default_factory=dict, compare=False, hash=False,
                                     repr=False)

    def axis_size(self, axis: str) -> int:
        return (self.shape or (self.num_shards,))[self.axis_names.index(axis)]

    def coords(self) -> tuple:
        """This rank's index along each axis, row-major."""
        if len(self.shape) == 2:
            return divmod(self.rank, self.shape[1])
        return (self.rank,)


def _group_size() -> int:
    """The default process group's world size, 1 when none is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank_device() -> torch.device:
    """This rank's card: ``cuda:(LOCAL_RANK % device_count())``, with the
    global rank for ``LOCAL_RANK`` when the launcher set none."""
    if not torch.cuda.is_available():
        raise RuntimeError('process mesh: no CUDA device; pass device="cpu" to work on the CPU')
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def _axis_groups(nx: int, ny: int) -> dict:
    """The subgroups of a 2-D process mesh: for each axis, the group of
    the ranks that share this rank's other coordinate, in axis order.
    ``dist.new_group`` is collective over the whole default group, so
    every rank creates every subgroup, in one order; an axis of one rank
    or of all of them needs none."""
    world, me = dist.get_world_size(), dist.get_rank()
    lines = {
        ROW_AXIS: [[x * ny + y for x in range(nx)] for y in range(ny)],
        COL_AXIS: [[x * ny + y for y in range(ny)] for x in range(nx)],
    }
    groups = {}
    for axis, members in lines.items():
        groups[axis] = None
        if len(members[0]) in (1, world):
            continue
        for ranks in members:
            g = dist.new_group(ranks)
            if me in ranks:
                groups[axis] = g
    return groups


def process_mesh(
    device: torch.device | str | None = None, shape: tuple | None = None
) -> ProcessMesh:
    """The mesh of the default process group, one shard a rank, at any
    world size (1 included), on ``device``: by default this rank's card
    (:func:`rank_device`).  ``shape`` is ``(W,)`` by default, or a 2-D
    ``(nx, ny)`` with ``nx * ny == W`` (collective: it creates the
    subgroups of the axes).  :func:`make_mesh` returns it when the group
    has more than one rank."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("process_mesh: no torch.distributed process group is initialised")
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    if len(shape) not in (1, 2) or math.prod(shape) != world:
        raise ValueError(f"a process mesh of shape {shape} under a process group of {world} "
                         f"ranks: it has one shard a rank, {world} in all")
    dev = rank_device() if device is None else torch.device(device)
    if len(shape) == 1:
        return ProcessMesh(world, dist.get_rank(), dev, shape)
    return ProcessMesh(world, dist.get_rank(), dev, shape, (ROW_AXIS, COL_AXIS),
                       _axis_groups(*shape))


def make_mesh(
    n_shards: int | tuple | None = None, device: torch.device | str | None = None
) -> ShardMesh | ProcessMesh:
    """A mesh of ``n_shards`` shards along :data:`ROW_AXIS`, or of
    ``nx * ny`` shards over ``("x", "y")`` for a shape ``(nx, ny)`` (the
    reference's ``jax.make_mesh((nx, ny), ("x", "y"))``).

    Under a process group of W > 1 ranks it is the process mesh of the
    group (:func:`process_mesh`): ``n_shards`` must be W or None, or a
    shape ``(nx, ny)`` with ``nx * ny == W`` (else ``ValueError``).
    Otherwise the shards are stacked on ``device`` (one shard when
    ``n_shards`` is None): by default the current CUDA card, as the
    reference's mesh is built over the accelerator's devices.  Without a
    card the default raises; a CPU mesh is only made when
    ``device="cpu"`` is asked for."""
    world = _group_size()
    if world > 1:
        return process_mesh(device, None if n_shards is None else (
            tuple(n_shards) if isinstance(n_shards, (tuple, list)) else (n_shards,)))
    if n_shards is None:
        n_shards = 1
    shape = tuple(int(s) for s in n_shards) if isinstance(n_shards, (tuple, list)) else (
        int(n_shards),)
    if len(shape) not in (1, 2) or min(shape) < 1:
        raise ValueError(f"need one or two axes of at least one shard, got {n_shards}")
    names = (ROW_AXIS,) if len(shape) == 1 else (ROW_AXIS, COL_AXIS)
    return ShardMesh(shape[0] * (shape[1] if len(shape) == 2 else 1),
                     resolve_device(device, "make_mesh"), shape, names)


@dataclasses.dataclass(frozen=True)
class StackedSharding:
    """The stacked mesh's counterpart of a ``NamedSharding``: the
    mesh's device and the axis the leading (shard-stack) dimension is
    split over, or None for a replicated operand."""

    mesh: ShardMesh | ProcessMesh
    axis: str | None

    def put(self, x):
        """``jax.device_put(x, sharding)``: ``x`` (a tensor, or a
        dataclass of tensors such as a ShardedCSR) on the mesh's device.
        A row-sharded tensor must carry one block a shard along its
        leading dimension (on a process mesh, this rank's one block)."""
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: self.put(getattr(x, f.name)) for f in dataclasses.fields(x)
                if isinstance(getattr(x, f.name), torch.Tensor)
            })
        if self.axis is not None:
            want = 1 if isinstance(self.mesh, ProcessMesh) else self.mesh.axis_size(self.axis)
            if x.dim() == 0 or x.shape[0] != want:
                raise ValueError(f"a tensor of shape {tuple(x.shape)} has no leading axis of "
                                 f"{want} shards along {self.axis!r}")
        return x.to(self.mesh.device)


def row_sharding(mesh: ShardMesh | ProcessMesh, axis: str = ROW_AXIS) -> StackedSharding:
    """Split the leading (shard-stack) axis across ``axis`` of the mesh."""
    return StackedSharding(mesh, axis)


def replicated(mesh: ShardMesh | ProcessMesh) -> StackedSharding:
    return StackedSharding(mesh, None)


def _multi_process_launch() -> bool:
    """Whether the environment marks a launch of several processes:
    ``MASTER_ADDR`` with ``WORLD_SIZE`` > 1 (torchrun and its kin), or
    ``SLURM_NTASKS`` > 1 inside a Slurm job.  Read from the environment
    alone, so that no backend is touched first."""
    if os.environ.get("MASTER_ADDR") and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return True
    return int(os.environ.get("SLURM_NTASKS", "1")) > 1 and bool(os.environ.get("SLURM_JOB_ID"))


def init_distributed(**kwargs) -> None:
    """Multi-process bring-up, the counterpart of the reference's
    ``jax.distributed.initialize`` wrapper.  With keyword arguments it
    calls ``torch.distributed.init_process_group(**kwargs)``; with none
    it initialises only when the environment marks a multi-process
    launch (:func:`_multi_process_launch`) and is a no-op otherwise.
    When it starts a group on a machine with a card, it first makes this
    rank's card (``LOCAL_RANK``, or ``kwargs["rank"]``, modulo the card
    count) the current device."""
    if not (kwargs or _multi_process_launch()):
        return
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", kwargs.get("rank", os.environ.get("RANK", 0))))
        torch.cuda.set_device(local % torch.cuda.device_count())
    torch.distributed.init_process_group(**kwargs)
