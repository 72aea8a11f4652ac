"""The shard layout of the distributed layer (the port of the JAX
package's ``parallel/mesh.py``).

The reference builds a ``jax`` mesh over the row axis ``"x"`` (and a
2-D ``("x", "y")`` one for the column-striped SpGEMM) and runs one
program per chip under ``shard_map``.  In the port the shards of that
mesh are stacked on one card: every sharded tensor carries a leading
shard axis, and the reference's collectives become

* ``all_gather`` over an axis: the stacked tensor itself, read as a
  view; on one card it moves no bytes, so the times of the sharded
  modules are compute only;
* ``ppermute(i -> i + 1)``: ``torch.roll(x, 1, 0)`` on the shard axis;
* ``psum``: a sum over the shard axis, in shard order (deterministic);
* ``axis_index``: the loop index of the per-shard body, which runs as a
  Python loop over the shards.

The ring kernels (``parallel/ring_kernels.py``) run all D ranks in one
launch, each writing its neighbour's buffers through that rank's base
pointer.  One rank per card (the same kernels on peer pointers over
NVLink, or ``torch.distributed`` with one process per card, brought up
by :func:`init_distributed`) is ROADMAP A10's cross-card step.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed

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


def make_mesh(
    n_shards: int | tuple = 1, device: torch.device | str | None = None
) -> ShardMesh:
    """A mesh of ``n_shards`` shards along :data:`ROW_AXIS`, or of
    ``nx * ny`` shards over ``("x", "y")`` for a shape ``(nx, ny)`` (the
    reference's ``jax.make_mesh((nx, ny), ("x", "y"))``), all on
    ``device``: by default the current CUDA card, as the reference's
    mesh is built over the accelerator's devices.  Without a card the
    default raises; a CPU mesh is only made when ``device="cpu"`` is
    asked for."""
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

    mesh: ShardMesh
    axis: str | None

    def put(self, x):
        """``jax.device_put(x, sharding)``: ``x`` (a tensor, or a
        dataclass of tensors such as a ShardedCSR) on the mesh's device.
        A row-sharded tensor must carry one block a shard along its
        leading dimension."""
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: self.put(getattr(x, f.name)) for f in dataclasses.fields(x)
                if isinstance(getattr(x, f.name), torch.Tensor)
            })
        if self.axis is not None and (x.dim() == 0 or x.shape[0] != self.mesh.axis_size(self.axis)):
            raise ValueError(f"a tensor of shape {tuple(x.shape)} has no leading axis of "
                             f"{self.mesh.axis_size(self.axis)} shards along {self.axis!r}")
        return x.to(self.mesh.device)


def row_sharding(mesh: ShardMesh, axis: str = ROW_AXIS) -> StackedSharding:
    """Split the leading (shard-stack) axis across ``axis`` of the mesh."""
    return StackedSharding(mesh, axis)


def replicated(mesh: ShardMesh) -> StackedSharding:
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
    launch (:func:`_multi_process_launch`) and is a no-op otherwise."""
    if kwargs:
        torch.distributed.init_process_group(**kwargs)
    elif _multi_process_launch():
        torch.distributed.init_process_group()
