"""The shard layout of the distributed layer (the port of the JAX
package's ``parallel/mesh.py``).

The reference builds a 1-D ``jax`` mesh over the row axis ``"x"`` and
runs one program per chip under ``shard_map``.  In this slice of the
port the D shards of that axis are stacked on one card: every sharded
tensor carries a leading shard axis of size D, a ``ppermute`` along the
ring is a roll of that axis, a ``psum`` a sum over it, and the ring
kernels (``parallel/ring_kernels.py``) run all D ranks in one launch,
each writing its neighbour's buffers through that rank's base pointer.
One rank per card (the same kernels on peer pointers over NVLink, or
``torch.distributed`` with one process per card, with the multi-host
``init_distributed``) is ROADMAP A10's next step.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import resolve_device

ROW_AXIS = "x"


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """D row shards stacked on one device."""

    num_shards: int
    device: torch.device


def make_mesh(n_shards: int = 1, device: torch.device | str | None = None) -> ShardMesh:
    """A 1-D mesh of ``n_shards`` shards along :data:`ROW_AXIS`, all on
    ``device``: by default the current CUDA card, as the reference's mesh
    is built over the accelerator's devices.  Without a card the default
    raises; a CPU mesh is only made when ``device="cpu"`` is asked for."""
    if n_shards < 1:
        raise ValueError(f"need at least one shard, got {n_shards}")
    return ShardMesh(int(n_shards), resolve_device(device, "make_mesh"))
