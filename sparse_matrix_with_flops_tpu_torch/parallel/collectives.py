"""The collectives of the distributed layer: the port's counterparts of
the ``jax.lax`` collectives that the JAX package calls inside
``shard_map`` (``all_gather``, ``ppermute``, ``psum``, ``axis_index``),
one implementation per mesh kind (``parallel/mesh.py``).

A sharded tensor's leading axis holds the shards this process runs: all
D on a stacked mesh (or when no mesh is given), this rank's one on a
process mesh.

* Stacked: ``all_gather`` is the stack itself (a view: on one card it
  moves no bytes), ``ppermute`` is ``torch.roll`` on the shard axis,
  ``psum`` a sum over it in shard order, and ``axis_index`` the loop
  index of the per-shard body.
* Process: ``all_gather`` is ``dist.all_gather_into_tensor``, over the
  whole group or, given an axis of a 2-D mesh, over the ranks that share
  the other coordinate (the mesh's subgroup for that axis),
  ``ppermute`` one ``dist.batch_isend_irecv`` (send to
  ``(me + shift) % W``, receive from ``(me - shift) % W``), ``psum`` the
  all-gathered values added as the stacked mesh adds them (never
  ``dist.all_reduce``: NCCL's order of addition is not the stacked
  path's, and a statistic such as R-MCL's ``differs`` must keep the
  stacked path's bits), and ``axis_index`` the rank.  The backend is the
  one the caller started the group with.  Under ``gloo``, ``ppermute``
  copies a tensor on a card to the host for the exchange and back: gloo's
  all-gather takes card tensors, but its send / receive do not (in torch
  2.11 a card tensor given to them aborts the process: gloo writes from
  the device pointer as if it were host memory).

The peer route: the compiled programs of ``parallel/rmcl_ell.py`` and
``parallel/spgemm.py`` move a process mesh's card tensors through
kernel K6 launched one rank at a time on CUDA IPC peer pointers
(``ring_kernels.peer_all_gather``, ``peer_ppermute`` for a shift of 1,
and :func:`psums` here): no ``torch.distributed`` call and no host round
trip, so a CUDA graph can capture the exchange.  The bytes moved are the
same, so the results keep their bits.  Every other caller (the dynamic
layer, the 2-D SpGEMM, plan-time gathers) and tensors on the CPU take
the group's calls above.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import ProcessMesh


def is_process(mesh) -> bool:
    """Whether ``mesh`` holds one shard a process."""
    return isinstance(mesh, ProcessMesh)


def local_ranks(mesh, d: int | None = None) -> list:
    """The global shard index of each shard this process runs, in the
    order of the leading axis: ``range(D)`` on a stacked mesh (``d`` when
    no mesh is given), ``[rank]`` on a process mesh."""
    if is_process(mesh):
        return [mesh.rank]
    return list(range(mesh.num_shards if mesh is not None else d))


def axis_index(mesh, i: int = 0) -> int:
    """``jax.lax.axis_index``: the global index of local shard ``i``."""
    return mesh.rank if is_process(mesh) else i


def _host_staged(x: torch.Tensor) -> bool:
    """Whether a send / receive of ``x`` goes through the host (gloo)."""
    return x.is_cuda and dist.get_backend() == "gloo"


def all_gather(mesh, x: torch.Tensor, axis: str | None = None) -> torch.Tensor:
    """Every shard's block: ``[L, ...] -> [D, ...]`` in shard order; with
    ``axis``, the blocks of the shards along that axis of a 2-D mesh
    that share this shard's other coordinate, in axis order (a stacked
    caller indexes its stack along the axis itself)."""
    if not is_process(mesh):
        return x
    src = x.contiguous()
    n = mesh.num_shards if axis is None else mesh.axis_size(axis)
    if n == 1:
        return src
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=None if axis is None else mesh.groups.get(axis))
    return out


def ppermute(mesh, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """``ppermute(i -> i + shift)``: shard ``me`` receives the block of
    shard ``(me - shift) mod D``."""
    if not is_process(mesh):
        return torch.roll(x, shift, 0)
    w = mesh.num_shards
    s = shift % w
    if s == 0:
        return x
    staged = _host_staged(x)
    src = x.cpu() if staged else x.contiguous()
    out = torch.empty_like(src)
    me = mesh.rank
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, (me + s) % w),
        dist.P2POp(dist.irecv, out, (me - s) % w),
    ])
    for r in reqs:
        r.wait()
    return out.to(x.device) if staged else out


def psum(mesh, x: torch.Tensor, axis: str | None = None, dtype=None) -> torch.Tensor:
    """The sum of every shard's value (along ``axis``, as
    :func:`all_gather`): ``x`` is [L], one value a local shard; the
    values are added as one sum over the shard axis, in shard order, in
    ``dtype`` (``torch.sum``'s default when None), on every mesh kind
    (the stacked path's bits)."""
    return all_gather(mesh, x, axis).sum(dtype=dtype)


def psums(mesh, xs) -> list:
    """``[psum(mesh, x) for x in xs]`` in one gather, on the peer route:
    on a process mesh the values (each [L], of 4- or 8-byte dtypes) go out
    as the int32 words of one block, and each is summed in its own dtype
    over the shard axis in shard order, as :func:`psum` adds it (the same
    bits)."""
    if not is_process(mesh):
        return [psum(mesh, x) for x in xs]
    from .ring_kernels import peer_all_gather

    # a trailing axis of stride 1 (a value's own stride may be any: a size-1 axis)
    words = torch.cat([x.reshape(-1).unsqueeze(-1).view(torch.int32) for x in xs], 1)
    every = peer_all_gather(words, mesh=mesh)[0]  # [D, words]
    out, at = [], 0
    for x in xs:
        w = x.element_size() // 4
        out.append(every[:, at:at + w].contiguous().reshape(-1).view(x.dtype).sum())
        at += w
    return out
