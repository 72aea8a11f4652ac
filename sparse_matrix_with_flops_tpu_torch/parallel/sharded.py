"""ShardedCSR: a CSR row-partitioned into D equal local blocks (the port
of the JAX package's ``parallel/sharded.py``).

Every per-row array gains a leading shard axis of size D and every block
has the same shape, so the stack is one tensor per array.  Row r lives
on shard r // local_rows as local row r % local_rows; rows beyond the
true row count are padding rows with no entries.  The host code is a
numpy copy of the reference's, so both packages make the same shards
and the same balanced permutation.

On a process mesh (one shard a rank, ``parallel/mesh.py``) a rank keeps
only its own block: a ShardedCSR whose stack holds one block, that of
shard ``rank``, with ``num_shards`` still the mesh's D; every per-shard
body reads it as it reads a stack.  :func:`unshard_csr` all-gathers the
blocks to every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..formats.csr import CSR
from ..utils.nphost import csr_host
from . import collectives
from .mesh import ROW_AXIS


@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """D stacked local CSR blocks with identical shapes."""

    row_ptr: torch.Tensor  # int32[D, local_rows + 1] (local offsets)
    col_ind: torch.Tensor  # int32[D, local_cap]; padding slots hold ncols
    values: torch.Tensor  # f32[D, local_cap]; padding slots hold 0
    ncols: int
    global_rows: int  # true (unpadded) row count
    shards: int = 0  # the mesh's D when the stack holds one rank's block, else 0
    rank: int = 0  # the shard of the stack's first block

    @property
    def num_shards(self) -> int:
        return self.shards or self.row_ptr.shape[0]

    @property
    def local_rows(self) -> int:
        return self.row_ptr.shape[1] - 1

    @property
    def local_capacity(self) -> int:
        return self.col_ind.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.num_shards * self.local_rows

    @property
    def nnz(self) -> torch.Tensor:
        """Entries of the blocks this process holds."""
        return self.row_ptr[:, -1].sum()

    def local_block(self, d: int) -> CSR:
        """Shard d as a standalone CSR (one this process holds)."""
        i = d - self.rank
        return CSR(self.row_ptr[i], self.col_ind[i], self.values[i], self.ncols)

    def rank_block(self, rank: int) -> "ShardedCSR":
        """The one-block stack of shard ``rank``, as a process mesh's rank
        keeps it."""
        i = rank - self.rank
        return ShardedCSR(self.row_ptr[i:i + 1], self.col_ind[i:i + 1],
                          self.values[i:i + 1], self.ncols, self.global_rows,
                          self.num_shards, rank)


def shard_csr(a: CSR, num_shards, local_capacity: int | None = None) -> ShardedCSR:
    """Block row partition of ``a`` into ``num_shards`` equal blocks (rows
    padded up to a multiple of D; padding rows are empty), on ``a``'s
    device.  ``num_shards`` may be a mesh, whose "x" axis gives the
    blocks (on a 2-D mesh the reference's ``P("x")``: each block is
    replicated over "y"); on a process mesh the result holds this rank's
    block only (every rank passes the same ``a``)."""
    if collectives.is_process(num_shards):
        return shard_csr(a, num_shards.axis_size(ROW_AXIS), local_capacity).rank_block(
            num_shards.coords()[0])
    if hasattr(num_shards, "axis_size"):
        num_shards = num_shards.axis_size(ROW_AXIS)
    num_shards = int(num_shards)
    rp, col = csr_host(a)
    val = a.values.cpu().numpy()
    rows = a.rows
    lr = -(-rows // num_shards)
    counts = np.concatenate(
        [rp[1:] - rp[:-1], np.zeros(num_shards * lr - rows, dtype=np.int64)]
    )
    per_shard = counts.reshape(num_shards, lr)
    shard_nnz = per_shard.sum(axis=1)
    lcap = int(shard_nnz.max()) if local_capacity is None else int(local_capacity)
    lcap = max(lcap, 1)
    if lcap < shard_nnz.max():
        raise ValueError(f"local_capacity {lcap} < max shard nnz {shard_nnz.max()}")
    out_rp = np.zeros((num_shards, lr + 1), dtype=np.int32)
    np.cumsum(per_shard, axis=1, out=out_rp[:, 1:])
    out_col = np.full((num_shards, lcap), a.ncols, dtype=np.int32)
    out_val = np.zeros((num_shards, lcap), dtype=np.float32)
    for d in range(num_shards):
        lo = int(rp[min(d * lr, rows)])
        hi = int(rp[min((d + 1) * lr, rows)])
        out_col[d, : hi - lo] = col[lo:hi]
        out_val[d, : hi - lo] = val[lo:hi]
    dev = a.device
    return ShardedCSR(
        row_ptr=torch.from_numpy(out_rp).to(dev, INDEX_DTYPE),
        col_ind=torch.from_numpy(out_col).to(dev, INDEX_DTYPE),
        values=torch.from_numpy(out_val).to(dev, QVALUE_DTYPE),
        ncols=a.ncols,
        global_rows=rows,
    )


def unshard_csr(s: ShardedCSR, mesh=None) -> CSR:
    """Stitch shard blocks back into one global CSR (host side) — the
    ``PCSR::toCSR`` role (original-matrix-perf/mvcsr.cc:80-121).  On a
    process mesh the blocks are first all-gathered (along "x" on a 2-D
    mesh), so every rank gets the whole matrix (collective)."""
    rp, col, val = (collectives.all_gather(mesh, x, ROW_AXIS)
                    for x in (s.row_ptr, s.col_ind, s.values))
    if rp.shape[0] != s.num_shards:
        raise ValueError("unshard_csr: the blocks of one rank need its process mesh")
    rp = rp.cpu().numpy().astype(np.int64)
    col = col.cpu().numpy()
    val = val.cpu().numpy()
    d = rp.shape[0]
    counts = (rp[:, 1:] - rp[:, :-1]).reshape(-1)[: s.global_rows]
    grp = np.zeros(s.global_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=grp[1:])
    nnz = int(grp[-1])
    gcol = np.full(max(nnz, 1), s.ncols, dtype=np.int32)
    gval = np.zeros(max(nnz, 1), dtype=np.float32)
    pos = 0
    for b in range(d):
        n = int(rp[b, -1])
        gcol[pos : pos + n] = col[b, :n]
        gval[pos : pos + n] = val[b, :n]
        pos += n
    return CSR.from_numpy(grp.astype(np.int32), gcol, gval, s.ncols, s.row_ptr.device)


def flops_balanced_permutation(row_flops: np.ndarray, num_shards: int) -> np.ndarray:
    """Row permutation that deals rows across shards in near-equal cost
    (arrayEqualPartition's static-shape analogue, util.cc:123-149): rows
    sorted by descending cost are dealt boustrophedon ("snake") over the
    D shard buckets, every shard getting exactly its ``local_rows`` real
    rows.  Returns ``perm`` with new row i = old row perm[i]."""
    rows = row_flops.shape[0]
    d = num_shards
    lr = -(-rows // d)
    order = np.argsort(-np.asarray(row_flops, dtype=np.int64), kind="stable")
    # shard_csr appends the D*lr - rows padding rows at the global tail,
    # so shard k receives exactly min(lr, rows - k*lr) real rows
    sizes = np.clip(rows - np.arange(d, dtype=np.int64) * lr, 0, lr)
    valid = np.arange(lr)[:, None] < sizes[None, :]  # [round, shard]
    cols2d = np.tile(np.arange(d), (lr, 1))
    cols2d[1::2] = cols2d[1::2, ::-1]  # snake to cancel systematic skew
    flatpos = np.repeat(np.arange(lr), d) * d + cols2d.reshape(-1)
    sel = flatpos[valid.reshape(-1)[flatpos]]  # valid slots, snake order
    grid = np.full(lr * d, -1, dtype=np.int64)
    grid[sel] = order
    perm = grid.reshape(lr, d).T.reshape(-1)
    return perm[perm >= 0].astype(np.int32)
