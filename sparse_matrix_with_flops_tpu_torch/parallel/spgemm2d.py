"""2-D sharded SpGEMM: rows × column stripes (the port of the JAX
package's ``parallel/spgemm2d.py``).

On a mesh ``(nx, ny)`` over ``("x", "y")`` (``make_mesh((nx, ny))``):

* A is row-sharded over "x" and replicated over "y": block x of A is
  read by every y;
* B is row-sharded over "x" and column-striped over "y", each block
  holding its stripe with *stripe-local* column ids;
* shard (x, y) reads B's row blocks of its stripe gathered along "x"
  and runs the local stream ESC of its A block against them;
* C comes out 2-D sharded, row blocks over "x" and column stripes over
  "y", with no cross-shard reduction.

On a stacked mesh the nx·ny shards run as a loop on one device and the
gather along "x" is the stacked ``[:, y]`` blocks (a view: on one card it
moves no bytes).  On a 2-D process mesh rank r holds shard
``(x, y) = divmod(r, ny)``: B's block ``[x, y]``, A's block x, and the
gather is ``torch.distributed``'s over the ranks of column y (the
mesh's subgroup for "x").  C's values are ``esc_compress``'s fixed-order
run sums, so two calls give the same bits, and a rank's block equals
the stacked path's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..formats.csr import CSR
from ..ops.spgemm import bview_from_blocks
from . import collectives
from .mesh import COL_AXIS, ROW_AXIS, ShardMesh
from .sharded import ShardedCSR, shard_csr
from .spgemm import _local_spgemm


def shard_csr_2d(b: CSR, nx: int, ny: int, local_capacity: int | None = None, mesh=None):
    """Host-side 2-D partition: row blocks × column stripes (a numpy
    copy of the reference's).

    Returns stacked tensors with leading axes [nx, ny] on ``b``'s device:
    row_ptr [nx, ny, lr+1] (local offsets), col_ind / values
    [nx, ny, lcap] with *stripe-local* column ids (padding lanes hold
    the column ``stripe``), then the stripe width and B's row count.  On
    a process ``mesh`` (every rank passes the same ``b``) the tensors
    hold this rank's one block, leading axes [1, 1]."""
    stripe = -(-b.ncols // ny)
    rp, col, val = b.to_numpy()
    rp = rp.astype(np.int64)
    erow = np.repeat(np.arange(b.rows), np.diff(rp))
    lcap = 0
    parts = []
    for y in range(ny):
        lo, hi = y * stripe, min((y + 1) * stripe, b.ncols)
        sel = (col >= lo) & (col < hi)
        counts = np.bincount(erow[sel], minlength=b.rows)
        srp = np.zeros(b.rows + 1, dtype=np.int64)
        np.cumsum(counts, out=srp[1:])
        stripe_csr = CSR.from_numpy(srp.astype(np.int32), col[sel] - lo, val[sel], stripe,
                                    device="cpu")
        s = shard_csr(stripe_csr, nx)
        parts.append(s)
        lcap = max(lcap, s.local_capacity)
    if local_capacity is not None:
        lcap = max(lcap, int(local_capacity))
    rp2 = np.stack([s.row_ptr.numpy() for s in parts], axis=1)  # [nx, ny, lr+1]
    ci2 = np.full((nx, ny, lcap), stripe, np.int32)
    v2 = np.zeros((nx, ny, lcap), np.float32)
    for y, s in enumerate(parts):
        ci2[:, y, : s.local_capacity] = s.col_ind.numpy()
        v2[:, y, : s.local_capacity] = s.values.numpy()
    if collectives.is_process(mesh):
        x, y = mesh.coords()
        rp2, ci2, v2 = (t[x:x + 1, y:y + 1] for t in (rp2, ci2, v2))
    dev = b.device
    return (
        torch.from_numpy(np.ascontiguousarray(rp2)).to(dev, INDEX_DTYPE),
        torch.from_numpy(np.ascontiguousarray(ci2)).to(dev, INDEX_DTYPE),
        torch.from_numpy(np.ascontiguousarray(v2)).to(dev, QVALUE_DTYPE),
        stripe,
        b.rows,
    )


def sharded_spgemm_2d(
    mesh: ShardMesh,
    a: ShardedCSR,
    b_rp,
    b_ci,
    b_v,
    stripe: int,
    b_rows: int,
    product_cap: int,
    out_cap: int,
):
    """C[x-block, y-stripe] = A[x-block] · B[:, y-stripe].

    ``a`` is a ShardedCSR over "x" (each block read by every y; on a
    process mesh, ``shard_csr(a, mesh)``: A's block x).  The B blocks are
    those this process holds (``shard_csr_2d``: all [nx, ny] stacked,
    [1, 1] a rank).  Returns C's blocks with the same leading axes and
    stripe-local columns: (row_ptr, col_ind, values)."""
    nx, ny = mesh.axis_size(ROW_AXIS), mesh.axis_size(COL_AXIS)
    held = (1, 1) if collectives.is_process(mesh) else (nx, ny)
    if a.num_shards != nx or a.row_ptr.shape[0] != held[0] or tuple(b_rp.shape[:2]) != held:
        raise ValueError(f"operands of {a.num_shards} and {tuple(b_rp.shape[:2])} shards "
                         f"on a mesh of {(nx, ny)}")
    blocks = [[None] * held[1] for _ in range(held[0])]
    for j in range(held[1]):
        bv = bview_from_blocks(*(collectives.all_gather(mesh, t[:, j], ROW_AXIS)
                                 for t in (b_rp, b_ci, b_v)), stripe)  # gathered along x
        for i in range(held[0]):
            c_rp, c_ci, c_v, _, _ = _local_spgemm(
                a.row_ptr[i], a.col_ind[i], a.values[i], bv, stripe, product_cap, out_cap)
            blocks[i][j] = (c_rp, c_ci, c_v)
    return tuple(
        torch.stack([torch.stack([blk[i] for blk in row]) for row in blocks]) for i in range(3)
    )


def unshard_2d(c_rp, c_ci, c_v, stripe: int, global_rows: int, ncols: int, mesh=None) -> CSR:
    """Stitch [nx, ny] blocks back to one CSR (host side, tests only).
    On a process ``mesh`` each rank passes its [1, 1] block: the blocks
    are first gathered over the whole group (collective), so every rank
    gets the whole matrix."""
    if collectives.is_process(mesh):
        c_rp, c_ci, c_v = (collectives.all_gather(mesh, t).reshape(*mesh.shape, *t.shape[2:])
                           for t in (c_rp, c_ci, c_v))
    nx, ny = c_rp.shape[0], c_rp.shape[1]
    dense = None
    for x in range(nx):
        for y in range(ny):
            d = CSR(c_rp[x, y], c_ci[x, y], c_v[x, y], stripe).to_dense().cpu().numpy()
            if dense is None:
                lr = d.shape[0]
                dense = np.zeros((nx * lr, ny * stripe), np.float32)
            dense[x * lr : (x + 1) * lr, y * stripe : y * stripe + d.shape[1]] += d
    return CSR.from_dense(dense[:global_rows, :ncols], c_rp.device)
