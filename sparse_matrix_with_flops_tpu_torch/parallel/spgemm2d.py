"""2-D sharded SpGEMM: rows × column stripes (the port of the JAX
package's ``parallel/spgemm2d.py``).

On a mesh ``(nx, ny)`` over ``("x", "y")`` (``make_mesh((nx, ny))``):

* A is row-sharded over "x" and replicated over "y": block x of A is
  read by every y;
* B is row-sharded over "x" and column-striped over "y", each block
  holding its stripe with *stripe-local* column ids;
* shard (x, y) reads B's row blocks of its stripe gathered along "x"
  (the stacked ``[:, y]`` blocks, a view: on one card the all-gather
  moves no bytes) and runs the local stream ESC of its A block against
  them;
* C comes out 2-D sharded, row blocks over "x" and column stripes over
  "y", with no cross-shard reduction.

The shards are stacked on one device and run as a loop; C's values are
``esc_compress``'s fixed-order run sums, so two calls give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..formats.csr import CSR
from ..ops.spgemm import bview_from_blocks
from . import collectives
from .mesh import ShardMesh
from .sharded import ShardedCSR, shard_csr
from .spgemm import _local_spgemm


def shard_csr_2d(b: CSR, nx: int, ny: int, local_capacity: int | None = None):
    """Host-side 2-D partition: row blocks × column stripes (a numpy
    copy of the reference's).

    Returns stacked tensors with leading axes [nx, ny] on ``b``'s device:
    row_ptr [nx, ny, lr+1] (local offsets), col_ind / values
    [nx, ny, lcap] with *stripe-local* column ids (padding lanes hold
    the column ``stripe``), then the stripe width and B's row count."""
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
    dev = b.device
    return (
        torch.from_numpy(rp2).to(dev, INDEX_DTYPE),
        torch.from_numpy(ci2).to(dev, INDEX_DTYPE),
        torch.from_numpy(v2).to(dev, QVALUE_DTYPE),
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

    ``a`` is a ShardedCSR over "x" (each block read by every y).
    Returns C's blocks with leading [nx, ny] axes and stripe-local
    columns: (row_ptr, col_ind, values)."""
    collectives.require_stacked(mesh, "sharded_spgemm_2d")
    nx, ny = mesh.axis_size("x"), mesh.axis_size("y")
    if a.num_shards != nx or tuple(b_rp.shape[:2]) != (nx, ny):
        raise ValueError(f"operands of {a.num_shards} and {tuple(b_rp.shape[:2])} shards "
                         f"on a mesh of {(nx, ny)}")
    blocks = [[None] * ny for _ in range(nx)]
    for y in range(ny):
        bv = bview_from_blocks(b_rp[:, y], b_ci[:, y], b_v[:, y], stripe)  # gathered along x
        for x in range(nx):
            c_rp, c_ci, c_v, _, _ = _local_spgemm(
                a.row_ptr[x], a.col_ind[x], a.values[x], bv, stripe, product_cap, out_cap)
            blocks[x][y] = (c_rp, c_ci, c_v)
    return tuple(
        torch.stack([torch.stack([blk[i] for blk in row]) for row in blocks]) for i in range(3)
    )


def unshard_2d(c_rp, c_ci, c_v, stripe: int, global_rows: int, ncols: int) -> CSR:
    """Stitch [nx, ny] blocks back to one CSR (host side, tests only)."""
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
