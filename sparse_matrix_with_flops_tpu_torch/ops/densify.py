"""The hub's dense operands: sparse rows scattered into dense blocks for
a matmul (the SpGEMM hub in ``ops/ell_esc.py``, the static R-MCL hub in
``models/rmcl_ell.py`` and ``parallel/rmcl_ell.py``).  Callers prepare
their own indices (clamps, union maps, owner offsets)."""

from __future__ import annotations

import torch

from ..config import QVALUE_DTYPE


def entries_to_dense(rows, cols, vals, nrows: int, ncols: int):
    """The entries ``(rows, cols, vals)`` summed into a dense f32
    ``[nrows, ncols]`` block, the reference's scatter-add: one
    ``index_add_`` into a flat buffer whose extra row takes the entries
    of row -1 (padding).  A cell that receives one entry (a CSR row holds
    each column once) is exact in any order, so the card's atomics give
    the CPU's bits.  (An accumulating ``index_put_`` sorts and
    serialises the pads, which all land on one cell.)"""
    flat = torch.zeros((nrows + 1) * ncols, dtype=QVALUE_DTYPE, device=vals.device)
    flat.index_add_(0, torch.where(rows >= 0, rows, nrows) * ncols + cols, vals)
    return flat.view(nrows + 1, ncols)[:nrows]


def ell_rows_to_dense(cols, vals, ncols: int, col0: int, width: int, dtype=QVALUE_DTYPE):
    """ELL rows ``cols / vals [R, S]`` (sentinel ``ncols``) as the dense
    ``[R, width]`` block of their columns ``col0 .. col0 + width - 1`` in
    ``dtype`` (columns past ``ncols`` zero): one plain indexed set.  A
    lane with a real column in the slab sets its cell, and a row holds
    each real column at most once (the ELL invariant that ``mt_to_ell``
    sets and every step keeps); every other lane sets a dump cell of its
    own past the block.  No two lanes write one cell, so nothing is
    accumulated and no write order shows."""
    r, s = cols.shape
    c = cols.long() - col0
    real = (c >= 0) & (c < min(width, ncols - col0))
    lane = torch.arange(r * s, device=cols.device).view(r, s)
    at = torch.where(real, lane // s * width + c, r * width + lane)
    flat = torch.zeros(r * (width + s), dtype=dtype, device=cols.device)
    flat[at] = vals.to(dtype)
    return flat[: r * width].view(r, width)
