"""Blocked SpMM and CSR SpMV / SpMM with a dense operand (the port of the
JAX package's ``ops/spmm.py``).

* :func:`bcsr_spmm` (kernel K5, ``csrc/bcsr_spmm.cu``): BCSR × dense.
  On the card it launches the CUDA kernel over the matrix's work items
  (``BCSR.schedule``); on the CPU it runs the plain twin
  :func:`bcsr_spmm_plain`.  ``bcsr_spmm.launches`` counts launches.
* :func:`bcsr_spmm_plain`: gather of B's block rows, one batched f32
  matmul, a sum into block rows (the reference's ``bcsr_spmm_xla``).
* :func:`csr_spmv`, :func:`csr_spmm_dense`: a gather and a sum into
  rows, plain torch.
"""

from __future__ import annotations

import torch

from .._build import check_tensor, counted, launch, on_card
from ..config import QVALUE_DTYPE, true_f32
from ..formats.bcsr import BCSR, SPMM_ROWS
from ..formats.csr import CSR


def bcsr_spmm_plain(a: BCSR, b: torch.Tensor) -> torch.Tensor:
    """K5's twin: gather B's block rows for every stored block, one
    ``torch.bmm`` (true f32, ``config.true_f32``), sum into block rows.  Padding
    blocks are masked; B is zero-padded to whole block columns."""
    n = b.shape[1]
    kpad = a.nbcols * a.bc
    bp = torch.zeros((kpad, n), dtype=QVALUE_DTYPE, device=b.device)
    bp[: b.shape[0]] = b
    safe = a.block_col.long().clamp(0, max(a.nbcols - 1, 0))
    gathered = bp.view(a.nbcols, a.bc, n)[safe]  # [bcap, bc, n]
    with true_f32():
        prods = torch.bmm(a.blocks, gathered)
    prods = torch.where((a.block_col < a.nbcols)[:, None, None], prods, 0.0)
    out = torch.zeros((a.nbrows + 1, a.br, n), dtype=QVALUE_DTYPE, device=b.device)
    out.index_add_(0, a.block_rows(), prods)  # slot nbrows: the dump
    return out[: a.nbrows].reshape(a.nbrows * a.br, n)[: a.rows]


@counted
def bcsr_spmm(
    a: BCSR, b: torch.Tensor, n_tile: int = 128, kernel: str = "xla"
) -> torch.Tensor:
    """C[rows, N] = A · B, A in BCSR, B dense f32 ``[cols, N]``.

    The reference's signature.  On a CUDA tensor this launches kernel K5
    for either ``kernel`` value ("xla" or "pallas": there is no XLA on
    the card, and the reference's "xla" default rests on a TPU
    measurement), and raises if the kernel fails to build or launch.  K5
    tiles N by 64 columns itself; ``n_tile`` is accepted for the
    reference's signature and not used.  With no stored block the
    result is zeros and nothing is launched.  On a CPU tensor the plain
    twin runs.  A BCSR from ``BCSR.from_csr`` carries K5's schedule, so
    the call reads nothing back from the card."""
    if kernel not in ("xla", "pallas"):
        raise ValueError(f"bcsr_spmm: unknown kernel {kernel!r}")
    check_tensor(b, "bcsr_spmm b", QVALUE_DTYPE, 2)
    check_tensor(a.blocks, "bcsr_spmm blocks", QVALUE_DTYPE, 3)
    check_tensor(a.block_row_ptr, "bcsr_spmm block_row_ptr", torch.int32, 1)
    check_tensor(a.block_col, "bcsr_spmm block_col", torch.int32, 1)
    if b.shape[0] != a.cols:
        raise ValueError(f"bcsr_spmm: B has {b.shape[0]} rows, A {a.cols} cols")
    if (
        a.blocks.shape != (a.block_capacity, a.br, a.bc)
        or a.nbrows != -(-a.rows // a.br)
    ):
        raise ValueError(
            f"bcsr_spmm: inconsistent BCSR (blocks {tuple(a.blocks.shape)}, "
            f"{a.block_capacity} block columns, {a.nbrows} block rows for "
            f"{a.rows} rows of {a.br})"
        )
    if not on_card("bcsr_spmm", a.block_row_ptr, a.block_col, a.blocks, b):
        return bcsr_spmm_plain(a, b)
    n = b.shape[1]
    if n > 65535 * 64:
        raise ValueError(f"bcsr_spmm: N={n} exceeds the kernel's grid")
    if a.br > 8 * SPMM_ROWS:
        raise ValueError(f"bcsr_spmm: br={a.br} > {8 * SPMM_ROWS} has no kernel")
    sched = a.spmm_schedule()
    if a.rows == 0 or n == 0 or sched.nblocks == 0:
        return torch.zeros((a.rows, n), dtype=QVALUE_DTYPE, device=b.device)
    if sched.items.device != b.device:
        raise ValueError(f"bcsr_spmm: schedule on {sched.items.device}, B on {b.device}")
    c = torch.empty((a.rows, n), dtype=QVALUE_DTYPE, device=b.device)
    nsplit = sched.splits.shape[0]
    partial = (torch.empty((sched.slots, a.br, n), dtype=QVALUE_DTYPE, device=b.device)
               if nsplit else c)
    launch(
        "smf_bcsr_spmm", b.device,
        sched.items.data_ptr(), sched.items.shape[0], sched.stages.data_ptr(), sched.group,
        sched.splits.data_ptr(), nsplit, partial.data_ptr(),
        a.blocks.data_ptr(), b.data_ptr(), c.data_ptr(),
        a.rows, a.cols, n, a.br, a.bc,
    )
    bcsr_spmm.launches += 1
    return c


def csr_spmv(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A·x: a gather and a sum into rows (row ``rows`` takes the
    padding slots)."""
    if x.shape[0] != a.ncols:
        raise ValueError(f"csr_spmv: x has {x.shape[0]} rows, A {a.ncols} cols")
    safe = a.col_ind.long().clamp(0, a.ncols - 1)
    prods = torch.where(a.entry_valid(), a.values * x[safe], 0.0)
    y = torch.zeros(a.rows + 1, dtype=QVALUE_DTYPE, device=x.device)
    y.index_add_(0, a.entry_rows().long(), prods)
    return y[: a.rows]


def csr_spmm_dense(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """C = A·B with dense B: per-entry gather of B rows scaled by the
    entry, summed into rows (the unblocked oracle for ``bcsr_spmm``)."""
    if b.shape[0] != a.ncols:
        raise ValueError(f"csr_spmm_dense: B has {b.shape[0]} rows, A {a.ncols} cols")
    safe = a.col_ind.long().clamp(0, a.ncols - 1)
    rows_b = torch.where(a.entry_valid()[:, None], b[safe] * a.values[:, None], 0.0)
    c = torch.zeros((a.rows + 1, b.shape[1]), dtype=QVALUE_DTYPE, device=b.device)
    c.index_add_(0, a.entry_rows().long(), rows_b)
    return c[: a.rows]
