"""R-MCL row math: inflation, threshold pruning, renormalisation (the
port of the JAX package's ``ops/prune.py``).

Semantics mirror the reference (values are float32 / QValue):

* inflation: v <- v*v                      (arrayInflationR2, util.cc:41-45)
* threshold: t = 0.90·avg·(1 − 2·(max−avg)), clamped to [1e-7, max]
                                           (computeThreshold, util.cc:4-9)
  where avg = (row sum of inflated values) / (row count incl. explicit
  zeros) and max is the row max of inflated values.
* prune+normalize: keep entries with inflated value >= t, then divide the
  kept (inflated) values by their sum  (arrayThreshPruneNormalize,
  util.cc:47-69).

Every row statistic is a segment reduction over the entry streams
(``ops/segments.py``), the float row sums each in a fixed order
(``run_sums``) so that the same stream gives the same bits on the card;
one stable sort compacts the survivors.
"""

from __future__ import annotations

import torch

from ..config import (
    INDEX_DTYPE,
    MLMCL_PRUNE_A,
    MLMCL_PRUNE_B,
    PRUNE_FLOOR,
    QVALUE_DTYPE,
)
from ..formats.csr import CSR
from .segments import exclusive_cumsum, run_sums, segment_max, segment_sum


def compute_threshold(avg: torch.Tensor, rmax: torch.Tensor) -> torch.Tensor:
    """Vectorised computeThreshold (util.cc:4-9)."""
    t = MLMCL_PRUNE_A * avg * (1.0 - MLMCL_PRUNE_B * (rmax - avg))
    t = torch.clamp(t, min=PRUNE_FLOOR)
    return torch.minimum(t, rmax)


def inflate_prune_normalize_stream(
    erow: torch.Tensor,
    col: torch.Tensor,
    val: torch.Tensor,
    valid: torch.Tensor,
    rows: int,
    ncols: int,
    out_cap: int,
):
    """Fused inflate→threshold→prune→normalize over entry streams.

    ``erow`` must be non-decreasing over valid entries (CSR entry order),
    the valid entries first, with sentinel ``rows`` on padding.  Returns
    (row_ptr, col, val, overflow): the survivors compacted to the front
    in (row, col) order and padded out to ``out_cap``; ``overflow`` flags
    survivors > out_cap (omp_CSR_RMCL_OneStep, omp_csr_kernel.cc:154-198)."""
    cap = erow.shape[0]
    seg = torch.where(valid, erow, rows)
    w = torch.where(valid, val * val, 0.0).to(QVALUE_DTYPE)  # inflation
    # each row's run of the stream
    roff = torch.searchsorted(
        seg, torch.arange(rows + 1, dtype=seg.dtype, device=seg.device)
    )
    rsum = run_sums(w, roff)
    rmax = segment_max(w, seg, rows)
    rcount = (roff[1:] - roff[:-1]).to(QVALUE_DTYPE)
    avg = rsum / torch.clamp(rcount, min=1.0)
    thresh = compute_threshold(avg, rmax)

    own = erow.long().clamp(0, max(rows - 1, 0))
    keep = valid & (w >= thresh[own])
    ksum = run_sums(torch.where(keep, w, 0.0), roff)
    newval = torch.where(keep, w / torch.clamp(ksum, min=1e-30)[own], 0.0)

    # compact survivors: a stable sort on the keep-aware row key keeps
    # column order within each row (matrix_relocation,
    # cpu_csr_kernel.h:206-228)
    key = torch.where(keep, erow, rows)
    order = torch.sort(key, stable=True).indices
    scol, sval = col[order], newval[order]

    counts = segment_sum(keep.to(INDEX_DTYPE), seg, rows)
    row_ptr = exclusive_cumsum(counts)
    total = row_ptr[-1]
    overflow = total > out_cap

    slot = torch.arange(out_cap, device=erow.device)
    take = slot.clamp(max=max(cap - 1, 0))
    ocol = torch.where(slot < total, scol[take], ncols).to(INDEX_DTYPE)
    oval = torch.where(slot < total, sval[take], 0.0).to(QVALUE_DTYPE)
    return torch.clamp(row_ptr, max=out_cap), ocol, oval, overflow


def prune_normalize(c: CSR, out_cap: int | None = None):
    """Unfused prune pass over an existing CSR (static_fair_CSR_RMCL_OneStep,
    static_omp_csr_kernel.cc:286-321).  Returns (CSR, overflow flag)."""
    cap = c.capacity if out_cap is None else out_cap
    row_ptr, col, val, overflow = inflate_prune_normalize_stream(
        c.entry_rows(), c.col_ind, c.values, c.entry_valid(), c.rows, c.ncols, cap
    )
    return CSR(row_ptr, col, val, c.ncols), overflow
