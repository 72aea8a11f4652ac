"""Stream-ESC SpGEMM and the host-side SpGEMM helpers (the port of the
JAX package's ``ops/spgemm.py``).

ESC (expand, sort, compress) over the whole multiply: every partial
product is written to a flat stream at its flops-prefix offset, the
stream is sorted by (row, col), and runs of equal keys are summed.  It
is plain torch: gathers, one stable sort, scatters.  Products that
cancel to 0.0 stay in C (structural semantics).  ``PCSR.striped_spgemm``
runs on it; ``spgemm_auto`` does not.

``product_cap`` (>= flops) and ``out_cap`` (>= nnz(C)) size the
streams; ``spgemm_upper_bounds`` gives exact concrete values from the
host arrays, and ``spgemm_dense_oracle`` is the dense host reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..formats.csr import CSR
from ..utils.nphost import csr_host
from .segments import exclusive_cumsum, repeat_segments, run_sums, segment_boundaries


class BView(NamedTuple):
    """Row-indexed view of B: flat (col, val) arrays + per-row start/count."""

    col: torch.Tensor  # int32[flat_cap]
    val: torch.Tensor  # f32[flat_cap]
    row_start: torch.Tensor  # int32[rows] index of each row's first entry
    row_count: torch.Tensor  # int32[rows] entries per row
    ncols: int

    @property
    def rows(self) -> int:
        return self.row_start.shape[0]

    @property
    def capacity(self) -> int:
        return self.col.shape[0]


def bview_from_csr(b: CSR) -> BView:
    return BView(b.col_ind, b.values, b.row_ptr[:-1], b.row_counts(), b.ncols)


def bview_from_blocks(row_ptr_blocks, col_blocks, val_blocks, ncols: int) -> BView:
    """View over D stacked local CSR blocks: ``row_ptr_blocks`` int32
    [D, lr + 1] of local offsets, block d's entries at flat offset
    ``d * local_cap``.  Padding rows must have count 0."""
    d, lcap = col_blocks.shape
    offs = (torch.arange(d, dtype=INDEX_DTYPE, device=col_blocks.device) * lcap)[:, None]
    row_start = (row_ptr_blocks[:, :-1] + offs).reshape(-1)
    row_count = (row_ptr_blocks[:, 1:] - row_ptr_blocks[:, :-1]).reshape(-1)
    return BView(
        col_blocks.reshape(-1), val_blocks.reshape(-1), row_start,
        row_count.to(INDEX_DTYPE), ncols,
    )


# ---------------------------------------------------------------------------
# expansion and sort
# ---------------------------------------------------------------------------
def esc_expand_view(a: CSR, bv: BView, product_cap: int):
    """All partial products of A·B as flat streams ``(prow, pcol, pval)``
    of length ``product_cap``, plus the exact product count.  Product q
    belongs to A entry p (a max-scatter of entry ids at their flops
    offsets, then a running max) and to B entry
    ``row_start[A.col[p]] + (q - start[p])``.  Slots past the flops hold
    the sentinel (rows, ncols, 0)."""
    dev = a.device
    valid = a.entry_valid()
    safe_col = a.col_ind.long().clamp(0, bv.rows - 1)
    ef = torch.where(valid, bv.row_count[safe_col], 0).to(INDEX_DTYPE)
    starts = exclusive_cumsum(ef)
    total = starts[-1]
    p = repeat_segments(starts[:-1], valid & (ef > 0), product_cap)
    q = torch.arange(product_cap, dtype=INDEX_DTYPE, device=dev)
    pvalid = q < total
    safe_p = p.long().clamp(0, a.capacity - 1)
    arow = a.entry_rows()[safe_p]
    acol = a.col_ind[safe_p]
    aval = a.values[safe_p]
    t = q - starts[safe_p]
    b_start = bv.row_start[acol.long().clamp(0, bv.rows - 1)]
    b_idx = (b_start + t).long().clamp(0, bv.capacity - 1)
    prow = torch.where(pvalid, arow, a.rows).to(INDEX_DTYPE)
    pcol = torch.where(pvalid, bv.col[b_idx], bv.ncols).to(INDEX_DTYPE)
    pval = torch.where(pvalid, aval * bv.val[b_idx], 0.0).to(QVALUE_DTYPE)
    return prow, pcol, pval, total


def esc_expand(a: CSR, b: CSR, product_cap: int):
    """CSR-to-CSR expansion (see :func:`esc_expand_view`)."""
    return esc_expand_view(a, bview_from_csr(b), product_cap)


def _sort_pairs(prow: torch.Tensor, pcol: torch.Tensor) -> torch.Tensor:
    """Permutation of a stable lexicographic (row, col) sort of
    non-negative int32 keys."""
    key = (prow.long() << 32) | pcol.long()
    return torch.sort(key, stable=True).indices


def esc_sort(prow, pcol, pval, rows: int):
    """Stable (row, col) sort of the product streams (sentinels sink to
    the tail); returns the sorted streams, validity, segment-start
    flags, segment ids and nnz(C)."""
    order = _sort_pairs(prow, pcol)
    prow, pcol, pval = prow[order], pcol[order], pval[order]
    pvalid = prow < rows
    flags = segment_boundaries(prow, pcol, pvalid)
    seg = torch.cumsum(flags, 0).to(INDEX_DTYPE) - 1
    nnzc = flags.sum(dtype=INDEX_DTYPE)
    return prow, pcol, pval, pvalid, flags, seg, nnzc


def esc_compress(prow, pcol, pval, flags, seg, nnzc, total, rows: int, ncols: int,
                 out_cap: int):
    """C's entries from the sorted product streams of :func:`esc_sort`:
    the first ``out_cap`` (row, col) segments as ``(crow, ccol, cval)``,
    the sentinel (rows, ncols, 0) past nnz(C); segments past ``out_cap``
    are dropped.  ``total`` is the flop count of :func:`esc_expand`.
    Each value sums its segment's run of products in a fixed order
    (``run_sums``), so equal products give equal bits on the card."""
    cap, dev = prow.shape[0], prow.device
    # each segment's first product; segments past nnz(C) start at the
    # end of the valid products, and one dump slot takes the rest
    start = torch.zeros(out_cap + 2, dtype=torch.int64, device=dev) + total.clamp(max=cap)
    idx = torch.where(flags, seg.long(), out_cap + 1).clamp(max=out_cap + 1)
    start.scatter_(0, idx, torch.arange(cap, device=dev))
    cval = run_sums(pval, start[: out_cap + 1])
    live = torch.arange(out_cap, device=dev) < nnzc
    first = start[:out_cap].clamp(max=cap - 1)
    crow = torch.where(live, prow[first], rows).to(INDEX_DTYPE)
    ccol = torch.where(live, pcol[first], ncols).to(INDEX_DTYPE)
    return crow, ccol, cval.to(QVALUE_DTYPE)


# ---------------------------------------------------------------------------
# numeric and symbolic SpGEMM
# ---------------------------------------------------------------------------
def spgemm(a: CSR, b: CSR, product_cap: int, out_cap: int) -> CSR:
    """C = A·B, ordered, duplicate columns summed.  Past ``out_cap`` the
    trailing segments are dropped, past ``product_cap`` the trailing
    products (caller-checked capacities, as in the reference)."""
    if a.ncols != b.rows:
        raise ValueError(f"inner dimensions differ: {a.ncols} != {b.rows}")
    m, n, dev = a.rows, b.ncols, a.device
    prow, pcol, pval, total = esc_expand(a, b, product_cap)
    prow, pcol, pval, _, flags, seg, nnzc = esc_sort(prow, pcol, pval, m)
    crow, ccol, cval = esc_compress(prow, pcol, pval, flags, seg, nnzc, total, m, n, out_cap)
    row_ptr = torch.searchsorted(
        crow, torch.arange(m + 1, dtype=INDEX_DTYPE, device=dev)
    ).to(INDEX_DTYPE)
    return CSR(row_ptr, ccol, cval, n)


def spgemm_symbolic(a: CSR, b: CSR, product_cap: int):
    """Exact per-row nnz(C) without the values: ``(row_ptr, nnz(C),
    flops)`` (the reference's ``*_CSR_IC_nnzC`` phase)."""
    if a.ncols != b.rows:
        raise ValueError(f"inner dimensions differ: {a.ncols} != {b.rows}")
    m = a.rows
    prow, pcol, _, total = esc_expand(a, b, product_cap)
    order = _sort_pairs(prow, pcol)
    prow, pcol = prow[order], pcol[order]
    flags = segment_boundaries(prow, pcol, prow < m)
    counts = torch.zeros(m + 1, dtype=INDEX_DTYPE, device=a.device)
    counts.index_add_(0, prow.long(), flags.to(INDEX_DTYPE))  # row m: padding
    row_ptr = exclusive_cumsum(counts[:m])
    return row_ptr, row_ptr[-1], total


# ---------------------------------------------------------------------------
# host-side capacity planning, the one-shot wrapper, the dense oracle
# ---------------------------------------------------------------------------
def spgemm_upper_bounds(a: CSR, b: CSR) -> tuple[int, int]:
    """Concrete ``(product_cap, out_cap)`` on the host: the exact flop
    count (multiply-adds), with the output bounded by it."""
    rp_a, ci_a = csr_host(a)
    rp_b, _ = csr_host(b)
    col = ci_a[: int(rp_a[-1])]
    safe = np.clip(col, 0, b.rows - 1)
    flops = max(int(np.diff(rp_b)[safe].sum()), 1)
    return flops, flops


def matmul(a: CSR, b: CSR, out_cap: int | None = None) -> CSR:
    """One-shot C = A·B with capacities planned on the host (the
    CSR::spmm facade, CSR.cc:59-71)."""
    product_cap, bound = spgemm_upper_bounds(a, b)
    return spgemm(a, b, product_cap, int(bound if out_cap is None else out_cap))


def spgemm_dense_oracle(a: CSR, b: CSR) -> CSR:
    """Trivially-correct dense reference: densify, f64 matmul,
    re-sparsify on the host.  Products that cancel to exactly 0.0 stay
    absent, through the pattern product."""
    da = a.to_dense().cpu().numpy().astype(np.float64)
    db = b.to_dense().cpu().numpy().astype(np.float64)
    dc = da @ db
    pattern = (np.abs(da) > 0).astype(np.float64) @ (
        np.abs(db) > 0
    ).astype(np.float64)
    return CSR.from_dense(
        np.where(pattern > 0, dc, 0.0).astype(np.float32), a.device
    )
