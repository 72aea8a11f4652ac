"""Flops-binned SpGEMM, the framework's namesake strategy (the port of the
JAX package's ``ops/binned.py``).

The reference's two binned engines, the CPU ``group_CSR_SpMM``
(group_csr_kernel.cc:10-52) and the GPU "mindex2" (flops.cu:39-47,
gnnz.cuh:19-70), bucket rows by flops and give each bucket its own
kernel shape.  Here a *bin* is a dense ``[R, W]`` tile of partial
products, W a power of two that holds each of its rows' flops.  Per bin:

1. gather the bin rows' products from the row-major expansion stream
   (each row's products are one contiguous range at its flops offset,
   flops.cu:133);
2. sort each row by column, sum runs of one column and compact left:
   kernel K1 (``sort_dedup_compact``) on the card, its plain twin on the
   CPU;
3. write each row's unique entries to their slots of C.

Rows with more flops than the widest bin go through the stream ESC's
sort restricted to their products (the 'olarge' escape,
mindex2-cuda/\\:23-143), and each run of one (row, col) is summed in a
fixed order (``ops/segments.run_sums``).

Every slot of C receives one value, so the output is written with
indexed sets, never float atomics: two calls on the card give the same
bits.  The plan is host numpy (the reference copies its bin boundaries
back to launch kernels, flops.cu:171); its row ids are uploaded once per
(plan, device), so a warm call reads nothing back from the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..formats.csr import CSR
from ..utils.nphost import csr_host, segment_sums
from .flops import row_flops
from .segments import exclusive_cumsum
from .sort_kernels import sort_dedup_compact
from .spgemm import esc_compress, esc_expand, esc_sort

DEFAULT_BIN_WIDTHS = (16, 64, 256, 1024, 4096)


@dataclasses.dataclass(frozen=True, eq=False)
class BinPlan:
    """Static per-structure dispatch plan (host-computed), the same fields
    as the reference's.

    ``bins``: tuple of (row_ids, width), row_ids an int32[R_b] numpy array
    (padded with -1 to a multiple of 8) of the rows whose flops fit in
    ``width`` lanes.  ``huge_rows``: rows past the largest width.  Build
    one plan per sparsity structure and reuse it."""

    bins: tuple  # ((np.ndarray[R], W), ...)
    huge_rows: np.ndarray  # int32[.]
    huge_product_cap: int
    product_cap: int
    out_cap: int
    rows: int

    @property
    def num_bins(self) -> int:
        return len(self.bins)


def plan_bins(
    a: CSR,
    b: CSR,
    widths: tuple = DEFAULT_BIN_WIDTHS,
    out_cap: int | None = None,
) -> BinPlan:
    """Classify rows by flops into power-of-two lane widths on the host
    (gpuFlopsClassify, flops.cu:110-140, and the CPU classifier,
    nGpuSpMM.cc:48-83)."""
    rp, ci = csr_host(a)
    nnz = int(rp[-1])
    b_counts = np.diff(csr_host(b)[0])
    rf = segment_sums(b_counts[np.clip(ci[:nnz], 0, b.rows - 1)], rp)

    total = int(rf.sum())
    bins = []
    lo = 1
    for w in widths:
        sel = np.nonzero((rf >= lo) & (rf <= w))[0]
        lo = w + 1
        if sel.size == 0:
            continue
        pad = (-sel.size) % 8
        sel = np.concatenate([sel, np.full(pad, -1, dtype=sel.dtype)])
        bins.append((sel.astype(np.int32), int(w)))
    huge = np.nonzero(rf > widths[-1])[0].astype(np.int32)
    huge_cap = int(rf[huge].sum()) if huge.size else 1
    return BinPlan(
        bins=tuple(bins),
        huge_rows=huge,
        huge_product_cap=max(huge_cap, 1),
        product_cap=max(total, 1),
        out_cap=max(total, 1) if out_cap is None else int(out_cap),
        rows=a.rows,
    )


def _plan_tensors(plan: BinPlan, device: torch.device) -> dict:
    """The plan's row ids on ``device`` (int64, the -1 padding mapped to
    the dump row ``rows``) and the huge-row mask over ``rows + 1`` ids,
    uploaded once and memoised on the plan (keyed by device)."""
    cache = getattr(plan, "_dev_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(plan, "_dev_cache", cache)
    key = str(device)
    if key not in cache:
        m = plan.rows
        hmask = np.zeros(m + 1, dtype=bool)
        hmask[plan.huge_rows] = True
        cache[key] = {
            "bins": [
                (w, torch.from_numpy(np.where(r >= 0, r, m).astype(np.int64)).to(device))
                for r, w in plan.bins
            ],
            "hmask": torch.from_numpy(hmask).to(device),
        }
    return cache[key]


def _bin_tile_dedup(cols: torch.Tensor, vals: torch.Tensor, ncols: int):
    """Sort + dedup each row of a [R, W] product tile (K1): returns
    (sorted unique cols [R, W], summed vals [R, W], per-row count).
    Padding lanes hold (ncols, 0) and are dropped; sums that are exactly
    zero are kept."""
    key, val = sort_dedup_compact(cols, vals, ncols)
    return key, val, (key < ncols).sum(1, dtype=INDEX_DTYPE)


def _gather_bin_products(
    rid: torch.Tensor,
    width: int,
    pcol: torch.Tensor,
    pval: torch.Tensor,
    row_off: torch.Tensor,
    rf: torch.Tensor,
    ncols: int,
):
    """[R, W] product tile of the rows ``rid`` from the row-major streams:
    lane l of row i is product ``row_off[i] + l`` while ``l < rf[i]``,
    else (ncols, 0).  ``rf`` has one trailing 0 for the dump row
    ``rows`` that padding ids point at."""
    lanes = torch.arange(width, device=rid.device)
    idx = (row_off[rid].long()[:, None] + lanes).clamp(max=pcol.shape[0] - 1)
    valid = lanes < rf[rid][:, None]
    cols = torch.where(valid, pcol[idx], ncols).to(INDEX_DTYPE)
    vals = torch.where(valid, pval[idx], 0.0).to(QVALUE_DTYPE)
    return cols, vals


def spgemm_binned(a: CSR, b: CSR, plan: BinPlan) -> CSR:
    """C = A·B through the binned pipeline; the semantics of
    :func:`.spgemm.spgemm` (ordered rows, summed duplicates, products that
    cancel to 0.0 kept).  C's capacity is ``plan.out_cap``; entries past
    it are dropped and ``row_ptr`` is clipped to it, as in the
    reference."""
    if a.ncols != b.rows:
        raise ValueError(f"inner dimensions differ: {a.ncols} != {b.rows}")
    m, n, dev = a.rows, b.ncols, a.device
    out_cap = plan.out_cap
    pt = _plan_tensors(plan, dev)
    # row-major product streams: expansion only, no global sort
    prow, pcol, pval, _ = esc_expand(a, b, plan.product_cap)
    rf = row_flops(a, b)
    row_off = exclusive_cumsum(rf)
    rf = torch.cat([rf, rf.new_zeros(1)])

    # per-row output counts, row m the dump of padding ids
    counts = torch.zeros(m + 1, dtype=INDEX_DTYPE, device=dev)
    tiles = []
    for w, rid in pt["bins"]:
        cols, vals = _gather_bin_products(rid, w, pcol, pval, row_off, rf, n)
        ucols, uvals, ucnt = _bin_tile_dedup(cols, vals, n)
        counts[rid] = ucnt  # each row in one bin; padding rows count 0
        tiles.append((rid, ucols, uvals, ucnt))

    # huge rows: the stream ESC's sort restricted to their products
    huge = None
    if plan.huge_rows.size:
        sel = pt["hmask"][prow.long()]
        hrow = torch.where(sel, prow, m).to(INDEX_DTYPE)
        hcol = torch.where(sel, pcol, n).to(INDEX_DTYPE)
        hval = torch.where(sel, pval, 0.0)
        hrow, hcol, hval, _, hflags, hseg, hnnz = esc_sort(hrow, hcol, hval, m)
        # one (row, col, run sum) per unique entry, sorted; (m, n, 0) past them
        hrow, hcol, hval = esc_compress(
            hrow, hcol, hval, hflags, hseg, hnnz, sel.sum(), m, n, plan.huge_product_cap
        )
        # hrow is sorted, padding (row m) last: each row's run bounds
        hoff = torch.searchsorted(hrow, torch.arange(m + 1, dtype=hrow.dtype, device=dev),
                                  out_int32=True)
        counts[:m] += hoff[1:] - hoff[:-1]
        huge = (hrow, hcol, hval, hoff)

    # output assembly: each slot below out_cap is set once; targets at or
    # past it go to the dump slot out_cap, which is cut off
    out_rp = exclusive_cumsum(counts[:m]).clamp(max=out_cap)
    ccol = torch.full((out_cap + 1,), n, dtype=INDEX_DTYPE, device=dev)
    cval = torch.zeros(out_cap + 1, dtype=QVALUE_DTYPE, device=dev)

    def place(tgt, ok, cols, vals):
        tgt = torch.where(ok & (tgt < out_cap), tgt, out_cap)
        ccol[tgt] = cols
        cval[tgt] = vals

    for rid, ucols, uvals, ucnt in tiles:
        lanes = torch.arange(ucols.shape[1], device=dev)
        place(
            (out_rp[rid].long()[:, None] + lanes).reshape(-1),
            (lanes < ucnt[:, None]).reshape(-1),
            ucols.reshape(-1),
            uvals.reshape(-1),
        )
    if huge is not None:
        hrow, hcol, hval, hoff = huge
        ok = hrow < m
        r = torch.where(ok, hrow, 0).long()
        k = torch.arange(hrow.shape[0], device=dev)
        place(out_rp[r].long() + k - hoff[r].long(), ok, hcol, hval)
    return CSR(out_rp, ccol[:out_cap], cval[:out_cap], n)
