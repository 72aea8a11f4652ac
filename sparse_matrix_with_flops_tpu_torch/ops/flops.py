"""Flops of C = A·B per entry and per row, the framework's namesake (the
port of the JAX package's ``ops/flops.py``): ``rowFlops[i] = sum over j
in A[i,:] of nnz(B[j,:])``, single-count (callers double it for
GFLOPS); rows sorted and binned by flops (gpuFlopsClassify,
mindex2-cuda/flops.cu:96-140); the log2 histograms of stats.cc; and the
footprint row costs that ``balance=True`` and the partitioned driver cut
on."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import FLOPS_BIN_BOUNDS, INDEX_DTYPE
from ..formats.csr import CSR
from .segments import exclusive_cumsum, segment_sum


def entry_flops(a: CSR, b: CSR) -> torch.Tensor:
    """Per A entry, the nnz of the B row it touches; padding gives 0."""
    safe = a.col_ind.long().clamp(0, b.rows - 1)
    lens = b.row_counts()[safe]
    return torch.where(a.entry_valid(), lens, 0).to(INDEX_DTYPE)


def row_flops(a: CSR, b: CSR) -> torch.Tensor:
    """Per-row flops (int32)."""
    return segment_sum(entry_flops(a, b), a.entry_rows(), a.rows + 1)[: a.rows]


def spgemm_flops(a: CSR, b: CSR) -> tuple[torch.Tensor, torch.Tensor]:
    """(per-row flops, total), both int32."""
    rf = row_flops(a, b)
    return rf, rf.sum(dtype=INDEX_DTYPE)


class FlopsBinning(NamedTuple):
    """Rows sorted by flops with bin boundaries (gpuFlopsClassify,
    flops.cu:110-140)."""

    sorted_rows: torch.Tensor  # int32[m] row ids, ascending flops
    sorted_flops: torch.Tensor  # int32[m]
    flops_offsets: torch.Tensor  # int32[m+1] exclusive prefix of sorted_flops
    bin_starts: torch.Tensor  # int32[nbins+1] boundaries into sorted_rows


def flops_bin_id(flops: torch.Tensor) -> torch.Tensor:
    """Row flops -> bin id 1..7 of the reference's bins {1: f=0, 2: f=1,
    3: 2-4, 4: 5-16, 5: 17-64, 6: 65-512, 7: >512} (flops.cu:39-47)."""
    bounds = torch.tensor(FLOPS_BIN_BOUNDS, dtype=flops.dtype, device=flops.device)
    return (torch.searchsorted(bounds, flops) + 1).to(INDEX_DTYPE)


def classify_flops(a: CSR, b: CSR) -> FlopsBinning:
    """Rows by flops and the bin boundaries, on A's device: per-row flops,
    a stable sort of the rows by them, the exclusive scan of the sorted
    flops (each product's output slot), and each bin's first row by a
    search of the sorted flops (flops.cu:96-140)."""
    rf = row_flops(a, b)
    sorted_flops, order = torch.sort(rf, stable=True)
    offsets = exclusive_cumsum(sorted_flops)
    # bin b covers flops in (bounds[b-1], bounds[b]]
    bounds = torch.tensor((0,) + FLOPS_BIN_BOUNDS, dtype=rf.dtype, device=rf.device)
    starts = torch.searchsorted(sorted_flops, bounds, right=True).to(INDEX_DTYPE)
    edge = torch.tensor([0, a.rows], dtype=INDEX_DTYPE, device=rf.device)
    bin_starts = torch.cat([edge[:1], starts[:-1], edge[1:]])
    return FlopsBinning(order.to(INDEX_DTYPE), sorted_flops, offsets, bin_starts)


# ---- histograms (stats.cc parity) ------------------------------------------------
def log2_histogram(x: torch.Tensor, num_buckets: int = 13) -> torch.Tensor:
    """Log2-bucket histogram (int32): bucket k counts values in
    [2^(k-1), 2^k), bucket 0 the zeros and ones (pushToStats +
    flopsStats, stats.cc:3-57).  The bucket is the ceiling of an f32
    log2, as the reference computes it, so the edges agree."""
    xf = torch.clamp(x.to(torch.float32), min=1.0)
    k = torch.ceil(torch.log2(xf)).to(torch.int64).clamp(0, num_buckets - 1)
    hist = torch.zeros(num_buckets, dtype=INDEX_DTYPE, device=x.device)
    return hist.index_add_(0, k, torch.ones_like(k, dtype=INDEX_DTYPE))


def flops_stats(a: CSR, b: CSR, num_buckets: int = 13):
    """(per-row flops histogram, per-row flops) (flopsStats,
    stats.cc:29-57)."""
    rf = row_flops(a, b)
    return log2_histogram(rf, num_buckets), rf


def nnz_stats(c: CSR, num_buckets: int = 13) -> torch.Tensor:
    """Per-row nnz histogram (CSR::nnzStats, CSR.cc:242-249)."""
    return log2_histogram(c.row_counts(), num_buckets)


def print_stats(hist, title: str = "stats") -> None:
    """Textual histogram like outputStats (stats.cc:14-27); the same text
    as the reference's."""
    hist = hist.cpu().numpy() if isinstance(hist, torch.Tensor) else np.asarray(hist)
    total = hist.sum()
    print(f"=== {title} (total {total}) ===")
    lo = 0
    for k, cnt in enumerate(hist):
        hi = 1 << k
        if cnt:
            print(f"  [{lo:>8} .. {hi:>8}): {cnt}")
        lo = hi


def footprint_row_costs(a: CSR, b: CSR, chunk: int | None = None) -> np.ndarray:
    """Per-row partition cost with memory-footprint terms (host, int64):
    ``padded descriptor slots + min(flops, ncols) + annz + 32``, the
    reference's modernisation of footPrintsCrowiCount
    (static_omp_csr_kernel.cc:28-62).  A host copy of the reference's
    function, so both deal the same rows to the same shards."""
    from ..utils.nphost import csr_host, segment_sums, snap_chunks_arr

    rp, ci_all = csr_host(a)
    nnz = int(rp[-1])
    ci = ci_all[:nnz]
    bcnt = np.diff(csr_host(b)[0])
    elen = bcnt[np.clip(ci, 0, b.rows - 1)]
    if chunk is None:
        from .ell_plan import MAX_W, auto_chunk

        chunk = auto_chunk(elen, rp, b.ncols, MAX_W)
    maxlen = int(elen.max()) if elen.size else 0
    lens = np.arange(maxlen + 1, dtype=np.int64)
    wtbl = snap_chunks_arr(-(-lens // chunk)) * chunk
    wtbl[0] = 0
    pad_slots = segment_sums(wtbl[elen.astype(np.int32, copy=False)], rp)
    row_fl = segment_sums(elen, rp)
    annz = np.diff(rp)
    cnnz_est = np.minimum(row_fl, int(b.ncols))
    return pad_slots + cnnz_est + annz + 32
