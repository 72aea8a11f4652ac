"""Flops of C = A·B per entry and per row (the port of the JAX package's
``ops/flops.py:27-55``): ``rowFlops[i] = sum over j in A[i,:] of
nnz(B[j,:])``, single-count (callers double it for GFLOPS); and the
footprint row costs that ``balance=True`` partitions on (``:136-175``).
The binning and statistics helpers are not ported yet."""

from __future__ import annotations

import numpy as np
import torch

from ..config import INDEX_DTYPE
from ..formats.csr import CSR
from .segments import segment_sum


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
