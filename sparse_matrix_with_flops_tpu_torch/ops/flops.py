"""Flops of C = A·B per entry and per row (the port of the JAX package's
``ops/flops.py:27-55``): ``rowFlops[i] = sum over j in A[i,:] of
nnz(B[j,:])``, single-count (callers double it for GFLOPS).  The
binning and statistics helpers are not ported yet."""

from __future__ import annotations

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
