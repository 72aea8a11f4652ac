"""Sparse convergence metrics (the port of the JAX package's
``ops/metrics.py``).

The reference's ``CSR::differs`` L2 drift (CSR.cc:213-240) and
``differsStats`` per-row-growth histogram (CSR.cc:381-415) as sparse
reductions: a union of the two entry streams, one sort, a sum a segment.
No host read: the R-MCL scan tracks them on the card.
"""

from __future__ import annotations

import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..formats.csr import CSR
from .segments import DUMP_SLOTS, dump_region, segment_boundaries, segment_sum


def csr_frobenius_diff(a: CSR, b: CSR) -> tuple[torch.Tensor, torch.Tensor]:
    """(||A − B||_F², ||A||_F²) over the union pattern, 0-d tensors.  Each
    (row, col) of two CSRs with unique columns a row holds at most two
    entries, adjacent after the sort: a segment's sum is its first entry
    plus the next where that one continues it (a sum of two does not
    depend on its order), stored once at the segment's index, so no
    write is an atomic and none queues on a shared address."""
    rows = a.rows
    b = b.to(a.device)
    valid = torch.cat([a.entry_valid(), b.entry_valid()])
    r = torch.where(valid, torch.cat([a.entry_rows(), b.entry_rows()]), rows)
    c = torch.cat([a.col_ind, b.col_ind])
    v = torch.cat([a.values, -b.values]).to(QVALUE_DTYPE)
    order = torch.sort(r.long() * (max(a.ncols, b.ncols) + 1) + c.long(), stable=True).indices
    r, c, v = r[order], c[order], v[order]
    n = r.shape[0]
    ok = r < rows
    flags = segment_boundaries(r, c, ok)
    v = torch.where(ok, v, 0.0)
    more = torch.cat([ok[1:] & ~flags[1:], ok.new_zeros(1)])  # the next entry continues
    pair = v + torch.where(more, torch.cat([v[1:], v.new_zeros(1)]), 0.0)
    q = torch.arange(n, device=r.device)
    seg = torch.where(flags, torch.cumsum(flags, 0) - 1, dump_region(q, n))
    sums = torch.zeros(n + DUMP_SLOTS, dtype=QVALUE_DTYPE, device=r.device)
    sums.scatter_(0, seg, pair)
    sums = sums[:n]
    a_sq = torch.where(a.entry_valid(), a.values**2, 0.0).sum()
    return (sums * sums).sum(), a_sq


def differs(a: CSR, b: CSR) -> torch.Tensor:
    """Relative Frobenius drift ||A − B||_F / ||A||_F (CSR::differs role),
    a 0-d tensor."""
    d2, n2 = csr_frobenius_diff(a, b)
    return torch.sqrt(d2) / torch.sqrt(n2).clamp(min=1e-30)


def row_growth_histogram(
    prev: CSR,
    new: CSR,
    bounds=(-30.0, -20.0, -5.0, 0.0, 5.0, 20.0, 30.0, 100.0),
) -> torch.Tensor:
    """Histogram of per-row nnz percent change (differsStats,
    CSR.cc:381-415; bucket bounds from qrmcl.cc:17): int32
    ``[len(bounds) + 1]``, bucket i counting the rows with
    ``bounds[i - 1] < pct <= bounds[i]``."""
    ca = prev.row_counts().to(torch.float32)
    cb = new.row_counts().to(prev.device, torch.float32)
    pct = 100.0 * (cb - ca) / ca.clamp(min=1.0)
    edges = torch.tensor(bounds, dtype=torch.float32, device=prev.device)
    idx = torch.searchsorted(edges, pct)
    return segment_sum(torch.ones_like(idx, dtype=INDEX_DTYPE), idx, len(bounds) + 1)
