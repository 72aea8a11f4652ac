"""R-MCL, plain PyTorch (the reference's nlibs/qrmcl.cc and util.cc).

* init (rmclInit): a self loop on every row that lacks one, each row's
  entries 1 / (its entry count);
* with a selection cap ``S`` (the static path, ``rmcl_ell``) the first
  iterate keeps each row's first S columns, renormalised;
* each iteration: C = Mgt · Mt with Mgt the initial matrix; per row
  inflate (w = c²), threshold t = min(max(0.9 · avg · (1 − 2 · (max −
  avg)), 1e-7), max) over the row's w, keep w ≥ t, with ``S`` keep the S
  largest (ties to the lower column), renormalise.

``precision`` as in :mod:`.spgemm`: "f64" the reference, "tf32" the
control (TF32 products, float32 everywhere else).
"""

from __future__ import annotations

import torch

from .spgemm import exclusive_cumsum, spgemm

PRUNE_A, PRUNE_B, PRUNE_FLOOR = 0.9, 2.0, 1e-7


def init(row_ptr, col, n: int, device):
    """Mgt = rmclInit(graph): host CSR arrays in, device CSR out (int64
    indices, float64 values 1 / count)."""
    rp = torch.as_tensor(row_ptr, dtype=torch.int64, device=device)
    ci = torch.as_tensor(col, dtype=torch.int64, device=device)
    rows = torch.repeat_interleave(torch.arange(n, device=device), rp[1:] - rp[:-1])
    has = torch.zeros(n, dtype=torch.bool, device=device)
    has[rows[rows == ci]] = True
    miss = torch.nonzero(~has).reshape(-1)
    key = torch.cat([rows * n + ci, miss * n + miss])
    key = torch.sort(key).values
    r, c = key // n, key % n
    counts = torch.bincount(r, minlength=n)
    out_rp = exclusive_cumsum(counts)
    val = 1.0 / counts[r].to(torch.float64)
    return out_rp, c, val


def _rows(row_ptr):
    n = row_ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=row_ptr.device),
                                   row_ptr[1:] - row_ptr[:-1])


def first_s(row_ptr, col, val, S: int):
    """Each row's first S entries (in column order), renormalised."""
    r = _rows(row_ptr)
    rank = torch.arange(col.shape[0], device=col.device) - row_ptr[r]
    keep = rank < S
    return _select(row_ptr.shape[0] - 1, r[keep], col[keep], val[keep])


def _select(n: int, r, c, v):
    counts = torch.bincount(r, minlength=n)
    s = torch.zeros(n, dtype=v.dtype, device=v.device).index_add_(0, r, v)
    return exclusive_cumsum(counts), c, v / s[r]


def prune(row_ptr, col, val, S: int | None):
    """Inflate, threshold, keep, top-S (ties to the lower column) and
    renormalise every row of C."""
    n = row_ptr.shape[0] - 1
    r = _rows(row_ptr)
    w = val * val
    cnt = (row_ptr[1:] - row_ptr[:-1]).to(w.dtype)
    rsum = torch.zeros(n, dtype=w.dtype, device=w.device).index_add_(0, r, w)
    rmax = torch.zeros(n, dtype=w.dtype, device=w.device).scatter_reduce_(
        0, r, w, "amax", include_self=True)
    avg = rsum / torch.clamp(cnt, min=1.0)
    t = torch.minimum(torch.clamp(PRUNE_A * avg * (1.0 - PRUNE_B * (rmax - avg)),
                                  min=PRUNE_FLOOR), rmax)
    keep = w >= t[r]
    r, c, w = r[keep], col[keep], w[keep]
    if S is not None:
        # rows in order, then w descending, then column ascending: the
        # entries arrive column-sorted, so two stable sorts do it
        o = torch.sort(-w, stable=True).indices
        o = o[torch.sort(r[o], stable=True).indices]
        rs, cs, ws = r[o], c[o], w[o]
        start = exclusive_cumsum(torch.bincount(rs, minlength=n))
        rank = torch.arange(rs.shape[0], device=rs.device) - start[rs]
        sel = rank < S
        rs, cs, ws = rs[sel], cs[sel], ws[sel]
        o = torch.sort(rs * n + cs).indices
        r, c, w = rs[o], cs[o], ws[o]
    return _select(n, r, c, w)


def rmcl(row_ptr, col, n: int, iters: int, S: int | None = None,
         precision: str = "f64", device="cpu"):
    """The final iterate of ``iters`` R-MCL iterations on the graph
    ``(row_ptr, col)`` (host CSR, values ignored: init weighs by count),
    as device CSR ``(row_ptr, col, val)``."""
    a_rp, a_ci, a_v = init(row_ptr, col, n, device)
    if precision != "f64":
        a_v = a_v.to(torch.float32)
    m_rp, m_ci, m_v = (a_rp, a_ci, a_v) if S is None else first_s(a_rp, a_ci, a_v, S)
    for _ in range(iters):
        c_rp, c_ci, c_v = spgemm(a_rp, a_ci, a_v, m_rp, m_ci, m_v, n, precision)
        m_rp, m_ci, m_v = prune(c_rp, c_ci, c_v, S)
    return m_rp, m_ci, m_v
