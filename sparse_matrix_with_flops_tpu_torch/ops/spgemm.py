"""Host-side SpGEMM helpers: flop counts and the dense oracle.

The port of ``spgemm_upper_bounds`` and ``spgemm_dense_oracle`` from
the JAX package's ``ops/spgemm.py``; the stream-ESC engine itself is
not part of this port yet.
"""

from __future__ import annotations

import numpy as np

from ..formats.csr import CSR
from ..utils.nphost import csr_host


def spgemm_upper_bounds(a: CSR, b: CSR) -> tuple[int, int]:
    """Concrete ``(product_cap, out_cap)`` on the host: the exact flop
    count (multiply-adds), with the output bounded by it."""
    rp_a, ci_a = csr_host(a)
    rp_b, _ = csr_host(b)
    col = ci_a[: int(rp_a[-1])]
    safe = np.clip(col, 0, b.rows - 1)
    flops = max(int(np.diff(rp_b)[safe].sum()), 1)
    return flops, flops


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
