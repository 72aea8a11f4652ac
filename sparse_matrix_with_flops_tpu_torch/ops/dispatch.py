"""Data-adaptive SpGEMM dispatch (port of the JAX package's
``ops/dispatch.py``).

Two structurally different engines:

* the lane pipeline (``ops/ell_esc.py``): flops-classified row tiles,
  gather + presorted bitonic dedup, right for power-law structure where
  occupied blocks would be ~0.1% dense;
* the dense-block path (``ops/block_spgemm.py``): batched bs x bs block
  matmuls, right for FEM/band structure where blocks along the band are
  15-40% dense.

:func:`spgemm_auto` picks per multiply from the measured block fill, one
cheap host pass (``block_fill_estimate``), with the reference's 5%
threshold.
"""

from __future__ import annotations

from ..formats.csr import CSR
from .block_spgemm import block_fill_estimate, block_spgemm, plan_block
from .ell_esc import spgemm_ell
from .ell_plan import plan_ell

BLOCK_FILL_THRESHOLD = 0.05


def route(
    a: CSR,
    b: CSR,
    fill_threshold: float = BLOCK_FILL_THRESHOLD,
    bs: int = 128,
) -> tuple[str, float]:
    """The dispatch decision: ('block' | 'ell', measured fill)."""
    fill = block_fill_estimate(a, b, bs=bs)
    return ("block" if fill >= fill_threshold else "ell"), fill


def spgemm_auto(
    a: CSR,
    b: CSR,
    fill_threshold: float = BLOCK_FILL_THRESHOLD,
    bs: int = 128,
) -> CSR:
    """C = A·B, routed to the block path or the lane pipeline by the
    measured block fill."""
    kernel, _ = route(a, b, fill_threshold, bs)
    if kernel == "block":
        return block_spgemm(a, b, plan_block(a, b, bs=bs))
    return spgemm_ell(a, b, plan_ell(a, b))
