"""Row-partitioned SpGEMM driver (the port of the JAX package's
``ops/partitioned.py``): flat-CSR output at scales where the
single-dispatch pipeline's intermediates would not fit on one card.

The ELL-ESC tiles phase holds O(padded flops) intermediates and the
assembly a further O(nnz C) window source.  This driver splits A's rows
into contiguous groups of near-equal footprint cost, runs the whole
pipeline (K1-K4) per group, so peak device memory is the largest
group's, and stitches the groups' CSRs on the host.  It is the
reference's private-output + stitch parallelism (mvcsr.cc:124-226,
per-thread PCSR blocks concatenated after the fact) applied one group
after another to bound memory.  B stays on the device across groups.
"""

from __future__ import annotations

import numpy as np

from ..formats.csr import CSR
from ..utils.nphost import csr_host
from .ell_esc import spgemm_ell
from .ell_plan import plan_ell


def csr_row_slice(a: CSR, r0: int, r1: int) -> CSR:
    """Row slice a[r0:r1, :] as a tight CSR on A's device, cut on the
    host."""
    rp, ci = csr_host(a)
    e0, e1 = int(rp[r0]), int(rp[r1])
    return CSR.from_numpy(
        rp[r0 : r1 + 1] - e0, ci[e0:e1], a.values[e0:e1].cpu().numpy(), a.ncols, a.device
    )


def csr_vstack(blocks: list[CSR], ncols: int) -> CSR:
    """Stack row blocks into one tight CSR, stitched on the host and put
    on the blocks' device (the card when there are none)."""
    rps, cis, vs = [np.zeros(1, np.int64)], [], []
    base = 0
    for blk in blocks:
        rp, ci, v = blk.to_numpy()
        rps.append(rp[1:].astype(np.int64) + base)
        cis.append(ci)
        vs.append(v)
        base += int(rp[-1])
    return CSR.from_numpy(
        np.concatenate(rps),
        np.concatenate(cis) if cis else np.zeros(0, np.int32),
        np.concatenate(vs) if vs else np.zeros(0, np.float32),
        ncols,
        blocks[0].device if blocks else None,
    )


def flops_prefix_partition(a: CSR, b: CSR, parts: int) -> list[int]:
    """Row cut points [0, r_1, ..., rows] splitting A into ``parts``
    contiguous groups of near-equal footprint cost (the reference's
    footPrintsCrowiCount partition, static_omp_csr_kernel.cc:28-62, with
    the scost law of cpu_csr_kernel.cc:317-334 applied to prefix sums so
    the groups stay contiguous and the stitch is a concatenation).  The
    cost is ``ops.flops.footprint_row_costs``: padded descriptor slots +
    output writes + A reads, not raw flops."""
    from .flops import footprint_row_costs

    row_cost = footprint_row_costs(a, b)
    pref = np.concatenate([[0], np.cumsum(row_cost)])  # pref[r+1] = cost of rows [0, r]
    total = pref[-1]
    cuts = [0]
    for g in range(1, parts):
        cuts.append(int(np.searchsorted(pref, total * g // parts)))
    cuts.append(a.rows)
    return sorted(set(cuts))


def spgemm_ell_partitioned(
    a: CSR, b: CSR, parts: int = 4, exact: bool = True
) -> CSR:
    """C = A·B with A's rows in flops-balanced groups, each multiplied
    through the whole ELL-ESC pipeline with its own plan, stitched on the
    host; the result is on A's device.  Peak device memory is about
    1/parts of the single call's."""
    cuts = flops_prefix_partition(a, b, parts)
    blocks = []
    for r0, r1 in zip(cuts[:-1], cuts[1:]):
        a_g = csr_row_slice(a, r0, r1)
        blocks.append(spgemm_ell(a_g, b, plan_ell(a_g, b), exact=exact))
    return csr_vstack(blocks, b.ncols)
