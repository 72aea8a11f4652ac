"""R-MCL, the flagship algorithm (the port of the JAX package's
``models/rmcl.py``; the reference's nlibs/qrmcl.{h,cc}).

* ``rmcl_init``      — rmclInit (qrmcl.cc:126-134): self loops, order,
                       CSR, row-uniform normalisation (the graph is read
                       transposed, so rows are the stochastic axis).
* ``rmcl_one_step``  — one fused iteration Mt' = prune(inflate(Mgt·Mt)):
                       the stream ESC feeding the segmented
                       inflate/threshold/prune/normalize, with no
                       intermediate CSR (omp_csr_kernel.cc:154-198).
* ``rmcl``           — the iteration loop.  ``mode="scan"`` keeps the
                       iterate and the per-iteration statistics on the
                       card and reads them once at the end (the
                       gpuRmclIter pattern, gpu_csr_kernel.cu:281-311);
                       ``mode="loop"`` re-plans capacities on the host
                       each iteration (mtRmclIter, qrmcl.cc:8-84).

Every step is deterministic on the card: the float sums of the product
segments and of the prune's rows each add up one contiguous run in a
fixed order (``ops.segments.run_sums``), so a scan and a loop over the
same graph give the same bits.  The registry ``BACKENDS`` maps each of
the reference's RunOptions names (qrmcl.h:8-21) onto the ESC step, as
the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..config import DEFAULT_MAX_ITERS, QVALUE_DTYPE
from ..formats.coo import COO
from ..formats.csr import CSR
from ..ops.flops import entry_flops
from ..ops.metrics import differs as csr_differs
from ..ops.metrics import row_growth_histogram
from ..ops.prune import inflate_prune_normalize_stream, prune_normalize
from ..ops.spgemm import esc_compress, esc_expand, esc_sort, matmul
from ..utils.timing import Profiler, block_until_ready


def rmcl_init(coo: COO) -> CSR:
    """Self loops + ordering + CSR + row-uniform normalisation
    (rmclInit, qrmcl.cc:126-134).  Requires coo capacity >= nnz + rows."""
    return coo.add_self_loops().make_ordered().to_csr().aver_and_norm_rows()


# ---------------------------------------------------------------------------
# one fused iteration
# ---------------------------------------------------------------------------
def rmcl_one_step(mgt: CSR, mt: CSR, product_cap: int, c_cap: int):
    """Mt' = prune(inflate(Mgt · Mt)) on the matrices' device, with no
    host read.

    The output's capacity is ``mt.capacity``, so the iterate keeps its
    shape from step to step.  Returns (new_mt, info): 0-d tensors of the
    exact flops and nnz and the overflow flags (a capacity too small
    truncates, the moral equivalent of an undersized malloc)."""
    m, n = mgt.rows, mt.ncols
    prow, pcol, pval, flops = esc_expand(mgt, mt, product_cap)
    prow, pcol, pval, _, flags, seg, nnzc = esc_sort(prow, pcol, pval, m)
    crow, ccol, cval = esc_compress(prow, pcol, pval, flags, seg, nnzc, flops, m, n, c_cap)
    del prow, pcol, pval, flags, seg  # the product streams, before the prune's own
    row_ptr, col, val, overflow_mt = inflate_prune_normalize_stream(
        crow, ccol, cval, crow < m, m, n, mt.capacity
    )
    new_mt = CSR(row_ptr, col, val, n)
    info = {
        "flops": flops,
        "nnz_c": nnzc,
        "nnz_mt": new_mt.nnz,
        "overflow_products": flops > product_cap,
        "overflow_c": nnzc > c_cap,
        "overflow_mt": overflow_mt,
    }
    return new_mt, info


def rmcl_one_step_unfused(mgt: CSR, mt: CSR):
    """SpGEMM then a separate prune pass (the SFOMP / seqRmclIter shape,
    qrmcl.cc:86-124), capacities planned on the host.  Returns
    (new_mt, overflow)."""
    c = matmul(mgt, mt)
    return prune_normalize(c, out_cap=c.capacity)


# ---------------------------------------------------------------------------
# iteration loops
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RmclResult:
    mt: CSR  # final iterate
    iters: int
    nnz_history: np.ndarray
    flops_history: np.ndarray
    differs_history: np.ndarray  # relative Frobenius drift per iteration
    overflow: bool
    row_growth: list | None = None


def rmcl_scan(
    mgt: CSR,
    mt: CSR,
    product_cap: int,
    c_cap: int,
    max_iters: int,
    track_differs: bool = True,
):
    """``max_iters`` fixed-capacity steps with the iterate on the card
    (the reference's ``lax.scan``, ``models/rmcl.py:112-145``).  The
    loop makes no device-to-host read: nnz, flops, drift and overflow
    stay 0-d tensors, stacked after the last step.  Returns (final mt,
    dict of [max_iters] tensors)."""
    hist = {"nnz": [], "flops": [], "differs": [], "overflow": []}
    zero = torch.zeros((), dtype=QVALUE_DTYPE, device=mt.device)
    cur = mt
    for _ in range(max_iters):
        new_mt, info = rmcl_one_step(mgt, cur, product_cap, c_cap)
        hist["nnz"].append(info["nnz_mt"])
        hist["flops"].append(info["flops"])
        hist["differs"].append(csr_differs(cur, new_mt) if track_differs else zero)
        hist["overflow"].append(
            info["overflow_products"] | info["overflow_c"] | info["overflow_mt"]
        )
        cur = new_mt
    return cur, {k: torch.stack(v) if v else torch.zeros(0, device=mt.device)
                 for k, v in hist.items()}


def plan_capacities(mgt: CSR, mt: CSR, margin: float = 1.5) -> tuple[int, int]:
    """Capacity planning: the exact flops of Mgt·Mt with a safety margin
    (flops is not monotone across iterations: pruning can keep more
    entries than the previous iterate had).  One read of the flop
    count from the card."""
    flops = max(int(entry_flops(mgt, mt).sum(dtype=torch.int64)), 1)
    product_cap = int(max(np.ceil(flops * margin), 16))
    return product_cap, product_cap


def rmcl(
    graph: COO | CSR,
    max_iters: int = DEFAULT_MAX_ITERS,
    mode: str = "scan",
    product_cap: int | None = None,
    c_cap: int | None = None,
    mt_cap: int | None = None,
    margin: float = 1.5,
    track_differs: bool = True,
    track_row_growth: bool = False,
    backend: str = "ESC",
    profile: bool = False,
) -> RmclResult:
    """Run R-MCL to ``max_iters`` (RMCL entry point, qrmcl.cc:136-164) on
    the graph's device.

    ``graph``: a COO (already transposed if read with is_trans=True, the
    reference default) or an initialised CSR (output of ``rmcl_init``).
    ``mode="scan"`` keeps the capacities of the first plan for every
    step and reports a step that outgrew them in ``overflow``; it never
    grows a capacity.
    """
    step_impl = BACKENDS[backend.upper()]
    mt0 = rmcl_init(graph) if isinstance(graph, COO) else graph
    mgt = mt0.deep_copy()  # Mgt = Mt.deepCopy() (qrmcl.cc:141)

    if product_cap is None or c_cap is None:
        pc, cc = plan_capacities(mgt, mt0, margin)
        product_cap = product_cap or pc
        c_cap = c_cap or cc

    # The iterate's capacity is its prune-survivor budget; pruning can keep
    # more entries than the previous iterate held, so default to c_cap
    # (always sufficient) unless the caller trades memory for a tighter cap.
    if mt_cap is None:
        mt_cap = c_cap
    if mt0.capacity < mt_cap:
        mt0 = mt0.with_capacity(mt_cap)

    if mode == "scan":
        mt, hist = rmcl_scan(mgt, mt0, product_cap, c_cap, max_iters, track_differs)
        hist = {k: v.cpu().numpy() for k, v in hist.items()}  # the one read
        return RmclResult(
            mt=mt,
            iters=max_iters,
            nnz_history=hist["nnz"],
            flops_history=hist["flops"],
            differs_history=hist["differs"],
            overflow=bool(np.any(hist["overflow"])),
        )

    # host loop: re-plan capacities per iteration (mtRmclIter shape), with
    # the reference's -Dprofiling phase spans (static_omp_csr_kernel.cc)
    prof = Profiler(enabled=profile)
    mt = mt0
    nnzs, flopss, diffs, growth = [], [], [], []
    overflow = False
    for _ in range(max_iters):
        with prof.span("plan"):
            pc, cc = plan_capacities(mgt, mt, margin=1.0)
        with prof.span("one_step"):
            new_mt, info = step_impl(mgt, mt, pc, max(cc, mt.capacity))
            if profile:
                block_until_ready(new_mt)
        if track_differs:
            diffs.append(float(csr_differs(mt, new_mt)))
        if track_row_growth:
            growth.append(row_growth_histogram(mt, new_mt).cpu().numpy())
        nnzs.append(int(info["nnz_mt"]))
        flopss.append(int(info["flops"]))
        overflow |= bool(info["overflow_mt"]) or bool(info["overflow_c"])
        mt = new_mt
    if profile:
        print(prof.report())
    return RmclResult(
        mt=mt,
        iters=max_iters,
        nnz_history=np.asarray(nnzs),
        flops_history=np.asarray(flopss),
        differs_history=np.asarray(diffs),
        overflow=overflow,
        row_growth=growth if track_row_growth else None,
    )


# RunOptions parity (qrmcl.h:8-21): every reference backend runs the ESC
# step; the names stay valid so reference run scripts port.
BACKENDS: dict[str, Callable[..., Any]] = dict.fromkeys(
    ("ESC", "SEQ", "OMP", "SOMP", "SFOMP", "HYB", "MKL", "CILK", "GPU"), rmcl_one_step
)
