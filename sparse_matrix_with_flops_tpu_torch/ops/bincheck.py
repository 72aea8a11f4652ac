"""Per-bin differential checking + bin diagnostics (the port of the JAX
package's ``ops/bincheck.py``, host numpy; it reads the port's CSRs, on
the card or the CPU, through host copies).

The reference's binned-kernel verification toolbox:

* ``classify_flops_queues`` — the CPU-side reference classifier
  (mindex2-cuda/nGpuSpMM.cc:48-83): rows grouped into 64 power-of-two
  flops queues with the "acount >= 128 -> queue 63" escape.
* ``is_partial_raw_equal`` — the per-bin comparator
  (nGpuSpMM.cc:85-125): for a subset of rows, every |value| > 1e-8 entry
  of ``hc`` must match ``rc`` within relative error 1e-3.
* ``results_comparison`` — the whole-output + bin-by-bin bidirectional
  verdict (nGpuSpMM.cc:127-240), localising which flops bin a kernel
  regression corrupted.
* ``per_bin_b_row_histogram`` — the bin diagnostics of
  mindex2-cuda/analysis.cu:35-110 (count_row_flops/printFlops): for each
  flops bin of A rows, the log2 histogram of the B-row sizes its elements
  touch.
* ``filter_rows`` — the binning-analysis prototype of
  tools/mat_dat_analysis.cc:53-106: touches of B rows (from A rows with
  nnz >= limit) aggregated into bins by B-row size.

These are diagnostic/verification tools, so they run host-side on numpy
arrays exactly like the reference's host checker does.
"""

from __future__ import annotations

import numpy as np

from ..formats.csr import CSR
from ..utils.nphost import csr_host

N_QUEUES = 64
HUGE_ACOUNT = 128  # acount >= 128 -> queue 63 escape (nGpuSpMM.cc:57-60)


def _queue_id(flops: np.ndarray) -> np.ndarray:
    """queueId (nGpuSpMM.cc:36-47): f=1 -> 1, f in (2^(k-2), 2^(k-1)] -> k."""
    f = np.maximum(flops, 1).astype(np.int64)
    return np.where(f <= 1, 1, 2 + np.ceil(np.log2(f) - 1).astype(np.int64))


def classify_flops_queues(
    a: CSR, b: CSR
) -> tuple[np.ndarray, np.ndarray]:
    """Rows grouped by flops queue (classifyFlops, nGpuSpMM.cc:48-83).

    Returns ``(hqueue, hv)``: ``hqueue`` holds row ids ordered by queue,
    ``hv`` (length 65) the queue boundaries into it.  Rows with zero
    flops appear in no queue; rows with a single A entry go to queue 0;
    rows with >= 128 A entries go to the escape queue 63.
    """
    rp, ci = csr_host(a)
    m = a.rows
    bcounts = np.diff(csr_host(b)[0])
    nnz = int(rp[-1])
    acol = np.clip(ci[:nnz], 0, b.rows - 1)
    acount = np.diff(rp)
    rf = np.zeros(m, dtype=np.int64)
    np.add.at(
        rf, np.repeat(np.arange(m), acount), bcounts[acol]
    )

    q = np.zeros(m, dtype=np.int64)
    multi = acount > 1
    q[multi] = _queue_id(rf[multi])
    q[acount >= HUGE_ACOUNT] = N_QUEUES - 1
    active = rf > 0
    rows = np.nonzero(active)[0]
    order = np.argsort(q[rows], kind="stable")
    hqueue = rows[order].astype(np.int32)
    hv = np.zeros(N_QUEUES + 1, dtype=np.int64)
    counts = np.bincount(np.clip(q[rows], 0, N_QUEUES - 1), minlength=N_QUEUES)
    np.cumsum(counts, out=hv[1:])
    return hqueue, hv


def is_partial_raw_equal(
    hc: CSR,
    rc: CSR,
    row_ids: np.ndarray,
    rel: float = 1e-3,
    eps: float = 1e-8,
) -> tuple[bool, int]:
    """Reference per-bin comparator (isPartialRawEqual, nGpuSpMM.cc:85-125).

    For each row in ``row_ids``: every entry of ``hc`` with |value| > eps
    must match the corresponding ``rc`` entry (0 if structurally absent or
    |rc value| <= eps) within relative error ``rel``.  Returns
    (ok, number of mismatching entries).
    """
    row_ids = np.asarray(row_ids, dtype=np.int64)
    if row_ids.size == 0:
        return True, 0
    n = hc.ncols

    def _rows(c: CSR):
        rp, col = csr_host(c)
        val = c.values.cpu().numpy()
        starts = rp[row_ids]
        lens = rp[row_ids + 1] - starts
        tot = int(lens.sum())
        src = np.repeat(starts, lens) + (
            np.arange(tot) - np.repeat(np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
        )
        rows_rep = np.repeat(row_ids, lens)
        return rows_rep * (n + 1) + col[src], val[src]

    hkey, hval = _rows(hc)
    rkey, rval = _rows(rc)
    # rc lookup table: only |value| > eps entries participate (the
    # reference skips tiny rc entries when building rowVals)
    keep = np.abs(rval) > eps
    rkey, rval = rkey[keep], rval[keep]
    ro = np.argsort(rkey, kind="stable")
    rkey, rval = rkey[ro], rval[ro]
    if rkey.size:
        pos = np.clip(np.searchsorted(rkey, hkey), 0, rkey.size - 1)
        matched = rkey[pos] == hkey
        want = np.where(matched, rval[pos], 0.0)
    else:
        want = np.zeros(hval.shape, hval.dtype)
    check = np.abs(hval) > eps
    relerr = np.abs(
        (want - hval) / np.where(np.abs(want) > 0, want, 1.0)
    )
    # reference: relativeError >= 0.001 (divides by rowVals[col]; an
    # absent rc entry means the hc entry must itself be ~0, checked via
    # the `check` mask with want==0 -> relerr = |hval| which fails)
    bad = check & np.where(
        want != 0, relerr >= rel, np.abs(hval) > eps
    )
    return not bool(bad.any()), int(bad.sum())


def results_comparison(
    hc: CSR,
    rc: CSR,
    a: CSR,
    b: CSR,
    rel: float = 1e-3,
) -> dict:
    """Bin-by-bin bidirectional comparison (resultsComparison,
    nGpuSpMM.cc:127-240).  Returns a report dict:

    ``{"ok": bool, "bins": {q: {"rows": n, "hc_vs_rc": ok, "rc_vs_hc": ok,
    "mismatches": k}}, "failing_bins": [...]}``
    """
    hqueue, hv = classify_flops_queues(a, b)
    bins: dict[int, dict] = {}
    failing = []
    for q in range(N_QUEUES):
        ids = hqueue[hv[q] : hv[q + 1]]
        if ids.size == 0:
            continue
        ok_f, n_f = is_partial_raw_equal(hc, rc, ids, rel=rel)
        ok_b, n_b = is_partial_raw_equal(rc, hc, ids, rel=rel)
        bins[q] = {
            "rows": int(ids.size),
            "hc_vs_rc": ok_f,
            "rc_vs_hc": ok_b,
            "mismatches": n_f + n_b,
        }
        if not (ok_f and ok_b):
            failing.append(q)
    return {"ok": not failing, "bins": bins, "failing_bins": failing}


def per_bin_b_row_histogram(
    a: CSR, b: CSR, num_buckets: int = 13
) -> np.ndarray:
    """[64, num_buckets] histogram: for each flops queue of A rows, the
    distribution of queueId(B-row size) over that queue's A ELEMENTS
    (count_row_flops/printFlops, analysis.cu:35-110)."""
    hqueue, hv = classify_flops_queues(a, b)
    rp, ci = csr_host(a)
    bcounts = np.diff(csr_host(b)[0])
    nnz = int(rp[-1])
    acol = np.clip(ci[:nnz], 0, b.rows - 1)
    ef = bcounts[acol]  # per-element B-row size
    # queue of each element's owning row
    row_q = np.full(a.rows, -1, dtype=np.int64)
    for q in range(N_QUEUES):
        row_q[hqueue[hv[q] : hv[q + 1]]] = q
    erow = np.repeat(np.arange(a.rows), np.diff(rp))
    eq = row_q[erow]
    keep = (eq >= 0) & (ef > 0)
    buckets = np.clip(_queue_id(ef[keep]), 0, num_buckets - 1)
    hist = np.zeros((N_QUEUES, num_buckets), dtype=np.int64)
    np.add.at(hist, (eq[keep], buckets), 1)
    return hist


def filter_rows(
    limit: int, a: CSR, b: CSR, bin_limits: list[int]
) -> list[int]:
    """B-row-size x A-row-filter binning (mat_dat_analysis.cc:53-106).

    Counts how often each B row is touched by A rows having
    nnz >= ``limit``, then aggregates those touch counts into bins by the
    B row's own nnz: returns len(bin_limits)+1 totals, bin i counting B
    rows with nnz <= bin_limits[i] (last bin: the rest).
    """
    rp, ci = csr_host(a)
    nnz = int(rp[-1])
    acol = ci[:nnz]
    acount = np.diff(rp)
    bsize = np.diff(csr_host(b)[0])

    count = np.zeros(b.rows, dtype=np.int64)
    sel_rows = acount >= limit
    sel_entries = np.repeat(sel_rows, acount)
    np.add.at(count, np.clip(acol[sel_entries], 0, b.rows - 1), 1)

    out = []
    prev = -1
    for lim in bin_limits:
        sel = (bsize > prev) & (bsize <= lim)
        out.append(int(count[sel].sum()))
        prev = lim
    out.append(int(count[bsize > prev].sum()))
    return out
