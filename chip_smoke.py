#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py        # from the repository root, one card

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds the CUDA kernels from ``sparse_matrix_with_flops_tpu_torch/csrc``;
3. holds each kernel (K1-K4) against its plain PyTorch twin on the card,
   on inputs cut from the R-MAT s14 plan, and times both; K4 also on
   2^25 + 3 words off the 16-byte grid (4097 tiles, more than the card
   holds resident CTAs); K3 both as the assembly calls it (its windows
   and its row heads in one launch) and on the windows alone, beside
   an index of an unfolded view a stream; K2 and K3 also on the device
   alone (torch.profiler);
4. runs ``spgemm_auto`` on R-MAT s14 (edge factor 8, seed 7, random
   weights; routes ``ell``) and on the cant-class band
   ``banded_csr(62451, 32)`` (routes ``block``), checks both products
   against scipy on the host, checks that the kernels were launched by
   that run, and times the warm multiply and the multiply with its plan;
5. K1 at W = 32768 (the 2-CTA cluster kernel) against its twin on the
   s14 ``max_w=32768`` plan's widest bin, then ``spgemm_ell`` with that
   plan against scipy;
6. K5 ``bcsr_spmm``: the cant-class band as BCSR(8, 128) times a dense
   [62451, 512] B, and R-MAT s14 as BCSR(8, 128) times [16384, 128];
   kernel and twin against scipy's f64 product, both timed, beside
   ``torch.sparse.mm`` on the CSR form of the same matrix (cuSPARSE
   SpMM, true f32) as the library yardstick;
7. the format zoo on the card (plain torch): ``ELL.spmm``,
   ``MCSR.spmm`` and ``csr_spmm_dense`` on the band, ``csr_spmv`` and
   ``PCSR.striped_spgemm`` (4 stripes) on s14, each against scipy;
8. single-chip static-ELL R-MCL (``rmcl_ell``) on R-MAT s14 (edge
   factor 8, seed 7, ``rmcl_init``), S = 128, ``max_tile`` 8192, 5
   iterations: step 1 against a scipy f64 host oracle of the prune
   semantics, the 5-iteration run against the port's own CPU run of the
   same plan, and the warm iteration timed;
9. sharded R-MCL with D = 4 shards stacked on the card (``make_mesh``'s
   default device), 3 iterations, all four exchanges: ``pallas_ring``
   (K6) bit-equal to ``all_gather``, ``fused_ring`` (K8) against
   ``ring``, ``all_gather`` against single-chip ``rmcl_ell``; the warm
   iteration 2 of each exchange timed with CUDA events; K6 at D = 2, 4, 8
   and K7 / K8 at D = 2, 4 against their twins on this run's blocks and
   hub operands.  K6 is timed as the ``pallas_ring`` exchange calls it,
   once for the cols and the vals together, so its launches on the main
   path are one a step (three in the 3-iteration run), half of what two
   calls a step made;
10. a caller that turned TF32 on (ROADMAP C7): with the legacy switches
   set to TF32, ``spgemm_auto`` on both routes (held to scipy as in
   phase 4), ``rmcl_ell`` and ``bcsr_spmm`` (each bit-equal to the same
   call with the switches as the script found them), then the caller's
   switches read back unchanged; a bare ``torch.matmul`` under the same
   switches must differ from true f32, or the phase would prove nothing;
11. the general R-MCL application from a graph file (plain torch, no
   kernel of its own): phase 8's graph written as a SNAP file and read
   back with ``load_coo`` (native loader) on the card, equal to the
   in-memory COO; ``rmcl`` at margin 2.5, scan (no device-to-host read
   under ``torch.cuda.set_sync_debug_mode("error")``) equal to loop,
   each step of ``rmcl_one_step`` against an f64 oracle of the prune
   rules without the S cut from the oracle's previous iterate; the
   reference's overflow at the default margin 1.5; ``nrmcl`` on both
   routes (default "Diffs" with the overflow, STATIC bit-equal to phase
   8's ``rmcl_ell`` and launching K1) and "Same" on ``tdata.snap``;
   ``extract_clusters``; ``rmcl_resumable`` stopped at 2 and resumed to
   5 against the straight run.  It times the scan and loop iterations,
   the loop's host planning and the file's load.

K1's tiles log their longest run of one column (what a run sum costs):
at s14 (phases 3 and 5) and in one R-MCL step (phase 8).

The s14 matrix of phases 3-5 is built with the constructors' default
device, and the script checks that it lands on the card.  Before each
kernel's timed loop, 20 calls with no synchronize between them are held
against the twin, which would show a stale flag or status word of an
earlier launch (K4's and K6's scratch is kept across calls: K4 zeroes
its own before each launch, K6 tags its flags with the launch's epoch).

Every kernel's record carries, beside its time and its twin's, its
device time alone (every device activity of the wrapper's call, by
torch.profiler: no host enqueue in it), its bound
(the larger of the bytes it must move, each input read once and each
output written once, over 3.35 TB/s, and its operations over the card's
peak: an f32 product counted as three TF32 passes at 495 TFLOP/s) and,
where one PyTorch call computes the same function, that call's time
(``library_ms``; the port never calls it), else null with the reason.

Each main-path run starts with every launch count at 0 and reads the
counts right after it; the kernel-versus-twin comparisons and timings
are not counted.  K7 (``ring_matmul``) is on no path of the system, as
its TPU kernel is on none in the reference: its launches come from one
direct call, and its ``launched_by`` entry in the ``kernels`` line says
so.

Any failure raises and exits non-zero.  Without a CUDA device, or
without the port beside it, the script exits non-zero before any
result.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "sparse_matrix_with_flops_tpu_torch"
REPLACES = {
    "sort_dedup_compact": "sparse_matrix_with_flops_tpu/ops/pallas_sort.py:181",
    "compact_nonzero_rows": "sparse_matrix_with_flops_tpu/ops/pallas_sort.py:300",
    "window_gather": "sparse_matrix_with_flops_tpu/ops/pallas_sort.py:244",
    "cumsum_i32": "sparse_matrix_with_flops_tpu/ops/pallas_scan.py:55",
    "bcsr_spmm": "sparse_matrix_with_flops_tpu/ops/spmm.py:84",
    "ring_all_gather": "sparse_matrix_with_flops_tpu/parallel/pallas_ring.py:64",
    "ring_matmul": "sparse_matrix_with_flops_tpu/parallel/pallas_ring.py:136",
    "ring_matmul_tiled": "sparse_matrix_with_flops_tpu/parallel/pallas_ring.py:254",
}
SOURCES = {
    "sort_dedup_compact": f"{PKG}/csrc/sort_dedup_compact.cu",
    "compact_nonzero_rows": f"{PKG}/csrc/compact_nonzero_rows.cu",
    "window_gather": f"{PKG}/csrc/window_gather.cu",
    "cumsum_i32": f"{PKG}/csrc/cumsum_i32.cu",
    "bcsr_spmm": f"{PKG}/csrc/bcsr_spmm.cu",
    "ring_all_gather": f"{PKG}/csrc/ring.cu",
    "ring_matmul": f"{PKG}/csrc/ring.cu",
    "ring_matmul_tiled": f"{PKG}/csrc/ring.cu",
}


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, f32_flops: float = 0.0) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` once and do ``f32_flops`` f32 product operations
    f32-accurately (three TF32 tensor-core passes)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3.0 * f32_flops / TF32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def cuda_ms(torch, fn, reps: int = 15, warm: int = 2) -> float:
    """Median CUDA-event time of one call of ``fn``, in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(torch, fn, calls: int = 20) -> float:
    """Device time of ``fn``'s kernels a call, in ms, from torch.profiler
    (no host enqueue in it)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(k.self_device_time_total for k in prof.key_averages()) / calls / 1e3


def host_ms(torch, fn, reps: int) -> float:
    """Median host-clock time of ``fn`` ending in a synchronize, in ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


FLIP_REL = 1e-5  # a kept value this close (relative) to a prune boundary may flip
MAX_FLIP_SHARE = 1e-3  # rows with a threshold flip, as a share of all rows
MAX_TIE_SHARE = 1e-2  # rows with a tie chosen apart at the S cut, as a share


def padded_rows(np, csr, n: int, S: int):
    """A CSR with at most S entries a row as [n, S] (cols, vals), the
    ELL iterate layout (sentinel n, value 0)."""
    rp, ci, v = csr.to_numpy()
    cols = np.full((n, S), n, np.int64)
    vals = np.zeros((n, S), np.float64)
    cnt = np.diff(rp)
    if cnt.max(initial=0) > S:
        raise AssertionError(f"a row holds {cnt.max()} > S = {S} entries")
    row = np.repeat(np.arange(n), cnt)
    lane = np.arange(ci.size) - rp[:-1][row]
    cols[row, lane] = ci
    vals[row, lane] = v
    return cols, vals


def oracle_step(np, sp, mgt, cols0, vals0, S: int):
    """One R-MCL step on the host in f64: P = Mgt · Mt (scipy), then per
    row inflate, threshold (util.cc:4-9), keep, top-S by value (ties to
    the lower column) and renormalise.  Returns ([n, S] cols, vals, the
    rows with a value within FLIP_REL of the threshold or of the S cut)."""
    n = mgt.rows
    rp, ci, v = mgt.to_numpy()
    a = sp.csr_matrix((v.astype(np.float64), ci, rp), shape=(n, n))
    keep0 = cols0 < n
    b = sp.csr_matrix(
        (vals0[keep0].astype(np.float64),
         (np.repeat(np.arange(n), keep0.sum(1)), cols0[keep0])),
        shape=(n, n),
    )
    p = (a @ b).tocsr()
    p.sort_indices()
    row = np.repeat(np.arange(n), np.diff(p.indptr))
    w = p.data * p.data
    cnt = np.bincount(row, minlength=n)
    rsum = np.bincount(row, weights=w, minlength=n)
    rmax = np.zeros(n)
    np.maximum.at(rmax, row, w)
    avg = rsum / np.maximum(cnt, 1)
    t = np.minimum(np.maximum(0.9 * avg * (1.0 - 2.0 * (rmax - avg)), 1e-7), rmax)
    keep = w >= t[row]
    near = np.zeros(n, bool)
    np.logical_or.at(near, row, np.abs(w - t[row]) <= FLIP_REL * t[row])
    cols = np.full((n, S), n, np.int64)
    vals = np.zeros((n, S), np.float64)
    for r in np.nonzero(np.bincount(row[keep], minlength=n))[0]:
        lo, hi = p.indptr[r], p.indptr[r + 1]
        k = np.nonzero(keep[lo:hi])[0]
        wk = w[lo:hi][k]
        if k.size > S:  # top S, ties to the lower column (stable)
            order = np.argsort(-wk, kind="stable")
            cut = wk[order]
            if abs(cut[S - 1] - cut[S]) <= FLIP_REL * cut[S - 1]:
                near[r] = True
            sel = np.sort(order[:S])
            k, wk = k[sel], wk[sel]
        cols[r, : k.size] = p.indices[lo:hi][k]
        vals[r, : k.size] = wk / wk.sum()
    return cols, vals, near


def tie_rows(np, got_c, got_v, want_c, want_v, rows, n: int):
    """Of ``rows`` (rows whose kept columns differ), those where the two
    sides chose differently between entries of equal value at the S
    cut: both keep as many entries, their sorted kept values agree
    within 1e-3 relative, and every column kept by one side only
    carries that side's smallest kept value to within FLIP_REL."""
    out = []
    for r in rows:
        gk, wk = got_c[r] < n, want_c[r] < n
        if gk.sum() != wk.sum():
            continue
        gv, wv = got_v[r][gk], want_v[r][wk]
        if not np.allclose(np.sort(gv), np.sort(wv), rtol=1e-3, atol=1e-7):
            continue
        go = ~np.isin(got_c[r][gk], want_c[r][wk])
        wo = ~np.isin(want_c[r][wk], got_c[r][gk])
        if (np.abs(gv[go] - gv.min()) <= FLIP_REL * gv.min()).all() and (
            np.abs(wv[wo] - wv.min()) <= FLIP_REL * wv.min()
        ).all():
            out.append(r)
    return np.asarray(out, np.int64)


def compare_iterates(np, what, got_c, got_v, want_c, want_v, near=None, tol=None):
    """Two [n, S] iterates.  Rows whose kept columns differ are S-cut
    ties (``tie_rows``) or threshold flips; with ``near`` (the oracle's
    boundary rows) every differing row must be one of them.  Fails above
    MAX_FLIP_SHARE flips or MAX_TIE_SHARE ties, or when the other rows'
    values differ by more than ``tol`` absolute, or by default 1e-3
    relative + 1e-7.  Returns the list of failures (empty if none)."""
    n = got_c.shape[0]
    diff = (got_c != want_c).any(axis=1)
    rows = np.nonzero(diff)[0]
    ties = tie_rows(np, got_c, got_v, want_c, want_v, rows, n)
    flips = np.setdiff1d(rows, ties)
    same = ~diff
    err = np.abs(got_v[same] - want_v[same])
    if tol is None:
        bound = 1e-3 * np.maximum(np.abs(got_v[same]), np.abs(want_v[same])) + 1e-7
    else:
        bound = np.full(err.shape, tol)
    log(
        f"{what}: {rows.size} of {n} rows differ in their kept columns: "
        f"{ties.size} ties at the S cut, {flips.size} threshold flips; max |err| "
        f"on the {n - rows.size} equal rows {err.max(initial=0.0):.3e}"
        + ("" if near is None else f"; {int(near.sum())} rows at a prune boundary")
    )
    if rows.size:
        log(f"{what}: ties {ties[:12].tolist()} flips {flips[:12].tolist()}")
    failed = []
    if near is not None and (diff & ~near).any():
        failed.append(f"{what}: rows differ away from any prune boundary: "
                      f"{np.nonzero(diff & ~near)[0][:10].tolist()}")
    if flips.size > MAX_FLIP_SHARE * n:
        failed.append(f"{what}: {flips.size} flipped rows > {MAX_FLIP_SHARE:.1%}")
    if ties.size > MAX_TIE_SHARE * n:
        failed.append(f"{what}: {ties.size} tie rows > {MAX_TIE_SHARE:.0%}")
    if not (err <= bound).all():
        failed.append(f"{what}: values differ on equal rows "
                      f"({int((err > bound).sum())} entries)")
    for f in failed:
        log(f"FAIL {f}")
    return failed


# K1 and K2 have no one PyTorch call that computes the same function
NO_CALL = {
    "sort_dedup_compact": "none: a per-row sort by column, a sum of equal columns "
                          "and a left compaction take several torch calls",
    "compact_nonzero_rows": "none: torch.nonzero gives coordinates, not each row's "
                            "(cols, vals) packed left with sentinel padding",
}


def longest_run(torch, tc, ncols: int) -> int:
    """The longest run of one real column (< ncols) in any row of a K1
    tile: the lanes one output lane sums."""
    r, w = tc.shape
    key = torch.arange(r, device=tc.device, dtype=torch.int64)[:, None] * (ncols + 1) \
        + torch.clamp(tc.long(), max=ncols)
    vals, counts = torch.unique_consecutive(torch.sort(key.ravel()).values,
                                            return_counts=True)
    real = (vals % (ncols + 1)) < ncols
    return int(counts[real].max()) if bool(real.any()) else 0


def csr_library(torch, x, b, want, cuda_ms):
    """The time of ``torch.sparse.mm`` on the CSR form of ``x`` (cuSPARSE
    SpMM) times ``b`` in true f32, after its product is held to the
    kernel's (``want``) within 1e-7 + 1e-4 |A||B|."""
    from sparse_matrix_with_flops_tpu_torch.config import true_f32

    nnz = int(x.row_ptr[-1])
    a = torch.sparse_csr_tensor(x.row_ptr, x.col_ind[:nnz], x.values[:nnz],
                                size=(x.rows, x.ncols))
    absa = torch.sparse_csr_tensor(x.row_ptr, x.col_ind[:nnz], x.values[:nnz].abs(),
                                   size=(x.rows, x.ncols))
    with true_f32():
        got = torch.sparse.mm(a, b)
        bound = 1e-7 + 1e-4 * torch.sparse.mm(absa, b.abs())
    torch.cuda.synchronize()
    if not bool(((got - want).abs() <= bound).all()):
        raise AssertionError("torch.sparse.mm on the CSR form disagrees with K5")

    def call():
        with true_f32():
            return torch.sparse.mm(a, b)

    return cuda_ms(torch, call)


def rmcl_phases(torch, np, sp, dev, card, drive, record, burst, cuda_ms, host_ms):
    """Phases 8 (single-chip R-MCL) and 9 (sharded R-MCL, K6-K8); returns
    the R-MCL input (the COO graph) for phase 10."""
    import importlib

    from sparse_matrix_with_flops_tpu_torch.formats import COO
    from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl_init
    from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh
    from sparse_matrix_with_flops_tpu_torch.parallel import ring_kernels as RK
    from sparse_matrix_with_flops_tpu_torch.parallel.ring_kernels import (
        ring_all_gather,
        ring_all_gather_plain,
        ring_matmul,
        ring_matmul_plain,
        ring_matmul_tiled,
        ring_matmul_tiled_plain,
    )
    from sparse_matrix_with_flops_tpu_torch.parallel.rmcl_ell import (
        fused_hub_operands,
        plan_sharded_rmcl_ell,
        sharded_rmcl_ell,
    )
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    # the module, not the function of the same name that models/ exports
    RM = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl_ell")
    S, MT = 128, 8192
    # ---- 8. single-chip static-ELL R-MCL --------------------------------
    g = rmat_csr(14, edge_factor=8, seed=7)  # unit weights, tools/bench_rmcl.py
    grp, gci, gv = g.to_numpy()
    n = g.rows
    coo = COO.from_numpy(
        np.repeat(np.arange(n), np.diff(grp)), gci, gv, n, n,
        capacity=gci.size + n, device=dev,
    )
    mgt = rmcl_init(coo).make_ordered()
    plan = RM.plan_rmcl_ell(mgt, S=S, max_tile=MT)
    log(
        f"R-MCL s14: rows {n} nnz {int(mgt.nnz)}; plan bins "
        f"{[(d, int(r.size)) for d, r, _ in plan.bins]} hub rows "
        f"{plan.huge_rows.size} hub_kh {plan.hub_kh}"
    )
    t0 = time.perf_counter()
    out5, hist5 = drive(
        "rmcl_ell s14 S=128 5 iterations",
        lambda: RM.rmcl_ell(coo, max_iters=5, S=S, max_tile=MT),
        ("sort_dedup_compact",),
    )
    log(f"rmcl_ell s14: 5 iterations with plan {time.perf_counter() - t0:.3f} s; "
        f"nnz {hist5['nnz'].tolist()} truncated {hist5['truncated_rows'].tolist()} "
        f"differs {hist5['differs'].tolist()}")
    cols0, vals0 = RM.mt_to_ell(mgt, S)
    a_d = RM._dense_huge(mgt, plan)
    # K1's tiles in one step: widths and the longest run of one column
    seen = []
    k1 = RM.sort_dedup_compact

    def k1_spy(tc, tv, ncols, presorted=1):
        seen.append((tc.shape[1], tc.shape[0], longest_run(torch, tc, ncols)))
        return k1(tc, tv, ncols, presorted)

    RM.sort_dedup_compact = k1_spy
    try:
        RM.rmcl_ell_step(plan, mgt, a_d, cols0, vals0)
        torch.cuda.synchronize()
    finally:
        RM.sort_dedup_compact = k1
    log(f"R-MCL s14 step 1: K1 tiles (W, R, longest run) {seen}; longest run "
        f"{max((r for _, _, r in seen), default=0)} lanes")
    failed = []
    # the same run one step at a time, keeping every iterate
    its = [(cols0, vals0)]
    for _ in range(5):
        c, v, _ = RM.rmcl_ell_step(plan, mgt, a_d, *its[-1])
        its.append((c, v))
    torch.cuda.synchronize()
    host = [(c.cpu().numpy().astype(np.int64), v.cpu().numpy().astype(np.float64))
            for c, v in its]
    if not all(np.isfinite(v).all() for _, v in host):
        raise AssertionError("rmcl_ell: non-finite values")
    oc, ov, near = oracle_step(np, sp, mgt, host[0][0], host[0][1], S)
    failed += compare_iterates(
        np, "rmcl_ell step 1 vs scipy f64 oracle", *host[1], oc, ov, near)
    gc_, gv_ = padded_rows(np, out5, n, S)
    same = np.array_equal(gc_, host[5][0]) and np.array_equal(gv_, host[5][1])
    log(f"rmcl_ell s14: the stepped iterate 5 {'equals' if same else 'differs from'} "
        f"the driven run's bit for bit")
    if not same:
        failed.append("rmcl_ell: stepping differs from the driven run")
    # every step again on the CPU (every kernel's twin), from the card's
    # own iterate, so that a tie chosen apart does not carry over; a row
    # may differ only at a prune boundary of the f64 oracle's same step
    mgt_h, a_h = mgt.to("cpu"), a_d.cpu()
    for i in range(5):
        hc, hv, _ = RM.rmcl_ell_step(plan, mgt_h, a_h, its[i][0].cpu(), its[i][1].cpu())
        near_i = near if i == 0 else oracle_step(np, sp, mgt, *host[i], S)[2]
        failed += compare_iterates(
            np, f"rmcl_ell step {i + 1}: card vs CPU twins from the card's iterate {i}",
            *host[i + 1], hc.numpy().astype(np.int64), hv.numpy().astype(np.float64),
            near_i)
    _, _, chist = RM.rmcl_ell_scan(plan, mgt_h, a_h, cols0.cpu(), vals0.cpu(), 5)
    nnz_card, nnz_cpu = hist5["nnz"].astype(np.int64), chist["nnz"].numpy().astype(np.int64)
    log(f"rmcl_ell s14 nnz history: card {nnz_card.tolist()} cpu {nnz_cpu.tolist()}")
    if (np.abs(nnz_card - nnz_cpu) > MAX_FLIP_SHARE * nnz_cpu).any():
        failed.append("rmcl_ell: the nnz history differs from the CPU run")
    step = lambda: RM.rmcl_ell_step(plan, mgt, a_d, *its[1])  # noqa: E731
    it_ms = cuda_ms(torch, step, reps=5)
    it_host = host_ms(torch, step, 5)
    log(f"rmcl_ell s14 warm iteration 2: {it_ms:.3f} ms device (CUDA events), "
        f"{it_host:.3f} ms host clock [{card}]")
    if failed:
        raise AssertionError("phase 8: " + "; ".join(failed))
    del its, host
    torch.cuda.synchronize()

    # ---- 9. sharded R-MCL, D = 4 shards on the card ---------------------
    mesh = make_mesh(4)  # the card, by default
    if mesh.device != dev:
        raise AssertionError(f"make_mesh(4) is on {mesh.device}, not {dev}")
    must = {
        "all_gather": ("sort_dedup_compact",),
        "pallas_ring": ("ring_all_gather", "sort_dedup_compact"),
        "ring": ("sort_dedup_compact",),
        "fused_ring": ("ring_matmul_tiled", "sort_dedup_compact"),
    }
    runs = {}
    for ex, kernels in must.items():
        t0 = time.perf_counter()
        runs[ex] = drive(
            f"sharded_rmcl_ell s14 D=4 {ex} 3 iterations",
            lambda ex=ex: sharded_rmcl_ell(coo, mesh, max_iters=3, S=S, max_tile=MT,
                                           exchange=ex),
            kernels,
        )
        h = runs[ex][1]
        log(f"sharded {ex}: {time.perf_counter() - t0:.3f} s with plan; nnz "
            f"{h['nnz'].tolist()} differs {h['differs'].tolist()}")
    (ag, hag), (pr, hpr) = runs["all_gather"], runs["pallas_ring"]
    same = (torch.equal(ag.row_ptr, pr.row_ptr) and torch.equal(ag.col_ind, pr.col_ind)
            and torch.equal(ag.values, pr.values)
            and all(np.array_equal(hag[k], hpr[k]) for k in hag))
    log(f"sharded pallas_ring {'==' if same else '!='} all_gather bit for bit "
        f"(iterate and stats)")
    if not same:
        failed.append("pallas_ring differs from all_gather")

    def rows_of(x):
        return padded_rows(np, x.make_ordered()._drop_explicit_zeros(), n, S)

    failed += compare_iterates(
        np, "sharded fused_ring vs ring (3 iterations)",
        *rows_of(runs["fused_ring"][0]), *rows_of(runs["ring"][0]), tol=1e-6)
    s3, h3 = RM.rmcl_ell(coo, max_iters=3, S=S, max_tile=MT)
    failed += compare_iterates(
        np, "sharded all_gather vs single-chip rmcl_ell (3 iterations)",
        *rows_of(ag), *rows_of(s3), tol=1e-5)
    log(f"differs: sharded all_gather {hag['differs'].tolist()}, single-chip "
        f"{h3['differs'].tolist()}")
    if not np.allclose(hag["differs"], h3["differs"], rtol=1e-3, atol=1e-5):
        failed.append("sharded all_gather: differs history off the single-chip run")
    if failed:
        raise AssertionError("phase 9: " + "; ".join(failed))
    del runs, ag, pr, s3
    torch.cuda.synchronize()

    # the warm D = 4 iteration 2 of each exchange, from the iterate of step 1
    PS = importlib.import_module("sparse_matrix_with_flops_tpu_torch.parallel.rmcl_ell")
    plan4, arrays4, smgt4 = plan_sharded_rmcl_ell(mgt, 4, S=S, max_tile=MT)
    lc1, lv1, _ = PS._sharded_step(
        plan4, smgt4, arrays4,
        torch.where(cols0 >= n, plan4.n, cols0).reshape(4, plan4.lr, S),
        vals0.reshape(4, plan4.lr, S), "fused_ring")
    for ex in must:
        ms = cuda_ms(torch, lambda ex=ex: PS._sharded_step(plan4, smgt4, arrays4, lc1, lv1, ex),
                     reps=5, warm=1)
        log(f"sharded_rmcl_ell s14 D=4 {ex} warm iteration 2: {ms:.3f} ms device "
            f"(CUDA events) [{card}]")
    del plan4, arrays4, smgt4, lc1, lv1
    torch.cuda.synchronize()

    # K6 on this run's [lr, 128] iterate blocks, cols and vals in one call
    # as the pallas_ring exchange makes it (the main path's D = 4 last)
    for d in (2, 8, 4):
        xc = cols0.reshape(d, n // d, S)
        xv = vals0.reshape(d, n // d, S)
        want = (ring_all_gather_plain(xc), ring_all_gather_plain(xv))

        def same(got, d=d, want=want):
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"K6 D={d}: differs from the twin")

        same(ring_all_gather(xc, xv))
        burst(f"K6 D={d}", lambda: ring_all_gather(xc, xv), same)
        idx = RK._owners(d, RK.RIGHT, dev)  # the rotation, as one index gather
        record(
            "ring_all_gather", f"D={d} [{n // d}, {S}] int32 + f32 in one call", 0.0,
            cuda_ms(torch, lambda: ring_all_gather(xc, xv)),
            cuda_ms(torch, lambda: (ring_all_gather_plain(xc), ring_all_gather_plain(xv))),
            bound((d + 1) * (xc.numel() + xv.numel()) * 4),
            cuda_ms(torch, lambda: (xc[idx], xv[idx])),
            dev_ms=device_ms(torch, lambda: ring_all_gather(xc, xv)),
        )
        del want
    # K7 / K8 on this run's hub operands
    for d in (2, 4):
        sp_, arrays, _ = plan_sharded_rmcl_ell(mgt, d, S=S, max_tile=MT)
        lc = torch.where(cols0 >= n, sp_.n, cols0).reshape(d, sp_.lr, S)
        lv = vals0.reshape(d, sp_.lr, S)
        a_cols, md_loc, nt = fused_hub_operands(sp_, arrays, lc, lv)
        full = md_loc.reshape(-1, md_loc.shape[2]).abs()
        tol = 1e-7 + 1e-4 * torch.stack([a_cols[r].abs() @ full for r in range(d)])
        gf = 2.0 * d * a_cols.shape[1] * a_cols.shape[2] * md_loc.shape[2] / 1e9
        kb = bound(4.0 * (a_cols.numel() + md_loc.numel()
                          + d * a_cols.shape[1] * md_loc.shape[2]), gf * 1e9)
        full_b = md_loc.reshape(-1, md_loc.shape[2])
        lib_ms = cuda_ms(torch, lambda: torch.matmul(a_cols, full_b))  # TF32 off
        log(f"torch.matmul D={d}: {lib_ms:.4f} ms, {gf / lib_ms:.2f} TFLOP/s; bound "
            f"{kb[0]:.4f} ms ({kb[1]}) [{card}]")
        for name, fk, fp in (
            ("ring_matmul", lambda: ring_matmul(a_cols, md_loc),
             lambda: ring_matmul_plain(a_cols, md_loc)),
            ("ring_matmul_tiled", lambda: ring_matmul_tiled(a_cols, md_loc, nt),
             lambda: ring_matmul_tiled_plain(a_cols, md_loc, nt)),
        ):
            k, p = fk(), fp()
            torch.cuda.synchronize()
            err = (k - p).abs()

            def close(got, name=name, d=d, p=p):
                e = (got - p).abs()
                if not bool(torch.isfinite(got).all()) or not bool((e <= tol).all()):
                    raise AssertionError(f"{name} D={d}: differs from the twin "
                                         f"(max err {float(e.max()):.3e})")

            close(k)
            burst(f"{name} D={d}", fk, close)
            ms, pms = cuda_ms(torch, fk), cuda_ms(torch, fp)
            log(f"{name} D={d}: a {tuple(a_cols.shape)} b {tuple(md_loc.shape)} nt {nt}: "
                f"{gf:.1f} GFLOP, kernel {gf / ms:.2f} TFLOP/s ({kb[0] / ms:.1%} of the "
                f"bound), twin {gf / pms:.2f} TFLOP/s [{card}]")
            record(name, f"D={d} M={a_cols.shape[1]} lr={md_loc.shape[1]} "
                   f"N={md_loc.shape[2]} nt={nt if 'tiled' in name else md_loc.shape[2]}",
                   float(err.max()), ms, pms, kb, lib_ms, dev_ms=device_ms(torch, fk, 5))
            del k, p
        if d == 4:  # B7 is on no path of the reference: a direct call
            drive("ring_matmul on the D=4 hub operands",
                  lambda: ring_matmul(a_cols, md_loc), ("ring_matmul",), path=False)
        del a_cols, md_loc, full, full_b
        torch.cuda.synchronize()
    return coo, out5


def general_oracle_step(np, sp, a64, prev):
    """One general R-MCL step on the host in f64, no S cut: P = Mgt ·
    Mt (scipy), then per row inflate, threshold (util.cc:4-9), keep and
    renormalise.  ``prev`` is a scipy CSR; returns (the next iterate as
    a scipy CSR, the rows with a value within FLIP_REL of their
    threshold)."""
    p = (a64 @ prev).tocsr()
    p.sort_indices()
    n = p.shape[0]
    cnt = np.diff(p.indptr)
    if (cnt == 0).any():
        raise AssertionError("oracle: an empty row of Mgt · Mt")
    row = np.repeat(np.arange(n), cnt)
    w = p.data * p.data
    rsum = np.add.reduceat(w, p.indptr[:-1])
    rmax = np.maximum.reduceat(w, p.indptr[:-1])
    avg = rsum / cnt
    t = np.minimum(np.maximum(0.9 * avg * (1.0 - 2.0 * (rmax - avg)), 1e-7), rmax)
    keep = w >= t[row]
    near = np.zeros(n, bool)
    np.logical_or.at(near, row, np.abs(w - t[row]) <= FLIP_REL * t[row])
    ksum = np.bincount(row[keep], weights=w[keep], minlength=n)
    out = sp.csr_matrix(
        (w[keep] / ksum[row[keep]], p.indices[keep], np.concatenate(
            [[0], np.cumsum(np.bincount(row[keep], minlength=n))])),
        shape=p.shape,
    )
    return out, near


def compare_csr(np, what, got, want, near):
    """Two iterates as scipy CSRs.  Rows whose kept columns differ must
    be prune flips at the oracle's boundary rows (``near``), at most
    MAX_FLIP_SHARE of the rows; the other rows' values within 1e-3
    relative + 1e-7.  Returns the list of failures (empty if none)."""
    n = got.shape[0]

    def keys(m):
        return np.repeat(np.arange(n, dtype=np.int64), np.diff(m.indptr)) * n + m.indices

    kg, kw = keys(got), keys(want)
    flips = np.unique(np.setxor1d(kg, kw) // n)
    same_g = ~np.isin(kg // n, flips)
    same_w = ~np.isin(kw // n, flips)
    vg, vw = got.data[same_g].astype(np.float64), want.data[same_w]
    err = np.abs(vg - vw)
    bound = 1e-3 * np.maximum(np.abs(vg), np.abs(vw)) + 1e-7
    log(f"{what}: nnz {kg.size} vs {kw.size}; {flips.size} of {n} rows differ in "
        f"their kept columns; max |err| on the equal rows {err.max(initial=0.0):.3e}; "
        f"{int(near.sum())} rows at a prune boundary")
    failed = []
    if (~near[flips]).any():
        failed.append(f"{what}: rows differ away from any prune boundary: "
                      f"{flips[~near[flips]][:10].tolist()}")
    if flips.size > MAX_FLIP_SHARE * n:
        failed.append(f"{what}: {flips.size} flipped rows > {MAX_FLIP_SHARE:.1%}")
    if not (err <= bound).all():
        failed.append(f"{what}: values differ on equal rows ({int((err > bound).sum())} entries)")
    for f in failed:
        log(f"FAIL {f}")
    return failed


def general_rmcl_phase(torch, np, sp, dev, card, drive, coo, static5, cuda_ms, host_ms):
    """Phase 11: the general R-MCL application from a graph file, on the
    card: ``load_coo`` of a SNAP file against the in-memory COO,
    ``rmcl`` scan and loop at margin 2.5 (scan with no host read, each
    step against the f64 oracle), the reference's overflow at margin
    1.5, ``nrmcl`` on both routes, clusters and a resumed checkpoint."""
    import contextlib
    import importlib
    import io
    import tempfile

    from sparse_matrix_with_flops_tpu_torch.cli import nrmcl
    from sparse_matrix_with_flops_tpu_torch.io import load_coo
    from sparse_matrix_with_flops_tpu_torch.io.native import get_lib
    from sparse_matrix_with_flops_tpu_torch.models import checkpoint as CK
    from sparse_matrix_with_flops_tpu_torch.models import clusters as CL
    from sparse_matrix_with_flops_tpu_torch.models.rmcl_ell import rmcl_ell
    from sparse_matrix_with_flops_tpu_torch.ops.segments import run_sums, segment_sum
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import esc_expand, esc_sort

    # the modules, not the functions of the same names that models/ exports
    R = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl")
    RE = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl_ell")
    iters, margin = 5, 2.5
    failed = []
    tmp = tempfile.TemporaryDirectory()
    snap = os.path.join(tmp.name, "rmat_s14.snap")
    nnz = int(coo.nnz)
    r, c, v = (x[:nnz].cpu().numpy() for x in (coo.row, coo.col, coo.val))
    with open(snap, "w") as f:  # "from to value", read transposed back to (row, col)
        f.write(f"# R-MAT s14, edge factor 8, seed 7\n{coo.nrows} {nnz}\n")
        f.write("\n".join(f"{b} {a} {x:.9g}" for a, b, x in zip(r, c, v)) + "\n")
    if get_lib() is None:
        raise AssertionError("the native loader did not build")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = load_coo(snap, extra_capacity=coo.nrows)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    same = (loaded.device == dev and (loaded.nrows, loaded.ncols) == (coo.nrows, coo.ncols)
            and all(torch.equal(getattr(loaded, k), getattr(coo, k))
                    for k in ("row", "col", "val", "nnz")))
    log(f"load_coo {snap.rsplit('/', 1)[-1]} ({nnz} edges, native loader) on "
        f"{loaded.device}: {load_ms:.1f} ms; {'==' if same else '!='} the in-memory COO [{card}]")
    if not same:
        raise AssertionError("phase 11: the SNAP file read back differs from the COO")

    mt0 = R.rmcl_init(loaded)
    mgt = mt0.deep_copy()
    pc, cc = R.plan_capacities(mgt, mt0, margin)
    mtc = mt0.with_capacity(cc)
    log(f"general R-MCL s14: rows {mt0.rows} nnz {int(mt0.nnz)}; margin {margin}: "
        f"product_cap = c_cap = {pc}")
    R.rmcl_scan(mgt, mtc, pc, cc, 1)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # where a step's device time goes (step 1, at the scan's capacities)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        R.rmcl_one_step(mgt, mtc, pc, cc)
        torch.cuda.synchronize()
    ka = sorted(prof.key_averages(), key=lambda k: -k.self_device_time_total)
    busy = sum(k.self_device_time_total for k in ka) / 1e3
    log(f"rmcl_one_step s14 step 1 at margin {margin} under torch.profiler: device "
        f"{busy:.3f} ms in {sum(k.count for k in ka)} kernels; largest: " + "; ".join(
            f"{k.key[:60]} x{k.count} {k.self_device_time_total / 1e3:.3f} ms" for k in ka[:6]))
    # what the fixed summation order costs: run_sums against index_add_'s
    # float atomics on the same step's sorted products
    prow, pcol, pval, fl = esc_expand(mgt, mtc, pc)
    prow, pcol, pval, valid, flags, seg, nnzc = esc_sort(prow, pcol, pval, mgt.rows)
    nseg = int(nnzc)
    seg = torch.where(valid, seg, nseg).long()
    off = torch.searchsorted(seg, torch.arange(nseg + 1, device=dev))
    want = run_sums(pval, off)
    if not torch.equal(run_sums(pval, off), want):
        raise AssertionError("phase 11: run_sums gave other bits on a second call")
    rs_ms = cuda_ms(torch, lambda: run_sums(pval, off))
    ia_ms = cuda_ms(torch, lambda: segment_sum(pval, seg, nseg))
    log(f"run sums of step 1's {int(fl)} products in {nseg} runs: run_sums (fixed order) "
        f"{rs_ms:.3f} ms, index_add_ (float atomics) {ia_ms:.3f} ms [{card}]")
    del prow, pcol, pval, valid, flags, seg, off, want, prof, ka
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")  # any device-to-host read raises
    try:
        s.record()
        scan_mt, hist = R.rmcl_scan(mgt, mtc, pc, cc, iters)
        e.record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    e.synchronize()
    scan_ms = s.elapsed_time(e) / iters
    hist = {k: x.cpu().numpy() for k, x in hist.items()}
    log(f"rmcl_scan s14 margin {margin}: no device-to-host read in {iters} steps "
        f"(sync debug mode \"error\"); {scan_ms:.3f} ms/iteration (CUDA events); nnz "
        f"{hist['nnz'].tolist()} flops {hist['flops'].tolist()} overflow "
        f"{hist['overflow'].tolist()}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    scan = R.rmcl(mt0, max_iters=iters, mode="scan", margin=margin)
    same_scan = nrmcl.same_iterates(scan_mt, scan.mt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = R.rmcl(mt0, max_iters=iters, mode="loop", margin=margin)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / iters
    same = nrmcl.same_iterates(loop.mt, scan.mt)
    bits = all(np.array_equal(x, y) for x, y in zip(loop.mt.to_numpy(), scan.mt.to_numpy()))
    log(f"rmcl s14 margin {margin}: loop {loop_ms:.3f} ms/iteration (host clock); scan "
        f"{'Same' if same else 'Diffs'} as loop by nrmcl's comparison, bit-equal {bits}; "
        f"overflow scan {scan.overflow} loop {loop.overflow}; nnz scan "
        f"{scan.nnz_history.tolist()} loop {loop.nnz_history.tolist()} [{card}]")
    if not (same and same_scan):
        failed.append("scan differs from loop")
    if scan.overflow or loop.overflow or hist["overflow"].any():
        failed.append(f"overflow at margin {margin}")

    # each step against the f64 oracle, from the oracle's previous iterate
    rp, ci, vv = mgt.to_numpy()
    a64 = sp.csr_matrix((vv.astype(np.float64), ci, rp), shape=mgt.shape)
    prev = sp.csr_matrix((vv.astype(np.float32), ci, rp), shape=mgt.shape)
    plan = []
    oracle_nnz, oracle_nnzc = [], []
    for i in range(iters):
        want, near = general_oracle_step(np, sp, a64, prev.astype(np.float64))
        oracle_nnz.append(want.nnz)
        oracle_nnzc.append(int(a64.dot(prev.astype(np.float64)).nnz))
        prev_t = R.CSR.from_numpy(prev.indptr, prev.indices, prev.data, prev.shape[1], dev,
                                  capacity=cc)
        plan.append(host_ms(torch, lambda p=prev_t: R.plan_capacities(mgt, p, 1.0), 5))
        got, info = R.rmcl_one_step(mgt, prev_t, pc, cc)
        grp, gci, gv = got.to_numpy()
        if bool(info["overflow_products"] | info["overflow_c"] | info["overflow_mt"]):
            failed.append(f"step {i + 1}: overflow")
        if not np.isfinite(gv).all():
            failed.append(f"step {i + 1}: non-finite values")
        failed += compare_csr(
            np, f"rmcl_one_step {i + 1} vs f64 oracle (from the oracle's iterate {i})",
            sp.csr_matrix((gv, gci, grp), shape=mgt.shape), want, near)
        prev = want.astype(np.float32)
    oracle_nnz = np.asarray(oracle_nnz)
    log(f"general R-MCL s14: f64 oracle nnz(C) {oracle_nnzc}, nnz(Mt) {oracle_nnz.tolist()}; "
        f"the loop's host "
        f"planning {statistics.median(plan):.3f} ms a step (median of "
        f"{[round(x, 3) for x in plan]}) [{card}]")
    if (np.abs(scan.nnz_history - oracle_nnz) > MAX_FLIP_SHARE * oracle_nnz).any():
        failed.append("scan: the nnz history is off the f64 oracle's")
    if failed:
        raise AssertionError("phase 11: " + "; ".join(failed))

    # the reference's own overflow at its default margin (ROADMAP C8)
    dflt = R.rmcl(mt0, max_iters=iters, mode="scan")
    log(f"rmcl s14 scan at the default margin 1.5: overflow {dflt.overflow}; flops "
        f"{dflt.flops_history.tolist()}")
    if not dflt.overflow:
        raise AssertionError("phase 11: no overflow at margin 1.5, where the reference has one")
    del scan_mt, mtc, dflt, got
    torch.cuda.synchronize()

    # the command line, both routes, on the SNAP file and on tdata.snap
    captured = []

    def spy(*a, **k):
        captured.append(rmcl_ell(*a, **k))
        return captured[-1]

    def cli(label, argv, must=()):
        buf = io.StringIO()

        def run():
            with contextlib.redirect_stdout(buf):
                return nrmcl.main(argv)

        t0 = time.perf_counter()
        rc = drive(label, run, must)
        ms = (time.perf_counter() - t0) * 1e3
        out = buf.getvalue().splitlines()
        verdict = next((x for x in out if x in ("Same", "Diffs")), None)
        log(f"{label}: {verdict}, exit {rc}, {ms:.1f} ms; " + "; ".join(
            x for x in out if x.startswith(("seq-loop", "final"))) + f" [{card}]")
        return verdict, rc, out

    verdict, rc, out = cli("nrmcl -i s14.snap -m 5", ["-i", snap, "-m", "5"])
    if (verdict, rc) != ("Diffs", 1) or not any("overflow = True" in x for x in out):
        raise AssertionError("phase 11: nrmcl's default route on s14 should report the "
                             "reference's overflow and Diffs")
    RE.rmcl_ell = spy
    try:
        cli("nrmcl -i s14.snap -m 5 -r STATIC", ["-i", snap, "-m", "5", "-r", "STATIC"],
            ("sort_dedup_compact",))
    finally:
        RE.rmcl_ell = rmcl_ell
    got = captured[0][0]
    same = all(np.array_equal(x, y) for x, y in zip(got.to_numpy(), static5.to_numpy()))
    log(f"nrmcl STATIC's iterate {'==' if same else '!='} phase 8's rmcl_ell(coo, 5) "
        f"bit for bit")
    if not same:
        raise AssertionError("phase 11: the STATIC route differs from rmcl_ell")
    verdict, rc, _ = cli("nrmcl -i tests/tdatas/tdata.snap -m 5",
                         ["-i", os.path.join(ROOT, "tests", "tdatas", "tdata.snap"), "-m", "5"])
    if (verdict, rc) != ("Same", 0):
        raise AssertionError("phase 11: nrmcl on tdata.snap is not Same")

    # clusters of the final iterate, and a checkpoint resumed
    labels = CL.extract_clusters(scan.mt)
    sizes = list(CL.cluster_sizes(labels).values())
    log(f"extract_clusters s14: {len(sizes)} clusters, largest {sizes[:8]}")
    ck, ck2 = os.path.join(tmp.name, "ck.npz"), os.path.join(tmp.name, "straight.npz")
    CK.rmcl_resumable(mt0, max_iters=2, checkpoint_path=ck)
    resumed, it, _ = CK.rmcl_resumable(mt0, max_iters=iters, checkpoint_path=ck)
    straight, _, _ = CK.rmcl_resumable(mt0, max_iters=iters, checkpoint_path=ck2)
    same = it == iters and all(
        np.array_equal(x, y) for x, y in zip(resumed.to_numpy(), straight.to_numpy()))
    log(f"rmcl_resumable: stopped at 2, resumed to {it}: {'==' if same else '!='} the "
        f"straight run bit for bit")
    if not same:
        raise AssertionError("phase 11: the resumed run differs from the straight run")
    tmp.cleanup()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; refusing to run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside the script", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    import scipy.sparse as sp

    from sparse_matrix_with_flops_tpu_torch import _build
    from sparse_matrix_with_flops_tpu_torch.config import ABS_TOL, REL_TOL
    from sparse_matrix_with_flops_tpu_torch.formats import BCSR, CSR, ELL, MCSR, PCSR
    from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
    from sparse_matrix_with_flops_tpu_torch.ops.block_spgemm import (
        block_spgemm,
        plan_block,
    )
    from sparse_matrix_with_flops_tpu_torch.ops.dispatch import route, spgemm_auto
    from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
    from sparse_matrix_with_flops_tpu_torch.ops.scan_kernels import (
        cumsum_i32,
        cumsum_i32_plain,
    )
    from sparse_matrix_with_flops_tpu_torch.ops.segments import exclusive_cumsum
    from sparse_matrix_with_flops_tpu_torch.ops.sort_kernels import (
        _window_starts,
        compact_nonzero_rows,
        compact_nonzero_rows_plain,
        sort_dedup_compact,
        sort_dedup_compact_plain,
        window_gather,
        window_gather_plain,
    )
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_upper_bounds
    from sparse_matrix_with_flops_tpu_torch.ops.spmm import (
        bcsr_spmm,
        bcsr_spmm_plain,
        csr_spmm_dense,
        csr_spmv,
    )
    from sparse_matrix_with_flops_tpu_torch.utils.generate import (
        banded_csr,
        rmat_csr,
    )
    from sparse_matrix_with_flops_tpu_torch.parallel.ring_kernels import (
        ring_all_gather,
        ring_all_gather_plain,
        ring_matmul,
        ring_matmul_plain,
        ring_matmul_tiled,
        ring_matmul_tiled_plain,
    )

    wrappers = {
        "sort_dedup_compact": sort_dedup_compact,
        "compact_nonzero_rows": compact_nonzero_rows,
        "window_gather": window_gather,
        "cumsum_i32": cumsum_i32,
        "bcsr_spmm": bcsr_spmm,
        "ring_all_gather": ring_all_gather,
        "ring_matmul": ring_matmul,
        "ring_matmul_tiled": ring_matmul_tiled,
    }
    ell_kernels = ("sort_dedup_compact", "compact_nonzero_rows", "window_gather", "cumsum_i32")

    # ---- 1. card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(smi[0])
    log(
        f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}"
    )
    dev = torch.device("cuda", 0)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {_build.BUILD_DIR}")
    for line in _build.build_log().splitlines():
        if "Used" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. kernels vs twins on the s14 plan's inputs ------------------
    a = rmat_csr(14, edge_factor=8, seed=7, weights="random")  # the default device
    if not (a.device == dev and a.col_ind.device == dev and a.values.device == dev):
        raise AssertionError(f"rmat_csr with no device is on {a.device}, not {dev}")
    log(f"s14 built with the default device: {a.device}")
    flops, _ = spgemm_upper_bounds(a, a)
    t0 = time.perf_counter()
    plan = plan_ell(a, a)
    log(
        f"s14: rows {a.rows} nnz {int(a.nnz)} flops {flops} plan "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms chunk {plan.chunk} "
        f"bins {[(w, int((r >= 0).sum())) for w, r, _, _ in plan.bins]} "
        f"hub groups {[g.rows.size for g in plan.hub_groups]} "
        f"split {plan.vstart is not None} out_cap {plan.out_cap}"
    )
    pt = E._plan_tensors(plan, dev)
    prod_c, prod_v = E._b_ell_chunks(a, plan, pt)
    results = {}

    def record(name, case, err, ms, plain_ms, kbound, library, library_call=None,
               dev_ms=None):
        """One case of a kernel: ``kbound`` (ms, what bounds it);
        ``library`` the time of the one PyTorch call that computes the
        same function (``library_call`` names it), or the reason there is
        none; ``dev_ms`` the kernel's device time alone, where measured."""
        lib_ms = library if isinstance(library, float) else None
        log(
            f"{name} [{case}]: max_abs_err {err:.3e} kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms bound {kbound[0]:.4f} ms ({kbound[1]}, "
            f"{kbound[0] / ms:.1%}) library "
            + (f"{lib_ms:.4f} ms" if lib_ms is not None else f"none: {library}")
            + ("" if dev_ms is None else
               f"; device {dev_ms:.4f} ms ({kbound[0] / dev_ms:.1%} of the bound)")
        )
        r = results.setdefault(name, {"max_abs_err": 0.0, "cases": {}})
        case_rec = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": kbound[0], "bound_by": kbound[1], "library_ms": lib_ms,
        }
        if dev_ms is not None:
            case_rec["device_ms"] = dev_ms
        if lib_ms is None:
            case_rec["library_none"] = library
        if library_call is not None:
            case_rec["library_call"] = library_call
        r.pop("library_none", None)
        r.pop("library_call", None)
        r.pop("device_ms", None)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.update({k: v for k, v in case_rec.items() if k != "max_abs_err"})  # the last case
        r["cases"][case] = case_rec

    def check_vals(got, want, what):
        err = (got - want).abs()
        bound = torch.clamp(REL_TOL * torch.maximum(got.abs(), want.abs()), min=ABS_TOL)
        if not bool((err <= bound).all()):
            raise AssertionError(f"{what}: values differ (max err {err.max():.3e})")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: non-finite values")
        return float(err.max()) if err.numel() else 0.0

    def burst(what, fn, check, calls=20):
        """``calls`` calls of ``fn`` with no synchronize between them, each
        result held to ``check`` after one synchronize: a flag or status
        word that a launch left behind would corrupt a later one."""
        outs = [fn() for _ in range(calls)]
        torch.cuda.synchronize()
        for out in outs:
            check(out)
        log(f"{what}: {calls} back-to-back calls pass the check")

    widths = [w for w, _, _, _ in pt["bins"]]
    for w_sel in (64, 8192):
        _, _, tile_src, tile_ent = pt["bins"][widths.index(w_sel)]
        tc, tv = E._bin_tiles(a, prod_c, prod_v, tile_src, tile_ent, w_sel, plan.chunk)
        kk, kv = sort_dedup_compact(tc, tv, plan.ncols, presorted=plan.chunk)
        pk, pv = sort_dedup_compact_plain(tc, tv, plan.ncols)
        torch.cuda.synchronize()
        log(f"K1 W={w_sel} R={tc.shape[0]}: longest run of one column "
            f"{longest_run(torch, tc, plan.ncols)} lanes")

        def k1_same(got, w_sel=w_sel, pk=pk, pv=pv, kv=kv):
            if not torch.equal(got[0], pk):
                raise AssertionError(f"K1 W={w_sel}: cols differ from the twin")
            if not torch.equal(got[1], kv):  # the sums' order is fixed
                raise AssertionError(f"K1 W={w_sel}: differs from the first call")
            return check_vals(got[1], pv, f"K1 W={w_sel}")

        err = k1_same((kk, kv))
        burst(f"K1 W={w_sel}", lambda: sort_dedup_compact(tc, tv, plan.ncols, plan.chunk),
              k1_same)
        record(
            "sort_dedup_compact", f"W={w_sel} R={tc.shape[0]} presorted={plan.chunk}", err,
            cuda_ms(torch, lambda: sort_dedup_compact(tc, tv, plan.ncols, plan.chunk)),
            cuda_ms(torch, lambda: sort_dedup_compact_plain(tc, tv, plan.ncols)),
            bound(16.0 * tc.numel()), NO_CALL["sort_dedup_compact"],
            dev_ms=device_ms(torch, lambda: sort_dedup_compact(tc, tv, plan.ncols, plan.chunk)),
        )
    if not plan.hub_groups:
        raise AssertionError("the s14 plan has no hub group: K2 has no input")
    g, _, _, _, vw, part = next(E._hub_products(a, a, plan, pt))
    kk, kv = compact_nonzero_rows(part, vw)
    pk, pv = compact_nonzero_rows_plain(part, vw)
    torch.cuda.synchronize()

    def k2_same(got):
        if not torch.equal(got[0], pk) or not torch.equal(got[1], pv):
            raise AssertionError("K2: output differs from the twin")

    k2_same((kk, kv))
    burst("K2", lambda: compact_nonzero_rows(part, vw), k2_same)
    record(
        "compact_nonzero_rows", f"R={part.shape[0]} N={part.shape[1]} ncols={vw}", 0.0,
        cuda_ms(torch, lambda: compact_nonzero_rows(part, vw)),
        cuda_ms(torch, lambda: compact_nonzero_rows_plain(part, vw)),
        bound(12.0 * part.numel()), NO_CALL["compact_nonzero_rows"],
        dev_ms=device_ms(torch, lambda: compact_nonzero_rows(part, vw)),
    )
    flat_c, flat_v, counts, flat_base = E._tiles_impl(a, a, plan)
    ocap = -(-E._nnz_bucket(int(counts.sum())) // 128) * 128
    starts = exclusive_cumsum(counts)[:-1]
    fc, fvb = E._window_source(flat_c, flat_v, plan.ncols)
    p0 = E._window_positions(counts, flat_base, starts, ocap // 128)
    # the assembly's second list: one window at the head of each row
    heads = torch.where(counts > 0, flat_base, 0).to(torch.int32)
    nr = fc.shape[0] // 128
    for lists in ((p0, heads), (p0,)):  # the main path's call, then the windows alone
        k3 = lambda lists=lists: window_gather(fc, fvb, lists[0], 128, *lists[1:])  # noqa: E731
        k3_plain = lambda lists=lists: window_gather_plain(  # noqa: E731
            fc, fvb, lists[0], 128, *lists[1:])
        want3 = k3_plain()

        def k3_same(got, want3=want3, n=len(lists)):
            if len(got) != 2 * n or not all(torch.equal(a, b) for a, b in zip(got, want3)):
                raise AssertionError(f"K3 ({n} list(s)): output differs from the twin")

        k3_same(k3())
        burst(f"K3 {len(lists)} list(s)", k3, k3_same)
        # the source lanes the windows cover (each read once), not the
        # whole source
        st = torch.sort(torch.cat([_window_starts(p, nr, 128) for p in lists])).values
        covered = int(torch.clamp(st[1:] - st[:-1], max=128).sum()) + 128 * (st.numel() > 0)
        nq = sum(p.shape[0] for p in lists)
        if len(lists) == 1:
            # yardstick: one index of an unfolded view a stream, the clipped
            # starts built beforehand (the clip is left out of its time)
            s0 = _window_starts(p0, nr, 128)
            lib = lambda: (fc.unfold(0, 128, 1)[s0], fvb.unfold(0, 128, 1)[s0])  # noqa: E731
            k3_same(lib())
            library = cuda_ms(torch, lib)
            call = ("fc.unfold(0, 128, 1)[starts] and the same of the value bits: one index "
                    "kernel a stream; the clipped starts are built beforehand, untimed")
            case = f"Q={nq} W=128 src={fc.shape[0]} covered={covered}"
        else:
            library, call = ("none: the windows and the row heads in one call; the "
                             "windows alone have the yardstick"), None
            case = (f"two lists in one launch: Q={p0.shape[0]} windows + {heads.shape[0]} row "
                    f"heads, W=128 src={fc.shape[0]} covered={covered}")
        record(
            "window_gather", case, 0.0, cuda_ms(torch, k3), cuda_ms(torch, k3_plain),
            bound(4.0 * nq + 8.0 * covered + 8.0 * nq * 128), library, call,
            dev_ms=device_ms(torch, k3),
        )
        del want3
    # K4: first 2^25 + 3 words off the 16-byte grid (4097 tiles, more than
    # the card holds resident CTAs; int32 sums that wrap), then phase 3's
    # own input, whose numbers stand for the kernel
    big = torch.randint(-(2**30), 2**30, (2**25 + 4,), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(3)).to(dev)[1:]
    dds = E._row_start_deltas(counts, starts, ocap)
    for label, xs in (("2^25+3 words off the 16-byte grid", big), (f"n={ocap}", dds)):
        want = cumsum_i32_plain(xs)

        def k4_same(got, label=label, want=want):
            if not torch.equal(got, want):
                raise AssertionError(f"K4 {label}: output differs from the twin")

        k4_same(cumsum_i32(xs))
        burst(f"K4 {label}", lambda: cumsum_i32(xs), k4_same)
        record(
            "cumsum_i32", label, 0.0,
            cuda_ms(torch, lambda: cumsum_i32(xs)),
            cuda_ms(torch, lambda: cumsum_i32_plain(xs)),
            bound(8.0 * xs.numel()),
            cuda_ms(torch, lambda: torch.cumsum(xs, 0, dtype=torch.int32)),
            dev_ms=device_ms(torch, lambda: cumsum_i32(xs)),
        )
        del want
    del big
    del prod_c, prod_v, flat_c, flat_v, fc, fvb, part
    torch.cuda.synchronize()

    # ---- 4. main path ----------------------------------------------------
    def scipy_check(x: CSR, c: CSR, what: str, positive: bool) -> None:
        """Structure exactly equal to scipy's pattern product; values
        within REL_TOL of scipy's f64 product, relative to the sum of
        absolute products (|A||A|), which bounds the f32 rounding of
        entries that cancel.  For positive matrices that sum is the
        value itself, and the port's is_relative_equal must hold too."""
        rp, ci, v = x.to_numpy()
        n = x.ncols
        amat = sp.csr_matrix((v.astype(np.float64), ci, rp), shape=x.shape)
        pat = sp.csr_matrix((np.ones(ci.size), ci, rp), shape=x.shape)
        ps = (pat @ pat).tocsr()
        ps.sort_indices()
        cm = (amat @ amat).tocsr()
        cm.sort_indices()
        am = (abs(amat) @ abs(amat)).tocsr()
        am.sort_indices()
        grp, gci, gv = c.to_numpy()
        if not np.array_equal(grp, ps.indptr) or not np.array_equal(gci, ps.indices):
            raise AssertionError(f"{what}: row_ptr/col_ind differ from scipy")
        if not np.array_equal(am.indptr, ps.indptr) or not np.array_equal(
            am.indices, ps.indices
        ):
            raise AssertionError(f"{what}: |A||A| lost structure")
        if not np.isfinite(gv).all():
            raise AssertionError(f"{what}: non-finite values")

        def keys(m):
            r = np.repeat(np.arange(m.shape[0], dtype=np.int64), np.diff(m.indptr))
            return r * n + m.indices

        pk = keys(ps)
        ref = np.zeros(pk.size)
        ref[np.searchsorted(pk, keys(cm))] = cm.data
        err = np.abs(gv - ref)
        over_rel = int((err > REL_TOL * np.maximum(np.abs(gv), np.abs(ref))).sum())
        ok = err <= REL_TOL * am.data + ABS_TOL
        log(
            f"{what}: nnz {gci.size} structure == scipy; max |err| "
            f"{err.max():.3e}, max |err|/|A||A| {(err / am.data).max():.3e}; "
            f"{over_rel} entries over REL_TOL of their own value"
        )
        if not ok.all():
            raise AssertionError(f"{what}: {int((~ok).sum())} values off scipy")
        if positive:
            want = CSR.from_numpy(ps.indptr, ps.indices, ref, n, device=c.device)
            if not c.is_relative_equal(want, REL_TOL):
                raise AssertionError(f"{what}: is_relative_equal fails")

    launches = {k: 0 for k in wrappers}
    launched_by = {k: [] for k in wrappers}

    def drive(label, fn, must, path=True):
        """One main-path run: every count set to 0 just before it, read
        just after; each kernel in ``must`` has to have launched.  Each
        launching run's label goes into the kernel's ``launched_by``;
        ``path=False`` marks a run that is a direct wrapper call on no
        path of the system (K7: the reference's B7 has no caller)."""
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        log(f"{label}: launches {counts}")
        for k in must:
            if counts[k] == 0:
                raise AssertionError(f"{label} launched {k} no time")
        for k, n in counts.items():
            launches[k] += n
            if n:
                launched_by[k].append(label if path else f"{label} (direct call, no path)")
        return out

    kind, fill = route(a, a)
    if kind != "ell":
        raise AssertionError(f"s14 routed {kind} (fill {fill})")
    c = drive(f"s14 (routed ell, fill {fill:.4f})", lambda: spgemm_auto(a, a), ell_kernels)
    scipy_check(a, c, "s14", positive=True)

    ca = banded_csr(62451, bandwidth=32, device=dev)
    kind, cfill = route(ca, ca)
    if kind != "block":
        raise AssertionError(f"cant-class band routed {kind} (fill {cfill})")
    cc = drive(
        f"band (routed block, fill {cfill:.4f})", lambda: spgemm_auto(ca, ca),
        ("window_gather", "cumsum_i32"),
    )
    scipy_check(ca, cc, "band", positive=False)
    del c, cc

    card = smi[0]
    plan = plan_ell(a, a)
    E.spgemm_ell(a, a, plan)  # caches the nnz(C) bucket
    s14_warm = host_ms(torch, lambda: E.spgemm_ell(a, a, plan), 10)
    s14_cold = host_ms(torch, lambda: spgemm_auto(a, a), 3)
    bplan = plan_block(ca, ca)
    block_spgemm(ca, ca, bplan)
    band_warm = host_ms(torch, lambda: block_spgemm(ca, ca, bplan), 10)
    band_cold = host_ms(torch, lambda: spgemm_auto(ca, ca), 3)
    cflops, _ = spgemm_upper_bounds(ca, ca)
    log(
        f"s14 ell: warm {s14_warm:.3f} ms ({2 * flops / s14_warm / 1e6:.3f} "
        f"GFLOPS), with plan {s14_cold:.3f} ms [{card}]"
    )
    log(
        f"band block: warm {band_warm:.3f} ms ({2 * cflops / band_warm / 1e6:.3f} "
        f"GFLOPS), with plan {band_cold:.3f} ms [{card}]"
    )
    torch.cuda.synchronize()

    # ---- 5. K1 at W = 32768 ----------------------------------------------
    plan32 = plan_ell(a, a, max_w=32768)
    w32 = [w for w, _, _, _ in plan32.bins]
    log(
        f"s14 max_w=32768: chunk {plan32.chunk} bins "
        f"{[(w, int((r >= 0).sum())) for w, r, _, _ in plan32.bins]} "
        f"hub groups {[g.rows.size for g in plan32.hub_groups]}"
    )
    if 32768 not in w32:
        raise AssertionError("the s14 max_w=32768 plan has no W=32768 bin")
    pt32 = E._plan_tensors(plan32, dev)
    prod_c, prod_v = E._b_ell_chunks(a, plan32, pt32)
    _, _, tile_src, tile_ent = pt32["bins"][w32.index(32768)]
    tc, tv = E._bin_tiles(a, prod_c, prod_v, tile_src, tile_ent, 32768, plan32.chunk)
    kk, kv = sort_dedup_compact(tc, tv, plan32.ncols, presorted=plan32.chunk)
    pk, pv = sort_dedup_compact_plain(tc, tv, plan32.ncols)
    torch.cuda.synchronize()
    log(f"K1 W=32768 R={tc.shape[0]}: longest run of one column "
        f"{longest_run(torch, tc, plan32.ncols)} lanes")

    def k1w_same(got):
        if not torch.equal(got[0], pk):
            raise AssertionError("K1 W=32768: cols differ from the twin")
        if not torch.equal(got[1], kv):  # the sums' order is fixed
            raise AssertionError("K1 W=32768: differs from the first call")
        return check_vals(got[1], pv, "K1 W=32768")

    err = k1w_same((kk, kv))
    burst("K1 W=32768", lambda: sort_dedup_compact(tc, tv, plan32.ncols, plan32.chunk),
          k1w_same)
    record(
        "sort_dedup_compact",
        f"W=32768 R={tc.shape[0]} presorted={plan32.chunk}",
        err,
        cuda_ms(torch, lambda: sort_dedup_compact(tc, tv, plan32.ncols, plan32.chunk)),
        cuda_ms(torch, lambda: sort_dedup_compact_plain(tc, tv, plan32.ncols)),
        bound(16.0 * tc.numel()), NO_CALL["sort_dedup_compact"],
        dev_ms=device_ms(torch, lambda: sort_dedup_compact(tc, tv, plan32.ncols, plan32.chunk)),
    )
    del prod_c, prod_v, tc, tv, kk, kv, pk, pv
    c32 = drive(
        "s14 spgemm_ell max_w=32768", lambda: E.spgemm_ell(a, a, plan32),
        ("sort_dedup_compact",),
    )
    scipy_check(a, c32, "s14 max_w=32768", positive=True)
    del c32

    # ---- 6. K5 bcsr_spmm -------------------------------------------------
    def host_matrix(x: CSR):
        rp, ci, v = x.to_numpy()
        return sp.csr_matrix((v.astype(np.float64), ci, rp), shape=x.shape)

    def dense_check(what, got, amat, bh):
        """Elementwise |got - want| <= 1e-7 + 1e-4 (|A||B|) against
        scipy's f64 product: a bound on f32 rounding in any order."""
        want = amat @ bh
        bound = 1e-7 + 1e-4 * (abs(amat) @ np.abs(bh))
        g = got.cpu().numpy().astype(np.float64)
        if g.shape != want.shape:
            raise AssertionError(f"{what}: shape {g.shape} != {want.shape}")
        if not np.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite values")
        err = np.abs(g - want)
        log(
            f"{what}: shape {g.shape}; max |err| {err.max():.3e}, "
            f"max |err| / bound {(err / bound).max():.3e}"
        )
        if not (err <= bound).all():
            raise AssertionError(f"{what}: {int((err > bound).sum())} values off scipy")
        return float(err.max())

    for label, x, n in (("band", ca, 512), ("s14", a, 128)):
        t0 = time.perf_counter()
        ab = BCSR.from_csr(x, 8, 128)
        nb = int(ab.nblocks)
        counts = np.diff(ab.block_row_ptr.cpu().numpy())
        log(
            f"K5 {label}: BCSR(8, 128) in {(time.perf_counter() - t0) * 1e3:.1f} ms; "
            f"{nb} blocks, per block row max {counts.max()} mean {counts.mean():.2f}, "
            f"fill {float(ab.nonzero_density()):.4f}"
        )
        bh = np.random.default_rng(0).random((x.rows, n)).astype(np.float32)
        bd = torch.from_numpy(bh).to(dev)
        got = drive(f"K5 {label} bcsr_spmm", lambda: bcsr_spmm(ab, bd), ("bcsr_spmm",))
        twin = bcsr_spmm_plain(ab, bd)
        torch.cuda.synchronize()
        err = float((got - twin).abs().max())
        amat = host_matrix(x)
        b64 = bh.astype(np.float64)
        dense_check(f"K5 {label} kernel vs scipy", got, amat, b64)
        dense_check(f"K5 {label} twin vs scipy", twin, amat, b64)
        lib = csr_library(torch, x, bd, got, cuda_ms)

        def k5_same(out, label=label, got=got):  # no atomics: bit for bit
            if not torch.equal(out, got):
                raise AssertionError(f"K5 {label}: differs from the checked call")

        burst(f"K5 {label}", lambda: bcsr_spmm(ab, bd), k5_same)
        del got, twin
        ms = cuda_ms(torch, lambda: bcsr_spmm(ab, bd))
        plain_ms = cuda_ms(torch, lambda: bcsr_spmm_plain(ab, bd))
        gf = 2.0 * nb * ab.br * ab.bc * n / 1e9
        log(
            f"K5 {label}: dense-block {gf:.3f} GFLOP; kernel {gf / ms * 1e3:.1f} "
            f"GFLOP/s, twin {gf / plain_ms * 1e3:.1f} GFLOP/s [{card}]"
        )
        # the stored blocks and their indices, B and C, each once
        kb = bound(4.0 * (nb * ab.br * ab.bc + nb + ab.nbrows + 1 + 2 * x.rows * n), gf * 1e9)
        record("bcsr_spmm", f"{label} N={n} blocks={nb}", err, ms, plain_ms, kb, lib,
               "torch.sparse.mm on the CSR form of the same matrix (cuSPARSE SpMM, true f32)",
               dev_ms=device_ms(torch, lambda: bcsr_spmm(ab, bd)))
        del ab, bd
        torch.cuda.synchronize()

    # ---- 7. format zoo on the card (plain torch, correctness only) -----
    band_mat = host_matrix(ca)
    b64h = np.random.default_rng(1).random((ca.rows, 64)).astype(np.float32)
    b64d = torch.from_numpy(b64h).to(dev)
    zoo = {
        "ELL.spmm band N=64": lambda: ELL.from_csr(ca).spmm(b64d),
        "MCSR(4096, 4096).spmm band N=64": lambda: MCSR.from_csr(ca, 4096, 4096).spmm(b64d),
        "csr_spmm_dense band N=64": lambda: csr_spmm_dense(ca, b64d),
    }
    for what, fn in zoo.items():
        out = fn()
        torch.cuda.synchronize()
        if out.device != dev:
            raise AssertionError(f"{what}: result on {out.device}")
        dense_check(what, out, band_mat, b64h.astype(np.float64))
        del out
    xh = np.random.default_rng(2).random(a.rows).astype(np.float32)
    y = csr_spmv(a, torch.from_numpy(xh).to(dev))
    torch.cuda.synchronize()
    s14_mat = host_matrix(a)
    dense_check("csr_spmv s14", y, s14_mat, xh.astype(np.float64))
    c = spgemm_auto(a, a)
    pc = PCSR.from_csr(a, 4).striped_spgemm(a)
    torch.cuda.synchronize()
    crp, cci, _ = c.to_numpy()
    crow = np.repeat(np.arange(a.rows), np.diff(crp))
    full = (s14_mat @ s14_mat).tocsr()
    full.sort_indices()
    for b, st in enumerate(pc.stripes):
        lo = b * pc.stride
        hi = lo + st.ncols
        rp, ci, v = st.to_numpy()
        sel = (cci >= lo) & (cci < hi)
        want_rp = np.zeros(a.rows + 1, np.int64)
        np.cumsum(np.bincount(crow[sel], minlength=a.rows), out=want_rp[1:])
        if not np.array_equal(rp, want_rp) or not np.array_equal(ci, cci[sel] - lo):
            raise AssertionError(f"PCSR stripe {b}: structure differs from spgemm_auto's")
        ref = full[:, lo:hi].tocsr()
        ref.sort_indices()
        if not np.array_equal(ci, ref.indices):
            raise AssertionError(f"PCSR stripe {b}: structure differs from scipy")
        tol = 1e-7 + REL_TOL * ref.data  # positive weights: |A||A| = A A
        err = np.abs(v - ref.data)
        if not (err <= tol).all():
            raise AssertionError(f"PCSR stripe {b}: values off scipy")
        log(f"PCSR stripe {b} [{lo}, {hi}): nnz {ci.size} == spgemm_auto's; max |err| {err.max():.3e}")
    del c, pc, y, b64d
    torch.cuda.synchronize()

    coo, static5 = rmcl_phases(torch, np, sp, dev, card, drive, record, burst, cuda_ms, host_ms)

    # ---- 10. a caller that turned TF32 on (ROADMAP C7) -------------------
    from sparse_matrix_with_flops_tpu_torch.config import _f32_switches, true_f32
    from sparse_matrix_with_flops_tpu_torch.models.rmcl_ell import rmcl_ell

    ab14 = BCSR.from_csr(a, 8, 128)
    bh14 = np.random.default_rng(0).random((a.rows, 128)).astype(np.float32)
    b14 = torch.from_numpy(bh14).to(dev)
    pinned = {
        "rmcl_ell s14 S=128 5 iterations":
            lambda: rmcl_ell(coo, max_iters=5, S=128, max_tile=8192)[0],
        "bcsr_spmm s14 N=128": lambda: bcsr_spmm(ab14, b14),
    }
    found = {k: f() for k, f in pinned.items()}  # the switches as the script found them
    caller = _f32_switches()
    g = torch.Generator().manual_seed(5)
    xm = torch.rand((1024, 1024), generator=g).to(dev)
    with true_f32():
        exact = torch.matmul(xm, xm)
    with true_f32():  # gives the switches back on leaving
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        bare = float((torch.matmul(xm, xm) - exact).abs().max())
        c = spgemm_auto(a, a)
        cc = spgemm_auto(ca, ca)
        on = {k: f() for k, f in pinned.items()}
        torch.cuda.synchronize()
        tf32_still_on = (torch.backends.cuda.matmul.allow_tf32
                         and torch.get_float32_matmul_precision() == "high")
    log(f"TF32 on: a bare torch.matmul [1024, 1024] differs from true f32 by {bare:.3e}")
    if bare == 0.0:
        raise AssertionError("TF32 on changed no bare matmul: the phase would prove nothing")
    if not tf32_still_on:
        raise AssertionError("the port turned the caller's TF32 off")
    if _f32_switches() != caller:
        raise AssertionError(f"the caller's switches came back as {_f32_switches()}, "
                             f"not {caller}")
    scipy_check(a, c, "TF32 on: s14 spgemm_auto (ell)", positive=True)
    scipy_check(ca, cc, "TF32 on: band spgemm_auto (block)", positive=False)
    dense_check("TF32 on: bcsr_spmm s14", on["bcsr_spmm s14 N=128"], host_matrix(a),
                bh14.astype(np.float64))
    for k in pinned:
        x, y = found[k], on[k]
        same = (torch.equal(x, y) if isinstance(x, torch.Tensor) else
                torch.equal(x.row_ptr, y.row_ptr) and torch.equal(x.col_ind, y.col_ind)
                and torch.equal(x.values, y.values))
        log(f"TF32 on: {k} {'==' if same else '!='} the call with the found switches, "
            f"bit for bit")
        if not same:
            raise AssertionError(f"TF32 on: {k} differs")
    del c, cc, on, found, ab14, b14, xm, exact
    torch.cuda.synchronize()

    # ---- 11. general R-MCL and nrmcl from a graph file -------------------
    general_rmcl_phase(torch, np, sp, dev, card, drive, coo, static5, cuda_ms, host_ms)
    del coo, static5
    torch.cuda.synchronize()

    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"no run launched {k}")
    kernels = [
        {
            "name": k,
            "route": "cuda",
            "source": SOURCES[k],
            "replaces": REPLACES[k],
            "launches": launches[k],
            "launched_by": launched_by[k],
            "max_abs_err": results[k]["max_abs_err"],
            "ms": results[k]["ms"],
            "device_ms": results[k]["device_ms"],
            "plain_ms": results[k]["plain_ms"],
            "bound_ms": results[k]["bound_ms"],
            "bound_by": results[k]["bound_by"],
            "library_ms": results[k]["library_ms"],
            **({key: results[k][key] for key in ("library_none", "library_call")
                if key in results[k]}),
            "cases": results[k]["cases"],
        }
        for k in wrappers
    ]
    log(json.dumps({"kernels": kernels}))
    log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": 1,  # the run used one card
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
