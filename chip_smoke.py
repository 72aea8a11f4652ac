#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py        # from the repository root, one card
    python3 chip_smoke.py --digests ROOT   # the stream paths' digests of checkout ROOT

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds the CUDA kernels from ``sparse_matrix_with_flops_tpu_torch/csrc``;
3. holds each kernel (K1-K4, K9) against its plain PyTorch twin on the card,
   on inputs cut from the R-MAT s14 plan, and times both; K4 also on
   2^25 + 3 words off the 16-byte grid (4097 tiles, more than the card
   holds resident CTAs); K3 both as the assembly calls it (its windows
   and its row heads in one launch) and on the windows alone, beside
   an index of an unfolded view a stream; K2 and K3 also on the device
   alone (torch.profiler); K9 (``run_sums``) on an offset probe (3,000 runs
   of 1-4096 values moved by 0-7 slots: K9 gives every move the same bits,
   torch.segment_reduce does not) and bit for bit against its plain
   version on the CPU; K10 (``hub_accumulate``) on Graph500 s16's first
   hub group (the benchmark's matrix) against its plain version on the
   card and, on a sample of items, bit for bit on the CPU, beside
   ``torch.sparse.mm`` of the group's rows (cuSPARSE SpGEMM), then the
   whole hub in one launch; K11 (``prune_select``) on the LFR cell's
   first-step tiles at W = 2,048 / 4,096 / 8,192 (one ``_TILE_BYTES``
   chunk of each bin) bit for bit against its plain version on the card,
   beside the two stable sorts it replaces;
4. runs ``spgemm_auto`` on R-MAT s14 (edge factor 8, seed 7, random
   weights; routes ``ell``, its hub on K10) and on the cant-class band
   ``banded_csr(62451, 32)`` (routes ``block``), checks both products
   against scipy on the host, checks that the kernels were launched by
   that run, and times the warm multiply and the multiply with its plan;
   a near-dense hub group takes the matmul route (K2);
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
   default device), 3 iterations, all four exchanges (each call plans
   afresh, so its scan captures a CUDA graph of its step only where 3
   reaches the step's break-even count, ``utils/graphs.captures``: each
   call logs whether it captured and the phase fails where that breaks
   the rule): ``pallas_ring``
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
   the loop's host planning and the file's load;
12. the flops-binned engine, the partitioned driver and the rest of the
   command line: ``classify_flops``, ``flops_stats`` and ``nnz_stats``
   of s14's A·A equal to a numpy recomputation; ``plan_bins`` and
   ``spgemm_binned`` on s14 against scipy, K1 launched once a non-empty
   bin, bit-equal over calls, no host read in a warm call, its eager
   body timed (CUDA events; phase 16 times its graph) with one call's
   device time by kernel; K1 at binned's
   W = 4096 and W = 16 tiles against its twin; ``spgemm_ell_partitioned``
   (4 groups) on the band and on s14 against scipy, with s14's peak
   device memory beside one ``spgemm_ell`` call's; ``perf`` (esc,
   binned, ell, ell-partitioned) and ``analysis --bins`` (its counts
   against scipy's) on phase 11's SNAP file, ``mat_dat_analysis`` on
   ``tdata.snap``, ``corpus --synthetic --scales 14 --cant --kernel auto
   --check --mt`` with and without ``--duel`` (s14 routed ``ell``, the
   band ``block``, both with ``nnzc_ok``), each through its ``main``;
13. the rest of the distributed layer, D = 4 shards stacked on the card
   (plain torch, no kernel of its own): ``sharded_spgemm`` and
   ``sharded_spgemm_ring`` on phase 4's s14 in the natural layout
   against scipy, each bit-equal over two calls made with no host read,
   timed (the ring's eager body; phase 16 times its graph), the ring's
   planner timed on the host; ``sharded_spgemm_2d`` at
   (2, 2), each block against the same block of scipy's product; the
   dynamic ``sharded_rmcl_scan`` on phase 8's graph relabelled by the
   flops-balanced permutation, 3 iterations at ``plan_shard_capacities``
   margin 4.0 of iteration 1's flops, with no host read, bit for bit
   against the single-card ``rmcl_scan``, its step's device time by
   kernel; ``sharded_rmcl_adaptive`` on the natural layout, 3
   iterations, its first snake permutation against numpy's, its result
   against the single-card loop by the R-MCL gate (values within 1e-5),
   a repartition timed alone; ``dryrun_multichip(4)``.  It logs its wall
   time and the peak device memory of the sharded SpGEMM and the scan;
14. R-MCL on planted partitions (``planted_partition_coo``, the users'
   test of the clustering): ``tools/cluster_quality.py``'s 64 x 64 nodes
   (p_in 0.3, p_out 0.0005, seed 1, 8 iterations, floor 0.2) through
   ``rmcl`` (K9) and ``rmcl_ell`` (K1), clusters, purity and the paths'
   label agreement; ``tools/bench_rmcl_scale.py``'s 1024 x 64 = 65,536
   nodes (p_out 8/n, seed 11, nnz(A) 1,825,520, S = 128): ``plan_rmcl_ell``
   ms, ms an iteration as the slope of CUDA-event medians at 2 and 6
   iterations (after the 30 below, which captured the step's graph),
   iteration 1 against the f64 oracle, 30 iterations to clusters at
   weight floor 0.05 with purity >= 0.95, and one stream step's
   run sums (K9) at that scale;
15. one rank a process (the process mesh, ranks started as processes of
   this script with ``--rank-child``, each group under a wall-clock limit,
   a failed rank failing the phase): (a) world size 1 under NCCL:
   ``sharded_spgemm`` and ``sharded_spgemm_ring`` on phase 4's s14 and
   ``sharded_rmcl_ell`` with each exchange on phase 8's graph, each bit
   for bit against the stacked D = 1 path, and no host read (sync debug
   mode "error") where the stacked path makes none; with phase 13's
   sizes, ``sharded_rmcl_scan`` (3 iterations, no host read),
   ``sharded_rmcl_adaptive`` (3 iterations), ``sharded_spgemm_2d`` on a
   (1, 1) process mesh and ``dryrun_multichip()``, each bit for bit
   against the stacked D = 1 path; (b) two processes on
   the one card under gloo, K6 / K8 launched one rank at a time on CUDA
   IPC peer pointers: ``sharded_rmcl_ell`` on phase 8's graph, 3
   iterations, each exchange, every rank's result bit for bit against the
   stacked D = 2 path (SHA-256 of the arrays and statistics), and the
   per-rank K6, K7 and K8 at phase 9's D = 2 shapes against their plain
   versions (the twins over the group's all-gather), timed and labelled
   as two processes time-sharing one card, not a cross-card figure; the
   dynamic scan, the adaptive loop (the same ``perm_total`` on every
   rank), the 2-D SpGEMM on (2, 1) and (1, 2) process meshes and the dry
   run, every rank's blocks bit for bit against the stacked D = 2 path's,
   each run's wall time and peak device memory logged a rank; (c) with
   more than one card, D = min(cards, 4) ranks under NCCL, one card a
   rank, the checks of (b), the (2, 2) 2-D mesh at D = 4, and weak
   scaling on the process group (on one card it logs that it did not
   run); then weak scaling stacked at D = 1, 2 and 4 (R-MAT s14 to s16,
   ``parallel/weak_scaling.py``).  In every group the process mesh's
   compiled programs (``child_graphs``): for each exchange, on one plan,
   the eager loop of the step, a scan call one short of the break-even
   count B (no capture), a call of B (a capture at its first iteration)
   and a call that replays every iteration, each bit-equal to the eager
   loop and to the stacked D path's digest; no host read (sync debug
   mode "error") in an eager step or a replaying call, under gloo as
   under NCCL; the warm ``sharded_spgemm_ring`` with its plan captured at
   call B and replayed, bit-equal to the first call and to the stacked
   path; each peer set's epoch counter read after every stage, every
   rank's readings equal (the counters on the card move in step across
   eager calls and replays); per-rank eager, replay and capture ms, pool
   and reserved bytes under the group's label.  K6 serves every
   exchange there (the statistics' sums, and the exchange itself on the
   peer route).  The ranks' launches add to the counts
   of the ``kernels`` line, and their per-rank cases to its ``cases``
   (the kernel's own numbers stay those of its stacked case).
16. the compiled programs (``utils/graphs.py``): the warm ``spgemm_ell``,
   ``rmcl_ell_scan``, the stacked ``sharded_rmcl_ell_scan``, the warm
   ``sharded_spgemm_ring`` (stacked, plan passed) and ``spgemm_binned``
   run as CUDA graphs kept on their plans, through their normal entry
   points (so phases 4, 14 and any caller past a program's break-even
   count run them too).  A program captures at the call where the eager
   runs already spent on its plan and key, plus the runs the call still
   makes, reach its break-even count B (``graphs.BREAK_EVEN``); each
   program here is driven on a fresh plan until it captures, and must
   capture at call ceil(B / its iterations a call), each call bit-equal
   to the eager run: the warm ``spgemm_ell`` on s14,
   ``rmcl_ell_scan`` on phase 8's graph (5 iterations a call),
   ``sharded_rmcl_ell_scan`` at D = 4 on phase 8's graph with each
   exchange (5 iterations; a second call on the same plan with another
   iterate equals its own eager loop), ``sharded_spgemm_ring`` at D = 4
   on phase 13's s14 with plan and caps passed, ``spgemm_binned`` on
   phase 12's s14 (a fresh plan) and ``rmcl_ell_scan`` on phase 14(b)'s planted
   graph (30 iterations, its clusters and purity); each scan bit-equal
   to the eager loop of its step, iterate and histories; the SpGEMMs
   replayed on A's values doubled must give exactly twice C; eager and
   graph ms, capture ms, pool bytes, peak memory and replays x launches
   a replay (K9 in the ring's and the binned graphs), in one ``phase
   16`` JSON line.  A replay adds its captured launches to the counts.
   The general ``rmcl_scan`` stays an eager loop: its step is bound by
   the device, and a graph of it was measured as no gain
   (``ring_probe.py capture``).

Phases 11-13 also hold ``ops/segments.last_marked`` (the segment
expansion behind ``repeat_segments``: unique-target scatters and K4
scans) bit for bit against ``repeat_segments_plain`` (the max-scatter
and ``torch.cummax``) on every caller's full-size input of their paths,
fail if ``torch.cummax`` is called or its scan kernel runs on those
paths, and hold the general scan, binned s14 and the dynamic sharded
scan to the SHA-256 digests that the tree before ``last_marked`` and
the dump regions gave (``DIGESTS_BEFORE``; ``python3 chip_smoke.py
--digests ROOT`` prints the digests of the port in checkout ROOT).

K9's records hold it bit for bit against its plain version on the CPU
on every run_sums call of a path (captured in one call: general R-MCL
step 1 in phase 11, binned s14's huge rows in phase 12, the sharded
step in phase 13, the planted step in phase 14), and time those calls
together against torch.segment_reduce, CUB's segmented reduce, which
is also K9's plain version on a card tensor.  Phase 12 also times
``plan_ell`` on s14 cold in fresh processes with and without
``prefault(1 << 28)`` first.

K1's tiles log their longest run of one column (what a run sum costs):
at s14 (phases 3 and 5) and in one R-MCL step (phase 8).  Its cases in
the ``kernels`` line include binned's tiles (phase 12).

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
    "run_sums": "sparse_matrix_with_flops_tpu/ops/segments.py:106",
    "hub_accumulate": "sparse_matrix_with_flops_tpu/ops/ell_esc.py:1382",
    "prune_select": "sparse_matrix_with_flops_tpu/models/rmcl_ell.py:182",
}
# K9, K10 and K11 are the port's own kernels: the lines they name are no
# pl.pallas_call
REPLACES_NOTE = {
    "run_sums": "no TPU kernel: the JAX package sums its runs with XLA's jax.ops.segment_sum "
                "(plain XLA); K9 fixes the card's summation order to a run's own, left to right",
    "hub_accumulate": "no TPU kernel: the JAX package's hub densifies A and B per column slab "
                      "and multiplies them with XLA's f32 jnp.dot, then compacts (B2); K10 sums "
                      "a sparse hub group's products alone, in A-entry order",
    "prune_select": "no TPU kernel: the JAX package selects each tile row's top S with XLA's "
                    "lax.sort, by value and again by column; K11 prunes, radix-selects and "
                    "renormalises a row in shared memory, with no sort",
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
    "run_sums": f"{PKG}/csrc/run_sums.cu",
    "hub_accumulate": f"{PKG}/csrc/hub_accumulate.cu",
    "prune_select": f"{PKG}/csrc/prune_select.cu",
}
PREFAULT_PROBE = """
import json, sys, time
from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
from sparse_matrix_with_flops_tpu_torch.utils import nphost
from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

a = rmat_csr(14, edge_factor=8, seed=7, weights="random", device="cpu")
t0 = time.perf_counter()
if sys.argv[1] == "1":
    nphost.prefault(1 << 28)
t1 = time.perf_counter()
plan_ell(a, a)
t2 = time.perf_counter()
plan_ell(a, a)
t3 = time.perf_counter()
print(json.dumps({"prefault_ms": (t1 - t0) * 1e3, "cold_ms": (t2 - t1) * 1e3,
                  "warm_ms": (t3 - t2) * 1e3, "heap": nphost._HEAP}))
"""


# the three stream paths' results (``stream_digests``) as the tree before
# last_marked and the dump regions computed them on an H100 (``chip_smoke.py
# --digests ROOT`` on that checkout); phases 11-13 hold theirs to them
DIGESTS_BEFORE = {
    "general rmcl_scan": "5870064abf6f13b3de18873d64b6768a8e63a03b8703b34ac724e09b1569d1a5",
    "spgemm_binned": "a45bd188ede46f850aa18706c0136c1a572f66233c8cfa7460d933c161bf0140",
    "sharded_rmcl_scan": "7af3a47c56dee0653cb701df3b9f867ed32c587b727268f54db6a8c1d158a478",
}
# the scan kernel of torch.cummax on the card (values with indices)
CUMMAX_KERNEL = "_with_indices"
# modules whose repeat_segments calls phases 11-13 capture
REPEAT_CALLERS = ("ops.spgemm", "parallel.spgemm", "parallel.rmcl")

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


PROFILE_TRIES = 3  # torch.profiler sessions before a device time counts as not recorded


def profile_kernels(torch, fn, calls: int = 1) -> list:
    """``key_averages()`` of ``calls`` calls of ``fn`` under torch.profiler
    (CUDA activity), sorted by device time, largest first. A session now
    and then hands back no device event at all (CUPTI's records lost, the
    kernels ran): such a session is taken again, up to PROFILE_TRIES in
    all; an empty list means none recorded one."""
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ka = [k for k in prof.key_averages() if k.self_device_time_total > 0]
        if ka:
            return sorted(ka, key=lambda k: -k.self_device_time_total)
    return []


def device_ms(torch, fn, calls: int = 20) -> float:
    """Device time of ``fn``'s kernels a call, in ms, from torch.profiler
    (no host enqueue in it). Where no profiler session recorded a device
    event, the median CUDA-event time of one call instead (enqueue gaps
    included), and the log says so."""
    fn()
    ka = profile_kernels(torch, fn, calls)
    if ka:
        return sum(k.self_device_time_total for k in ka) / calls / 1e3
    ms = cuda_ms(torch, fn)
    log(f"  torch.profiler recorded no device event in {PROFILE_TRIES} sessions: "
        f"device time by CUDA events instead, {ms:.4f} ms")
    return ms


def breakdown(ka, top: int) -> str:
    """One call's device time by kernel, from ``profile_kernels``."""
    if not ka:
        return (f"device time not measured (torch.profiler recorded no device event "
                f"in {PROFILE_TRIES} sessions)")
    return (f"device {sum(k.self_device_time_total for k in ka) / 1e3:.3f} ms in "
            f"{sum(k.count for k in ka)} kernels; largest: " + "; ".join(
                f"{k.key[:60]} x{k.count} {k.self_device_time_total / 1e3:.3f} ms"
                for k in ka[:top]))


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
    "prune_select": "none: a row's threshold, its top S by value with ties to the lower "
                    "column, in column order and renormalised, take several torch calls",
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
    failed = []
    t0 = time.perf_counter()
    (out5, hist5), made = captures_in(lambda: drive(
        "rmcl_ell s14 S=128 5 iterations",
        lambda: RM.rmcl_ell(coo, max_iters=5, S=S, max_tile=MT),
        ("sort_dedup_compact", "prune_select"),
    ))
    check_policy("rmcl_ell s14 5 iterations", "rmcl_ell_scan", 5, made, failed)
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
        "all_gather": ("sort_dedup_compact", "prune_select"),
        "pallas_ring": ("ring_all_gather", "sort_dedup_compact", "prune_select"),
        "ring": ("sort_dedup_compact", "prune_select"),
        "fused_ring": ("ring_matmul_tiled", "sort_dedup_compact", "prune_select"),
    }
    runs = {}
    for ex, kernels in must.items():
        t0 = time.perf_counter()
        runs[ex], made = captures_in(lambda ex=ex, kernels=kernels: drive(
            f"sharded_rmcl_ell s14 D=4 {ex} 3 iterations",
            lambda: sharded_rmcl_ell(coo, mesh, max_iters=3, S=S, max_tile=MT, exchange=ex),
            kernels,
        ))
        h = runs[ex][1]
        log(f"sharded {ex}: {time.perf_counter() - t0:.3f} s with plan; nnz "
            f"{h['nnz'].tolist()} differs {h['differs'].tolist()}")
        check_policy(f"sharded_rmcl_ell s14 D=4 {ex}", "sharded_rmcl_ell_scan", 3, made,
                     failed)
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
        step = lambda ex=ex: PS._sharded_step(plan4, smgt4, arrays4, lc1, lv1, ex)  # noqa: E731
        ms = cuda_ms(torch, step, reps=5, warm=1)
        log(f"sharded_rmcl_ell s14 D=4 {ex} warm iteration 2: {ms:.3f} ms (CUDA events, eager), "
            f"{device_ms(torch, step, 3):.3f} ms of device time (torch.profiler) [{card}]")
    ka = profile_kernels(torch, lambda: PS._sharded_step(plan4, smgt4, arrays4, lc1, lv1, "ring"))
    log("sharded_rmcl_ell s14 D=4 ring iteration 2 under torch.profiler: " + breakdown(ka, 6))
    del plan4, arrays4, smgt4, lc1, lv1, ka
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


def compare_csr(np, what, got, want, near, tol=None):
    """Two iterates as scipy CSRs.  Rows whose kept columns differ must
    be prune flips at the oracle's boundary rows (``near``), at most
    MAX_FLIP_SHARE of the rows; the other rows' values within 1e-3
    relative + 1e-7, or within ``tol`` absolute where it is given.
    Returns the list of failures (empty if none)."""
    n = got.shape[0]

    def keys(m):
        return np.repeat(np.arange(n, dtype=np.int64), np.diff(m.indptr)) * n + m.indices

    kg, kw = keys(got), keys(want)
    flips = np.unique(np.setxor1d(kg, kw) // n)
    same_g = ~np.isin(kg // n, flips)
    same_w = ~np.isin(kw // n, flips)
    vg, vw = got.data[same_g].astype(np.float64), want.data[same_w]
    err = np.abs(vg - vw)
    bound = 1e-3 * np.maximum(np.abs(vg), np.abs(vw)) + 1e-7 if tol is None else tol
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


def general_rmcl_phase(torch, np, sp, dev, card, drive, record, coo, static5, cuda_ms,
                       host_ms):
    """Phase 11: the general R-MCL application from a graph file, on the
    card: ``load_coo`` of a SNAP file against the in-memory COO,
    ``rmcl`` scan and loop at margin 2.5 (scan with no host read, each
    step against the f64 oracle), the reference's overflow at margin
    1.5, ``nrmcl`` on both routes, clusters and a resumed checkpoint.
    Returns the temporary directory and the SNAP file in it, which
    phase 12 reads."""
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
    from sparse_matrix_with_flops_tpu_torch.ops.segments import (
        blocked_run_sums,
        run_sums,
        run_sums_plain,
        segment_sum,
    )
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import esc_compress, esc_expand, esc_sort

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
    ka = profile_kernels(torch, lambda: R.rmcl_one_step(mgt, mtc, pc, cc))
    log(f"rmcl_one_step s14 step 1 at margin {margin} under torch.profiler: "
        + breakdown(ka, 6))
    no_cummax_kernel("phase 11", ka, failed)
    _, calls = capture_run_sums(lambda: R.rmcl_one_step(mgt, mtc, pc, cc))
    k9_cases(torch, f"general R-MCL s14 step 1 (margin {margin})", calls, record, cuda_ms,
             device_ms)
    del calls
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
    del prow, pcol, pval, valid, flags, seg, off, want, ka
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
    check_digest("general rmcl_scan", rmcl_digest(np, scan_mt, hist), failed)
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
        if i == 0:
            prev1 = prev
    oracle_nnz = np.asarray(oracle_nnz)
    log(f"general R-MCL s14: f64 oracle nnz(C) {oracle_nnzc}, nnz(Mt) {oracle_nnz.tolist()}; "
        f"the loop's host "
        f"planning {statistics.median(plan):.3f} ms a step (median of "
        f"{[round(x, 3) for x in plan]}) [{card}]")
    if (np.abs(scan.nnz_history - oracle_nnz) > MAX_FLIP_SHARE * oracle_nnz).any():
        failed.append("scan: the nnz history is off the f64 oracle's")

    # the prune's row sums of step 2 (from the oracle's iterate 1), each
    # against its f64 sum: strictly sequential (run_sums) and in 32-value
    # blocks (blocked_run_sums, what the prune adds)
    p1 = R.CSR.from_numpy(prev1.indptr, prev1.indices, prev1.data, prev1.shape[1], dev,
                          capacity=cc)
    prow, pcol, pval, fl = esc_expand(mgt, p1, pc)
    prow, pcol, pval, _, flags, seg, nnzc = esc_sort(prow, pcol, pval, mgt.rows)
    crow, _, cval = esc_compress(prow, pcol, pval, flags, seg, nnzc, fl, mgt.rows, mgt.ncols, cc)
    w = cval * cval
    roff = torch.searchsorted(crow, torch.arange(mgt.rows + 1, dtype=crow.dtype, device=dev))
    exact = run_sums_plain(w.double().cpu(), roff.cpu()).numpy()
    lens = np.diff(roff.cpu().numpy())
    for what, f in (("sequential", run_sums), ("32-value blocks", blocked_run_sums)):
        rel = np.abs(f(w, roff).double().cpu().numpy() - exact) / np.maximum(exact, 1e-300)
        r = int(rel.argmax())
        log(f"step 2 prune row sums, {what}: max relative error {rel.max():.3e} at row {r} "
            f"({lens[r]} entries); mean {rel.mean():.3e} [{card}]")
    del prow, pcol, pval, flags, seg, crow, cval, w, p1
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
    return tmp, snap


def log2_hist_np(np, x, buckets: int = 13):
    """The stats.cc log2 histogram on the host: the ceiling of an f32
    log2 of max(x, 1), clipped to the last bucket."""
    k = np.ceil(np.log2(np.maximum(np.asarray(x).astype(np.float32), np.float32(1.0))))
    return np.bincount(np.clip(k.astype(np.int64), 0, buckets - 1), minlength=buckets)


def binned_phase(torch, np, sp, dev, card, a, ca, snap, drive, record, burst, check_vals,
                 scipy_check):
    """Phase 12: the flops statistics against a numpy recomputation, the
    binned engine on R-MAT s14 (K1 once a non-empty bin, bit-stable, no
    host read, timed, its device time by kernel), K1 at the binned
    widths against its twin, the partitioned driver on the band and on
    s14 (peak memory against one ``spgemm_ell``), and the command-line
    programs perf, analysis, mat_dat_analysis and corpus in process."""
    import contextlib
    import io

    from sparse_matrix_with_flops_tpu_torch.cli import analysis, corpus, mat_dat_analysis, perf
    from sparse_matrix_with_flops_tpu_torch.config import FLOPS_BIN_BOUNDS
    from sparse_matrix_with_flops_tpu_torch.ops import binned as BN
    from sparse_matrix_with_flops_tpu_torch.ops.ell_esc import spgemm_ell
    from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
    from sparse_matrix_with_flops_tpu_torch.ops.flops import (
        classify_flops,
        flops_stats,
        nnz_stats,
        row_flops,
    )
    from sparse_matrix_with_flops_tpu_torch.ops.partitioned import spgemm_ell_partitioned
    from sparse_matrix_with_flops_tpu_torch.ops.segments import exclusive_cumsum
    from sparse_matrix_with_flops_tpu_torch.ops.sort_kernels import (
        sort_dedup_compact,
        sort_dedup_compact_plain,
    )
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import esc_expand

    t_phase = time.perf_counter()
    # ---- 12a. flops statistics of A·A against numpy ----------------------
    rp, ci, _ = a.to_numpy()
    n = a.rows
    elen = np.diff(rp).astype(np.int64)[ci]
    cs = np.concatenate([[0], np.cumsum(elen)])
    rf = cs[rp[1:]] - cs[rp[:-1]]
    order = np.argsort(rf, kind="stable")
    sorted_f = rf[order]
    starts = np.searchsorted(sorted_f, (0,) + FLOPS_BIN_BOUNDS, side="right")
    want = {
        "sorted_rows": order,
        "sorted_flops": sorted_f,
        "flops_offsets": np.concatenate([[0], np.cumsum(sorted_f)]),
        "bin_starts": np.concatenate([[0], starts[:-1], [n]]),
    }
    fb = classify_flops(a, a)
    hist, trf = flops_stats(a, a)
    pat = sp.csr_matrix((np.ones(ci.size), ci, rp), shape=a.shape)
    ps = (pat @ pat).tocsr()
    got = {k: getattr(fb, k).cpu().numpy() for k in want}
    got["flops hist"], want["flops hist"] = hist.cpu().numpy(), log2_hist_np(np, rf)
    got["row flops"], want["row flops"] = trf.cpu().numpy(), rf
    bad = [k for k in want if not np.array_equal(got[k].astype(np.int64), want[k])]
    log(f"classify_flops s14: bin starts {got['bin_starts'].tolist()}; flops histogram "
        f"{got['flops hist'].tolist()}")
    if bad:
        raise AssertionError(f"phase 12: {bad} differ from the numpy recomputation")

    # ---- 12b. the binned engine on s14 -----------------------------------
    t0 = time.perf_counter()
    plan = BN.plan_bins(a, a)
    plan_ms = (time.perf_counter() - t0) * 1e3
    rows = [int((r >= 0).sum()) for r, _ in plan.bins]
    log(f"plan_bins s14: {plan_ms:.1f} ms; bins (W, rows) "
        f"{[(w, k) for (_, w), k in zip(plan.bins, rows)]}; {plan.huge_rows.size} huge rows "
        f"carry {plan.huge_product_cap} of {plan.product_cap} products")
    c = drive("s14 spgemm_binned", lambda: BN.spgemm_binned(a, a, plan),
              ("sort_dedup_compact", "cumsum_i32"))
    failed = []
    check_digest("spgemm_binned", block_digest(np, c.row_ptr, c.col_ind, c.values), failed)
    if sort_dedup_compact.launches != plan.num_bins:
        raise AssertionError(f"phase 12: K1 launched {sort_dedup_compact.launches} times for "
                             f"{plan.num_bins} non-empty bins")
    scipy_check(a, c, "s14 spgemm_binned", positive=True)
    c2 = BN.spgemm_binned(a, a, plan)
    torch.cuda.set_sync_debug_mode("error")  # any device-to-host read raises
    try:
        c3 = BN.spgemm_binned(a, a, plan)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for other, what in ((c2, "a second call"), (c3, "a call under sync debug mode")):
        if not all(torch.equal(getattr(c, k), getattr(other, k))
                   for k in ("row_ptr", "col_ind", "values")):
            raise AssertionError(f"phase 12: spgemm_binned differs from {what}")
    log("s14 spgemm_binned: bit-equal over three calls; the warm call made no "
        "device-to-host read (sync debug mode \"error\")")
    nh = nnz_stats(c).cpu().numpy()
    if not np.array_equal(nh.astype(np.int64), log2_hist_np(np, np.diff(ps.indptr))):
        raise AssertionError("phase 12: nnz_stats(A·A) differs from the numpy recomputation")
    log(f"nnz_stats s14 A·A: {nh.tolist()} == numpy's; classify_flops, flops_stats too")
    del c2, c3
    flops = plan.product_cap
    # the eager body, whatever the plan's calls so far: phase 16 times the
    # graph, and the run sums below are caught in Python
    fn = lambda: BN._binned_impl(a, a, plan)  # noqa: E731
    ms = cuda_ms(torch, fn, reps=9)
    ka = profile_kernels(torch, fn)
    log(f"s14 spgemm_binned warm, eager body: {ms:.3f} ms (median of 9, CUDA events), "
        f"{2 * flops / ms / 1e6:.3f} GFLOPS [{card}]")
    log("s14 spgemm_binned, one eager call under torch.profiler: " + breakdown(ka, 8))
    no_cummax_kernel("phase 12", ka, failed)
    if failed:
        raise AssertionError("phase 12: " + "; ".join(failed))
    _, calls = capture_run_sums(fn)
    k9_cases(torch, "s14 spgemm_binned (the huge rows)", calls, record, cuda_ms, device_ms)
    del c, ka, calls

    # ---- 12c. K1 at the binned widths ------------------------------------
    pt = BN._plan_tensors(plan, dev)
    _, pcol, pval, _ = esc_expand(a, a, plan.product_cap)
    rfd = row_flops(a, a)
    row_off = exclusive_cumsum(rfd)
    rfd = torch.cat([rfd, rfd.new_zeros(1)])
    widths = [w for w, _ in pt["bins"]]
    for w_sel in (4096, 16):
        if w_sel not in widths:
            raise AssertionError(f"phase 12: the s14 bin plan has no W={w_sel} bin")
        rid = pt["bins"][widths.index(w_sel)][1]
        tc, tv = BN._gather_bin_products(rid, w_sel, pcol, pval, row_off, rfd, a.ncols)
        kk, kv = sort_dedup_compact(tc, tv, a.ncols)
        pk, pv = sort_dedup_compact_plain(tc, tv, a.ncols)
        torch.cuda.synchronize()

        def k1_same(got, w_sel=w_sel, pk=pk, pv=pv, kv=kv):
            if not torch.equal(got[0], pk):
                raise AssertionError(f"K1 binned W={w_sel}: cols differ from the twin")
            if not torch.equal(got[1], kv):
                raise AssertionError(f"K1 binned W={w_sel}: differs from the first call")
            return check_vals(got[1], pv, f"K1 binned W={w_sel}")

        err = k1_same((kk, kv))
        k1 = lambda tc=tc, tv=tv: sort_dedup_compact(tc, tv, a.ncols)  # noqa: E731
        burst(f"K1 binned W={w_sel}", k1, k1_same)
        record(
            "sort_dedup_compact", f"binned W={w_sel} R={tc.shape[0]} presorted=1", err,
            cuda_ms(torch, k1), cuda_ms(torch, lambda: sort_dedup_compact_plain(tc, tv, a.ncols)),
            bound(16.0 * tc.numel()), NO_CALL["sort_dedup_compact"], dev_ms=device_ms(torch, k1),
        )
    del pcol, pval, tc, tv, kk, kv, pk, pv
    torch.cuda.synchronize()

    # ---- 12d. the partitioned driver -------------------------------------
    cb = drive("band spgemm_ell_partitioned parts=4",
               lambda: spgemm_ell_partitioned(ca, ca, parts=4),
               ("sort_dedup_compact", "window_gather", "cumsum_i32"))
    scipy_check(ca, cb, "band spgemm_ell_partitioned parts=4", positive=False)
    del cb
    peaks = {}
    for label, fn in (
        ("partitioned parts=4", lambda: spgemm_ell_partitioned(a, a, parts=4)),
        ("spgemm_ell", lambda: spgemm_ell(a, a, plan_ell(a, a))),
    ):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = drive(f"s14 {label}", fn, ("sort_dedup_compact", "window_gather", "cumsum_i32"))
        ms_with_plan = (time.perf_counter() - t0) * 1e3
        peaks[label] = (torch.cuda.max_memory_allocated() - base) / 2**20
        scipy_check(a, out, f"s14 {label}", positive=True)
        log(f"s14 {label}: peak device memory above the inputs {peaks[label]:.1f} MiB; "
            f"{ms_with_plan:.1f} ms with its plans, one cold call [{card}]")
        del out
    log(f"s14 partitioned / single-call peak memory: "
        f"{peaks['partitioned parts=4'] / peaks['spgemm_ell']:.3f} [{card}]")

    # ---- 12e. the command line, in process -------------------------------
    def cli(label, main, argv, must=()):
        buf = io.StringIO()

        def run():
            with contextlib.redirect_stdout(buf):
                return main(argv)

        t0 = time.perf_counter()
        rc = drive(label, run, must)
        out = buf.getvalue().splitlines()
        log(f"{label}: exit {rc}, {(time.perf_counter() - t0) * 1e3:.1f} ms wall")
        if rc != 0:
            raise AssertionError(f"phase 12: {label} exited {rc}")
        return out

    k134 = ("sort_dedup_compact", "window_gather", "cumsum_i32")
    for kernel, must in (("esc", ()), ("binned", ("sort_dedup_compact",)), ("ell", k134),
                         ("ell-partitioned", k134)):
        out = cli(f"perf --kernel {kernel}", perf.main, ["-i", snap, "--kernel", kernel], must)
        if not (out and out[-1].startswith(f"{kernel} spgemm: ") and "GFLOPS = " in out[-1]):
            raise AssertionError(f"phase 12: perf --kernel {kernel} printed no GFLOPS line")
        log(f"  {out[-1]} [{card}]")
    # analysis on the same file against scipy: the file holds "from to
    # value" lines, read untransposed as (from, to)
    with open(snap) as f:
        f.readline()
        nrows = int(f.readline().split()[0])
    edges = np.loadtxt(snap, comments="#", skiprows=2, ndmin=2)
    fm = sp.csr_matrix((edges[:, 2], (edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64))),
                       shape=(nrows, nrows))
    fp = fm.copy()
    fp.data[:] = 1.0
    oflops = int(np.diff(fp.indptr)[fp.indices].sum())
    want_first = (f"N= {nrows} Annz= {fm.nnz} Cnnz={(fp @ fp).nnz} flops= {2 * oflops} ")
    out = cli("analysis --bins", analysis.main, ["-i", snap, "--bins"])
    if not (out[0].startswith(want_first) and out[1] == f"Oflops={oflops}"):
        raise AssertionError(f"phase 12: analysis printed {out[:2]}, scipy gives "
                             f"{want_first!r} Oflops={oflops}")
    log(f"  {out[0]} | {out[1]} == scipy's; {sum(x.startswith('Binwise') for x in out)} bins")
    tdata = os.path.join(ROOT, "tests", "tdatas", "tdata.snap")
    out = cli("mat_dat_analysis tdata.snap", mat_dat_analysis.main, ["-i", tdata])
    log(f"  {' | '.join(out)}")
    for extra in ((), ("--duel",)):
        argv = ["--synthetic", "--scales", "14", "--cant", "--kernel", "auto", "--check", "--mt",
                *extra]
        out = cli(f"corpus {' '.join(argv)}", corpus.main, argv, k134)
        recs = [json.loads(x) for x in out if x.startswith("{")]
        for r in recs:
            log(f"  {json.dumps(r)} [{card}]")
        routes = [(r["matrix"], r["routed"]["kernel"], r["nnzc_ok"]) for r in recs]
        if routes != [("rmat_s14", "ell", True), ("banded_cant_62k_b32", "block", True)]:
            raise AssertionError(f"phase 12: corpus records {routes}")

    # ---- 12f. the host heap tuning: plan_ell cold, with and without prefault
    # first, each in a fresh process (the CSR on the host: the planner's
    # own time), in the order none, prefault, prefault, none
    runs = {0: [], 1: []}
    for pre in (0, 1, 1, 0):
        out = subprocess.run([sys.executable, "-c", PREFAULT_PROBE, str(pre)], cwd=ROOT,
                             capture_output=True, text=True, timeout=300, check=True).stdout
        runs[pre].append(json.loads(out.strip().splitlines()[-1]))
    for pre, label in ((0, "without prefault"), (1, "after prefault(1 << 28)")):
        r = runs[pre]
        log(f"plan_ell s14 cold in a fresh process {label}: "
            f"{[round(x['cold_ms'], 1) for x in r]} ms, then warm "
            f"{[round(x['warm_ms'], 1) for x in r]} ms; prefault "
            f"{[round(x['prefault_ms'], 1) for x in r]} ms; (heap pages kept, THP allocator) "
            f"{r[0]['heap']} [{card}]")
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")


def snake_perm_np(np, rf, rows: int, d: int, lr: int):
    """``parallel/rmcl._snake_perm_device`` recomputed on the host: the
    rows by descending flops (stable), dealt boustrophedon over the
    valid slots, padding rows into the trailing holes."""
    n_pad = d * lr
    idx = np.arange(n_pad)
    order = np.argsort(-np.where(idx < rows, rf.astype(np.int64), -1), kind="stable")
    k, r = idx // lr, idx % lr
    rank = r * d + np.where(r % 2 == 0, k, d - 1 - k)
    key = np.where(r < np.clip(rows - k * lr, 0, lr), rank, n_pad + rank)
    perm = np.zeros(n_pad, np.int64)
    perm[np.argsort(key, kind="stable")] = order
    return perm


def probe_runs(torch, dev, runs: int = 3000):
    """The offset probe's stream: ``runs`` runs of 1 to 4096 random f32
    values (seed 13) and their int64 offsets, on ``dev``."""
    g = torch.Generator().manual_seed(13)
    lens = torch.randint(1, 4097, (runs,), generator=g)
    vals = torch.rand(int(lens.sum()), generator=g).to(dev)
    off = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(lens, 0)]).to(dev)
    return vals, off


def run_sums_offset_probe(torch, fn, vals, off, moves: int = 8) -> list:
    """How many runs ``fn`` (a run-sum function) adds to other bits when
    the whole stream is moved by 0 .. ``moves`` - 1 slots, against the
    unmoved stream: nonzero counts show a summation order that depends
    on a run's offset."""
    base = fn(vals, off)
    counts = []
    for k in range(moves):
        moved = torch.cat([torch.zeros(k, device=vals.device), vals])
        counts.append(int((fn(moved, off + k) != base).sum()))
    return counts


def capture_run_sums(fn):
    """``fn()`` with every ``run_sums`` call on its path recorded: returns
    (its result, the list of (values, offsets) of each call).  The
    stream paths reach run_sums through ``ops/spgemm.esc_compress`` and
    the prune's ``ops/segments.blocked_run_sums`` (two calls a sum)."""
    import importlib

    mods = [importlib.import_module(f"{PKG}.ops.{m}") for m in ("spgemm", "segments")]
    real = mods[0].run_sums
    seen = []

    class Spy:
        """Stands in for run_sums in its own module too, so the wrapper's
        ``run_sums.launches += 1`` reaches the real count through it."""

        def __call__(self, values, offsets):
            seen.append((values, offsets))
            return real(values, offsets)

        @property
        def launches(self):
            return real.launches

        @launches.setter
        def launches(self, n):
            real.launches = n

    spy = Spy()
    for m in mods:
        m.run_sums = spy
    try:
        out = fn()
    finally:
        for m in mods:
            m.run_sums = real
    return out, seen


K9_LIBRARY = ("torch.segment_reduce(values, 'sum', offsets=..., unsafe=True): CUB's segmented "
              "reduce, whose order depends on a run's offset; on a card tensor it is also "
              "K9's plain version")


def k10_phase(torch, np, dev, record, burst, cuda_ms, device_ms):
    """K10 at Graph500 s16's shapes (the benchmark's matrix): its first hub
    group (the plan's own tables for that group alone) against the plain
    version on the card (CUB's sums: values within the comparators) and,
    on a sample of items, on the CPU (bit for bit); the whole hub in one
    launch, as the warm call makes it; yardstick torch.sparse.mm (cuSPARSE)
    of the group's hub rows by B, which the port never calls."""
    from portbench.reference import generate

    from sparse_matrix_with_flops_tpu_torch.config import ABS_TOL, REL_TOL
    from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR
    from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
    from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
    from sparse_matrix_with_flops_tpu_torch.ops.hub_kernels import (
        hub_accumulate,
        hub_accumulate_plain,
    )

    with open(os.path.join(ROOT, "portbench", "configs", "graph500-s16.json")) as f:
        rp, ci, v = generate.matrix(json.load(f))
    n = rp.shape[0] - 1
    a = CSR.from_numpy(rp, ci, v, n, dev)
    plan = plan_ell(a, a)
    hub = E._plan_tensors(plan, dev)["hub"]
    if hub["sparse"] is None or hub["dense"]:
        raise AssertionError("phase 3: s16's hub groups are not all on K10")

    def inputs(sp):
        krow = sp["kmap"][sp["kofs"] + a.col_ind[sp["src"]].long()]
        return (sp["meta"], krow, a.values[sp["src"]], sp["boff"], sp["bcol"],
                a.values[sp["eorder"]])

    def outputs(lanes):
        return (torch.empty(lanes, dtype=torch.int32, device=dev),
                torch.empty(lanes, dtype=torch.float32, device=dev),
                torch.zeros(plan.v_rows + 1, dtype=torch.int32, device=dev))

    def in_bytes(sp, lanes):
        """Each input byte once, each output lane written once."""
        return (sum(x.numel() * x.element_size() for x in inputs(sp)) + 8.0 * lanes
                + 4.0 * sp["meta"].shape[0])

    g = plan.hub_groups[0]
    sp = E._sparse_hub_groups(plan, [0], dev)
    ins = inputs(sp)
    lanes = int(g.caps_rs.sum())
    out, ref = outputs(lanes), outputs(lanes)
    k10 = lambda: hub_accumulate(*ins, *out, n, sp["tile"], sp["warps"])  # noqa: E731
    plain = lambda: hub_accumulate_plain(*ins, *ref, n)  # noqa: E731
    k10()
    plain()
    torch.cuda.synchronize()
    want = tuple(x.clone() for x in out)
    if not (torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])):
        raise AssertionError("K10 s16 group 0: columns or counts differ from the plain version")
    err = (out[1].double() - ref[1].double()).abs()
    if not bool((err <= torch.clamp(REL_TOL * ref[1].abs().double(), min=ABS_TOL)).all()):
        raise AssertionError(f"K10 s16 group 0: values off the plain version's ({float(err.max())})")
    # bit for bit against the CPU, on 2,000 items and the 3 longest
    rng = np.random.default_rng(7)
    items = sp["meta"].shape[0]
    longest = torch.argsort(sp["meta"][:, 1] - sp["meta"][:, 0], descending=True)[:3].cpu()
    pick = torch.cat([torch.from_numpy(rng.choice(items, 2000, replace=False)), longest])
    meta = sp["meta"].cpu()[pick]
    cap = meta[:, 6]
    own = meta.clone()
    own[:, 5] = torch.cumsum(cap, 0) - cap  # the sample's regions end to end
    own[:, 9] = torch.arange(pick.numel())
    cpu = (torch.empty(int(cap.sum()), dtype=torch.int32), torch.empty(int(cap.sum())),
           torch.zeros(pick.numel(), dtype=torch.int32))
    hub_accumulate_plain(own, *(x.cpu() for x in ins[1:]), *cpu, n)
    owner = torch.repeat_interleave(torch.arange(pick.numel()), cap)
    at = meta[:, 5][owner] + torch.arange(owner.numel()) - own[:, 5][owner]
    if not (torch.equal(out[0].cpu()[at], cpu[0])
            and torch.equal(out[1].cpu()[at].view(torch.int32), cpu[1].view(torch.int32))
            and torch.equal(out[2].cpu()[meta[:, 9]], cpu[2])):
        raise AssertionError("K10 s16 group 0: differs from the CPU's bits on the sample")
    log(f"K10 s16 group 0: {items} items, {lanes} lanes, {g._products} products; the card equals "
        f"the CPU bit for bit on {pick.numel()} items")

    def same(got):
        if not all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(got, want)):
            raise AssertionError("K10: a call differs from the first")

    burst("K10 s16 group 0", lambda: (k10(), out)[1], same, calls=5)
    # yardstick: the group's hub rows of A by B in CSR, one cuSPARSE SpGEMM
    rows = torch.from_numpy(g.rows.astype(np.int64)).to(dev)
    lens = a.row_ptr[rows + 1] - a.row_ptr[rows]
    crow = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    sel = torch.from_numpy(g.src.astype(np.int64)).to(dev)
    a_hub = torch.sparse_csr_tensor(crow, a.col_ind[sel].long(), a.values[sel], (rows.numel(), n))
    b_csr = torch.sparse_csr_tensor(a.row_ptr.long(), a.col_ind.long(), a.values, (n, n))
    lib = lambda: torch.sparse.mm(a_hub, b_csr)  # noqa: E731
    record(
        "hub_accumulate", f"s16 group 0: {rows.numel()} rows x {g.n_slabs} slabs of {g.slab}, "
        f"tiles of {sp['tile']}, {lanes} lanes", 0.0,
        cuda_ms(torch, k10, reps=7), cuda_ms(torch, plain, reps=3, warm=1),
        bound(in_bytes(sp, lanes)), cuda_ms(torch, lib, reps=5, warm=1),
        "torch.sparse.mm(A's hub rows as CSR, B as CSR): cuSPARSE SpGEMM, the same sums "
        "in CSR form", dev_ms=device_ms(torch, k10, calls=5),
    )
    del ins, out, ref, want, a_hub, b_csr
    # the whole hub, every group in one launch, as the warm call makes it
    sp = hub["sparse"]
    ins = inputs(sp)
    lanes = hub["lanes"]
    out = outputs(lanes)
    full = lambda: hub_accumulate(*ins, *out, n, sp["tile"], sp["warps"])  # noqa: E731
    ms, dev_ms = cuda_ms(torch, full, reps=7), device_ms(torch, full, calls=5)
    kb = bound(in_bytes(sp, lanes))
    log(f"K10 s16 whole hub: {sp['meta'].shape[0]} items, {lanes} lanes in one launch: "
        f"{ms:.4f} ms, device {dev_ms:.4f} ms, bound {kb[0]:.4f} ms ({kb[1]}, {kb[0] / dev_ms:.1%})")
    del ins, out, sp, plan, a
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def k11_phase(torch, np, dev, record, burst, cuda_ms, device_ms):
    """K11 at the LFR cell's three tile widths (W 2,048 / 4,096 / 8,192):
    the first ``_TILE_BYTES`` chunk of each degree bin of the first step
    on the cell's graph (2^19 nodes, generator seed 7), K1 applied, as
    the step hands it over; against its plain version on the card, bit
    for bit, and beside the two stable sorts it replaces
    (``_prune_select_lanes``).  No one PyTorch call computes the
    function.  Bound: the valid lanes read (8 bytes each, the sentinel
    tail never read) and the output rows written."""
    import importlib

    from portbench.reference import lfr

    from sparse_matrix_with_flops_tpu_torch.formats.coo import COO
    from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl_init
    from sparse_matrix_with_flops_tpu_torch.ops.select_kernels import (
        prune_select,
        prune_select_plain,
    )

    RM = importlib.import_module(f"{PKG}.models.rmcl_ell")
    with open(os.path.join(ROOT, "portbench", "configs", "lfr-524288.json")) as f:
        rp, ci, _ = lfr.graph(json.load(f), seed=7)
    n, S = rp.shape[0] - 1, 128
    coo = COO.from_numpy(np.repeat(np.arange(n), np.diff(rp)), ci,
                         np.ones(ci.shape[0], np.float32), n, n,
                         capacity=ci.shape[0] + n, device=dev)
    mt = rmcl_init(coo).make_ordered()
    plan = RM.plan_rmcl_ell(mt, S=S, max_tile=8192)
    cols, vals = RM.mt_to_ell(mt, S)
    for d, rid, src in RM._plan_tensors(plan, dev)["bins"]:
        w = d * S
        r = min(max(RM._TILE_BYTES // (8 * w), 1), rid.shape[0])
        tc, tv = RM._tile(mt, cols, vals, src[: r * d], n, w)
        key, uval = RM._dedup_tile(tc, tv, n, run=S)
        del tc, tv
        rows = torch.arange(r, device=dev)
        out = (torch.empty((r, S), dtype=torch.int32, device=dev),
               torch.empty((r, S), device=dev), torch.zeros(2, dtype=torch.int64, device=dev))
        k11 = lambda: prune_select(key, uval, n, S, rows, *out)  # noqa: E731
        plain = lambda: prune_select_plain(key, uval, n, S)  # noqa: E731
        k11()
        want_c, want_v, trunc = plain()
        torch.cuda.synchronize()
        if not (torch.equal(out[0], want_c)
                and torch.equal(out[1].view(torch.int32), want_v.view(torch.int32))):
            raise AssertionError(f"K11 W={w}: differs from the plain version's bits")
        if out[2].tolist() != [int((want_c < n).sum()), int(trunc.sum())]:
            raise AssertionError(f"K11 W={w}: counters {out[2].tolist()} off the plain version's")
        first = tuple(x.clone() for x in out[:2])

        def same(got, w=w, first=first):
            if not all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(got[:2], first)):
                raise AssertionError(f"K11 W={w}: a call differs from the first")

        burst(f"K11 W={w}", lambda: (k11(), out)[1], same, calls=5)
        sorts = lambda: RM._prune_select_lanes(key, uval, n, S)  # noqa: E731
        apart = int((sorts()[0] != want_c).any(dim=1).sum())
        valid = int((key < n).sum())
        record(
            "prune_select", f"LFR 2^19 step 1, bin D={d}: W={w}, R={r}, {valid} valid lanes, "
            f"{int(trunc.sum())} rows over S", 0.0, cuda_ms(torch, k11),
            cuda_ms(torch, plain, reps=3, warm=1), bound(8.0 * (valid + r * S + r)),
            NO_CALL["prune_select"], dev_ms=device_ms(torch, k11, calls=5),
        )
        log(f"K11 W={w}: the two stable sorts it replaces {cuda_ms(torch, sorts, reps=5):.4f} ms "
            f"a chunk (device {device_ms(torch, sorts, calls=3):.4f} ms); rows whose columns "
            f"differ from theirs: {apart} of {r}")
        del key, uval, out, first, want_c, want_v, trunc
    del coo, mt, plan, cols, vals
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def k9_cases(torch, label, calls, record, cuda_ms, device_ms):
    """K9 on a path's captured run_sums calls: each output bit-equal to
    the plain version on the CPU; against the plain version on the card
    (CUB's order) within 1e-7 + (len - 1) * 2^-23 of the run's absolute
    sum, twice the textbook bound of an f32 sum of len values in any
    order; then all the calls timed together against
    torch.segment_reduce on the same inputs, one record.  Returns K9's
    and CUB's device ms."""
    from sparse_matrix_with_flops_tpu_torch.ops.segments import run_sums, run_sums_plain

    err, nbytes, runs, covered = 0.0, 0.0, 0, 0
    for values, offsets in calls:
        got = run_sums(values, offsets)
        cub = run_sums_plain(values, offsets)
        mag = run_sums_plain(values.abs(), offsets)
        want = run_sums_plain(values.cpu(), offsets.cpu())
        torch.cuda.synchronize()
        if not torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)):
            bad = int((got.cpu().view(torch.int32) != want.view(torch.int32)).sum())
            raise AssertionError(f"K9 {label}: {bad} of {want.numel()} sums differ from the "
                                 f"plain version's bits on the CPU")
        e = (got - cub).abs()
        lens = (offsets[1:] - offsets[:-1]).clamp(min=1).to(torch.float32)
        if not bool((e <= 1e-7 + (lens - 1) * 2.0**-23 * mag).all()):
            raise AssertionError(f"K9 {label}: differs from torch.segment_reduce on the card "
                                 f"beyond its rounding (max {float(e.max()):.3e})")
        err = max(err, float(e.max()) if e.numel() else 0.0)
        span = int(offsets[-1] - offsets[0])
        covered += span
        runs += offsets.numel() - 1
        # the values the runs cover, the offsets and the sums, each once
        nbytes += 4.0 * span + offsets.element_size() * offsets.numel() + 4.0 * (offsets.numel() - 1)
        del got, cub, mag, want

    def k9():
        return [run_sums(v, o) for v, o in calls]

    def cub():
        return [run_sums_plain(v, o) for v, o in calls]

    def lib():
        return [torch.segment_reduce(v, "sum", offsets=o.long(), unsafe=True) for v, o in calls]

    kb = bound(nbytes)
    dev_k9, dev_cub = device_ms(torch, k9, 5), device_ms(torch, cub, 5)
    ms = cuda_ms(torch, k9, reps=7)
    if dev_k9 < kb[0]:  # faster than the card can move the bytes: records were lost
        log(f"  K9 {label}: torch.profiler's {dev_k9:.4f} ms is below the byte bound "
            f"{kb[0]:.4f} ms; device time by CUDA events instead ({ms:.4f} ms)")
        dev_k9 = ms
    record("run_sums", f"{label}: {len(calls)} call(s), {runs} runs over {covered} values", err,
           ms, cuda_ms(torch, cub, reps=7), kb, cuda_ms(torch, lib, reps=7), K9_LIBRARY,
           dev_ms=dev_k9)
    log(f"K9 {label}: == the plain version's bits on the CPU in every call; device "
        f"{dev_k9:.4f} ms against torch.segment_reduce's {dev_cub:.4f} ms")
    return dev_k9, dev_cub


def planted_phase(torch, np, sp, dev, card, drive, record, cuda_ms, device_ms):
    """Phase 14: R-MCL on planted partitions, the users' test of the
    clustering (``tools/cluster_quality.py``, ``tools/bench_rmcl_scale.py``):
    (a) 64 x 64 nodes through the stream loop (``rmcl``, K9) and the
    static-ELL path (``rmcl_ell``, K1), clusters, purity and the paths'
    label agreement; (b) the reference-scale 1024 x 64 = 65,536 nodes at
    S = 128: plan ms, ms/iteration by slope, iteration 1 against the f64
    oracle, 30 iterations to clusters at purity >= 0.95, and one stream
    step's run sums (K9) at that scale."""
    import importlib

    from sparse_matrix_with_flops_tpu_torch.models.clusters import cluster_sizes, extract_clusters
    from sparse_matrix_with_flops_tpu_torch.models.rmcl_ell import rmcl_ell
    from sparse_matrix_with_flops_tpu_torch.utils.generate import (
        cluster_purity,
        planted_partition_coo,
    )

    R = importlib.import_module(f"{PKG}.models.rmcl")
    RM = importlib.import_module(f"{PKG}.models.rmcl_ell")
    t_phase = time.perf_counter()
    failed = []

    # ---- 14a. tools/cluster_quality.py's case, both paths ----------------
    kc, cs, iters, floor = 64, 64, 8, 0.2
    coo, planted = planted_partition_coo(kc, cs, p_in=0.3, p_out=0.0005, seed=1)
    if coo.device != dev:
        raise AssertionError(f"planted_partition_coo with no device is on {coo.device}")
    mt0 = R.rmcl_init(coo)
    log(f"planted {kc} x {cs}: n {mt0.rows} nnz {int(mt0.nnz)}")
    labels = {}
    for path, fn, must in (
        ("stream loop (rmcl)", lambda: R.rmcl(mt0, max_iters=iters, mode="loop").mt, ("run_sums",)),
        ("static ELL (rmcl_ell)", lambda: rmcl_ell(mt0, max_iters=iters)[0],
         ("sort_dedup_compact",)),
    ):
        t0 = time.perf_counter()
        out = drive(f"planted {kc}x{cs} {path} {iters} iterations", fn, must)
        lab = extract_clusters(out, weight_floor=floor)
        secs = time.perf_counter() - t0
        pur = cluster_purity(lab, planted)
        labels[path] = lab
        log(f"planted {kc}x{cs} {path}: {len(cluster_sizes(lab))} clusters found of {kc} "
            f"planted, purity {pur:.4f}, {secs:.2f} s with extraction [{card}]")
        if pur < 0.95:
            failed.append(f"{kc}x{cs} {path}: purity {pur:.4f} < 0.95")
    lab_s, lab_e = labels.values()
    agree = float(np.mean(lab_s == lab_e))
    log(f"planted {kc}x{cs}: label agreement stream vs ELL {agree:.4f}")
    del coo, mt0

    # ---- 14b. bench_rmcl_scale's reference-scale case --------------------
    kc, cs, S, iters = 1024, 64, 128, 30
    n = kc * cs
    coo, planted = planted_partition_coo(kc, cs, p_in=0.3, p_out=8.0 / n, seed=11)
    mgt = R.rmcl_init(coo).make_ordered()
    nnz = int(mgt.nnz)
    log(f"planted {kc} x {cs}: n {n} nnz(A) {nnz} (p_out 8/n, seed 11)")
    if nnz != 1825520:
        raise AssertionError(f"phase 14: nnz(A) {nnz} != 1,825,520")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = RM.plan_rmcl_ell(mgt, S=S)
    plan_ms = (time.perf_counter() - t0) * 1e3
    cols0, vals0 = RM.mt_to_ell(mgt, S)
    a_d = RM._dense_huge(mgt, plan)
    torch.cuda.synchronize()
    log(f"plan_rmcl_ell planted n={n} S={S}: {plan_ms:.1f} ms host; bins "
        f"{[(d, int(r.size)) for d, r, _ in plan.bins]} hub rows {plan.huge_rows.size} [{card}]")
    c1, v1, _ = RM.rmcl_ell_step(plan, mgt, a_d, cols0, vals0)
    h0 = (cols0.cpu().numpy().astype(np.int64), vals0.cpu().numpy().astype(np.float64))
    oc, ov, near = oracle_step(np, sp, mgt, *h0, S)
    failed += compare_iterates(
        np, f"planted n={n} rmcl_ell step 1 vs scipy f64 oracle",
        c1.cpu().numpy().astype(np.int64), v1.cpu().numpy().astype(np.float64), oc, ov, near)
    del c1, v1, oc, ov, near
    t0 = time.perf_counter()
    c30, v30, hist = drive(f"rmcl_ell_scan planted n={n} S={S} {iters} iterations",
                           lambda: RM.rmcl_ell_scan(plan, mgt, a_d, cols0, vals0, iters),
                           ("sort_dedup_compact",))
    scan_s = time.perf_counter() - t0
    if not bool(torch.isfinite(v30).all()):
        failed.append(f"planted n={n}: non-finite values after {iters} iterations")
    mt_fin = RM.ell_to_csr(c30, v30, mgt.ncols)
    t0 = time.perf_counter()
    lab = extract_clusters(mt_fin, weight_floor=0.05)
    ext_s = time.perf_counter() - t0
    pur = cluster_purity(lab, planted)
    found = len(cluster_sizes(lab))
    log(f"planted n={n} {iters} iterations: {scan_s:.2f} s; nnz "
        f"{hist['nnz'].cpu().numpy().tolist()}; differs "
        f"{[round(float(x), 5) for x in hist['differs'].cpu().numpy()]}; {found} clusters of "
        f"{kc} planted, purity {pur:.4f} at weight floor 0.05 (extraction {ext_s:.2f} s) [{card}]")
    if pur < 0.95:
        failed.append(f"planted n={n}: purity {pur:.4f} < 0.95")
    # after the 30-iteration call, which captured the step's graph: both
    # lengths replay it
    walls = {k: cuda_ms(torch, lambda k=k: RM.rmcl_ell_scan(plan, mgt, a_d, cols0, vals0, k),
                        reps=3, warm=1) for k in (2, 6)}
    ms_iter = (walls[6] - walls[2]) / 4
    log(f"rmcl_ell_scan planted n={n} S={S}: {ms_iter:.3f} ms/iteration (slope of CUDA-event "
        f"medians, {walls[2]:.3f} ms at 2 and {walls[6]:.3f} ms at 6 iterations) [{card}]")
    del c30, v30, mt_fin, plan, a_d, cols0, vals0

    # one stream step at this scale: K9 on its products and row sums
    mt = mgt.deep_copy()
    pc, cc = R.plan_capacities(mgt, mt, 1.5)
    mtc = mt.with_capacity(cc)
    (got, info), calls = capture_run_sums(
        lambda: drive(f"rmcl_one_step planted n={n} step 1", lambda: R.rmcl_one_step(
            mgt, mtc, pc, cc), ("run_sums",)))
    if bool(info["overflow_products"] | info["overflow_c"] | info["overflow_mt"]):
        failed.append(f"planted n={n} rmcl_one_step: overflow")
    k9_cases(torch, f"planted n={n} rmcl_one_step step 1", calls, record, cuda_ms, device_ms)
    del got, calls, mt, mtc
    torch.cuda.synchronize()
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError("phase 14: " + "; ".join(failed))


def captures_in(fn):
    """(``fn()``, the names of the bodies it captured): a spy on
    ``utils/graphs.CapturedBody._capture`` for the call."""
    from sparse_matrix_with_flops_tpu_torch.utils import graphs

    made, real = [], graphs.CapturedBody._capture

    def spy(self):
        made.append(self.name)
        return real(self)

    graphs.CapturedBody._capture = spy
    try:
        return fn(), made
    finally:
        graphs.CapturedBody._capture = real


def check_policy(label: str, name: str, iters: int, made: list, failed: list) -> None:
    """Log whether a call of ``iters`` runs on a fresh plan captured, and
    fail where the capture policy says otherwise (it captures iff
    ``iters`` reaches the program's break-even count)."""
    from sparse_matrix_with_flops_tpu_torch.utils import graphs

    b = graphs.BREAK_EVEN[name]
    log(f"{label}: a call of {iters} iterations on a fresh plan "
        f"{'captured' if made else 'captured nothing'} "
        f"({name}'s break-even count B = {b})")
    if bool(made) != (iters >= b) or any(m != name for m in made):
        failed.append(f"{label}: captured {made} against the policy (B = {b})")


def same_bits(torch, x, y) -> bool:
    """Bit for bit: tensors (f32 by their bits), CSRs array by array,
    dicts, tuples and lists of them."""
    if hasattr(x, "row_ptr"):
        return all(same_bits(torch, getattr(x, k), getattr(y, k))
                   for k in ("row_ptr", "col_ind", "values"))
    if isinstance(x, dict):
        return sorted(x) == sorted(y) and all(same_bits(torch, x[k], y[k]) for k in x)
    if isinstance(x, (tuple, list)):
        return len(x) == len(y) and all(same_bits(torch, a, b) for a, b in zip(x, y))
    bits = (lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t)  # noqa: E731
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(bits(x), bits(y))


def compiled_phase(torch, np, dev, card, a, drive, cuda_ms):
    """Phase 16: the compiled programs, CUDA graphs kept on a plan and
    replayed through the normal entry points (``utils/graphs.py``), each
    on a fresh plan driven by calls until the capture policy captures
    (at call ceil(B / iterations a call), B its break-even count): the
    warm ``spgemm_ell`` on R-MAT s14 (phase 4's matrix), ``rmcl_ell_scan``
    on phase 8's graph (S = 128, 5 iterations a call), the stacked
    ``sharded_rmcl_ell_scan`` at D = 4 on phase 8's graph with each
    exchange (5 iterations, and a second call on another iterate), the
    warm ``sharded_spgemm_ring`` at D = 4 on phase 13's s14 (plan and
    caps passed), the warm ``spgemm_binned`` on phase 12's s14 and
    ``rmcl_ell_scan`` on phase 14(b)'s 65,536-node planted graph (30
    iterations, clusters and purity).  Each call is held bit for bit to
    the eager run of the same body (the warm ``_tiles_impl``, a loop of
    the step, ``_ring_impl``, ``_binned_impl``), and each SpGEMM replayed
    on A's values doubled must give exactly twice C.  For each program
    it logs eager and graph ms (CUDA events, median of 15 after
    warm-up), B and the call that captured, the capture's host ms, the
    graph's pool bytes, the peak device memory of an eager call, of the
    capturing call and of a replaying call, and replays x the launches a
    replay makes, counted by ``drive``."""
    import dataclasses
    import importlib

    from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR
    from sparse_matrix_with_flops_tpu_torch.models.clusters import cluster_sizes, extract_clusters
    from sparse_matrix_with_flops_tpu_torch.ops import binned as BN
    from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
    from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
    from sparse_matrix_with_flops_tpu_torch.parallel import shard_csr
    from sparse_matrix_with_flops_tpu_torch.parallel.spgemm import (
        _ring_impl,
        plan_spgemm_ring,
        sharded_spgemm_ring,
    )
    from sparse_matrix_with_flops_tpu_torch.utils import graphs
    from sparse_matrix_with_flops_tpu_torch.utils.generate import (
        cluster_purity,
        planted_partition_coo,
    )

    R = importlib.import_module(f"{PKG}.models.rmcl")
    RM = importlib.import_module(f"{PKG}.models.rmcl_ell")
    PS = importlib.import_module(f"{PKG}.parallel.rmcl_ell")
    from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    failed = []
    report = {}

    def peak_gib(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 2**30

    def program(label, owner, name, eager, call, must, iters=1, reps=15):
        """One compiled program: eager and graph results, bits, times,
        memory, the call that captured, and replays."""
        want, peak_e = peak_gib(eager)
        b = graphs.BREAK_EVEN[name]
        expect = -(-b // iters)  # the policy's capturing call on a fresh plan
        ok = True
        for k in range(1, expect + 1):  # eager calls, then the eager run and the capture
            first, peak_c = peak_gib(call)
            ok = ok and same_bits(torch, first, want)
            g = graphs.held(owner, name)
            if g is not None and g.graph is not None:
                break
        if g is None or g.graph is None or k != expect:
            raise AssertionError(f"phase 16: {label} kept no graph at call {k}; the policy "
                                 f"captures at call {expect} (B = {b}, {iters} a call)")
        del first
        replays0 = g.replays
        got, peak_r = peak_gib(lambda: drive(f"{label} (graph replays)", call, must))
        per_call = g.replays - replays0
        ok = ok and same_bits(torch, got, want)
        eager_ms = cuda_ms(torch, eager, reps=reps, warm=1)
        graph_ms = cuda_ms(torch, call, reps=reps, warm=1)
        rec = {
            "eager_ms": eager_ms, "graph_ms": graph_ms, "iterations": iters,
            "eager_ms_per_iteration": eager_ms / iters, "graph_ms_per_iteration": graph_ms / iters,
            "break_even": b, "captured_at_call": k, "eager_runs": g.spent,
            "capture_ms": g.capture_ms, "pool_bytes": g.pool_bytes,
            "peak_gib": {"eager": peak_e, "capturing call": peak_c, "replaying call": peak_r},
            "replays_a_call": per_call,
            "launches_a_replay": {w.__name__: n for w, n in g.launches.items()},
            "bit_equal": ok,
        }
        report[label] = rec
        log(f"{label}: eager {eager_ms:.3f} ms, graph {graph_ms:.3f} ms "
            f"({eager_ms / iters:.3f} / {graph_ms / iters:.3f} ms an iteration, CUDA events, "
            f"median of {reps}); B = {b}, captured at call {k} of {iters} "
            f"({g.spent} eager runs); capture {g.capture_ms:.1f} ms host; pool "
            f"{g.pool_bytes / 2**20:.1f} MiB; peak GiB eager {peak_e:.3f}, capturing call "
            f"{peak_c:.3f}, replaying call {peak_r:.3f}; {per_call} replays x "
            f"{rec['launches_a_replay']} a call; graph {'==' if ok else '!='} eager bit for "
            f"bit [{card}]")
        if not ok:
            failed.append(f"{label}: the graph differs from the eager run")
        return got

    # ---- 16a. the warm spgemm_ell on R-MAT s14 ---------------------------
    plan = plan_ell(a, a)
    E.spgemm_ell(a, a, plan)  # two-phase: caches the nnz(C) bucket
    cap = plan._nnzc_cache

    def warm_eager():
        c, _ = E._tiles_impl(a, a, plan, fused_out_cap=cap)
        return c

    c = program("spgemm_ell s14 warm", plan, "spgemm_ell", warm_eager,
                lambda: E.spgemm_ell(a, a, plan),
                ("sort_dedup_compact", "hub_accumulate", "window_gather", "cumsum_i32"))
    a2 = CSR(a.row_ptr, a.col_ind, 2.0 * a.values, a.ncols)

    def doubled(label, c, c2):
        torch.cuda.synchronize()
        ok = (torch.equal(c2.row_ptr, c.row_ptr) and torch.equal(c2.col_ind, c.col_ind)
              and torch.equal(c2.values, 2.0 * c.values))
        log(f"{label} graph replayed on A's values doubled: C's values "
            f"{'exactly' if ok else 'NOT'} doubled, structure kept")
        if not ok:
            failed.append(f"{label}: the replay on 2A did not give exactly 2C")

    doubled("spgemm_ell s14 warm", c, E.spgemm_ell(a2, a, plan))  # a replay on new inputs
    n, d = a.rows, 4
    oc = int(torch.diff(c.row_ptr).reshape(d, n // d).sum(1).max())  # phase 13's out_cap
    del c, plan

    # ---- 16b. the warm sharded_spgemm_ring, D = 4 stacked, on s14 ---------
    sa, mesh = shard_csr(a, d), make_mesh(d, dev)
    rplan, ents = plan_spgemm_ring(sa, sa)
    c, _ = program("sharded_spgemm_ring s14 D=4 warm", rplan, "sharded_spgemm_ring",
                   lambda: _ring_impl(mesh, rplan.step_prod_caps, sa, sa, ents, oc),
                   lambda: sharded_spgemm_ring(mesh, sa, sa, out_cap=oc, plan=rplan,
                                               step_ents=ents),
                   ("cumsum_i32", "run_sums"))
    sa2 = dataclasses.replace(sa, values=2.0 * sa.values)
    doubled("sharded_spgemm_ring s14 D=4 warm", c,
            sharded_spgemm_ring(mesh, sa2, sa, out_cap=oc, plan=rplan, step_ents=ents)[0])
    del c, sa, sa2, rplan, ents, mesh

    # ---- 16c. the warm spgemm_binned on s14 --------------------------------
    bplan = BN.plan_bins(a, a)
    c = program("spgemm_binned s14 warm", bplan, "spgemm_binned",
                lambda: BN._binned_impl(a, a, bplan), lambda: BN.spgemm_binned(a, a, bplan),
                ("sort_dedup_compact", "cumsum_i32", "run_sums"))
    doubled("spgemm_binned s14 warm", c, BN.spgemm_binned(a2, a, bplan))
    del c, a2, bplan
    torch.cuda.synchronize()

    # ---- 16d. rmcl_ell_scan on phase 8's graph -----------------------------
    def ell_eager(plan, mgt, a_d, cols, vals, iters):
        hist = []
        for _ in range(iters):
            cols, vals, st = RM.rmcl_ell_step(plan, mgt, a_d, cols, vals)
            hist.append(st)
        return cols, vals, {k: torch.stack([h[k] for h in hist]) for k in hist[0]}

    coo, mgt, cols0, vals0 = phase8_graph(torch, np, dev)
    plan = RM.plan_rmcl_ell(mgt, S=S15, max_tile=MT15)
    a_d = RM._dense_huge(mgt, plan)
    RM._plan_tensors(plan, dev)
    program("rmcl_ell_scan s14 S=128 5 iterations", plan, "rmcl_ell_scan",
            lambda: ell_eager(plan, mgt, a_d, cols0, vals0, 5),
            lambda: RM.rmcl_ell_scan(plan, mgt, a_d, cols0, vals0, 5),
            ("sort_dedup_compact",), iters=5)
    del plan, a_d

    # ---- 16e. sharded_rmcl_ell_scan, D = 4 stacked, each exchange ----------
    mesh = make_mesh(4, dev)
    plan, arrays, smgt = PS.plan_sharded_rmcl_ell(mgt, 4, S=S15, max_tile=MT15)
    x0 = (torch.where(cols0 >= mgt.rows, plan.n, cols0).reshape(4, plan.lr, S15),
          vals0.reshape(4, plan.lr, S15))

    def sharded_eager(x, ex, iters):
        hist, (c, v) = [], x
        for _ in range(iters):
            c, v, st = PS._sharded_step(plan, smgt, arrays, c, v, ex, mesh)
            hist.append(st)
        return c, v, {k: torch.stack([h[k] for h in hist]) for k in hist[0]}

    x1 = PS._sharded_step(plan, smgt, arrays, *x0, "all_gather", mesh)[:2]  # another iterate
    for ex, kernels in (("ring", ()), ("all_gather", ()), ("pallas_ring", ("ring_all_gather",)),
                        ("fused_ring", ("ring_matmul_tiled",))):
        program(f"sharded_rmcl_ell_scan s14 D=4 {ex} 5 iterations", plan,
                "sharded_rmcl_ell_scan", lambda ex=ex: sharded_eager(x0, ex, 5),
                lambda ex=ex: PS.sharded_rmcl_ell_scan(mesh, plan, smgt, arrays, *x0, 5, ex),
                ("sort_dedup_compact", *kernels), iters=5, reps=5)
        again = PS.sharded_rmcl_ell_scan(mesh, plan, smgt, arrays, *x1, 5, ex)
        own = same_bits(torch, again, sharded_eager(x1, ex, 5))
        log(f"sharded_rmcl_ell_scan {ex}: a second call on the plan with another iterate "
            f"{'==' if own else '!='} its own eager loop bit for bit")
        if not own:
            failed.append(f"sharded {ex}: a second call differs from its eager loop")
        del again
    del plan, arrays, smgt, x0, x1, cols0, vals0
    torch.cuda.synchronize()

    # ---- 16f. rmcl_ell_scan on the 65,536-node planted graph ---------------
    kc, cs, iters = 1024, 64, 30
    pcoo, planted = planted_partition_coo(kc, cs, p_in=0.3, p_out=8.0 / (kc * cs), seed=11)
    pmgt = R.rmcl_init(pcoo).make_ordered()
    plan = RM.plan_rmcl_ell(pmgt, S=S15)
    a_d = RM._dense_huge(pmgt, plan)
    pc0, pv0 = RM.mt_to_ell(pmgt, S15)
    RM._plan_tensors(plan, dev)
    c30, v30, hist = program(
        f"rmcl_ell_scan planted n={kc * cs} S=128 {iters} iterations", plan, "rmcl_ell_scan",
        lambda: ell_eager(plan, pmgt, a_d, pc0, pv0, iters),
        lambda: RM.rmcl_ell_scan(plan, pmgt, a_d, pc0, pv0, iters),
        ("sort_dedup_compact",), iters=iters)
    lab = extract_clusters(RM.ell_to_csr(c30, v30, pmgt.ncols), weight_floor=0.05)
    pur = cluster_purity(lab, planted)
    log(f"planted n={kc * cs} graph scan, {iters} iterations: {len(cluster_sizes(lab))} "
        f"clusters of {kc} planted, purity {pur:.4f} at weight floor 0.05; nnz "
        f"{hist['nnz'][-1].item()} at the end [{card}]")
    if pur < 0.95:
        failed.append(f"planted n={kc * cs}: purity {pur:.4f} < 0.95")
    del pcoo, pmgt, plan, a_d, pc0, pv0, c30, v30, hist

    del coo, mgt
    torch.cuda.synchronize()
    log("phase 16 " + json.dumps({"compiled_programs": report, "card": card}))
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError("phase 16: " + "; ".join(failed))


def distributed_phase(torch, np, sp, dev, card, a, drive, record, cuda_ms, host_ms):
    """Phase 13: the rest of the distributed layer with D = 4 shards
    stacked on the card: ``sharded_spgemm`` and ``sharded_spgemm_ring``
    on R-MAT s14 against scipy (bit-equal over calls, no host read), the
    2-D SpGEMM block by block, the dynamic ``sharded_rmcl_scan`` (no host
    read) bit for bit against the single-card ``rmcl_scan``, the adaptive
    ``sharded_rmcl_adaptive`` against the single-card loop, and
    ``dryrun_multichip(4)``.  None of these modules launches a kernel of
    its own: their streams reach K9 through ``esc_compress`` and the
    prune and K4 through ``repeat_segments``, and the dry run's static
    R-MCL reaches K1."""
    import importlib

    from sparse_matrix_with_flops_tpu_torch.config import ABS_TOL, REL_TOL
    from sparse_matrix_with_flops_tpu_torch.formats import COO
    from sparse_matrix_with_flops_tpu_torch.ops.flops import row_flops
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_upper_bounds
    from sparse_matrix_with_flops_tpu_torch.parallel import (
        dryrun_multichip,
        flops_balanced_permutation,
        make_mesh,
        row_sharding,
        shard_csr,
        unshard_csr,
    )
    from sparse_matrix_with_flops_tpu_torch.parallel import rmcl as PR
    from sparse_matrix_with_flops_tpu_torch.parallel.spgemm import (
        _ring_impl,
        plan_spgemm_ring,
        sharded_spgemm,
        sharded_spgemm_ring,
    )
    from sparse_matrix_with_flops_tpu_torch.parallel.spgemm2d import (
        shard_csr_2d,
        sharded_spgemm_2d,
    )
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    R = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl")
    t_phase = time.perf_counter()
    d = 4
    failed = []
    mesh = make_mesh(d)  # the card, by default
    if mesh.device != dev:
        raise AssertionError(f"make_mesh({d}) is on {mesh.device}, not {dev}")

    # ---- 13a. sharded and ring SpGEMM on s14 against scipy ---------------
    rp, ci, v = a.to_numpy()
    n = a.rows
    amat = sp.csr_matrix((v.astype(np.float64), ci, rp), shape=a.shape)
    pat = sp.csr_matrix((np.ones(ci.size), ci, rp), shape=a.shape)
    ps = (pat @ pat).tocsr()
    ps.sort_indices()
    cm = (amat @ amat).tocsr()
    am = (abs(amat) @ abs(amat)).tocsr()
    am.sort_indices()

    def keys(m):
        r = np.repeat(np.arange(m.shape[0], dtype=np.int64), np.diff(m.indptr))
        return r * m.shape[1] + m.indices

    def check_block(what, grp, gci, gv, r0, r1, c0, c1):
        """C's rows r0:r1, columns c0:c1 (shifted to 0): structure equal
        to scipy's pattern product, values within REL_TOL of the f64
        product relative to |A||A|."""
        ps_b, am_b = ps[r0:r1, c0:c1].tocsr(), am[r0:r1, c0:c1].tocsr()
        cm_b = cm[r0:r1, c0:c1].tocsr()
        for m in (ps_b, am_b, cm_b):
            m.sort_indices()
        if not (np.array_equal(grp, ps_b.indptr) and np.array_equal(gci, ps_b.indices)):
            failed.append(f"{what}: row_ptr/col_ind differ from scipy")
            log(f"FAIL {failed[-1]}")
            return
        ref = np.zeros(ps_b.nnz)
        ref[np.searchsorted(keys(ps_b), keys(cm_b))] = cm_b.data
        err = np.abs(gv - ref)
        ok = np.isfinite(gv) & (err <= REL_TOL * am_b.data + ABS_TOL)
        log(f"{what}: nnz {gci.size} structure == scipy; max |err|/|A||A| "
            f"{(err / am_b.data).max(initial=0.0):.3e}")
        if not ok.all():
            failed.append(f"{what}: {int((~ok).sum())} values off scipy")
            log(f"FAIL {failed[-1]}")

    sa = shard_csr(a, d)
    lr = sa.local_rows
    elen = np.diff(rp).astype(np.int64)
    rowf = np.bincount(np.repeat(np.arange(n), np.diff(rp)), weights=elen[ci], minlength=n)
    shard_flops = rowf.reshape(d, lr).sum(axis=1).astype(np.int64)
    shard_nnzc = np.diff(ps.indptr).reshape(d, lr).sum(axis=1)
    pc, oc = int(shard_flops.max()), int(shard_nnzc.max())
    log(f"sharded s14 D={d}, natural layout: flops a shard {shard_flops.tolist()}, "
        f"nnz(C) a shard {shard_nnzc.tolist()}; product_cap {pc}, out_cap {oc}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    c1, info = drive(f"sharded_spgemm s14 D={d}",
                     lambda: sharded_spgemm(mesh, sa, sa, pc, oc), ())
    peak_spgemm = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    plan, ents = plan_spgemm_ring(sa, sa)
    plan_ms0 = (time.perf_counter() - t0) * 1e3
    plan_ms = host_ms(torch, lambda: plan_spgemm_ring(sa, sa), 3)
    log(f"plan_spgemm_ring s14 D={d}: {plan_ms:.3f} ms host (median of 3; first "
        f"{plan_ms0:.3f}); step widths {plan.step_widths} product caps "
        f"{plan.step_prod_caps} [{card}]")
    c2, info2 = drive(f"sharded_spgemm_ring s14 D={d}",
                      lambda: sharded_spgemm_ring(mesh, sa, sa, out_cap=oc, plan=plan,
                                                  step_ents=ents), ())
    if not (np.array_equal(info["flops"].cpu().numpy(), shard_flops)
            and np.array_equal(info2["flops"].cpu().numpy(), shard_flops)
            and np.array_equal(info["nnz"].cpu().numpy(), shard_nnzc)):
        failed.append("sharded SpGEMM: per-shard flops or nnz(C) off the host's")
    for what, c in (("sharded_spgemm", c1), ("sharded_spgemm_ring", c2)):
        check_block(f"{what} s14 D={d} (unsharded)", *unshard_csr(c).to_numpy(), 0, n, 0, n)
    # bit-equal over calls, with no host read
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = sharded_spgemm(mesh, sa, sa, pc, oc)[0]
        ring2 = sharded_spgemm_ring(mesh, sa, sa, out_cap=oc, plan=plan, step_ents=ents)[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same = all(torch.equal(getattr(x, f), getattr(y, f)) for x, y in ((c1, again), (c2, ring2))
               for f in ("row_ptr", "col_ind", "values"))
    log(f"sharded_spgemm and sharded_spgemm_ring: a second call with no host read (sync "
        f"debug mode \"error\") {'==' if same else '!='} the first bit for bit")
    if not same:
        failed.append("sharded SpGEMM: a second call gave other bits")
    del again, ring2
    sh_ms = cuda_ms(torch, lambda: sharded_spgemm(mesh, sa, sa, pc, oc), reps=5, warm=1)
    ring_ms = cuda_ms(torch, lambda: _ring_impl(mesh, plan.step_prod_caps, sa, sa, ents, oc),
                      reps=5, warm=1)  # the eager body: phase 16 times the graph
    log(f"sharded_spgemm s14 D={d} warm: {sh_ms:.3f} ms; sharded_spgemm_ring {ring_ms:.3f} "
        f"ms, eager body (CUDA events, median of 5); peak device memory of the first call "
        f"{peak_spgemm / 2**30:.3f} GiB above its inputs [{card}]")
    del c1, c2, info, info2, plan, ents
    torch.cuda.synchronize()

    # ---- 13b. 2-D SpGEMM, (nx, ny) = (2, 2) --------------------------------
    nx = ny = 2
    mesh2 = make_mesh((nx, ny))
    b_rp, b_ci, b_v, stripe, b_rows = shard_csr_2d(a, nx, ny)
    sa2 = shard_csr(a, nx)
    lr2 = sa2.local_rows
    erow = np.repeat(np.arange(n), np.diff(rp))
    caps = []
    for y in range(ny):
        sel = (ci >= y * stripe) & (ci < (y + 1) * stripe)
        blen = np.bincount(erow[sel], minlength=n)
        rf_y = np.bincount(erow, weights=blen[ci], minlength=n).reshape(nx, lr2).sum(axis=1)
        nnz_y = [ps[x * lr2:(x + 1) * lr2, y * stripe:(y + 1) * stripe].nnz for x in range(nx)]
        caps += list(zip(rf_y.astype(np.int64).tolist(), nnz_y))
    pc2, oc2 = max(c for c, _ in caps), max(z for _, z in caps)
    blocks = drive(f"sharded_spgemm_2d s14 ({nx}, {ny})",
                   lambda: sharded_spgemm_2d(mesh2, sa2, b_rp, b_ci, b_v, stripe, b_rows, pc2,
                                             oc2), ())
    c_rp, c_ci, c_v = (x.cpu().numpy() for x in blocks)
    for x in range(nx):
        for y in range(ny):
            nz = int(c_rp[x, y, -1])
            check_block(f"sharded_spgemm_2d block [{x}, {y}]", c_rp[x, y], c_ci[x, y, :nz],
                        c_v[x, y, :nz], x * lr2, (x + 1) * lr2, y * stripe, (y + 1) * stripe)
    ms2 = cuda_ms(torch, lambda: sharded_spgemm_2d(mesh2, sa2, b_rp, b_ci, b_v, stripe, b_rows,
                                                   pc2, oc2), reps=5, warm=1)
    log(f"sharded_spgemm_2d s14 ({nx}, {ny}): product_cap {pc2} out_cap {oc2}; warm "
        f"{ms2:.3f} ms (CUDA events, median of 5) [{card}]")
    del blocks, b_rp, b_ci, b_v, sa2, sa, cm, am, ps, pat, amat
    torch.cuda.synchronize()

    # ---- 13c. dynamic sharded R-MCL against the single-card scan ---------
    g = rmat_csr(14, edge_factor=8, seed=7)  # phase 8's graph, unit weights
    grp, gci, gv = g.to_numpy()
    coo = COO.from_numpy(np.repeat(np.arange(n), np.diff(grp)), gci, gv, n, n,
                         capacity=gci.size + n, device=dev)
    mt0 = R.rmcl_init(coo)
    rf0 = row_flops(mt0, mt0).cpu().numpy()
    perm = flops_balanced_permutation(rf0, d)
    mtp = mt0.conjugate_permute(torch.from_numpy(perm))
    flops1, _ = spgemm_upper_bounds(mtp, mtp)
    smgt = shard_csr(mtp, d)
    margin = 4.0
    pcs, ccs = PR.plan_shard_capacities(smgt, flops1, margin=margin)
    smt = shard_csr(mtp, d, local_capacity=ccs)
    log(f"dynamic sharded R-MCL s14 D={d}: nnz {int(mtp.nnz)}, flops-balanced relabel; "
        f"iteration 1 flops {flops1}; margin {margin}: product_cap = c_cap = {pcs} a shard")
    iters = 3
    PR.sharded_rmcl_scan(mesh, smgt, smt, pcs, ccs, 1)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")  # any device-to-host read raises
    try:
        s.record()
        smt3, hist = drive(f"sharded_rmcl_scan s14 D={d} {iters} iterations",
                           lambda: PR.sharded_rmcl_scan(mesh, smgt, smt, pcs, ccs, iters),
                           ("cumsum_i32", "run_sums"))
        e.record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    e.synchronize()
    scan_ms = s.elapsed_time(e) / iters
    peak_scan = torch.cuda.max_memory_allocated() - base
    hist = {k: x.cpu().numpy() for k, x in hist.items()}
    check_digest("sharded_rmcl_scan", rmcl_digest(np, smt3, hist), failed)
    log(f"sharded_rmcl_scan s14 D={d}: no device-to-host read in {iters} steps; "
        f"{scan_ms:.3f} ms/iteration (CUDA events); flops {hist['flops'].tolist()} nnz "
        f"{hist['nnz_mt'].tolist()} overflow {hist['overflow'].tolist()} differs "
        f"{hist['differs'].tolist()}; peak device memory {peak_scan / 2**30:.3f} GiB above "
        f"its inputs [{card}]")
    if hist["overflow"].any():
        failed.append(f"sharded_rmcl_scan overflows at margin {margin}: raise the margin")
    ka = profile_kernels(torch, lambda: PR.sharded_rmcl_step(mesh, smgt, smt, pcs, ccs))
    log(f"sharded_rmcl_step s14 D={d} step 1 under torch.profiler: " + breakdown(ka, 6))
    no_cummax_kernel("phase 13", ka, failed)
    _, calls = capture_run_sums(lambda: PR.sharded_rmcl_step(mesh, smgt, smt, pcs, ccs))
    k9_cases(torch, f"sharded_rmcl_step s14 D={d} step 1", calls, record, cuda_ms, device_ms)
    del calls
    pc1, cc1 = R.plan_capacities(mtp, mtp, 2.5)
    one, h1 = R.rmcl_scan(mtp, mtp.with_capacity(cc1), pc1, cc1, iters)
    h1 = {k: x.cpu().numpy() for k, x in h1.items()}
    got, want = unshard_csr(smt3).to_numpy(), one.to_numpy()
    same = all(np.array_equal(x, y) for x, y in zip(got, want))
    diff_rel = np.abs(hist["differs"] - h1["differs"]) / np.abs(h1["differs"])
    log(f"sharded_rmcl_scan {'==' if same else '!='} the single-card rmcl_scan (margin 2.5, "
        f"cap {pc1}) bit for bit after {iters} iterations; nnz {h1['nnz'].tolist()} flops "
        f"{h1['flops'].tolist()}; differs relative gap {diff_rel.max():.3e}")
    if not same:
        # each shard's products for a row are the single card's, in the
        # same order, at another offset of the stream: K9 adds a run in
        # an order fixed by the run alone, so the bits must be equal
        struct = np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        if struct:
            rel = np.abs(got[2] - want[2]) / np.abs(want[2])
            log(f"  D = {d}: the structure is equal; {int((got[2] != want[2]).sum())} of "
                f"{got[2].size} values differ, max relative {rel.max():.3e}")
        failed.append("sharded_rmcl_scan differs from the single-card scan bit for bit")
    if not (np.array_equal(hist["nnz_mt"], h1["nnz"]) and np.array_equal(hist["flops"],
                                                                         h1["flops"])):
        failed.append("sharded_rmcl_scan: nnz or flops history off the single card's")
    if not (diff_rel <= 1e-6).all():
        failed.append("sharded_rmcl_scan: differs off the single card's by more than 1e-6")
    del smt3, one, smgt, smt, mtp, ka
    torch.cuda.synchronize()

    # ---- 13d. adaptive sharded R-MCL against the single-card loop --------
    lr = -(-n // d)
    pca = max(16, int(np.ceil(int(rf0.sum()) / d * 2.0)))
    lcap_t = max(pca, int(mt0.capacity))
    smgt = shard_csr(mt0, d, local_capacity=lcap_t)
    smt = shard_csr(mt0, d, local_capacity=lcap_t)
    rfb = torch.from_numpy(rf0.astype(np.int32).reshape(d, lr)).to(dev)
    rep = PR._device_repartition_pair(mesh, smgt, smt, rfb, n)
    perm_dev = rep[2].cpu().numpy()
    perm_np = snake_perm_np(np, rf0, n, d, lr)
    same = np.array_equal(perm_dev, perm_np) and np.array_equal(
        perm_dev[perm_dev < n], flops_balanced_permutation(rf0, d))
    log(f"_snake_perm_device of iteration 1 {'==' if same else '!='} its numpy recomputation "
        f"(and the host's flops_balanced_permutation) index for index; spread after "
        f"{float(rep[4]):.4f}, overflow {bool(rep[3])}")
    if not same:
        failed.append("the device snake permutation differs from numpy's")
    rep_ms = cuda_ms(torch, lambda: PR._device_repartition_pair(mesh, smgt, smt, rfb, n),
                     reps=5, warm=1)
    del rep, smgt, smt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, ah = drive(f"sharded_rmcl_adaptive s14 D={d} {iters} iterations",
                    lambda: PR.sharded_rmcl_adaptive(mt0, mesh, max_iters=iters), ())
    torch.cuda.synchronize()
    ad_ms = (time.perf_counter() - t0) * 1e3 / iters
    log(f"sharded_rmcl_adaptive s14 D={d}: {ad_ms:.3f} ms/iteration (host clock, set-up and "
        f"the final unshard included); one repartition {rep_ms:.3f} ms (CUDA events, median "
        f"of 5); rebalanced {ah['rebalanced'].tolist()} spread_before "
        f"{[round(float(x), 4) for x in ah['spread_before']]} spread_after "
        f"{[round(float(x), 4) for x in ah['spread_after']]} nnz {ah['nnz'].tolist()} "
        f"overflow {ah['overflow'].tolist()} [{card}]")
    if ah["overflow"].any():
        failed.append("sharded_rmcl_adaptive overflows")
    loop = R.rmcl(mt0, max_iters=iters, mode="loop")
    rp0, ci0, v0 = mt0.to_numpy()
    a64 = sp.csr_matrix((v0.astype(np.float64), ci0, rp0), shape=mt0.shape)
    prev = a64
    near = np.zeros(n, bool)
    for _ in range(iters):
        prev, nr = general_oracle_step(np, sp, a64, prev)
        near |= nr
    grp, gci, gv = out.to_numpy()
    lrp, lci, lv = loop.mt.to_numpy()
    failed += compare_csr(
        np, f"sharded_rmcl_adaptive vs single-card rmcl loop ({iters} iterations)",
        sp.csr_matrix((gv, gci, grp), shape=mt0.shape),
        sp.csr_matrix((lv, lci, lrp), shape=mt0.shape), near, tol=1e-5)
    if not np.allclose(ah["differs"], loop.differs_history, rtol=1e-3, atol=1e-5):
        failed.append("sharded_rmcl_adaptive: differs history off the single-card loop's")
    del out, loop, mt0, coo
    torch.cuda.synchronize()

    # ---- 13e. the multi-shard dry run --------------------------------------
    drive("dryrun_multichip(4)", lambda: dryrun_multichip(4), ())
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s; peak device memory above the "
        f"inputs: sharded_spgemm {peak_spgemm / 2**30:.3f} GiB, sharded_rmcl_scan "
        f"{peak_scan / 2**30:.3f} GiB [{card}]")
    if failed:
        raise AssertionError("phase 13: " + "; ".join(failed))


# ---- 15. one rank a process ------------------------------------------------------
EXCHANGES = ("all_gather", "pallas_ring", "ring", "fused_ring")
# the kernels a process-mesh run of each exchange must launch on the card
# (K6 in each: the statistics' sums and, but for pallas_ring's own K6,
# the exchange take the peer route)
EXCHANGE_KERNELS = {
    "all_gather": ("ring_all_gather", "sort_dedup_compact"),
    "pallas_ring": ("ring_all_gather", "sort_dedup_compact"),
    "ring": ("ring_all_gather", "sort_dedup_compact"),
    "fused_ring": ("ring_all_gather", "ring_matmul_tiled", "sort_dedup_compact"),
}
RANK_LIMIT_S = {"a": 300, "b": 360, "c": 360}  # a phase 15 group's wall clock
# how each group's per-rank times are labelled
RANK_LABEL = {"a": "world size 1 under NCCL, one card",
              "b": "two processes time-sharing one card, not a cross-card figure",
              "c": "one card a rank, across cards"}
S15, MT15 = 128, 8192  # phase 8's S and max_tile
DYN_MARGIN, DYN_ITERS = 4.0, 3  # phase 13's scan: margin on iteration 1's flops / D


def kernel_wrappers() -> dict:
    """The wrapper of every kernel, by name, in ``SOURCES``' order (each
    counts its launches): the registry the kernel modules fill as the
    package imports them."""
    import sparse_matrix_with_flops_tpu_torch  # noqa: F401  (imports every kernel module)
    from sparse_matrix_with_flops_tpu_torch._build import WRAPPERS

    by_name = {w.__name__: w for w in WRAPPERS}
    return {k: by_name[k] for k in SOURCES}


def phase8_graph(torch, np, dev):
    """Phase 8's R-MCL input: R-MAT s14 (edge factor 8, seed 7, unit
    weights) as a COO on ``dev``, its ``rmcl_init`` and S-wide ELL."""
    from sparse_matrix_with_flops_tpu_torch.formats import COO
    from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl_init
    from sparse_matrix_with_flops_tpu_torch.models.rmcl_ell import mt_to_ell
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    g = rmat_csr(14, edge_factor=8, seed=7, device=dev)
    grp, gci, gv = g.to_numpy()
    n = g.rows
    coo = COO.from_numpy(np.repeat(np.arange(n), np.diff(grp)), gci, gv, n, n,
                         capacity=gci.size + n, device=dev)
    mgt = rmcl_init(coo).make_ordered()
    cols0, vals0 = mt_to_ell(mgt, S15)
    return coo, mgt, cols0, vals0


def rmcl_digest(np, out, hist) -> str:
    """SHA-256 of an R-MCL result's CSR arrays and statistics: equal
    digests mean bit-equal results."""
    import hashlib

    h = hashlib.sha256()
    for t in (out.row_ptr, out.col_ind, out.values):
        h.update(t.cpu().numpy().tobytes())
    for k in sorted(hist):
        h.update(k.encode())
        h.update(np.ascontiguousarray(hist[k]).tobytes())
    return h.hexdigest()


def hist_np(hist) -> dict:
    return {k: x.cpu().numpy() for k, x in hist.items()}


def stream_digests(torch, np, dev) -> dict:
    """Digests of the three stream paths' results as phases 11-13 run
    them: the general ``rmcl_scan`` on phase 8's graph at margin 2.5 (5
    iterations, its iterate and histories), ``spgemm_binned`` of phase
    4's s14 (C), and the dynamic ``sharded_rmcl_scan`` at D = 4 (3
    iterations at margin 4.0 on the flops-balanced relabel)."""
    import importlib

    from sparse_matrix_with_flops_tpu_torch.ops import binned as BN
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    R = importlib.import_module(f"{PKG}.models.rmcl")
    coo = phase8_graph(torch, np, dev)[0]
    mt0 = R.rmcl_init(coo)
    pc, cc = R.plan_capacities(mt0, mt0, 2.5)
    out, hist = R.rmcl_scan(mt0.deep_copy(), mt0.with_capacity(cc), pc, cc, 5)
    got = {"general rmcl_scan": rmcl_digest(np, out, hist_np(hist))}
    a = rmat_csr(14, edge_factor=8, seed=7, weights="random", device=dev)
    c = BN.spgemm_binned(a, a, BN.plan_bins(a, a))
    got["spgemm_binned"] = block_digest(np, c.row_ptr, c.col_ind, c.values)
    del out, c
    mesh, smgt, smt, pcs, ccs = dynamic_scan_inputs(torch, np, dev, mt0, 4)
    PR = importlib.import_module(f"{PKG}.parallel.rmcl")
    out, hist = PR.sharded_rmcl_scan(mesh, smgt, smt, pcs, ccs, 3)
    got["sharded_rmcl_scan"] = rmcl_digest(np, out, hist_np(hist))
    return got


def dynamic_scan_inputs(torch, np, dev, mt0, d: int, margin: float = 4.0):
    """Phase 13's dynamic scan inputs from ``rmcl_init`` of phase 8's
    graph: the mesh, the flops-balanced relabel sharded (Mgt, and Mt at
    the shard capacity) and the per-shard caps of ``margin``."""
    import importlib

    from sparse_matrix_with_flops_tpu_torch.ops.flops import row_flops
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_upper_bounds
    from sparse_matrix_with_flops_tpu_torch.parallel import (
        flops_balanced_permutation,
        make_mesh,
        shard_csr,
    )

    PR = importlib.import_module(f"{PKG}.parallel.rmcl")
    perm = flops_balanced_permutation(row_flops(mt0, mt0).cpu().numpy(), d)
    mtp = mt0.conjugate_permute(torch.from_numpy(perm))
    flops1, _ = spgemm_upper_bounds(mtp, mtp)
    smgt = shard_csr(mtp, d)
    pcs, ccs = PR.plan_shard_capacities(smgt, flops1, margin=margin)
    return make_mesh(d, dev), smgt, shard_csr(mtp, d, local_capacity=ccs), pcs, ccs


def check_digest(label: str, got: str, failed: list) -> None:
    """Log a path's digest; fail where the tree before the change gave
    another."""
    want = DIGESTS_BEFORE.get(label)
    verdict = ("no digest recorded before the change" if want is None else
               "== the digest before the change" if got == want else
               f"!= the digest before the change, {want}")
    log(f"digest {label}: {got} ({verdict})")
    if want is not None and got != want:
        failed.append(f"{label}: other bits than before the change")


class RepeatSegmentsSpy:
    """Within ``with``: every ``repeat_segments`` call of the port's
    callers runs as it would, and the first call of each caller keeps a
    copy of its inputs (copies on the device: no host read)."""

    def __init__(self):
        import importlib

        self.mods = [importlib.import_module(f"{PKG}.{m}") for m in REPEAT_CALLERS]
        self.calls = {}

    def __enter__(self):
        self.saved = [m.repeat_segments for m in self.mods]
        for m, fn in zip(self.mods, self.saved):
            def spy(starts, valid, total, _name=m.__name__, _fn=fn):
                if _name not in self.calls:
                    self.calls[_name] = (starts.clone(), valid.clone(), total)
                return _fn(starts, valid, total)
            m.repeat_segments = spy
        return self

    def __exit__(self, *exc):
        for m, fn in zip(self.mods, self.saved):
            m.repeat_segments = fn


def check_last_marked(torch, phase: str, calls: dict, failed: list) -> None:
    """``last_marked`` against ``repeat_segments_plain`` (max-scatter and
    running max) on each captured caller's input, element for element."""
    from sparse_matrix_with_flops_tpu_torch.ops.segments import (
        last_marked,
        repeat_segments_plain,
    )

    if not calls:
        failed.append(f"{phase}: no repeat_segments call on the path")
    for name, (starts, valid, total) in calls.items():
        same = torch.equal(last_marked(starts, valid, total),
                           repeat_segments_plain(starts, valid, total))
        log(f"{phase}: last_marked {'==' if same else '!='} repeat_segments_plain on "
            f"{name.rsplit('.', 2)[-2]}.{name.rsplit('.', 1)[-1]}'s input ({starts.shape[0]} "
            f"segments, {int(valid.sum())} valid, {total} slots)")
        if not same:
            failed.append(f"{phase}: last_marked differs from repeat_segments_plain on "
                          f"{name}'s input")


def cummax_calls(torch, fn):
    """``fn()`` with ``torch.cummax`` counting its calls: (result, calls)."""
    real, n = torch.cummax, [0]

    def spy(*a, **k):
        n[0] += 1
        return real(*a, **k)

    torch.cummax = spy
    try:
        return fn(), n[0]
    finally:
        torch.cummax = real


def no_cummax_kernel(phase: str, ka, failed: list) -> None:
    """Fail where torch.cummax's scan kernel shows in a path's device
    breakdown (``profile_kernels``)."""
    ran = [k.key for k in ka if CUMMAX_KERNEL in k.key]
    log(f"{phase}: torch.cummax's scan kernel {'in' if ran else 'not in'} the device "
        f"breakdown")
    if ran:
        failed.append(f"{phase}: torch.cummax's kernel ran on the path")


def stream_phase(torch, phase: str, fn):
    """Run one of phases 11-13 with every ``repeat_segments`` caller's
    first input kept and ``torch.cummax`` counted; then ``last_marked``
    against its plain version on each kept input.  Fails where the
    phase called ``torch.cummax``."""
    failed = []
    with RepeatSegmentsSpy() as spy:
        out, calls = cummax_calls(torch, fn)
    log(f"{phase}: torch.cummax called {calls} times")
    if calls:
        failed.append(f"torch.cummax called {calls} times")
    check_last_marked(torch, phase, spy.calls, failed)
    if failed:
        raise AssertionError(f"{phase}: " + "; ".join(failed))
    return out


def same_sharded(torch, x, y) -> bool:
    return all(torch.equal(getattr(x, f), getattr(y, f))
               for f in ("row_ptr", "col_ind", "values"))


def block_digest(np, *arrays) -> str:
    """SHA-256 of tensors' or arrays' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for x in arrays:
        h.update(x.cpu().numpy().tobytes() if hasattr(x, "cpu") else
                 np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def shapes_2d(d: int) -> list:
    """The 2-D meshes phase 15 runs at D shards."""
    return [(1, 1)] if d == 1 else [(d, 1), (1, d)] + ([(2, 2)] if d == 4 else [])


def caps_2d(np, a, nx: int, ny: int) -> int:
    """The most products of one block of A·A on an (nx, ny) mesh (A's row
    block x against B's column stripe y): the product and output
    capacity a block."""
    rp, ci, _ = a.to_numpy()
    n = a.rows
    lr, stripe = -(-n // nx), -(-a.ncols // ny)
    erow = np.repeat(np.arange(n), np.diff(rp))
    most = 1
    for y in range(ny):
        sel = (ci >= y * stripe) & (ci < (y + 1) * stripe)
        blen = np.bincount(erow[sel], minlength=n)
        rf = np.bincount(erow, weights=blen[ci], minlength=n)
        per = np.concatenate([rf, np.zeros(nx * lr - n)]).reshape(nx, lr).sum(axis=1)
        most = max(most, int(per.max()))
    return most


def dynamic_paths(torch, np, mesh, run, mesh_2d, reads=None) -> dict:
    """Phase 15's dynamic paths on ``mesh`` (the stacked reference, or a
    rank's process mesh), at phase 13's sizes: ``sharded_rmcl_scan`` (3
    iterations, phase 8's graph relabelled by the flops-balanced
    permutation, DYN_MARGIN of iteration 1's flops a shard),
    ``sharded_rmcl_adaptive`` (natural layout, 3 iterations),
    ``sharded_spgemm_2d`` of phase 4's s14 on each of ``shapes_2d(D)``
    (``mesh_2d(shape)`` makes the mesh) and ``dryrun_multichip``.
    ``run(label, fn, must)`` calls each (counted and timed in a rank).
    Returns {path: {shard: SHA-256}} for the shards this process holds;
    with ``reads``, whether the scan reads the card from the host."""
    from sparse_matrix_with_flops_tpu_torch.formats import COO
    from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl_init
    from sparse_matrix_with_flops_tpu_torch.ops.flops import row_flops
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_upper_bounds
    from sparse_matrix_with_flops_tpu_torch.parallel import (
        collectives,
        dryrun_multichip,
        flops_balanced_permutation,
        plan_shard_capacities,
        shard_csr,
        shard_csr_2d,
        sharded_rmcl_adaptive,
        sharded_rmcl_scan,
        sharded_spgemm_2d,
    )
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    d, dev = mesh.num_shards, mesh.device
    held = collectives.local_ranks(mesh)
    out = {}
    g = rmat_csr(14, edge_factor=8, seed=7, device=dev)  # phase 8's graph
    grp, gci, gv = g.to_numpy()
    n = g.rows
    mt0 = rmcl_init(COO.from_numpy(np.repeat(np.arange(n), np.diff(grp)), gci, gv, n, n,
                                   capacity=gci.size + n, device=dev))
    perm = flops_balanced_permutation(row_flops(mt0, mt0).cpu().numpy(), d)
    mtp = mt0.conjugate_permute(torch.from_numpy(perm))
    flops1, _ = spgemm_upper_bounds(mtp, mtp)
    smgt = shard_csr(mtp, mesh)
    pcs, ccs = plan_shard_capacities(smgt, flops1, margin=DYN_MARGIN)
    smt = shard_csr(mtp, mesh, local_capacity=ccs)

    def scan():
        return sharded_rmcl_scan(mesh, smgt, smt, pcs, ccs, DYN_ITERS)

    new, hist = run(f"sharded_rmcl_scan s14 D={d} {DYN_ITERS} iterations, cap {pcs} a shard",
                    scan, ("run_sums",))
    stats = block_digest(np, *(hist[k] for k in sorted(hist)))
    out["sharded_rmcl_scan"] = {
        str(me): block_digest(np, new.row_ptr[i], new.col_ind[i], new.values[i]) + stats
        for i, me in enumerate(held)}
    if reads is not None:
        reads["sharded_rmcl_scan"] = host_reads(torch, scan)
    del new, hist, smgt, smt, mtp
    res, ah = run(f"sharded_rmcl_adaptive s14 D={d} {DYN_ITERS} iterations",
                  lambda: sharded_rmcl_adaptive(mt0, mesh, max_iters=DYN_ITERS), ("run_sums",))
    out["sharded_rmcl_adaptive"] = {str(me): rmcl_digest(np, res, ah) for me in held}
    out["perm_total"] = {str(me): block_digest(np, ah["perm_total"]) for me in held}
    del res, mt0
    a = rmat_csr(14, edge_factor=8, seed=7, weights="random", device=dev)  # phase 4's s14
    for nx, ny in shapes_2d(d):
        m2 = mesh_2d((nx, ny))
        cap = caps_2d(np, a, nx, ny)
        b = shard_csr_2d(a, nx, ny, mesh=m2)
        sa = shard_csr(a, m2)
        c = run(f"sharded_spgemm_2d s14 ({nx}, {ny}), cap {cap} a block",
                lambda m2=m2, sa=sa, b=b, cap=cap: sharded_spgemm_2d(m2, sa, *b, cap, cap),
                ("run_sums",))
        blocks = ([m2.coords()] if collectives.is_process(m2) else
                  [(x, y) for x in range(nx) for y in range(ny)])
        out[f"sharded_spgemm_2d ({nx}, {ny})"] = {
            str(x * ny + y): block_digest(np, *(t[x - blocks[0][0], y - blocks[0][1]]
                                                for t in c))
            for x, y in blocks}
        del c, b, sa
    dry = run(f"dryrun_multichip() D={d}", lambda: dryrun_multichip(mesh),
              ("sort_dedup_compact", "run_sums"))
    out["dryrun_multichip"] = {str(me): repr(dry) for me in held}
    return out


def rank_child(argv) -> int:
    """One rank of phase 15 (``chip_smoke.py --rank-child MODE RANK WORLD
    DIR``): joins the group through DIR's file store and writes its
    report to DIR/rank<r>.json.  MODE a: world size 1 under NCCL; b: two
    processes on one card under gloo; c: one card a rank under NCCL."""
    import datetime
    import traceback

    import torch

    mode, rank, world, work = argv[0], int(argv[1]), int(argv[2]), argv[3]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; refusing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.distributed as dist

    from sparse_matrix_with_flops_tpu_torch.parallel import mesh as M
    from sparse_matrix_with_flops_tpu_torch.parallel import peer

    rep = {"runs": [], "digests": {}, "records": [], "failed": [], "log": []}
    try:
        M.init_distributed(backend="gloo" if mode == "b" else "nccl",
                           init_method=f"file://{os.path.join(work, 'store')}", rank=rank,
                           world_size=world, timeout=datetime.timedelta(seconds=150))
        mesh = M.process_mesh() if world == 1 else M.make_mesh()
        if mesh.device.type != "cuda" or not isinstance(mesh, M.ProcessMesh):
            raise AssertionError(f"rank {rank}: {mesh} is not a process mesh on a card")
        wrappers = kernel_wrappers()

        def counted(label, fn, must=(), path=True):
            """A main-path run: every count 0 just before, read just after."""
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
            counts = {k: w.launches for k, w in wrappers.items()}
            rep["runs"].append({"label": label, "counts": counts, "path": path})
            rep["log"].append(f"{label}: launches {counts}")
            for k in must:
                if not counts[k]:
                    rep["failed"].append(f"{label} launched {k} no time")
            return out

        def timed(label, fn, must=()):
            """A counted run, with its wall time and its peak device memory."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = counted(label, fn, must)
            rep["log"].append(
                f"15{mode} rank {rank} {label}: {time.perf_counter() - t0:.3f} s wall, peak "
                f"device memory {(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB "
                f"above its inputs ({RANK_LABEL[mode]})")
            return out

        coo, mgt, cols0, vals0 = phase8_graph(torch, np, mesh.device)
        if mode == "a":
            child_world_one(torch, np, mesh, rep, counted, coo, mgt, cols0, vals0)
            child_graphs(torch, np, mesh, rep, counted, mgt, cols0, vals0, mode)
            want = graph_digests(torch, np, mesh.device, mgt, cols0, vals0, 1)
            check_graph_reports(f"15{mode}", [rep], want, rep["failed"], rep["log"].append)
            del coo, mgt, cols0, vals0
            child_dynamic_one(torch, np, mesh, rep, timed)
        else:
            child_rmcl(torch, np, mesh, rep, counted, coo, mode)
            child_kernels(torch, np, mesh, rep, counted, mgt, cols0, vals0, mode)
            child_graphs(torch, np, mesh, rep, counted, mgt, cols0, vals0, mode)
            del coo, mgt, cols0, vals0
            torch.cuda.empty_cache()
            rep["dynamic"] = dynamic_paths(torch, np, mesh, timed, M.make_mesh)
            if mode == "c":
                from sparse_matrix_with_flops_tpu_torch.parallel import weak_scaling_rmcl_ell

                for row in timed("weak scaling, process group, R-MAT base scale 14",
                                 lambda: weak_scaling_rmcl_ell(base_scale=14),
                                 ("sort_dedup_compact",)):
                    rep["log"].append(f"15c rank {rank} weak scaling: {json.dumps(row)}")
        peer.close_all()
        dist.destroy_process_group()
    except Exception:  # the report carries the failure; the exit code says it
        rep["failed"].append(f"rank {rank}: " + traceback.format_exc()[-3000:])
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    return 1 if rep["failed"] else 0


def host_reads(torch, fn) -> bool:
    """Whether ``fn`` reads the card from the host (sync debug mode
    "error" raises on the first such read)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return False
    except RuntimeError as e:
        if "synchroniz" not in str(e).lower():
            raise
        return True
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def child_world_one(torch, np, mesh, rep, counted, coo, mgt, cols0, vals0):
    """15(a): world size 1 under NCCL, each path bit-equal to the stacked
    D = 1 path, and no host read where the stacked path makes none."""
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_upper_bounds
    from sparse_matrix_with_flops_tpu_torch.parallel import (
        make_mesh,
        plan_sharded_rmcl_ell,
        shard_csr,
        sharded_rmcl_ell,
        sharded_rmcl_ell_scan,
        sharded_spgemm,
        sharded_spgemm_ring,
    )
    from sparse_matrix_with_flops_tpu_torch.parallel.spgemm import plan_spgemm_ring
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    stacked = make_mesh(1, mesh.device)  # a group of one rank: the stacked mesh
    if type(stacked) is type(mesh):
        raise AssertionError("make_mesh(1) under a one-rank group is not the stacked mesh")
    a = rmat_csr(14, edge_factor=8, seed=7, weights="random")  # phase 4's s14
    pc, oc = spgemm_upper_bounds(a, a)
    sp_, ss = shard_csr(a, mesh), shard_csr(a, stacked)
    runs = {}
    runs["spgemm"] = (
        counted("sharded_spgemm s14 W=1 process mesh (NCCL)",
                lambda: sharded_spgemm(mesh, sp_, sp_, pc, oc)[0]),
        sharded_spgemm(stacked, ss, ss, pc, oc)[0])
    plan_p, ents_p = plan_spgemm_ring(sp_, sp_, mesh)
    plan_s, ents_s = plan_spgemm_ring(ss, ss)
    runs["spgemm_ring"] = (
        counted("sharded_spgemm_ring s14 W=1 process mesh (NCCL)",
                lambda: sharded_spgemm_ring(mesh, sp_, sp_, out_cap=oc, plan=plan_p,
                                            step_ents=ents_p)[0]),
        sharded_spgemm_ring(stacked, ss, ss, out_cap=oc, plan=plan_s, step_ents=ents_s)[0])
    for what, (x, y) in runs.items():
        same = same_sharded(torch, x, y)
        rep["log"].append(f"15a {what} s14: process mesh (W=1, NCCL) {'==' if same else '!='} "
                          f"stacked D=1 bit for bit; nnz(C) {int(x.row_ptr[0, -1])}")
        if not same:
            rep["failed"].append(f"15a {what}: differs from the stacked D=1 path")
    reads = {
        "sharded_spgemm": (
            host_reads(torch, lambda: sharded_spgemm(stacked, ss, ss, pc, oc)),
            host_reads(torch, lambda: sharded_spgemm(mesh, sp_, sp_, pc, oc))),
        "sharded_spgemm_ring": (
            host_reads(torch, lambda: sharded_spgemm_ring(stacked, ss, ss, out_cap=oc,
                                                          plan=plan_s, step_ents=ents_s)),
            host_reads(torch, lambda: sharded_spgemm_ring(mesh, sp_, sp_, out_cap=oc,
                                                          plan=plan_p, step_ents=ents_p))),
    }
    del runs, sp_, ss, plan_p, ents_p, plan_s, ents_s
    n = mgt.rows
    for ex in EXCHANGES:
        got = counted(f"sharded_rmcl_ell s14 W=1 {ex} 3 iterations process mesh (NCCL)",
                      lambda ex=ex: sharded_rmcl_ell(coo, mesh, max_iters=3, S=S15,
                                                     max_tile=MT15, exchange=ex),
                      EXCHANGE_KERNELS[ex])
        want = sharded_rmcl_ell(coo, stacked, max_iters=3, S=S15, max_tile=MT15, exchange=ex)
        same = rmcl_digest(np, *got) == rmcl_digest(np, *want)
        rep["log"].append(f"15a sharded_rmcl_ell {ex}: process mesh (W=1, NCCL) "
                          f"{'==' if same else '!='} stacked D=1 bit for bit (iterate and "
                          f"stats); nnz {got[1]['nnz'].tolist()} differs "
                          f"{got[1]['differs'].tolist()}")
        if not same:
            rep["failed"].append(f"15a sharded_rmcl_ell {ex}: differs from the stacked D=1 path")
        # the scan, warm, with and without the process group's collectives
        scans = []
        for m in (stacked, mesh):
            plan, arrays, smgt = plan_sharded_rmcl_ell(mgt, 1, S=S15, max_tile=MT15, mesh=m)
            c0 = torch.where(cols0 >= n, plan.n, cols0).reshape(1, plan.lr, S15)
            v0 = vals0.reshape(1, plan.lr, S15)

            def scan(m=m, plan=plan, arrays=arrays, smgt=smgt, c0=c0, v0=v0):
                return sharded_rmcl_ell_scan(m, plan, smgt, arrays, c0, v0, 2, ex)

            scan()
            scans.append(host_reads(torch, scan))
        reads[f"sharded_rmcl_ell_scan {ex}"] = tuple(scans)
    for what, (s_read, p_read) in reads.items():
        rep["log"].append(f"15a {what}: host read under sync debug mode 'error': stacked "
                          f"{'yes' if s_read else 'none'}, process mesh "
                          f"{'yes' if p_read else 'none'}")
        if p_read and not s_read:
            rep["failed"].append(f"15a {what}: the process mesh reads the card from the host "
                                 f"where the stacked path does not")


def child_dynamic_one(torch, np, mesh, rep, timed):
    """15(a): the dynamic scan, the adaptive loop, the 2-D SpGEMM on a
    (1, 1) process mesh and the dry run at world size 1, each bit-equal
    to the stacked D = 1 path; the scan makes no host read."""
    from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh, process_mesh

    stacked = make_mesh(1, mesh.device)
    reads_p, reads_s = {}, {}
    got = dynamic_paths(torch, np, mesh, timed, lambda s: process_mesh(shape=s), reads_p)
    want = dynamic_paths(torch, np, stacked, lambda label, fn, must: fn(),
                         lambda s: make_mesh(s, mesh.device), reads_s)
    for path, by_shard in want.items():
        same = got[path] == by_shard
        rep["log"].append(f"15a {path}: process mesh (W=1, NCCL) {'==' if same else '!='} "
                          f"stacked D=1 bit for bit")
        if not same:
            rep["failed"].append(f"15a {path}: differs from the stacked D=1 path")
    rep["log"].append(f"15a sharded_rmcl_scan: host read under sync debug mode 'error': "
                      f"stacked {'yes' if reads_s['sharded_rmcl_scan'] else 'none'}, process "
                      f"mesh {'yes' if reads_p['sharded_rmcl_scan'] else 'none'}")
    if reads_p["sharded_rmcl_scan"]:
        rep["failed"].append("15a sharded_rmcl_scan: the process mesh reads the card from the "
                             "host")


def child_rmcl(torch, np, mesh, rep, counted, coo, mode):
    """15(b) / (c): ``sharded_rmcl_ell`` on phase 8's graph, 3 iterations,
    each exchange on the process mesh; the digests go to the parent."""
    from sparse_matrix_with_flops_tpu_torch.parallel import sharded_rmcl_ell

    tag = "two processes on one card (gloo)" if mode == "b" else "one card a rank (NCCL)"
    for ex in EXCHANGES:
        t0 = time.perf_counter()
        out = counted(f"sharded_rmcl_ell s14 D={mesh.num_shards} {ex} 3 iterations, {tag}",
                      lambda ex=ex: sharded_rmcl_ell(coo, mesh, max_iters=3, S=S15,
                                                     max_tile=MT15, exchange=ex),
                      EXCHANGE_KERNELS[ex])
        wall = time.perf_counter() - t0
        rep["digests"][ex] = rmcl_digest(np, *out)
        rep["log"].append(f"15{mode} rank {mesh.rank} {ex}: {wall:.3f} s with plan "
                          f"({RANK_LABEL[mode]}); nnz "
                          f"{out[1]['nnz'].tolist()} differs {out[1]['differs'].tolist()}")


def child_kernels(torch, np, mesh, rep, counted, mgt, cols0, vals0, mode):
    """15(b) / (c): per-rank K6, K7 and K8 at phase 9's shapes for the
    group's D against their plain versions (the twins over the group's
    all-gather), timed under the group's label."""
    import torch.distributed as dist

    from sparse_matrix_with_flops_tpu_torch.parallel import collectives as C
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
    )

    d, me, n = mesh.num_shards, mesh.rank, mgt.rows
    rows = slice(me, me + 1)
    label, backend = RANK_LABEL[mode], dist.get_backend()

    def add(name, case, err, ms, plain_ms, kb, library, call=None):
        rep["records"].append({
            "name": name, "case": f"{case}, rank {me} [{label}]", "err": err, "ms": ms,
            "plain_ms": plain_ms, "bound": list(kb), "library": library, "call": call})
        rep["log"].append(f"15{mode} rank {me} {name} [{case}]: max_abs_err {err:.3e} kernel "
                          f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {kb[0]:.4f} ms ({kb[1]}) "
                          f"library {library if isinstance(library, str) else f'{library:.4f} ms'}"
                          f" [{label}]")

    def burst(what, fn, check, calls=20):
        outs = [fn() for _ in range(calls)]
        torch.cuda.synchronize()
        for o in outs:
            check(o)
        rep["log"].append(f"15{mode} rank {me} {what}: {calls} back-to-back calls pass the check")

    # K6 on this rank's [lr, 128] iterate block, cols and vals in one call
    xc = cols0.reshape(d, n // d, S15)[rows].contiguous()
    xv = vals0.reshape(d, n // d, S15)[rows].contiguous()
    want = (ring_all_gather_plain(xc, mesh), ring_all_gather_plain(xv, mesh))

    def k6_same(got):
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"per-rank K6 D={d}: differs from the twin")

    k6_same(ring_all_gather(xc, xv, mesh=mesh))
    burst(f"per-rank K6 D={d}", lambda: ring_all_gather(xc, xv, mesh=mesh), k6_same)
    gathered = [torch.empty((d, *x.shape[1:]), dtype=x.dtype, device=x.device) for x in (xc, xv)]
    full = 2 * d * (xc[0].numel() + xv[0].numel()) * 4  # every block in, every block out
    add("ring_all_gather", f"one rank a launch D={d} [{n // d}, {S15}] int32 + f32", 0.0,
        cuda_ms(torch, lambda: ring_all_gather(xc, xv, mesh=mesh)),
        cuda_ms(torch, lambda: (ring_all_gather_plain(xc, mesh),
                                ring_all_gather_plain(xv, mesh))),
        bound(full),
        cuda_ms(torch, lambda: [dist.all_gather_into_tensor(o, x)
                                for o, x in zip(gathered, (xc, xv))]),
        f"torch.distributed.all_gather_into_tensor ({backend}) of the cols and of the vals, "
        "owner-major")
    # K7 / K8 on this rank's hub operands
    sp_, arrays, _ = plan_sharded_rmcl_ell(mgt, d, S=S15, max_tile=MT15, mesh=mesh)
    lc = torch.where(cols0 >= n, sp_.n, cols0).reshape(d, sp_.lr, S15)[rows]
    lv = vals0.reshape(d, sp_.lr, S15)[rows]
    a_cols, md_loc, nt = fused_hub_operands(sp_, arrays, lc, lv, mesh)
    full_b = C.all_gather(mesh, md_loc).reshape(-1, md_loc.shape[2])
    tol = 1e-7 + 1e-4 * (a_cols[0].abs() @ full_b.abs())
    m, k, npad = a_cols.shape[1], a_cols.shape[2], md_loc.shape[2]
    gf = 2.0 * m * k * npad
    kb = bound(4.0 * (a_cols.numel() + full_b.numel() + m * npad), gf)
    lib_ms = cuda_ms(torch, lambda: torch.matmul(a_cols[0], full_b))
    for name, fk, fp in (
        ("ring_matmul", lambda: ring_matmul(a_cols, md_loc, mesh=mesh),
         lambda: ring_matmul_plain(a_cols, md_loc, mesh)),
        ("ring_matmul_tiled", lambda: ring_matmul_tiled(a_cols, md_loc, nt, mesh=mesh),
         lambda: ring_matmul_tiled_plain(a_cols, md_loc, nt, mesh)),
    ):
        got, p = fk(), fp()
        torch.cuda.synchronize()

        def close(x, name=name, p=p):
            e = (x - p).abs()
            if not bool(torch.isfinite(x).all()) or not bool((e <= tol).all()):
                raise AssertionError(f"per-rank {name} D={d}: differs from the twin "
                                     f"(max err {float(e.max()):.3e})")

        close(got)
        burst(f"per-rank {name} D={d}", fk, close)
        add(name, f"one rank a launch D={d} M={m} lr={md_loc.shape[1]} N={npad} "
            f"nt={nt if 'tiled' in name else npad}", float((got - p).abs().max()),
            cuda_ms(torch, fk), cuda_ms(torch, fp), kb, lib_ms,
            "torch.matmul(a_cols[rank], all-gathered B) (true f32)")
        if name == "ring_matmul":  # B7 is on no path of the reference: a direct call
            counted(f"per-rank ring_matmul D={d} on the hub operands", fk, ("ring_matmul",),
                    path=False)


def scan_lengths() -> tuple:
    """Phase 15's process-mesh scan lengths: a call one short of the
    program's break-even count B (it stays eager) and a call of B on the
    same plan (it captures at its first iteration, the plan's eager runs
    and its own reaching B)."""
    from sparse_matrix_with_flops_tpu_torch.utils import graphs

    b = max(graphs.BREAK_EVEN["sharded_rmcl_ell_scan_process"], 2)
    return b - 1, b


def scan_block_digest(np, cols, vals, hist, r: int) -> str:
    """Digest of rank ``r``'s iterate block of a held [L, lr, S] iterate
    (L = 1: this rank's; r indexes the stack) and the histories."""
    return block_digest(np, cols[r:r + 1], vals[r:r + 1], *(hist[k] for k in sorted(hist)))


def graph_digests(torch, np, dev, mgt, cols0, vals0, d: int) -> dict:
    """The stacked D = d path's digests of what phase 15's process-mesh
    programs compute, one a rank: the static scan of ``scan_lengths()[1]``
    iterations with each exchange (rank r's block and the histories) and
    the ring SpGEMM of phase 4's s14 (rank r's block of C)."""
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_upper_bounds
    from sparse_matrix_with_flops_tpu_torch.parallel import (
        make_mesh,
        plan_sharded_rmcl_ell,
        shard_csr,
        sharded_rmcl_ell_scan,
        sharded_spgemm_ring,
    )
    from sparse_matrix_with_flops_tpu_torch.parallel.spgemm import plan_spgemm_ring
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    stacked, n = make_mesh(d, dev), mgt.rows
    length = scan_lengths()[1]
    plan, arrays, smgt = plan_sharded_rmcl_ell(mgt, d, S=S15, max_tile=MT15, mesh=stacked)
    c0 = torch.where(cols0 >= n, plan.n, cols0).reshape(d, plan.lr, S15)
    v0 = vals0.reshape(d, plan.lr, S15)
    want = {}
    for ex in EXCHANGES:
        c, v, hist = sharded_rmcl_ell_scan(stacked, plan, smgt, arrays, c0, v0, length, ex)
        want[ex] = [scan_block_digest(np, c, v, hist, r) for r in range(d)]
    del plan, arrays, smgt
    a = rmat_csr(14, edge_factor=8, seed=7, weights="random", device=dev)  # phase 4's s14
    oc = spgemm_upper_bounds(a, a)[1]
    sa = shard_csr(a, stacked)
    rplan, ents = plan_spgemm_ring(sa, sa)
    c = sharded_spgemm_ring(stacked, sa, sa, out_cap=oc, plan=rplan, step_ents=ents)[0]
    want["spgemm_ring"] = [block_digest(np, c.row_ptr[r:r + 1], c.col_ind[r:r + 1],
                                        c.values[r:r + 1]) for r in range(d)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return want


def child_graphs(torch, np, mesh, rep, counted, mgt, cols0, vals0, mode):
    """15(a-c): the process mesh's compiled programs.  For each exchange,
    on one plan: the eager loop of the step (``scan_lengths()[1]``
    iterations, ms an iteration by CUDA events), a scan call short of B
    (no capture), a call of B (a capture at its first iteration, the
    eager loop's bits), a call that replays every iteration (ms an
    iteration, the same bits), and the eager step once more (iteration
    1's bits); no host read (sync debug mode "error") in an eager step or
    in a replaying call.  Then the warm ``sharded_spgemm_ring`` on phase
    4's s14 with its plan, called until it captures (call B) and once
    more, every call bit-equal to the first.  Each peer set's epoch
    counter is read after every stage (the parent holds the ranks'
    readings equal: the counters move in step).  The digests go to
    ``rep["graph"]``, the per-rank ms, capture ms and pool to the log."""
    import importlib

    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_upper_bounds
    from sparse_matrix_with_flops_tpu_torch.parallel import (
        peer,
        plan_sharded_rmcl_ell,
        shard_csr,
        sharded_rmcl_ell_scan,
    )
    from sparse_matrix_with_flops_tpu_torch.parallel.spgemm import (
        _ring_impl,
        plan_spgemm_ring,
        ring_name,
        sharded_spgemm_ring,
    )
    from sparse_matrix_with_flops_tpu_torch.utils import graphs
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    PS = importlib.import_module("sparse_matrix_with_flops_tpu_torch.parallel.rmcl_ell")
    d, me, n = mesh.num_shards, mesh.rank, mgt.rows
    tag, label = f"15{mode} rank {me}", RANK_LABEL[mode]
    name = PS.scan_name(mesh)
    short, length = scan_lengths()
    out = rep.setdefault("graph", {"counters": []})
    fail = rep["failed"].append

    def counters(stage):
        torch.cuda.synchronize()
        out["counters"].append(
            [stage, {repr(k[1]): int(ps.counter) for k, ps in peer._SETS.items()}])

    def events(fn):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        res = fn()
        e.record()
        e.synchronize()
        return res, s.elapsed_time(e)

    plan, arrays, smgt = plan_sharded_rmcl_ell(mgt, d, S=S15, max_tile=MT15, mesh=mesh)
    c0 = torch.where(cols0 >= n, plan.n, cols0).reshape(d, plan.lr, S15)[me:me + 1].contiguous()
    v0 = vals0.reshape(d, plan.lr, S15)[me:me + 1].contiguous()
    out["scan"] = {}
    for ex in EXCHANGES:
        def eager(iters, ex=ex):
            hist, cols, vals = [], c0, v0
            for _ in range(iters):
                cols, vals, stats = PS._sharded_step(plan, smgt, arrays, cols, vals, ex, mesh)
                hist.append(stats)
            return cols, vals, {k: torch.stack([h[k] for h in hist]) for k, _ in PS._HIST}

        def scan(iters, ex=ex):
            return sharded_rmcl_ell_scan(mesh, plan, smgt, arrays, c0, v0, iters, ex)

        counters(f"{ex}: before")
        loop, eager_ms = events(lambda: eager(length))
        want = scan_block_digest(np, *loop, 0)
        one = scan_block_digest(np, *eager(1), 0)
        counters(f"{ex}: after the eager loop")
        made = captures_in(lambda: scan(short))[1]
        if made or graphs.held(plan, name).graph is not None:
            fail(f"{tag} {ex}: a call of {short} iterations short of B captured")
        got, made = counted(f"process-mesh scan {ex} {length} iterations, capturing ({label})",
                            lambda: captures_in(lambda: scan(length)),
                            EXCHANGE_KERNELS[ex])
        g = graphs.held(plan, name)
        if made != [name] or g.graph is None:
            fail(f"{tag} {ex}: the call of B = {length} iterations captured {made}")
        counters(f"{ex}: after the capturing call")
        again, replay_ms = events(lambda: counted(
            f"process-mesh scan {ex} {length} iterations, replayed ({label})",
            lambda: scan(length), EXCHANGE_KERNELS[ex]))
        counters(f"{ex}: after the replays")
        step_read = host_reads(torch, lambda: PS._sharded_step(plan, smgt, arrays, c0, v0, ex,
                                                               mesh))
        replay_read = host_reads(torch, lambda: scan(length))
        last = scan_block_digest(np, *eager(1), 0)
        counters(f"{ex}: after another eager call")
        digests = [scan_block_digest(np, *x, 0) for x in (got, again)]
        out["scan"][ex] = digests[0]
        same = digests == [want, want] and last == one
        rep["log"].append(
            f"{tag} process-mesh scan {ex}: captured at iteration 1 of a call of {length} (after "
            f"{short} eager), replays {'==' if same else '!='} the eager loop bit for bit; eager "
            f"{eager_ms / length:.3f} ms an iteration, replayed {replay_ms / length:.3f} ms an "
            f"iteration (CUDA events, a whole call), capture {g.capture_ms:.1f} ms, pool "
            f"{g.pool_bytes / 2**20:.1f} MiB, reserved {torch.cuda.memory_reserved() / 2**30:.2f} "
            f"GiB; host read: eager step {'yes' if step_read else 'none'}, replay "
            f"{'yes' if replay_read else 'none'} ({label})")
        if not same:
            fail(f"{tag} process-mesh scan {ex}: the replays differ from the eager loop")
        if step_read or replay_read:
            fail(f"{tag} process-mesh scan {ex}: a host read in the step (eager "
                 f"{step_read}, replayed {replay_read})")
    del plan, arrays, smgt
    graphs.drop_process_graphs()
    torch.cuda.empty_cache()
    # the warm ring SpGEMM, its plan passed
    a = rmat_csr(14, edge_factor=8, seed=7, weights="random", device=mesh.device)
    oc = spgemm_upper_bounds(a, a)[1]
    sa = shard_csr(a, mesh)
    rplan, ents = plan_spgemm_ring(sa, sa, mesh)
    b = graphs.BREAK_EVEN[ring_name(mesh)]

    def ring():
        return sharded_spgemm_ring(mesh, sa, sa, out_cap=oc, plan=rplan, step_ents=ents)[0]

    counters("ring SpGEMM: before")
    first, made_at = ring(), None
    eager_ms = events(lambda: _ring_impl(mesh, rplan.step_prod_caps, sa, sa, ents, oc))[1]
    calls = [first]
    for k in range(2, max(b, 2) + 1):
        c, made = captures_in(ring)
        calls.append(c)
        if made:
            made_at = k
    counters("ring SpGEMM: after the capturing call")
    c, replay_ms = events(lambda: counted(f"process-mesh ring SpGEMM s14, replayed ({label})",
                                          ring, ("ring_all_gather",) if d > 1 else ()))
    calls.append(c)
    counters("ring SpGEMM: after a replay")
    body_read = host_reads(torch, lambda: _ring_impl(mesh, rplan.step_prod_caps, sa, sa, ents,
                                                     oc))
    replay_read = host_reads(torch, ring)
    g = graphs.held(rplan, ring_name(mesh))
    same = all(same_sharded(torch, x, first) for x in calls)
    out["spgemm_ring"] = block_digest(np, first.row_ptr, first.col_ind, first.values)
    rep["log"].append(
        f"{tag} process-mesh ring SpGEMM s14: captured at call {made_at} (B = {b}), every call "
        f"{'==' if same else '!='} the first bit for bit; eager body {eager_ms:.3f} ms, replayed "
        f"call {replay_ms:.3f} ms (CUDA events), capture {g.capture_ms:.1f} ms, pool "
        f"{g.pool_bytes / 2**20:.1f} MiB; host read: eager body "
        f"{'yes' if body_read else 'none'}, replay {'yes' if replay_read else 'none'} ({label})")
    if made_at != max(b, 2) or not same or body_read or replay_read:
        fail(f"{tag} process-mesh ring SpGEMM: captured at call {made_at} (B = {b}), same "
             f"{same}, host read eager {body_read} replayed {replay_read}")
    del rplan, ents, calls, first, c, g
    graphs.drop_process_graphs()
    torch.cuda.empty_cache()


def check_graph_reports(phase, reports, want, failed, say) -> None:
    """The ranks' ``rep["graph"]``: each rank's scan and ring digests
    against the stacked path's (``graph_digests``), and every rank's
    epoch counters equal at every stage, advancing from stage to stage."""
    for r, rep in enumerate(reports):
        got = rep.get("graph", {})
        for what in (*EXCHANGES, "spgemm_ring"):
            mine = got.get(what) if what == "spgemm_ring" else got.get("scan", {}).get(what)
            same = mine == want[what][r]
            say(f"{phase} process-mesh {'ring SpGEMM' if what == 'spgemm_ring' else 'scan ' + what} "
                f"rank {r}: {'==' if same else '!='} the stacked D={len(reports)} path bit for "
                f"bit")
            if not same:
                failed.append(f"{phase} rank {r} process-mesh {what}: differs from the stacked "
                              f"path")
    stages = [rep.get("graph", {}).get("counters", []) for rep in reports]
    in_step = all(s == stages[0] for s in stages) and bool(stages[0])
    # every stage launches K6 or K8 on the sets but the first of a program
    # (and the ring SpGEMM's at W = 1: a ppermute of one rank moves nothing)
    moved = all(sum(b[1].values()) > sum(a[1].values())
                for a, b in zip(stages[0], stages[0][1:])
                if not b[0].endswith("before") and (len(reports) > 1 or not b[0].startswith("ring SpGEMM")))
    say(f"{phase} epoch counters: {len(stages[0])} readings, the ranks' "
        f"{'equal' if in_step else 'unequal'} at every one, "
        f"{'advancing' if moved else 'not advancing'} between them; last "
        f"{stages[0][-1] if stages[0] else None}")
    if not (in_step and moved):
        failed.append(f"{phase}: the ranks' epoch counters are not in step")


def run_ranks(mode: str, world: int) -> list:
    """Start ``world`` ranks of ``mode`` (``chip_smoke.py --rank-child``),
    wait for them under RANK_LIMIT_S, kill any still running; each rank's
    report (a missing one fails the phase)."""
    import shutil

    work = os.path.join(ROOT, "build", f"phase15{mode}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    procs = []
    for r in range(world):
        logf = open(os.path.join(work, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-child", mode, str(r),
             str(world), work], stdout=logf, stderr=subprocess.STDOUT, cwd=ROOT), logf))
    t0 = time.perf_counter()
    limit = RANK_LIMIT_S[mode]
    for p, _ in procs:
        try:
            p.wait(max(1.0, limit - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
    killed = []
    for r, (p, logf) in enumerate(procs):
        if p.poll() is None:
            p.kill()
            p.wait()
            killed.append(r)
        logf.close()
    log(f"15{mode}: {world} rank(s) in {time.perf_counter() - t0:.1f} s, exit codes "
        f"{[p.returncode for p, _ in procs]}" + (f"; killed at {limit} s: {killed}"
                                                   if killed else ""))
    reports = []
    for r in range(world):
        path = os.path.join(work, f"rank{r}.json")
        if not os.path.exists(path):
            with open(os.path.join(work, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"phase 15{mode}: rank {r} wrote no report; its output "
                                 f"ends:\n{tail}")
        with open(path) as f:
            reports.append(json.load(f))
    shutil.rmtree(work, ignore_errors=True)
    return reports


def process_phase(torch, np, dev, card, launches, launched_by, record, drive):
    """Phase 15: one rank a process (ranks started as processes of this
    script, each under RANK_LIMIT_S).  (a) world size 1 under NCCL;
    (b) two processes on the one card under gloo, K6 / K8 on CUDA IPC peer
    pointers, each rank's R-MCL results (static, dynamic, adaptive, 2-D
    SpGEMM, dry run) held to the stacked D = 2 path and per-rank K6 / K7 /
    K8 to their plain versions; (c) one card a rank under NCCL when the
    machine has more than one card; then weak scaling, stacked."""
    t_phase = time.perf_counter()
    failed = []
    torch.cuda.empty_cache()

    def take(mode, reports):
        for r, rep in enumerate(reports):
            for line in rep["log"]:
                log(f"  [15{mode} rank {r}] {line}")
            failed.extend(rep["failed"])
            for run in rep["runs"]:
                for k, n in run["counts"].items():
                    launches[k] += n
                    if n:
                        label = f"{run['label']} (rank {r})"
                        launched_by[k].append(label if run["path"] else
                                              f"{label} (direct call, no path)")
            for rec in rep["records"]:
                record(rec["name"], rec["case"], rec["err"], rec["ms"], rec["plain_ms"],
                       tuple(rec["bound"]), rec["library"], rec["call"], top=False)

    take("a", run_ranks("a", 1))
    coo = phase8_graph(torch, np, dev)[0]
    groups = [("b", 2)]
    if torch.cuda.device_count() > 1:
        groups.append(("c", min(torch.cuda.device_count(), 4)))
    else:
        log("cross-card: 1 card, not run")
    for mode, d in groups:
        rank_group(torch, np, dev, coo, mode, d, take, failed)
    del coo
    torch.cuda.empty_cache()
    from sparse_matrix_with_flops_tpu_torch.parallel import weak_scaling_rmcl_ell

    for row in drive("weak scaling, stacked D = 1, 2, 4, R-MAT s14-s16",
                     lambda: weak_scaling_rmcl_ell((1, 2, 4), 14), ("sort_dedup_compact",)):
        log(f"weak scaling: {json.dumps(row)} [{card}]")
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s [{card}]")
    if failed:
        raise AssertionError("phase 15: " + "; ".join(failed))


def rank_group(torch, np, dev, coo, mode, d, take, failed):
    """Phase 15(b) or (c): the stacked D = d path's digests on ``dev``,
    then the d ranks, each rank's digests held to them."""
    from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh, sharded_rmcl_ell

    want = {}
    for ex in EXCHANGES:
        out = sharded_rmcl_ell(coo, make_mesh(d, dev), max_iters=3, S=S15, max_tile=MT15,
                               exchange=ex)
        want[ex] = rmcl_digest(np, *out)
    del out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    want_dyn = dynamic_paths(torch, np, make_mesh(d, dev), lambda label, fn, must: fn(),
                             lambda s: make_mesh(s, dev))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _, mgt, cols0, vals0 = phase8_graph(torch, np, dev)
    want_graph = graph_digests(torch, np, dev, mgt, cols0, vals0, d)
    del mgt, cols0, vals0
    torch.cuda.empty_cache()
    reports = run_ranks(mode, d)
    take(mode, reports)
    check_graph_reports(f"15{mode}", reports, want_graph, failed, log)
    for path, by_shard in want_dyn.items():
        for r, rep in enumerate(reports):
            got = rep.get("dynamic", {}).get(path, {})
            same = bool(got) and all(got[k] == by_shard[k] for k in got)
            log(f"15{mode} {path} D={d} rank {r}: {'==' if same else '!='} the stacked D={d} "
                f"path bit for bit ({', '.join(f'shard {k}' for k in got)})")
            if not same:
                failed.append(f"15{mode} rank {r} {path}: differs from the stacked path")
    perms = {rep.get("dynamic", {}).get("perm_total", {}).get(str(r)) for r, rep in
             enumerate(reports)}
    log(f"15{mode} sharded_rmcl_adaptive: {len(perms)} distinct perm_total over {d} ranks")
    if len(perms) != 1:
        failed.append(f"15{mode} sharded_rmcl_adaptive: the ranks hold different perm_total")
    for r, rep in enumerate(reports):
        for ex in EXCHANGES:
            same = rep["digests"].get(ex) == want[ex]
            log(f"15{mode} sharded_rmcl_ell {ex} D={d} rank {r}: "
                f"{'==' if same else '!='} the stacked D={d} path bit for bit "
                f"(iterate and stats)")
            if not same:
                failed.append(f"15{mode} rank {r} {ex}: differs from the stacked path")


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--rank-child"]:
        return rank_child(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; refusing to run", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--digests"]:  # the stream paths' digests of another checkout
        import numpy as np

        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        print(json.dumps(stream_digests(torch, np, torch.device("cuda", 0))))
        return 0
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
    from sparse_matrix_with_flops_tpu_torch.ops.segments import (
        exclusive_cumsum,
        run_sums,
        run_sums_plain,
    )
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
    from sparse_matrix_with_flops_tpu_torch.utils import graphs
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

    wrappers = kernel_wrappers()
    ell_kernels = ("sort_dedup_compact", "hub_accumulate", "window_gather", "cumsum_i32")

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
               dev_ms=None, top=True):
        """One case of a kernel: ``kbound`` (ms, what bounds it);
        ``library`` the time of the one PyTorch call that computes the
        same function (``library_call`` names it), or the reason there is
        none; ``dev_ms`` the kernel's device time alone, where measured.
        The last case with ``top`` gives the kernel's own numbers."""
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
        r["max_abs_err"] = max(r["max_abs_err"], err)
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
        r["cases"][case] = case_rec
        if not top:
            return
        r.pop("library_none", None)
        r.pop("library_call", None)
        r.pop("device_ms", None)
        r.update({k: v for k, v in case_rec.items() if k != "max_abs_err"})  # the last case

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
    # K2's input: the s14 hub group densified (the matmul route's part)
    g, _, _, vw, part = next(E._hub_products(a, a, plan, [E._dense_hub_group(plan, 0, dev)]))
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

    # K9: the offset probe, K9 against torch.segment_reduce's order, then
    # K9 bit-equal to its plain version on the CPU
    pvals, poff = probe_runs(torch, dev)
    k9_moves = run_sums_offset_probe(torch, run_sums, pvals, poff)
    cub_moves = run_sums_offset_probe(torch, run_sums_plain, pvals, poff)
    log(f"run_sums offset probe, 3,000 runs moved by 0..7 slots, runs whose bits differ from "
        f"offset 0: K9 {k9_moves}; torch.segment_reduce {cub_moves}")
    if any(k9_moves):
        raise AssertionError("K9: a run's bits depend on where it starts in the stream")
    want9 = run_sums_plain(pvals.cpu(), poff.cpu())

    def k9_same(got):
        if not torch.equal(got.cpu().view(torch.int32), want9.view(torch.int32)):
            raise AssertionError("K9 probe: differs from the plain version's bits on the CPU")

    k9_same(run_sums(pvals, poff))
    burst("K9 probe", lambda: run_sums(pvals, poff), k9_same)
    k9_cases(torch, "offset probe, 3,000 runs of 1-4096 values", [(pvals, poff)], record,
             cuda_ms, device_ms)
    del pvals, poff, want9

    k10_phase(torch, np, dev, record, burst, cuda_ms, device_ms)
    k11_phase(torch, np, dev, record, burst, cuda_ms, device_ms)

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
    # a near-dense hub group takes the matmul route (K2 compacts it)
    rng = np.random.default_rng(3)
    nd = rng.random((600, 600), dtype=np.float32)
    nd[rng.random((600, 600)) > 0.9] = 0.0
    dn = CSR.from_dense(nd, device=dev)
    dplan = plan_ell(dn, dn, max_w=1024)
    if not dplan.hub_groups or E._plan_tensors(dplan, dev)["hub"]["sparse"] is not None:
        raise AssertionError("the near-dense hub did not take the matmul route")
    cd = drive("near-dense 600 x 600 hub (matmul route)", lambda: E.spgemm_ell(dn, dn, dplan),
               ("compact_nonzero_rows",))
    scipy_check(dn, cd, "near-dense hub", positive=True)
    del dn, dplan, cd

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
    for _ in range(graphs.BREAK_EVEN["spgemm_ell"]):  # warm calls up to the graph's capture
        E.spgemm_ell(a, a, plan)
    if graphs.held(plan, "spgemm_ell").graph is None:
        raise AssertionError("phase 4: the warm s14 spgemm_ell kept no graph")
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
    tmp, snap = stream_phase(torch, "phase 11", lambda: general_rmcl_phase(
        torch, np, sp, dev, card, drive, record, coo, static5, cuda_ms, host_ms))
    del coo, static5
    torch.cuda.synchronize()

    # ---- 12. the binned engine, the partitioned driver, the command line -
    try:
        stream_phase(torch, "phase 12", lambda: binned_phase(
            torch, np, sp, dev, card, a, ca, snap, drive, record, burst, check_vals,
            scipy_check))
    finally:
        tmp.cleanup()
    torch.cuda.synchronize()

    # ---- 13. the rest of the distributed layer, D = 4 shards on the card -
    stream_phase(torch, "phase 13", lambda: distributed_phase(
        torch, np, sp, dev, card, a, drive, record, cuda_ms, host_ms))
    torch.cuda.synchronize()

    # ---- 14. R-MCL on planted partitions, two sizes ----------------------
    planted_phase(torch, np, sp, dev, card, drive, record, cuda_ms, device_ms)
    torch.cuda.synchronize()

    # ---- 15. one rank a process --------------------------------------------
    process_phase(torch, np, dev, card, launches, launched_by, record, drive)
    torch.cuda.synchronize()

    # ---- 16. the compiled programs: CUDA graphs ------------------------------
    compiled_phase(torch, np, dev, card, a, drive, cuda_ms)
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
            **({"replaces_note": REPLACES_NOTE[k]} if k in REPLACES_NOTE else {}),
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
