#!/usr/bin/env python3
"""Probes of the port's kernels on one CUDA card (the ring kernels
K6-K8; K1, K2, K3 and K5 in ``kernels``).

    python3 ring_probe.py accuracy [--unpromoted]
    python3 ring_probe.py step ROOT [ROOT ...]
    python3 ring_probe.py kernels ROOT [ROOT ...]
    python3 ring_probe.py streams ROOT [ROOT ...]
    python3 ring_probe.py split ROOT [ROOT ...]
    python3 ring_probe.py peaks ROOT [ROOT ...]
    python3 ring_probe.py entry ROOT [ROOT ...]
    python3 ring_probe.py launch [--root ROOT]
    python3 ring_probe.py variants [--root ROOT] [NAME ...]
    python3 ring_probe.py cross-card          # a machine with 2 or more cards
    python3 ring_probe.py processes
    python3 ring_probe.py capture

``accuracy``: K8 and its plain twin on the D = 2 and D = 4 hub operands
of the sharded R-MCL loop on R-MAT s14 (the operands ``chip_smoke.py``
phase 9 uses), each held against an f64 product: max |err|, max and mean
|err| / (|A||B|) and the summed signed error (its bias).
``--unpromoted`` builds a variant of ``csrc/ring.cu`` whose wgmma groups
add into one accumulator over all of K, as a kernel without the
stage-wise f32 promotion would (exact text edits; the script stops if
the source no longer matches), into ``build/ring_probe/``.

``step``: for each ROOT in turn (a checkout of the repository; give two
in the order A B B A to compare them on one card), a fresh process
imports the port from that ROOT, builds its kernels there and times, as
``chip_smoke.py`` phase 9 does, the warm D = 4 iteration 2 of every
exchange with CUDA events, K8 alone on that iteration's hub operands,
and K6 alone on its cols and vals as that tree's ``pallas_ring``
exchange calls it: median, min and max of 7 calls each.

``kernels``: as ``step``, one fresh process a ROOT (give two in the
order A B B A), K1, K2, K3 and K5 at the shapes ``chip_smoke.py`` times
them: K1 on the R-MAT s14 plan's W = 64 and W = 8192 tiles and the
``max_w=32768`` plan's W = 32768 tile, K2 on the plan's first hub part
(R = 563, N = 16384), K3 on the s14 assembly's windows (Q = 82,792,
W = 128) and as that tree's assembly calls it (the windows and the row
heads in one launch, or in two), K5 on the cant-class band (BCSR(8,
128), N = 512) and on s14 (N = 128).  Each one call at a time (CUDA events around the call, host
enqueue included: median, min and max of 15) and back to back (20 calls
between two events, per call).

``streams``: as ``step``, one fresh process a ROOT (give two in the
order A B B A), the stream paths whose run sums go through
``ops/segments.run_sums``: general R-MCL ``rmcl_scan`` on phase 11's
s14 graph at margin 2.5 (3 iterations, per iteration), ``spgemm_binned``
on s14 with random weights (warm), and one dynamic ``sharded_rmcl_step``
at D = 4 as phase 13 runs it, and the warm ``spgemm_ell`` on s14 (a
graph replay, phases 4 and 16); CUDA events, median, min and max of 5.

``split``: for each ROOT in turn, a fresh process profiles one call of
each stream path with torch.profiler (CPU and CUDA activity, Python
stacks) and splits its device time by the aten op that launched each
kernel and the port's two innermost functions above the op (a
function as its first line, the innermost first): general
R-MCL step 1 on phase 11's s14 graph at margin 2.5 (``rmcl_one_step``),
its drift (``differs`` of that step's iterate) and one ``rmcl_scan``
iteration; ``spgemm_binned`` on s14 with random weights (warm); one
dynamic ``sharded_rmcl_step`` at D = 4 as ``streams`` runs it, and its
drift alone (``csr_frobenius_diff`` of each shard's old and new block);
the warm ``spgemm_ell`` on s14 run eagerly (``_tiles_impl`` and
``_assemble_body`` with the cached bucket, the body a graph replays).
Each path prints its device total, its kernels, and its largest
(op, line) entries; ``torch.cummax`` anywhere is named.

``peaks``: as ``step``, one fresh process a ROOT (give two in the order
A B B A), ``chip_smoke.py`` phase 12's peak device memory of one cold
``spgemm_ell_partitioned`` call (4 groups) and of one cold
``spgemm_ell`` on s14, and their ratio: fresh, once more, and after
three warm ``spgemm_ell`` calls on another plan.

``launch``: K2, K3, K4 and K6 at their main-path sizes, beside the
library calls that compute the same functions where there are some,
timed one call at a time (as ``chip_smoke.py``), back to back, on the
host, and by ``torch.profiler`` on the device; then the host cost of
each step of a kernel wrapper.

``cross-card``: ``chip_smoke.py`` phase 15(c) alone, on a machine with
more than one card: D = min(cards, 4) ranks under NCCL, one card a rank
(processes of ``chip_smoke.py --rank-child``), ``sharded_rmcl_ell`` with
each exchange on phase 8's graph against the stacked D path on card 0,
the per-rank K6, K7 and K8 against their plain versions, timed; the
dynamic scan, the adaptive loop, the 2-D SpGEMM on (D, 1), (1, D) and, at
D = 4, (2, 2) process meshes and the dry run, each rank's blocks against
the stacked D path's; weak scaling on the process group.

``processes``: what one rank a process meets on the machine it runs on, each
group of ranks a process of this script under a wall-clock limit: which
gloo collectives take card tensors (``all_gather_into_tensor``,
``batch_isend_irecv``, two ranks); world size 1 under NCCL (per-rank K6 /
K7 / K8 against their twins, ``sharded_rmcl_ell`` on R-MAT s10 with each
exchange against the stacked D = 1 path); two processes on card 0 under
gloo (per-rank K6 on [1000, 128] int32 + f32 blocks, K7 / K8 on
[1, 200, 512] · [1, 256, 4096], nt 2048, against their twins and timed,
CUDA events over 20 / 10 calls); whether the MPS control daemon starts
(pipes under ``build/mps``), and if it does the two processes again
under it.  The ranks' reports and output land in ``build/processes/``.

``variants``: text-edited builds of ``csrc/ring.cu`` (K6),
``csrc/cumsum_i32.cu`` (K4), ``csrc/sort_dedup_compact.cu`` (K1, on the
s14 plan's W = 8192 tile), ``csrc/bcsr_spmm.cu`` (K5),
``csrc/compact_nonzero_rows.cu`` (K2) and ``csrc/window_gather.cu``
(K3), each entry of ``VARIANTS`` or those named, timed in turn on the
main path's inputs.  The entries named "v1" edit K2 and K3 as first
written (a CTA a row with a block scan each 1024 lanes; a thread a
lane), in a checkout that still has them, given as ``--root``.

``entry``: as ``step``, one fresh process a ROOT (give two in the order
A B B A), the entry points that ``chip_smoke.py`` phases 4, 8, 9, 10,
11 and 12 time, at their default settings: ``rmcl_ell`` (5 iterations,
plan included), ``rmcl`` in scan mode on s14 and on tdata, ``rmcl_scan``
at margin 2.5, the warm ``spgemm_ell``, ``corpus``' ``ell`` and
partitioned rows on s14 with the partitioned row's peak memory,
``perf --kernel binned`` on s14 written as a SNAP file (its printed
ms), and ``sharded_rmcl_ell`` at D = 4 stacked with each exchange, at
phase 9's 3 iterations and at 5 (plan included), with a digest of the
5-iteration result's bits (48 bits of a SHA-256 of the iterate and the
histories, equal across trees when the bits are).

``capture``: what a CUDA graph costs and buys, the source of
``utils/graphs.BREAK_EVEN``.  For the warm ``spgemm_ell`` body, one
``rmcl_ell_step``, one general ``rmcl_one_step`` and one D = 4 stacked
sharded step with each exchange at ``chip_smoke.py`` phase 16's s14
sizes: eager and replay ms, ``utils/graphs.py``'s first run, capture ms
and pool (five captures, the median), a capture inside
``torch.cuda.graph`` for comparison; for the warm ``sharded_spgemm_ring``
(D = 4, plan passed) and ``spgemm_binned`` on s14 (random weights),
through their entry points: the eager body's ms, the calls the capture
policy took to capture, capture ms (five captures, the graph dropped
between) and pool, and the replaying call's ms.  Then the iterations or
calls after which each graph pays for its capture, 1 + capture / (eager
- replay), none where the replay saves nothing, and for each of the five
programs the count rounded up beside the table in ``utils/graphs.py``.
Last, the warm ``sharded_spgemm`` and ring bodies at D = 4 and
``sharded_spgemm_2d`` on a (2, 2) stacked mesh, eager ms (CUDA events)
beside their device time (torch.profiler), uncaptured: how far a graph
could take them.

``--root ROOT`` (``launch``, ``variants``): import the port, and build
the variants, from the checkout ROOT instead of this script's own.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "sparse_matrix_with_flops_tpu_torch"
EXCHANGES = ("fused_ring", "ring", "all_gather", "pallas_ring")
CAPTURES = 5  # captures a body in ``capture``: one capture's host time spreads widely


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"the source changed; cannot find once:\n{old}")
    return src.replace(old, new)


def unpromoted(src: str) -> str:
    """Every wgmma adds into acc over all of K; no f32 promotion."""
    for old in ("wgmma_tf32(part, al[ks], bh, ks);", "wgmma_tf32(part, ah[ks], bl, 1);",
                "wgmma_tf32(part, ah[ks], bh, 1);"):
        src = _edit(src, old, old.replace("(part,", "(acc[tp],").replace(", ks)", ", 1)"))
    src = _edit(src, "acc[tp][e] += part[e];", "(void)0;")
    return src.replace("pin(part);", "pin(acc[tp]);")


def use_unpromoted() -> None:
    """Build ``unpromoted(ring.cu)`` with the error-string source into
    build/ring_probe/unpromoted.so and make the port's wrappers launch
    it."""
    from sparse_matrix_with_flops_tpu_torch import _build

    csrc = os.path.join(HERE, PKG, "csrc")
    out = os.path.join(HERE, "build", "ring_probe")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(csrc, "ring.cu")) as f:
        src = unpromoted(f.read())
    cu = os.path.join(out, "unpromoted.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out, "unpromoted.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, cu,
                    os.path.join(csrc, "errors.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for fn, argtypes in _build._SIGNATURES.items():
        if fn.startswith("smf_ring"):
            getattr(lib, fn).argtypes = (*argtypes, ctypes.c_void_p)
            getattr(lib, fn).restype = ctypes.c_int
    lib.smf_error_string.argtypes = (ctypes.c_int,)
    lib.smf_error_string.restype = ctypes.c_char_p
    _build.library = lambda: lib


def s14_state(dev):
    """R-MAT s14 (edge factor 8, seed 7) after ``rmcl_init``, as
    ``chip_smoke.py`` phase 9 builds it: (mgt, its [n, 128] ELL)."""
    import numpy as np

    from sparse_matrix_with_flops_tpu_torch.formats import COO
    from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl_init
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    rm = importlib.import_module(f"{PKG}.models.rmcl_ell")
    g = rmat_csr(14, edge_factor=8, seed=7)
    rp, ci, v = g.to_numpy()
    n = g.rows
    coo = COO.from_numpy(np.repeat(np.arange(n), np.diff(rp)), ci, v, n, n,
                         capacity=ci.size + n, device=dev)
    mgt = rmcl_init(coo).make_ordered()
    return mgt, rm.mt_to_ell(mgt, 128)


def accuracy(dev, promoted: bool) -> None:
    import torch

    from sparse_matrix_with_flops_tpu_torch.parallel import ring_kernels as RK
    from sparse_matrix_with_flops_tpu_torch.parallel.rmcl_ell import (
        fused_hub_operands,
        plan_sharded_rmcl_ell,
    )

    if not promoted:
        use_unpromoted()
    mgt, (cols0, vals0) = s14_state(dev)
    n = mgt.rows
    for d in (2, 4):
        plan, arrays, _ = plan_sharded_rmcl_ell(mgt, d, S=128, max_tile=8192)
        lc = torch.where(cols0 >= n, plan.n, cols0).reshape(d, plan.lr, 128)
        lv = vals0.reshape(d, plan.lr, 128)
        a, b, nt = fused_hub_operands(plan, arrays, lc, lv)
        full = b.reshape(-1, b.shape[2])
        got = {"kernel": RK.ring_matmul_tiled(a, b, nt), "twin": RK.ring_matmul_tiled_plain(a, b, nt)}
        for name, c in got.items():
            worst = [0.0, 0.0, 0.0, 0.0]
            for r in range(d):
                exact = a[r].double() @ full.double()
                scale = a[r].abs().double() @ full.abs().double()
                err = c[r].double() - exact
                rel = (err.abs() / scale)[scale > 0]
                worst = [max(worst[0], float(err.abs().max())), max(worst[1], float(rel.max())),
                         worst[2] + float(rel.mean()) / d, worst[3] + float(err[scale > 0].sum())]
            print(f"D={d} {name}{'' if promoted or name == 'twin' else ' (unpromoted)'}: "
                  f"max |err| {worst[0]:.3e}, max |err|/(|A||B|) {worst[1]:.3e}, mean "
                  f"{worst[2]:.3e}, summed error {worst[3]:.3e}", flush=True)


def _times(torch, fn, reps: int = 7) -> list:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def step_one(dev) -> dict:
    """This process's port (imported from sys.path[0]): the warm D = 4
    iteration 2 of each exchange and K8 on its hub operands, in ms."""
    import torch

    from sparse_matrix_with_flops_tpu_torch import _build
    from sparse_matrix_with_flops_tpu_torch.parallel import ring_kernels as RK
    from sparse_matrix_with_flops_tpu_torch.parallel.rmcl_ell import (
        fused_hub_operands,
        plan_sharded_rmcl_ell,
    )

    ps = importlib.import_module(f"{PKG}.parallel.rmcl_ell")
    _build.library()
    mgt, (cols0, vals0) = s14_state(dev)
    n = mgt.rows
    plan, arrays, smgt = plan_sharded_rmcl_ell(mgt, 4, S=128, max_tile=8192)
    lc1, lv1, _ = ps._sharded_step(
        plan, smgt, arrays, torch.where(cols0 >= n, plan.n, cols0).reshape(4, plan.lr, 128),
        vals0.reshape(4, plan.lr, 128), "fused_ring")
    out = {ex: _times(torch, lambda ex=ex: ps._sharded_step(plan, smgt, arrays, lc1, lv1, ex))
           for ex in EXCHANGES}
    a, b, nt = fused_hub_operands(plan, arrays, lc1, lv1)
    out["K8 alone"] = _times(torch, lambda: RK.ring_matmul_tiled(a, b, nt))
    # K6 as this tree's pallas_ring exchange calls it: one call for the
    # cols and vals where the wrapper takes several operands, else two
    if "xs" in inspect.signature(RK.ring_all_gather).parameters:
        out["K6 alone"] = _times(torch, lambda: RK.ring_all_gather(lc1, lv1))
    else:
        out["K6 alone"] = _times(
            torch, lambda: (RK.ring_all_gather(lc1), RK.ring_all_gather(lv1)))
    return out


def _back_to_back(torch, fn, calls: int = 20, reps: int = 5) -> list:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / calls)
    return out


def ell_inputs(dev) -> dict:
    """K2's and K3's main-path inputs, as ``chip_smoke.py`` phase 3 cuts
    them from R-MAT s14 (edge factor 8, seed 7, random weights): the
    first hub part (R = 563, N = 16384) and its valid width; the s14
    assembly's window source, its window positions (Q = 82,792) and its
    row heads (one a row), with the clipped starts of the windows."""
    import torch

    from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
    from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
    from sparse_matrix_with_flops_tpu_torch.ops.segments import exclusive_cumsum
    from sparse_matrix_with_flops_tpu_torch.ops.sort_kernels import _window_starts
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    a = rmat_csr(14, edge_factor=8, seed=7, weights="random", device=dev)
    plan = plan_ell(a, a)
    pt = E._plan_tensors(plan, dev)
    _, _, _, _, vw, part = next(E._hub_products(a, a, plan, pt))
    flat_c, flat_v, counts, flat_base = E._tiles_impl(a, a, plan)
    ocap = -(-E._nnz_bucket(int(counts.sum())) // 128) * 128
    starts = exclusive_cumsum(counts)[:-1]
    fc, fvb = E._window_source(flat_c, flat_v, plan.ncols)
    p0 = E._window_positions(counts, flat_base, starts, ocap // 128)
    heads = torch.where(counts > 0, flat_base, 0).to(torch.int32)
    return {"part": part, "vw": vw, "fc": fc, "fvb": fvb, "p0": p0, "heads": heads,
            "starts": _window_starts(p0, fc.shape[0] // 128, 128)}


def kernels_one(dev) -> dict:
    """This process's port (imported from sys.path[0]): K1, K2, K3 and K5
    at the shapes of ``chip_smoke.py`` phases 3, 5 and 6, in ms."""
    import numpy as np
    import torch

    from sparse_matrix_with_flops_tpu_torch import _build
    from sparse_matrix_with_flops_tpu_torch.formats import BCSR
    from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
    from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
    from sparse_matrix_with_flops_tpu_torch.ops.sort_kernels import (
        compact_nonzero_rows,
        sort_dedup_compact,
        window_gather,
    )
    from sparse_matrix_with_flops_tpu_torch.ops.spmm import bcsr_spmm
    from sparse_matrix_with_flops_tpu_torch.utils.generate import banded_csr, rmat_csr

    _build.library()
    a = rmat_csr(14, edge_factor=8, seed=7, weights="random", device=dev)
    out = {}
    for kw, widths in (({}, (64, 8192)), ({"max_w": 32768}, (32768,))):
        plan = plan_ell(a, a, **kw)
        pt = E._plan_tensors(plan, dev)
        pc, pv = E._b_ell_chunks(a, plan, pt)
        ws = [w for w, _, _, _ in pt["bins"]]
        for w in widths:
            _, _, src, ent = pt["bins"][ws.index(w)]
            tc, tv = E._bin_tiles(a, pc, pv, src, ent, w, plan.chunk)

            def k1(tc=tc, tv=tv, plan=plan):
                return sort_dedup_compact(tc, tv, plan.ncols, plan.chunk)

            out[f"K1 W={w} R={tc.shape[0]}"] = _times(torch, k1, 15)
            out[f"K1 W={w} back to back"] = _back_to_back(torch, k1)
        del pc, pv
    x = ell_inputs(dev)
    # K3 as this tree's assembly calls it: the windows and the row heads
    # in one launch where the wrapper takes two lists, else two calls
    if "p1" in inspect.signature(window_gather).parameters:
        assembly = lambda: window_gather(x["fc"], x["fvb"], x["p0"], 128, x["heads"])  # noqa: E731
    else:
        assembly = lambda: (window_gather(x["fc"], x["fvb"], x["p0"]),  # noqa: E731
                            window_gather(x["fc"], x["fvb"], x["heads"]))
    for label, fn in (
        (f"K2 R={x['part'].shape[0]} N={x['part'].shape[1]}",
         lambda: compact_nonzero_rows(x["part"], x["vw"])),
        (f"K3 Q={x['p0'].shape[0]} W=128", lambda: window_gather(x["fc"], x["fvb"], x["p0"])),
        (f"K3-assembly windows + {x['heads'].shape[0]} row heads", assembly),
    ):
        out[label] = _times(torch, fn, 15)
        out[f"{label.split()[0]} back to back"] = _back_to_back(torch, fn)
    del x
    band = banded_csr(62451, bandwidth=32, device=dev)
    for label, x, n in (("band", band, 512), ("s14", a, 128)):
        ab = BCSR.from_csr(x, 8, 128)
        b = torch.from_numpy(
            np.random.default_rng(0).random((x.rows, n)).astype(np.float32)).to(dev)
        out[f"K5 {label} N={n}"] = _times(torch, lambda: bcsr_spmm(ab, b), 15)
        out[f"K5 {label} back to back"] = _back_to_back(torch, lambda: bcsr_spmm(ab, b))
    return out


def streams_one(dev) -> dict:
    """This process's port: the general scan, binned s14 and a dynamic
    sharded step, each timed as ``chip_smoke.py`` phases 11-13 run it."""
    import torch

    from sparse_matrix_with_flops_tpu_torch.ops.binned import plan_bins, spgemm_binned
    from sparse_matrix_with_flops_tpu_torch.ops.ell_esc import spgemm_ell
    from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
    from sparse_matrix_with_flops_tpu_torch.ops.flops import row_flops
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_upper_bounds
    from sparse_matrix_with_flops_tpu_torch.parallel import (
        flops_balanced_permutation,
        make_mesh,
        shard_csr,
    )
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    rm = importlib.import_module(f"{PKG}.models.rmcl")
    pr = importlib.import_module(f"{PKG}.parallel.rmcl")
    mgt, _ = s14_state(dev)
    out = {}
    pc, cc = rm.plan_capacities(mgt, mgt, 2.5)
    mtc = mgt.with_capacity(cc)
    out["rmcl_scan per iteration"] = [
        t / 3 for t in _times(torch, lambda: rm.rmcl_scan(mgt, mtc, pc, cc, 3), 5)]
    del mtc
    a = rmat_csr(14, edge_factor=8, seed=7, weights="random")
    plan = plan_bins(a, a)
    out["spgemm_binned"] = _times(torch, lambda: spgemm_binned(a, a, plan), 5)
    del a, plan
    perm = flops_balanced_permutation(row_flops(mgt, mgt).cpu().numpy(), 4)
    mtp = mgt.conjugate_permute(torch.from_numpy(perm))
    flops1, _ = spgemm_upper_bounds(mtp, mtp)
    smgt = shard_csr(mtp, 4)
    pcs, ccs = pr.plan_shard_capacities(smgt, flops1, margin=4.0)
    smt = shard_csr(mtp, 4, local_capacity=ccs)
    mesh = make_mesh(4, dev)
    out["sharded_rmcl_step D=4"] = _times(
        torch, lambda: pr.sharded_rmcl_step(mesh, smgt, smt, pcs, ccs), 5)
    a = rmat_csr(14, edge_factor=8, seed=7, weights="random")
    eplan = plan_ell(a, a)
    spgemm_ell(a, a, eplan)  # caches the nnz(C) bucket: later calls replay a graph
    out["spgemm_ell s14 warm"] = _times(torch, lambda: spgemm_ell(a, a, eplan), 5)
    return out


def _op_split(torch, fn) -> dict:
    """One call of ``fn`` under torch.profiler (CPU and CUDA activity,
    Python stacks): its device time in all, by kernel, and by (aten op,
    the port's two innermost functions above it), each [name, ms, count],
    largest first.  A session that recorded no device event is taken
    again, up to three in all; then every list is empty."""
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA], with_stack=True) as prof:
            fn()
            torch.cuda.synchronize()
        kernels, ops = {}, {}
        for ev in prof.events():
            us = ev.self_device_time_total
            if us <= 0:
                continue
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                k = kernels.setdefault(ev.name[:70], [0.0, 0])
            else:
                # the op's Python stack where the profiler keeps one,
                # else the Python function events it nests in
                frames, up = list(ev.stack or ()), ev.cpu_parent
                while up is not None:
                    frames.append(up.name)
                    up = up.cpu_parent
                mine = [f[f.index(PKG) + len(PKG) + 1:] for f in frames
                        if f"{PKG}/" in f and ".py(" in f]
                site = " < ".join(mine[:2]) or "?"
                k = ops.setdefault(f"{ev.name} @ {site}", [0.0, 0])
            k[0] += us / 1e3
            k[1] += 1
        if kernels:
            break

    def rows(d):
        return sorted(([n, ms, c] for n, (ms, c) in d.items()), key=lambda r: -r[1])

    return {"device ms": sum(ms for ms, _ in kernels.values()), "kernels": rows(kernels),
            "ops": rows(ops)}


def split_one(dev) -> dict:
    """This process's port: the device-time splits of ``split``."""
    import torch

    from sparse_matrix_with_flops_tpu_torch import _build
    from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
    from sparse_matrix_with_flops_tpu_torch.ops.binned import plan_bins, spgemm_binned
    from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
    from sparse_matrix_with_flops_tpu_torch.ops.flops import row_flops
    from sparse_matrix_with_flops_tpu_torch.ops.metrics import csr_frobenius_diff, differs
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_upper_bounds
    from sparse_matrix_with_flops_tpu_torch.parallel import (
        flops_balanced_permutation,
        make_mesh,
        shard_csr,
    )
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    rm = importlib.import_module(f"{PKG}.models.rmcl")
    pr = importlib.import_module(f"{PKG}.parallel.rmcl")
    _build.library()
    mgt, _ = s14_state(dev)
    out = {}
    pc, cc = rm.plan_capacities(mgt, mgt, 2.5)
    mtc = mgt.with_capacity(cc)
    new, _ = rm.rmcl_one_step(mgt, mtc, pc, cc)
    out["general step 1 (rmcl_one_step, margin 2.5)"] = _op_split(
        torch, lambda: rm.rmcl_one_step(mgt, mtc, pc, cc))
    out["general step 1's drift (differs)"] = _op_split(torch, lambda: differs(mtc, new))
    out["rmcl_scan, 1 iteration"] = _op_split(
        torch, lambda: rm.rmcl_scan(mgt, mtc, pc, cc, 1))
    del mtc, new
    a = rmat_csr(14, edge_factor=8, seed=7, weights="random")
    plan = plan_bins(a, a)
    out["spgemm_binned s14 warm"] = _op_split(torch, lambda: spgemm_binned(a, a, plan))
    del plan
    perm = flops_balanced_permutation(row_flops(mgt, mgt).cpu().numpy(), 4)
    mtp = mgt.conjugate_permute(torch.from_numpy(perm))
    flops1, _ = spgemm_upper_bounds(mtp, mtp)
    smgt = shard_csr(mtp, 4)
    pcs, ccs = pr.plan_shard_capacities(smgt, flops1, margin=4.0)
    smt = shard_csr(mtp, 4, local_capacity=ccs)
    mesh = make_mesh(4, dev)
    snew, _ = pr.sharded_rmcl_step(mesh, smgt, smt, pcs, ccs)
    out["sharded_rmcl_step D=4"] = _op_split(
        torch, lambda: pr.sharded_rmcl_step(mesh, smgt, smt, pcs, ccs))
    out["sharded_rmcl_step D=4's drift (csr_frobenius_diff a shard)"] = _op_split(
        torch, lambda: [csr_frobenius_diff(smt.local_block(i), snew.local_block(i))
                        for i in range(4)])
    del smgt, smt, snew
    eplan = plan_ell(a, a)
    E.spgemm_ell(a, a, eplan)  # caches the nnz(C) bucket
    cap = eplan._nnzc_cache
    out["spgemm_ell s14 warm body, eager"] = _op_split(
        torch, lambda: E._tiles_impl(a, a, eplan, fused_out_cap=cap))
    return out


def split(roots) -> None:
    rows = []
    for root in roots:
        root = os.path.abspath(root)
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "split-one", root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"ring_probe split: {root} failed")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        rows.append((root, got))
        for path, sp in got.items():
            cm = sum(r[1] for r in sp["ops"] if "cummax" in r[0])
            print(f"{root}: {path}: device {sp['device ms']:.3f} ms in "
                  f"{sum(r[2] for r in sp['kernels'])} kernels; torch.cummax {cm:.3f} ms",
                  flush=True)
            print("  kernels: " + "; ".join(f"{n} x{c} {ms:.3f}" for n, ms, c in
                                             sp["kernels"][:8]), flush=True)
            print("  ops: " + "; ".join(f"{n} x{c} {ms:.3f}" for n, ms, c in
                                         sp["ops"][:14]), flush=True)
    out = os.path.join(HERE, "build", "ring_probe")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "split.json"), "w") as f:  # every op, not only the largest
        json.dump({"split": rows}, f)


def _one_step_bodies(dev) -> dict:
    """The three step bodies at ``chip_smoke.py`` phase 16's s14 sizes,
    each a function of no arguments that reads its inputs in place and
    returns fresh outputs (no carry written back, so every run does the
    same work): the warm ``spgemm_ell`` body (``_tiles_impl`` with the
    cached bucket, random weights), one ``rmcl_ell_step`` on phase 8's
    graph (S = 128) and one general ``rmcl_one_step`` at margin 2.5."""
    import torch  # noqa: F401

    from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
    from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    rm = importlib.import_module(f"{PKG}.models.rmcl")
    re_ = importlib.import_module(f"{PKG}.models.rmcl_ell")
    a = rmat_csr(14, edge_factor=8, seed=7, weights="random")
    eplan = plan_ell(a, a)
    E.spgemm_ell(a, a, eplan)  # caches the nnz(C) bucket
    cap = eplan._nnzc_cache
    mgt, (cols0, vals0) = s14_state(dev)
    splan = re_.plan_rmcl_ell(mgt, S=128, max_tile=8192)
    a_d = re_._dense_huge(mgt, splan)
    re_._plan_tensors(splan, dev)
    pc, cc = rm.plan_capacities(mgt, mgt, 2.5)
    mtc = mgt.with_capacity(cc)
    bodies = {
        "spgemm_ell s14 warm": lambda: E._tiles_impl(a, a, eplan, fused_out_cap=cap),
        "rmcl_ell_step s14 S=128": lambda: re_.rmcl_ell_step(splan, mgt, a_d, cols0, vals0),
        "rmcl_one_step s14 margin 2.5": lambda: rm.rmcl_one_step(mgt, mtc, pc, cc),
    }
    ps, mesh, pplan, arrays, smgt, x0 = sharded_state(dev, mgt, cols0, vals0)
    for ex in EXCHANGES:
        bodies[f"sharded step s14 D=4 {ex}"] = (
            lambda ex=ex: ps._sharded_step(pplan, smgt, arrays, *x0, ex, mesh))
    return bodies


def sharded_state(dev, mgt, cols0, vals0):
    """The D = 4 stacked static sharded scan's state on phase 8's graph, as
    ``chip_smoke.py`` phases 9 and 16 build it: (module, mesh, plan,
    arrays, smgt, initial iterate), the plan's uploads made."""
    from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh

    ps = importlib.import_module(f"{PKG}.parallel.rmcl_ell")
    plan, arrays, smgt = ps.plan_sharded_rmcl_ell(mgt, 4, S=128, max_tile=8192)
    x0 = (cols0.masked_fill(cols0 >= mgt.rows, plan.n).reshape(4, plan.lr, 128),
          vals0.reshape(4, plan.lr, 128))
    ps._plan_tensors(plan, dev, range(4))  # the plan's uploads, never inside a capture
    return ps, make_mesh(4, dev), plan, arrays, smgt, x0


def capture_costs(dev) -> None:
    """What a CUDA graph costs and buys (the module docstring's
    ``capture``): eager and replay ms by CUDA events (median of 5 after a
    warm run, the replay with its clones of the outputs), capture ms by
    the host clock, the median of ``CAPTURES`` captures."""
    import math

    import torch

    from sparse_matrix_with_flops_tpu_torch import _build
    from sparse_matrix_with_flops_tpu_torch.utils import graphs

    _build.library()
    report = {}

    def show(label, row, runs):
        report[label] = row
        print(f"{label}: " + "; ".join(f"{k} {v:.3f}" if v is not None else f"{k} none"
                                       for k, v in row.items())
              + f"; captures {', '.join(f'{c:.3f}' for c in runs)} ms [CUDA events; host "
              "clock for first run and captures]", flush=True)

    for label, body in _one_step_bodies(dev).items():
        body()
        torch.cuda.synchronize()
        eager = statistics.median(_times(torch, body, reps=5))
        runs = []
        for _ in range(CAPTURES):
            # nothing to load: the body reads its inputs in place; a body no
            # program names captures at its first run
            g = graphs.CapturedBody(label, body, (torch.empty(0, device=dev),))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.run()
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3 if not runs else first
            runs.append(g.capture_ms)
        replay = statistics.median(_times(torch, g.run, reps=5))
        old = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.graph(old):
            body()
        old_ms = (time.perf_counter() - t0) * 1e3
        saved, cap = eager - replay, statistics.median(runs)
        show(label, {"eager ms": eager, "replay ms": replay, "first run ms": first,
                     "capture ms": cap, "pool MiB": g.pool_bytes / 2**20,
                     "torch.cuda.graph capture ms": old_ms,
                     "break-even iterations": 1 + cap / saved if saved > 0 else None}, runs)
        del old, g
        torch.cuda.synchronize()
    for label, (name, plan, call, eager_body) in _one_shot_programs(dev).items():
        eager_body()
        torch.cuda.synchronize()
        eager = statistics.median(_times(torch, eager_body, reps=5))
        runs, calls = [], []
        for _ in range(CAPTURES):
            graphs.drop(plan, name)  # and with it the count of eager calls
            torch.cuda.synchronize()
            for k in range(1, graphs.BREAK_EVEN[name] + 1):
                call()
                g = graphs.held(plan, name)
                if g.graph is not None:
                    break
            else:
                raise SystemExit(f"ring_probe capture: {name} captured nothing in {k} calls")
            torch.cuda.synchronize()
            runs.append(g.capture_ms)
            calls.append(k)
        replay = statistics.median(_times(torch, call, reps=5))
        saved, cap = eager - replay, statistics.median(runs)
        show(label, {"eager ms": eager, "replay ms": replay, "calls to capture": calls[0],
                     "capture ms": cap, "pool MiB": g.pool_bytes / 2**20,
                     "break-even calls": 1 + cap / saved if saved > 0 else None}, runs)
        graphs.drop(plan, name)
        torch.cuda.synchronize()

    def count(*labels):
        bs = [report[k].get("break-even iterations", report[k].get("break-even calls"))
              for k in labels]
        return None if None in bs else max(math.ceil(b) for b in bs)

    measured = {
        "spgemm_ell": count("spgemm_ell s14 warm"),
        "rmcl_ell_scan": count("rmcl_ell_step s14 S=128"),
        "sharded_rmcl_ell_scan": count(*(f"sharded step s14 D=4 {ex}" for ex in EXCHANGES)),
        "sharded_spgemm_ring": count("sharded_spgemm_ring s14 D=4 warm"),
        "spgemm_binned": count("spgemm_binned s14 warm"),
        "rmcl_scan (eager, no graph)": count("rmcl_one_step s14 margin 2.5"),
    }
    print("break-even counts, rounded up (none: the replay saves nothing): "
          + json.dumps(measured) + "; utils/graphs.BREAK_EVEN " + json.dumps(graphs.BREAK_EVEN),
          flush=True)
    report.update(sharded_spgemm_costs(dev))
    print(json.dumps({"capture": report, "break_even": measured}))


def _one_shot_programs(dev) -> dict:
    """label -> (program name, plan, the entry point's warm call, the eager
    body) of the warm ``sharded_spgemm_ring`` (D = 4 stacked, plan and
    caps passed) and ``spgemm_binned`` on R-MAT s14 with random weights."""
    ops_binned = importlib.import_module(f"{PKG}.ops.binned")
    spg = importlib.import_module(f"{PKG}.parallel.spgemm")
    a, mesh, sa, rplan, ents, _, oc = _ring_state(dev)
    bplan = ops_binned.plan_bins(a, a)
    return {
        "sharded_spgemm_ring s14 D=4 warm": (
            "sharded_spgemm_ring", rplan,
            lambda: spg.sharded_spgemm_ring(mesh, sa, sa, out_cap=oc, plan=rplan,
                                            step_ents=ents),
            lambda: spg._ring_impl(mesh, rplan.step_prod_caps, sa, sa, ents, oc)),
        "spgemm_binned s14 warm": (
            "spgemm_binned", bplan, lambda: ops_binned.spgemm_binned(a, a, bplan),
            lambda: ops_binned._binned_impl(a, a, bplan)),
    }


def _ring_state(dev):
    """R-MAT s14 (random weights), the D = 4 stacked mesh, A sharded, the
    ring's plan and step entries, and phase 13's per-shard caps: (a,
    mesh, sa, plan, ents, product cap, out cap)."""
    import numpy as np

    from sparse_matrix_with_flops_tpu_torch.ops.ell_esc import spgemm_ell
    from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
    from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh, shard_csr
    from sparse_matrix_with_flops_tpu_torch.parallel.spgemm import plan_spgemm_ring
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    d = 4
    a = rmat_csr(14, edge_factor=8, seed=7, weights="random")
    sa, mesh = shard_csr(a, d), make_mesh(d, dev)
    rp, ci, _ = a.to_numpy()
    n, lr = a.rows, sa.local_rows
    elen = np.diff(rp).astype(np.int64)
    rowf = np.bincount(np.repeat(np.arange(n), elen), weights=elen[ci], minlength=n)
    crp = spgemm_ell(a, a, plan_ell(a, a)).row_ptr.cpu().numpy()
    pc = int(rowf.reshape(d, lr).sum(axis=1).max())
    oc = int(np.diff(crp).reshape(d, lr).sum(axis=1).max())
    plan, ents = plan_spgemm_ring(sa, sa)
    return a, mesh, sa, plan, ents, pc, oc


def sharded_spgemm_costs(dev) -> dict:
    """One warm ``sharded_spgemm`` and one warm ring body (``_ring_impl``
    with the plan) at D = 4 stacked on R-MAT s14 with random weights, the
    caps of ``chip_smoke.py`` phase 13, and one ``sharded_spgemm_2d`` on
    a (2, 2) stacked mesh (a block's caps its most products): eager ms
    (CUDA events, median of 5) and device ms (torch.profiler, a call of
    5), not captured."""
    import numpy as np
    import torch

    from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh, shard_csr
    from sparse_matrix_with_flops_tpu_torch.parallel.spgemm import _ring_impl, sharded_spgemm
    from sparse_matrix_with_flops_tpu_torch.parallel.spgemm2d import (
        shard_csr_2d,
        sharded_spgemm_2d,
    )

    a, mesh, sa, plan, ents, pc, oc = _ring_state(dev)
    nx = ny = 2
    mesh2, sa2 = make_mesh((nx, ny), dev), shard_csr(a, nx)
    b2 = shard_csr_2d(a, nx, ny)
    rp, ci, _ = a.to_numpy()
    n, stripe = a.rows, b2[3]
    erow = np.repeat(np.arange(n), np.diff(rp))
    pc2 = 1
    for y in range(ny):
        sel = (ci >= y * stripe) & (ci < (y + 1) * stripe)
        blen = np.bincount(erow[sel], minlength=n)
        rf = np.bincount(erow, weights=blen[ci], minlength=n)
        pc2 = max(pc2, int(rf.reshape(nx, -1).sum(axis=1).max()))
    calls = {
        "sharded_spgemm s14 D=4 warm": lambda: sharded_spgemm(mesh, sa, sa, pc, oc),
        "sharded_spgemm_ring s14 D=4 warm, eager body": lambda: _ring_impl(
            mesh, plan.step_prod_caps, sa, sa, ents, oc),
        "sharded_spgemm_2d s14 (2, 2) warm": lambda: sharded_spgemm_2d(mesh2, sa2, *b2, pc2,
                                                                       pc2),
    }
    out = {}
    for label, fn in calls.items():
        eager = statistics.median(_times(torch, fn, reps=5))
        dev_ms = device_ms(torch, fn, calls=5)
        out[label] = {"eager ms": eager, "device ms": dev_ms}
        print(f"{label}: eager {eager:.3f} ms (CUDA events, median of 5), device "
              f"{dev_ms:.3f} ms (torch.profiler), {1 - dev_ms / eager:.1%} of the call not "
              f"device time: not captured", flush=True)
    return out


def peaks_one(dev) -> dict:
    """This process's port: ``chip_smoke.py`` phase 12's two peaks, each
    the peak device memory of one cold call above what was allocated
    before it (``spgemm_ell_partitioned`` with 4 groups, then
    ``spgemm_ell`` with a fresh plan, on R-MAT s14), and their ratio: in
    a fresh process, once more, and after three warm calls on another
    plan (a two-phase call, then warm ones: where the tree has CUDA
    graphs, an eager run with a capture and a replay)."""
    import torch

    from sparse_matrix_with_flops_tpu_torch import _build
    from sparse_matrix_with_flops_tpu_torch.ops.ell_esc import spgemm_ell
    from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
    from sparse_matrix_with_flops_tpu_torch.ops.partitioned import spgemm_ell_partitioned
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    _build.library()
    a = rmat_csr(14, edge_factor=8, seed=7, weights="random")

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        del out
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    out = {}
    for tag in ("fresh", "again", "after warm calls"):
        if tag == "after warm calls":
            plan = plan_ell(a, a)
            for _ in range(3):
                spgemm_ell(a, a, plan)
        part = peak(lambda: spgemm_ell_partitioned(a, a, parts=4))
        one = peak(lambda: spgemm_ell(a, a, plan_ell(a, a)))
        out.update({f"{tag}: partitioned": [part], f"{tag}: spgemm_ell": [one],
                    f"{tag}: ratio": [part / one]})
    return out


def entry_one(dev) -> dict:
    """This process's port: the entry points that ``chip_smoke.py``
    phases 4, 8, 9, 10, 11 and 12 time, at their default settings, each
    called once to warm and then three times: ``rmcl_ell`` on phase 8's s14
    graph (5 iterations, plan included: the STATIC route's call),
    ``rmcl`` in scan mode on s14 and on ``tests/tdatas/tdata.snap`` (5
    iterations, the default route of ``nrmcl``; host clock),
    ``rmcl_scan`` at s14 margin 2.5 (5 iterations, ms an iteration by
    CUDA events, as phase 11), the warm ``spgemm_ell`` on s14 (host
    clock a call, median of 10), ``corpus``' ``ell`` row on s14 (its
    timed ms), ``perf --kernel binned`` on phase 11's SNAP file of the
    s14 graph (its printed ms: the median of its 5 timed calls after one
    warm call, each call with a fresh plan's first calls), and
    ``run_partitioned`` with 4 groups (its timed ms, and its peak device
    memory above what was allocated before it); then ``sharded_rmcl_ell``
    at D = 4 with each exchange, 3 iterations (phase 9's calls) and 5,
    plan included, host clock."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from sparse_matrix_with_flops_tpu_torch import _build
    from sparse_matrix_with_flops_tpu_torch.cli import corpus, perf
    from sparse_matrix_with_flops_tpu_torch.formats import COO
    from sparse_matrix_with_flops_tpu_torch.io import load_coo
    from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl, rmcl_init
    from sparse_matrix_with_flops_tpu_torch.ops.ell_esc import spgemm_ell
    from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    rm = importlib.import_module(f"{PKG}.models.rmcl")
    re_ = importlib.import_module(f"{PKG}.models.rmcl_ell")
    _build.library()
    g = rmat_csr(14, edge_factor=8, seed=7)
    rp, ci, v = g.to_numpy()
    n = g.rows
    coo = COO.from_numpy(np.repeat(np.arange(n), np.diff(rp)), ci, v, n, n,
                         capacity=ci.size + n, device=dev)
    tdata = load_coo(os.path.join(sys.path[0], "tests", "tdatas", "tdata.snap"),
                     is_trans=True, extra_capacity=2**20, device=dev)
    mgt = rmcl_init(coo)
    pc, cc = rm.plan_capacities(mgt, mgt, 2.5)
    mtc = mgt.with_capacity(cc)
    a = rmat_csr(14, edge_factor=8, seed=7, weights="random")

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def events(fn):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    def warm_spgemm():
        plan = plan_ell(a, a)
        for _ in range(2):
            spgemm_ell(a, a, plan)
        return statistics.median(wall(lambda: spgemm_ell(a, a, plan)) for _ in range(10))

    tmp = tempfile.TemporaryDirectory()
    snap = os.path.join(tmp.name, "rmat_s14.snap")
    nnz = int(coo.nnz)
    r, c, v = (x[:nnz].cpu().numpy() for x in (coo.row, coo.col, coo.val))
    with open(snap, "w") as f:  # chip_smoke.py phase 11's file
        f.write(f"# R-MAT s14, edge factor 8, seed 7\n{coo.nrows} {nnz}\n")
        f.write("\n".join(f"{b} {a} {x:.9g}" for a, b, x in zip(r, c, v)) + "\n")

    def perf_binned():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = perf.main(["-i", snap, "--kernel", "binned"])
        line = buf.getvalue().splitlines()[-1]
        if rc or not line.startswith("binned spgemm: "):
            raise SystemExit(f"ring_probe entry: perf --kernel binned: {line}")
        return float(line.split()[2])

    def partitioned():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rec = corpus.run_partitioned("s14", a, 4)
        torch.cuda.synchronize()
        return rec["ms"], (torch.cuda.max_memory_allocated() - base) / 2**20

    cases = {
        "rmcl_ell s14 5 iterations ms": lambda: wall(
            lambda: re_.rmcl_ell(coo, max_iters=5, S=128, max_tile=8192)),
        "rmcl scan s14 5 iterations ms": lambda: wall(
            lambda: rmcl(rmcl_init(coo), max_iters=5, mode="scan")),
        "rmcl scan tdata 5 iterations ms": lambda: wall(
            lambda: rmcl(rmcl_init(tdata), max_iters=5, mode="scan")),
        "rmcl_scan s14 margin 2.5 ms an iteration": lambda: events(
            lambda: rm.rmcl_scan(mgt, mtc, pc, cc, 5)) / 5,
        "spgemm_ell s14 warm ms": warm_spgemm,
        "corpus ell s14 ms": lambda: corpus.run_one("s14", a, "ell")["ms"],
        "perf --kernel binned s14 ms": perf_binned,
    }
    out = {}
    for label, fn in cases.items():
        fn()
        out[label] = [fn() for _ in range(3)]
    part = [partitioned() for _ in range(3)]
    out["corpus run_partitioned s14 4 groups ms"] = [p[0] for p in part]
    out["corpus run_partitioned s14 4 groups peak MiB"] = [p[1] for p in part]
    from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh, sharded_rmcl_ell

    mesh = make_mesh(4, dev)
    for ex in EXCHANGES:
        three = lambda ex=ex: wall(lambda: sharded_rmcl_ell(  # noqa: E731
            coo, mesh, max_iters=3, S=128, max_tile=8192, exchange=ex))
        three()
        out[f"sharded_rmcl_ell s14 D=4 {ex} 3 iterations ms"] = [three() for _ in range(3)]
    for ex in EXCHANGES:
        runs = []

        def sharded(ex=ex):
            runs.append(sharded_rmcl_ell(coo, mesh, max_iters=5, S=128, max_tile=8192,
                                         exchange=ex))

        sharded()
        out[f"sharded_rmcl_ell s14 D=4 {ex} 5 iterations ms"] = [wall(sharded)
                                                                for _ in range(3)]
        out[f"sharded_rmcl_ell s14 D=4 {ex} digest"] = [digest(np, *r) for r in runs]
        del runs
    tmp.cleanup()
    return out


def digest(np, csr, hist) -> float:
    """48 bits of a SHA-256 of a result's bits (a CSR and a dict of numpy
    histories), as a float that holds them exactly."""
    import hashlib

    h = hashlib.sha256()
    for x in (*csr.to_numpy(), *(hist[k] for k in sorted(hist))):
        h.update(np.ascontiguousarray(x).tobytes())
    return float(int(h.hexdigest()[:12], 16))


def step(roots, mode: str = "step") -> None:
    rows = []
    for root in roots:
        root = os.path.abspath(root)
        if not os.path.isdir(os.path.join(root, PKG)):
            raise SystemExit(f"ring_probe: no {PKG}/ in {root}")
        res = subprocess.run([sys.executable, os.path.abspath(__file__), f"{mode}-one", root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"ring_probe {mode}: {root} failed")
        rows.append((root, json.loads(res.stdout.strip().splitlines()[-1])))
        print(f"{root}: " + "; ".join(
            f"{k} {statistics.median(v):.3f} [{min(v):.3f}, {max(v):.3f}]"
            for k, v in rows[-1][1].items())
              + {"peaks": " (MiB; ratios)", "entry": " (units as named)"}.get(mode, " ms"),
              flush=True)
    print(json.dumps({f"{mode}_ms": rows}))


def _enter_device(torch, dev) -> None:
    with torch.cuda.device(dev):
        pass


def launch_costs(dev) -> None:
    """K2, K3, K4 and K6 at their main-path sizes, and the library calls
    that compute the same functions (K3's: one index of an unfolded view
    a stream, the clipped starts already built): the one-call CUDA-event
    time that ``chip_smoke.py`` reports, the per-call time of 200
    back-to-back calls (device-bound once the host keeps ahead), the host
    time a call takes to enqueue, and the device time of each kernel from
    ``torch.profiler``; then the host cost of the steps of a wrapper."""
    import time

    import torch

    from sparse_matrix_with_flops_tpu_torch import _build
    from sparse_matrix_with_flops_tpu_torch.ops.scan_kernels import cumsum_i32
    from sparse_matrix_with_flops_tpu_torch.ops.sort_kernels import (
        compact_nonzero_rows,
        window_gather,
    )
    from sparse_matrix_with_flops_tpu_torch.parallel import ring_kernels as RK

    _build.library()
    ei = ell_inputs(dev)
    fc, fvb, st = ei["fc"], ei["fvb"], ei["starts"]
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-(2**30), 2**30, (10_597_376,), generator=g, dtype=torch.int32).to(dev)
    xc = torch.randint(0, 2**14, (4, 4096, 128), generator=g, dtype=torch.int32).to(dev)
    xv = torch.rand((4, 4096, 128), generator=g).to(dev)
    idx = RK._owners(4, RK.RIGHT, dev)
    cases = {
        f"K2 compact_nonzero_rows R={ei['part'].shape[0]} N={ei['part'].shape[1]}":
            lambda: compact_nonzero_rows(ei["part"], ei["vw"]),
        f"K3 window_gather Q={ei['p0'].shape[0]} W=128": lambda: window_gather(fc, fvb, ei["p0"]),
        f"K3 window_gather row heads Q={ei['heads'].shape[0]}":
            lambda: window_gather(fc, fvb, ei["heads"]),
        "unfold(0, 128, 1)[starts] cols+vals":
            lambda: (fc.unfold(0, 128, 1)[st], fvb.unfold(0, 128, 1)[st]),
        "K4 cumsum_i32 n=10597376": lambda: cumsum_i32(x),
        "torch.cumsum int32": lambda: torch.cumsum(x, 0, dtype=torch.int32),
        "K6 D=4 cols+vals one call": lambda: RK.ring_all_gather(xc, xv),
        "index gather cols+vals": lambda: (xc[idx], xv[idx]),
    }
    if "p1" in inspect.signature(window_gather).parameters:  # the two-list form
        cases["K3 window_gather windows + row heads in one call"] = lambda: window_gather(
            fc, fvb, ei["p0"], 128, ei["heads"])
    for name, fn in cases.items():
        one = statistics.median(_times(torch, fn, 15))
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda.synchronize()
        s.record()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host = (time.perf_counter() - t0) / 200 * 1e3
        e.record()
        e.synchronize()
        burst = s.elapsed_time(e) / 200
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        kern = [(k.key, k.self_device_time_total / k.count, k.count // 20)
                for k in prof.key_averages() if k.self_device_time_total > 0]
        print(f"{name}: one call {one:.4f} ms; 200 back to back {burst:.4f} ms a call; "
              f"host enqueue {host:.4f} ms a call; device "
              + ", ".join(f"{k[:60]} x{c} {t / 1e3:.4f} ms" for k, t, c in kern), flush=True)
    steps = {
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(0)": lambda: torch._C._cuda_getCurrentRawStream(0),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "with torch.cuda.device(dev)": lambda: _enter_device(torch, dev),
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "torch.empty([4, 16384, 128], int32)":
            lambda: torch.empty((4, 16384, 128), dtype=torch.int32, device=dev),
        "x.data_ptr()": x.data_ptr,
        "ctypes call smf_error_string(0)": lambda: _build.library().smf_error_string(0),
        "_build.stream_scratch": lambda: _build.stream_scratch("probe", dev, 0, 8),
    }
    # the C entries alone, with the arguments the wrappers build (300
    # launches each, well inside the launch queue)
    lib, stream = _build.library(), _build.current_stream(dev)
    words = xc[0].numel()
    outs = [torch.empty((4, 4 * 4096, 128), dtype=t.dtype, device=dev) for t in (xc, xv)]
    ctas, slice_, _ = RK._gather_grid(dev, 4, words)
    host = (ctypes.c_longlong * 4)(*[t.data_ptr() for t in (xc, xv, *outs)])
    flags = torch.zeros(4 * 3 * ctas, dtype=torch.int32, device=dev)
    scratch = torch.zeros(4096, dtype=torch.int64, device=dev)
    y = torch.empty_like(x)
    epoch = iter(range(1, 1 << 20))
    steps["C entry smf_ring_all_gather (cooperative launch)"] = lambda: lib.smf_ring_all_gather(
        ctypes.addressof(host), 2, 4, words, slice_, ctas, flags.data_ptr(), next(epoch), stream)
    steps["C entry smf_cumsum_i32 (memset and launch)"] = lambda: lib.smf_cumsum_i32(
        x.data_ptr(), y.data_ptr(), x.numel(), scratch.data_ptr(), stream)
    for name, fn in steps.items():
        reps = 300 if name.startswith("C entry") else 2000
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        print(f"host {name}: {(time.perf_counter() - t0) / reps * 1e6:.2f} us", flush=True)
    torch.cuda.synchronize()


K6_SYNC = "      Flag(theirs[k * stride]).store(p.epoch, cuda::std::memory_order_release);"
K6_WAIT = "      wait_epoch<32>(&mine[k * stride], p.epoch);"
K6_STACKED_TAIL = """dim3(ctas, d),
        dim3(kGatherThreads), args, 0, stream));
  };
"""
K4_VECS = "constexpr int kVecs = 8; "
K5_STAGES = "constexpr int kStages = 2;"
K5_COMPUTE = "compute<G>(st, atile"
K5_MMA = """        mma_tf32(d, al, bh0, bh1);
        mma_tf32(d, ah, bl0, bl1);
        mma_tf32(d, ah, bh0, bh1);
"""

K2_G = "  G = G < kMaxCluster ? G : kMaxCluster;"
K3_STORE = """    out_c[o] = realign(c, nc, r);
    out_v[o] = realign(v, nv, r);"""
K3_HEAD = """  static_assert(W == 128, "one 16-byte vector a lane");
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x) >> 5;
"""
K3_END = """    out_v[o] = realign(v, nv, r);
  }
}"""


def k3_loop(loop: str) -> list:
    """Edits that replace the loop of K3's W = 128 kernel by ``loop``
    (which ends the function)."""
    return [(K3_HEAD, K3_HEAD + "#if 0\n"), (K3_END, K3_END[:-1] + "#endif\n" + loop)]


def k3_windows_a_warp(n: int) -> list:
    """K3 with ``n`` windows a warp in flight (loads of all, then the
    stores of all): the whole loop of the W = 128 kernel replaced."""
    loop = f"""  constexpr int kUnroll = {n};
  const long long step = static_cast<long long>(gridDim.x) * kWarps * kUnroll;
  for (long long q0 = warp * kUnroll; q0 < Q; q0 += step) {{
    long long s[kUnroll];
    int4 c[kUnroll], v[kUnroll], cn[kUnroll], vn[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {{
      s[u] = q0 + u < Q ? clipped_start(position(p0, Q0, p1, q0 + u), nr, W) : 0;
    }}
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {{
      if (q0 + u < Q) {{
        const long long a = (s[u] >> 2) + lane;
        c[u] = src_c[a];
        v[u] = src_v[a];
        if (lane == 31 && (s[u] & 3)) {{
          cn[u] = src_c[a + 1];
          vn[u] = src_v[a + 1];
        }}
      }}
    }}
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {{
      if (q0 + u < Q) {{
        const int r = static_cast<int>(s[u] & 3);
        int4 nc = shfl_down4(c[u]), nv = shfl_down4(v[u]);
        if (lane == 31) nc = cn[u], nv = vn[u];
        const long long o = (q0 + u) * (W / 4) + lane;
        out_c[o] = realign(c[u], nc, r);
        out_v[o] = realign(v[u], nv, r);
      }}
    }}
  }}
}}"""
    return k3_loop(loop)


# units of one stream of one window, two in flight: unit i < Q the cols
# of window i, unit Q + i its value bits (row Q + i of the [2, Q, W]
# output), so the warps in flight read one stream at a time
K3_UNITS = """  constexpr int kUnroll = 2;
  const long long step = static_cast<long long>(gridDim.x) * kWarps * kUnroll;
  for (long long i0 = warp * kUnroll; i0 < 2 * Q; i0 += step) {
    long long s[kUnroll];
    int4 c[kUnroll], cn[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u;
      s[u] = i < 2 * Q ? clipped_start(position(p0, Q0, p1, i < Q ? i : i - Q), nr, W) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u;
      if (i < 2 * Q) {
        const int4* src = i < Q ? src_c : src_v;
        const long long a = (s[u] >> 2) + lane;
        c[u] = src[a];
        if (lane == 31 && (s[u] & 3)) cn[u] = src[a + 1];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u < 2 * Q) {
        int4 nc = shfl_down4(c[u]);
        if (lane == 31) nc = cn[u];
        out_c[(i0 + u) * (W / 4) + lane] = realign(c[u], nc, static_cast<int>(s[u] & 3));
      }
    }
  }
}"""

VARIANTS = {  # name -> (source, [(old, new), ...], checked): exact text edits
    "K6 as is": ("ring.cu", [], True),
    "K6 device scope": ("ring.cu", [
        (K6_SYNC, K6_SYNC.replace("Flag(", "DevFlag(")),
        (K6_WAIT, "      { DevFlag f(mine[k * stride]);\n        while (f.load("
                  "cuda::std::memory_order_acquire) != p.epoch) __nanosleep(32); }"),
        ("using Flag = cuda::atomic_ref<int, cuda::thread_scope_system>;",
         "using Flag = cuda::atomic_ref<int, cuda::thread_scope_system>;\n"
         "using DevFlag = cuda::atomic_ref<int, cuda::thread_scope_device>;")], True),
    "K6 with system fences around the flags": ("ring.cu", [
        (K6_SYNC, "      __threadfence_system();\n" + K6_SYNC),
        (K6_WAIT, K6_WAIT + "\n      __threadfence_system();")], True),
    # timing only, wrong results: what the waits and the forwarding hops cost
    "K6 no waits": ("ring.cu", [(K6_WAIT, "")], False),
    "K6 hop 0 only": ("ring.cu", [("for (int k = 1; k < hops; ++k) {",
                                   "for (int k = 1; k < 1; ++k) {")], False),
    # every launch through the instance whose parameters hold 2040 pointers
    "K6 large instance only": ("ring.cu", [(
        K6_STACKED_TAIL + "  if (n <= kPtrsSmall) return run(std::integral_constant<int, "
        "kPtrsSmall>{});", K6_STACKED_TAIL)], True),
    "K4 as is": ("cumsum_i32.cu", [], True),
    "K4 4 vectors a lane": ("cumsum_i32.cu", [(K4_VECS, "constexpr int kVecs = 4; ")], True),
    "K4 6 vectors a lane": ("cumsum_i32.cu", [(K4_VECS, "constexpr int kVecs = 6; ")], True),
    "K4 plain stores": ("cumsum_i32.cu", [(
        "__stcs(reinterpret_cast<uint4*>(out + wbase + j * 128), v[j]);",
        "*reinterpret_cast<uint4*>(out + wbase + j * 128) = v[j];")], True),
    # timing only, wrong results: what the look-back costs
    "K4 no look-back": ("cumsum_i32.cu", [(
        "excl = look_back(tiles, tile, lane);", "excl = 0;")], False),
    "K1 as is": ("sort_dedup_compact.cu", [], True),
    # timing only, wrong results: what each kind of stage costs at W = 8192
    "K1 no shuffle stages": ("sort_dedup_compact.cu", [(
        "    shfl_stages<E, C::SW>(x, rt, lane0, k);\n", "")], False),
    "K1 no register stages": ("sort_dedup_compact.cu", [(
        "    reg_stages<E>(x, lane0, k);\n", "")], False),
    "K1 no shared-memory stages": ("sort_dedup_compact.cu", [(
        "      smem_stages<C>(buf, j, k, g0);\n", "")], False),
    "K1 no network": ("sort_dedup_compact.cu", [(
        "    network<C, false>(x, buf, kstart, rt, 0);\n", "")], False),
    "K5 as is": ("bcsr_spmm.cu", [], True),
    "K5 3 stages": ("bcsr_spmm.cu", [(K5_STAGES, "constexpr int kStages = 3;")], True),
    "K5 4 stages": ("bcsr_spmm.cu", [(K5_STAGES, "constexpr int kStages = 4;")], True),
    # timing only, wrong results: the products, the B slabs, the splits
    "K5 no compute": ("bcsr_spmm.cu", [(K5_COMPUTE, "if (false) " + K5_COMPUTE)], False),
    "K5 no B slabs": ("bcsr_spmm.cu", [("  if ((st.flags & 1) == 0) return;", "  return;")],
                      False),
    "K5 no mma": ("bcsr_spmm.cu", [(K5_MMA, "")], False),
    "K2 as is": ("compact_nonzero_rows.cu", [], True),
    # designs that lost: one CTA a row (8 pieces, counted, then read
    # again), clusters of 4 CTAs (2 pieces each)
    "K2 one CTA a row": ("compact_nonzero_rows.cu", [(K2_G, "  G = 1;")], True),
    "K2 clusters of 4": ("compact_nonzero_rows.cu", [(
        "constexpr int kMaxCluster = 8;", "constexpr int kMaxCluster = 4;")], True),
    # timing only, wrong results: what the loads, the stores and the
    # scan cost
    "K2 no loads": ("compact_nonzero_rows.cu", [(
        "return *reinterpret_cast<const float4*>(v + e);",
        "return make_float4(e & 4, 1.0f, 0.0f, e & 8);")], False),
    "K2 no stores": ("compact_nonzero_rows.cu", [(
        "      *reinterpret_cast<int4*>(cols + p) = c;\n"
        "      *reinterpret_cast<float4*>(vals + p) = v;",
        "      if (c.x == -12345) *reinterpret_cast<int4*>(cols + p) = c;")], False),
    "K2 no scan": ("compact_nonzero_rows.cu", [(
        "const unsigned excl = block_excl(packed, sm.warp_tot, ptotal);",
        "const unsigned excl = threadIdx.x * 0x40004u; ptotal = 0x4000400u;")], False),
    "K3 as is": ("window_gather.cu", [], True),
    # designs that lost or tied: 4-byte loads and stores (the kernel of
    # every other W) at W = 128; two or four windows a warp in flight;
    # one stream of one window a unit; eight CTAs an SM (32 registers);
    # streaming stores
    "K3 4-byte loads and stores": ("window_gather.cu", [(
        "const bool vec = W == 128 &&", "const bool vec = W == -128 &&")], True),
    "K3 two windows a warp": ("window_gather.cu", k3_windows_a_warp(2), True),
    "K3 four windows a warp": ("window_gather.cu", k3_windows_a_warp(4), True),
    "K3 one stream a unit": ("window_gather.cu", k3_loop(K3_UNITS), True),
    "K3 eight CTAs an SM": ("window_gather.cu", [(
        "__global__ void __launch_bounds__(kThreads)\n    window_vec_kernel(",
        "__global__ void __launch_bounds__(kThreads, 8)\n    window_vec_kernel(")], True),
    "K3 streaming stores": ("window_gather.cu", [(
        K3_STORE, "    __stcs(out_c + o, realign(c, nc, r));\n"
                  "    __stcs(out_v + o, realign(v, nv, r));")], True),
    # timing only, wrong results
    "K3 no loads": ("window_gather.cu", [
        ("    const int4 c = src_c[a], v = src_v[a];",
         "    const int4 c = make_int4(static_cast<int>(a), lane, 1, 2), v = c;"),
        ("    if (lane == 31 && r) cn = src_c[a + 1], vn = src_v[a + 1];", "")], False),
    "K3 no stores": ("window_gather.cu", [(
        K3_STORE, "    const int4 x = realign(c, nc, r), y = realign(v, nv, r);\n"
                  "    if ((x.x ^ y.w) == 0x7ffffff3) out_c[o] = x;")], False),
    # K2 and K3 as first written (--root: a checkout that has them);
    # timing only, wrong results: what the loads, the stores and the
    # scan cost
    "K2 v1 as is": ("compact_nonzero_rows.cu", [], True),
    "K2 v1 no loads": ("compact_nonzero_rows.cu", [("x = v[i];", "x = (float)(i & 1);")],
                         False),
    "K2 v1 no stores": ("compact_nonzero_rows.cu", [
        ("      ko[base + pos] = i;\n      vo[base + pos] = x;",
         "      if (x == -1.5f) ko[base + pos] = i;"),
        ("    ko[i] = ncols;\n    vo[i] = 0.0f;", "    if (ncols < -7) ko[i] = 0;")], False),
    "K2 v1 no scan": ("compact_nonzero_rows.cu", [(
        "const int pos = smf::block_ballot_scan(keep, warp_cnt, total);",
        "const int pos = threadIdx.x; total = blockDim.x >> 1; (void)warp_cnt;")], False),
    "K3 v1 as is": ("window_gather.cu", [], True),
    "K3 v1 no loads": ("window_gather.cu", [(
        "out_c[i] = src_c[s];\n  out_v[i] = src_v[s];",
        "out_c[i] = static_cast<int>(s);\n  out_v[i] = static_cast<int>(q);")], False),
    "K3 v1 no stores": ("window_gather.cu", [(
        "out_c[i] = src_c[s];\n  out_v[i] = src_v[s];",
        "if (src_c[s] == -7 && src_v[s] == -9) out_c[i] = 0;")], False),
}


def build_variant(name: str, source: str, edits, root: str = HERE) -> ctypes.CDLL:
    """``csrc/<source>`` of the checkout ``root`` with exact text edits,
    and errors.cu, as one library under build/ring_probe/, its entry
    points typed as ``_build.library()``'s."""
    from sparse_matrix_with_flops_tpu_torch import _build

    csrc = os.path.join(root, PKG, "csrc")
    out = os.path.join(HERE, "build", "ring_probe")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(csrc, source)) as f:
        src = f.read()
    for old, new in edits:
        src = _edit(src, old, new)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    cu, so = os.path.join(out, f"{tag}.cu"), os.path.join(out, f"{tag}.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-shared", "-o", so, cu,
                    os.path.join(csrc, "errors.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for table, extra in ((_build._SIGNATURES, (ctypes.c_void_p,)), (_build._QUERIES, ())):
        for fn, argtypes in table.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = (*argtypes, *extra)
                getattr(lib, fn).restype = ctypes.c_int
    lib.smf_error_string.argtypes = (ctypes.c_int,)
    lib.smf_error_string.restype = ctypes.c_char_p
    return lib


def device_ms(torch, fn, calls: int = 20) -> float:
    """Device time of ``fn``'s kernels a call, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(k.self_device_time_total for k in prof.key_averages()) / calls / 1e3


def variants(dev, names, root: str = HERE) -> None:
    """Each entry of VARIANTS (those named, when names are given) built
    from ``root``'s sources and timed in turn (those marked checked held
    against the twin first), in the order given and then again in
    reverse (device time by torch.profiler, and one call by CUDA events
    as chip_smoke.py times it), on the main path's K6 (D = 4), K4, K2
    and K3 inputs, and K4 also on 2^25 words; K5 on the cant-class band
    (BCSR(8, 128), N = 512) and on s14 (N = 128); K3 also on the row
    heads of the same assembly."""
    import numpy as np
    import torch

    from sparse_matrix_with_flops_tpu_torch import _build
    from sparse_matrix_with_flops_tpu_torch.ops.scan_kernels import cumsum_i32
    from sparse_matrix_with_flops_tpu_torch.parallel import ring_kernels as RK

    g = torch.Generator().manual_seed(0)
    x = torch.randint(-(2**30), 2**30, (10_597_376,), generator=g, dtype=torch.int32).to(dev)
    xl = torch.randint(-(2**30), 2**30, (2**25,), generator=g, dtype=torch.int32).to(dev)
    xc = torch.randint(0, 2**14, (4, 4096, 128), generator=g, dtype=torch.int32).to(dev)
    xv = torch.rand((4, 4096, 128), generator=g).to(dev)
    want = (RK.ring_all_gather_plain(xc), RK.ring_all_gather_plain(xv),
            torch.cumsum(x, 0, dtype=torch.int32), torch.cumsum(xl, 0, dtype=torch.int32))
    chosen = [n for n in VARIANTS if not names or n in names]
    if names and len(chosen) != len(set(names)):
        raise SystemExit(f"ring_probe variants: unknown among {names}; have {list(VARIANTS)}")
    k1 = None
    if any(n.startswith("K1") for n in chosen):
        from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
        from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
        from sparse_matrix_with_flops_tpu_torch.ops.sort_kernels import (
            sort_dedup_compact,
            sort_dedup_compact_plain,
        )
        from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

        a = rmat_csr(14, edge_factor=8, seed=7, weights="random", device=dev)
        plan = plan_ell(a, a)
        pt = E._plan_tensors(plan, dev)
        pc, pv = E._b_ell_chunks(a, plan, pt)
        _, _, src, ent = pt["bins"][[w for w, _, _, _ in pt["bins"]].index(8192)]
        tc, tv = E._bin_tiles(a, pc, pv, src, ent, 8192, plan.chunk)
        k1 = (lambda: sort_dedup_compact(tc, tv, plan.ncols, plan.chunk),
              sort_dedup_compact_plain(tc, tv, plan.ncols))
    k5 = {}
    if any(n.startswith("K5") for n in chosen):
        from sparse_matrix_with_flops_tpu_torch.formats import BCSR
        from sparse_matrix_with_flops_tpu_torch.ops.spmm import bcsr_spmm, bcsr_spmm_plain
        from sparse_matrix_with_flops_tpu_torch.utils.generate import banded_csr, rmat_csr

        for label, mat, n in (("band", banded_csr(62451, bandwidth=32, device=dev), 512),
                              ("s14", rmat_csr(14, edge_factor=8, seed=7, weights="random",
                                               device=dev), 128)):
            ab = BCSR.from_csr(mat, 8, 128)
            b = torch.from_numpy(
                np.random.default_rng(0).random((mat.rows, n)).astype(np.float32)).to(dev)
            nnz = int(mat.row_ptr[-1])
            absa = torch.sparse_csr_tensor(mat.row_ptr, mat.col_ind[:nnz],
                                           mat.values[:nnz].abs(), size=(mat.rows, mat.ncols))
            tol = 1e-7 + 1e-4 * torch.sparse.mm(absa, b.abs())
            k5[label] = (lambda ab=ab, b=b: bcsr_spmm(ab, b), bcsr_spmm_plain(ab, b), tol)
    k23 = None
    if any(n[:2] in ("K2", "K3") for n in chosen):
        from sparse_matrix_with_flops_tpu_torch.ops.sort_kernels import (
            compact_nonzero_rows,
            compact_nonzero_rows_plain,
            window_gather,
            window_gather_plain,
        )

        ei = ell_inputs(dev)
        k23 = {
            "K2": (lambda: compact_nonzero_rows(ei["part"], ei["vw"]),
                   compact_nonzero_rows_plain(ei["part"], ei["vw"])),
            "K3": (lambda: window_gather(ei["fc"], ei["fvb"], ei["p0"]),
                   window_gather_plain(ei["fc"], ei["fvb"], ei["p0"], 128)),
        }
        heads = lambda: window_gather(ei["fc"], ei["fvb"], ei["heads"])  # noqa: E731
    libs = {name: build_variant(name, *VARIANTS[name][:2], root) for name in chosen}
    res = {name: [] for name in chosen}
    for name in [*chosen, *reversed(chosen)]:
        _build.library = lambda lib=libs[name]: lib
        RK._GRIDS.clear()
        if name.startswith("K1"):
            fn = k1[0]
            got = fn()
            ok = torch.equal(got[0], k1[1][0]) and bool(
                ((got[1] - k1[1][1]).abs() <= 1e-3 * k1[1][1].abs() + 1e-7).all())
        elif name.startswith("K5"):
            fn, s14 = k5["band"][0], k5["s14"][0]
            ok = all(bool(((f() - p).abs() <= t).all()) for f, p, t in k5.values())
        elif name[:2] in ("K2", "K3"):
            fn, want23 = k23[name[:2]]
            got = fn()
            ok = torch.equal(got[0], want23[0]) and torch.equal(got[1], want23[1])
        elif name.startswith("K6"):
            fn = lambda: RK.ring_all_gather(xc, xv)  # noqa: E731
            gc, gv = fn()
            ok = torch.equal(gc, want[0]) and torch.equal(gv, want[1])
        else:
            fn = lambda: cumsum_i32(x)  # noqa: E731
            ok = torch.equal(fn(), want[2]) and torch.equal(cumsum_i32(xl), want[3])
        if VARIANTS[name][2] and not ok:
            raise SystemExit(f"{name}: differs from the twin")
        big = (device_ms(torch, lambda: cumsum_i32(xl)) if name.startswith("K4") else
               device_ms(torch, s14) if name.startswith("K5") else
               device_ms(torch, heads) if name.startswith("K3") else 0.0)
        res[name].append((device_ms(torch, fn), statistics.median(_times(torch, fn, 15)), big))
    for name, r in res.items():
        print(f"{name}: device " + " / ".join(f"{d:.4f}" for d, _, _ in r) + " ms; one call "
              + " / ".join(f"{o:.4f}" for _, o, _ in r) + " ms"
              + ("; device at 2^25 words " + " / ".join(f"{b:.4f}" for _, _, b in r) + " ms"
                 if name.startswith("K4") else "")
              + ("; device on s14 " + " / ".join(f"{b:.4f}" for _, _, b in r) + " ms"
                 if name.startswith("K5") else "")
              + ("; device on the row heads " + " / ".join(f"{b:.4f}" for _, _, b in r)
                 + " ms" if name.startswith("K3") else ""), flush=True)


def processes_child(mode, rank, world, store, res) -> None:
    """One rank of ``processes`` (see the module's docstring)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from sparse_matrix_with_flops_tpu_torch.parallel import mesh as M
    from sparse_matrix_with_flops_tpu_torch.parallel import peer

    backend = "nccl" if mode.startswith("nccl") else "gloo"
    t0 = time.time()
    M.init_distributed(backend=backend, init_method=f"file://{store}", rank=rank,
                       world_size=world)
    mesh = M.process_mesh()
    dev = mesh.device
    out = {"init_s": time.time() - t0, "device": str(dev)}
    if mode == "gloo_cuda":
        x = torch.arange(8, device=dev, dtype=torch.float32) + 100 * rank
        try:
            o = torch.empty(8 * world, device=dev)
            dist.all_gather_into_tensor(o, x)
            torch.cuda.synchronize()
            out["all_gather_into_tensor"] = o.cpu().tolist()
        except Exception as e:  # noqa: BLE001 - the report says what the backend refused
            out["all_gather_into_tensor"] = repr(e)[:300]
        try:
            r = torch.empty(8, device=dev)
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, (rank + 1) % world),
                                           dist.P2POp(dist.irecv, r, (rank - 1) % world)])
            for q in reqs:
                q.wait()
            torch.cuda.synchronize()
            out["batch_isend_irecv"] = r.cpu().tolist()
        except Exception as e:  # noqa: BLE001
            out["batch_isend_irecv"] = repr(e)[:300]
    else:
        from sparse_matrix_with_flops_tpu_torch.parallel import ring_kernels as RK

        g = torch.Generator().manual_seed(1)
        lr, S = 1000, 128
        xc_full = torch.randint(0, 1 << 20, (world, lr, S), generator=g, dtype=torch.int32)
        xv_full = torch.rand((world, lr, S), generator=g)
        xc, xv = xc_full[rank:rank + 1].to(dev), xv_full[rank:rank + 1].to(dev)
        t1 = time.time()
        gc, gv = RK.ring_all_gather(xc, xv, mesh=mesh)
        torch.cuda.synchronize()
        out["k6_first_s"] = time.time() - t1
        want_c = RK.ring_all_gather_plain(xc_full)[rank:rank + 1]
        want_v = RK.ring_all_gather_plain(xv_full)[rank:rank + 1]
        out["k6_ok"] = bool(torch.equal(gc.cpu(), want_c) and torch.equal(gv.cpu(), want_v))
        outs = [RK.ring_all_gather(xc, xv, mesh=mesh) for _ in range(20)]
        torch.cuda.synchronize()
        out["k6_burst_ok"] = all(torch.equal(a.cpu(), want_c) and torch.equal(b.cpu(), want_v)
                                 for a, b in outs)
        pc = RK.ring_all_gather_plain(xc, mesh)
        out["k6_plain_ok"] = bool(torch.equal(pc.cpu(), want_c))
        m, lrb, n, nt = 200, 256, 4096, 2048
        a_full = torch.rand((world, m, world * lrb), generator=g)
        b_full = torch.rand((world, lrb, n), generator=g)
        a, b = a_full[rank:rank + 1].to(dev), b_full[rank:rank + 1].to(dev)
        for name, fk, fp in (
            ("k7", lambda: RK.ring_matmul(a, b, mesh=mesh),
             lambda: RK.ring_matmul_plain(a_full, b_full)[rank:rank + 1]),
            ("k8", lambda: RK.ring_matmul_tiled(a, b, nt, mesh=mesh),
             lambda: RK.ring_matmul_tiled_plain(a_full, b_full, nt)[rank:rank + 1]),
        ):
            t1 = time.time()
            k = fk()
            torch.cuda.synchronize()
            out[f"{name}_first_s"] = time.time() - t1
            p = fp()
            out[f"{name}_err"] = float((k.cpu() - p).abs().max())
            ks = [fk() for _ in range(10)]
            torch.cuda.synchronize()
            out[f"{name}_burst_err"] = max(float((x.cpu() - p).abs().max()) for x in ks)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(10):
                fk()
            e.record()
            e.synchronize()
            out[f"{name}_ms"] = s.elapsed_time(e) / 10
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(20):
            RK.ring_all_gather(xc, xv, mesh=mesh)
        e.record()
        e.synchronize()
        out["k6_ms"] = s.elapsed_time(e) / 20
        out["launches"] = [RK.ring_all_gather.launches, RK.ring_matmul.launches,
                           RK.ring_matmul_tiled.launches]
        if mode == "nccl1":
            import numpy as np

            from sparse_matrix_with_flops_tpu_torch.formats import COO
            from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh, sharded_rmcl_ell
            from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

            gg = rmat_csr(10, edge_factor=8, seed=7)
            grp, gci, gv = gg.to_numpy()
            coo = COO.from_numpy(np.repeat(np.arange(gg.rows), np.diff(grp)), gci, gv,
                                 gg.rows, gg.rows, capacity=gci.size + gg.rows, device=dev)
            for ex in ("ring", "all_gather", "pallas_ring", "fused_ring"):
                r1, h1 = sharded_rmcl_ell(coo, mesh, max_iters=3, S=128, max_tile=1024,
                                          exchange=ex)
                r2, h2 = sharded_rmcl_ell(coo, make_mesh(1), max_iters=3, S=128, max_tile=1024,
                                          exchange=ex)
                out[f"rmcl_{ex}"] = bool(
                    torch.equal(r1.row_ptr, r2.row_ptr) and torch.equal(r1.col_ind, r2.col_ind)
                    and torch.equal(r1.values, r2.values)
                    and all(np.array_equal(h1[k], h2[k]) for k in h1))
    peer.close_all()
    dist.destroy_process_group()
    with open(res, "w") as f:
        json.dump(out, f)


def processes_group(mode, world, env=None, limit=150) -> None:
    """Run ``world`` ranks of ``processes_child`` to their end or ``limit``
    seconds and print each rank's report (or its output's tail)."""
    d = os.path.join(HERE, "build", "processes", f"{mode}{world}{'_mps' if env else ''}")
    os.makedirs(d, exist_ok=True)
    store = os.path.join(d, "store")
    if os.path.exists(store):
        os.remove(store)
    procs = []
    for r in range(world):
        log = open(os.path.join(d, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "processes-child", mode, str(r),
             str(world), store, os.path.join(d, f"rank{r}.json")], stdout=log,
            stderr=subprocess.STDOUT, env={**os.environ, **(env or {})}))
    t0 = time.time()
    for p in procs:
        try:
            p.wait(max(1, limit - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    print(f"== {mode} x{world} {'MPS' if env else ''}: rc {[p.returncode for p in procs]} "
          f"in {time.time() - t0:.1f} s", flush=True)
    for r in range(world):
        j = os.path.join(d, f"rank{r}.json")
        if os.path.exists(j):
            with open(j) as f:
                print(f"  rank {r}: {f.read()}", flush=True)
        else:
            with open(os.path.join(d, f"rank{r}.log")) as f:
                print(f"  rank {r} log tail: {f.read()[-3000:]}", flush=True)


def processes() -> int:
    """The ``processes`` probe (see the module's docstring)."""
    import shutil

    sys.path.insert(0, HERE)
    from sparse_matrix_with_flops_tpu_torch import _build

    _build.library()
    mps = shutil.which("nvidia-cuda-mps-control")
    print("mps control:", mps, flush=True)
    processes_group("gloo_cuda", 2)
    processes_group("nccl1", 1)
    processes_group("k", 2)
    if not mps:
        return 0
    base = os.path.join(HERE, "build", "mps")
    env = {"CUDA_MPS_PIPE_DIRECTORY": os.path.join(base, "pipe"),
           "CUDA_MPS_LOG_DIRECTORY": os.path.join(base, "log")}
    for v in env.values():
        os.makedirs(v, exist_ok=True)
    try:
        r = subprocess.run([mps, "-d"], env={**os.environ, **env}, capture_output=True,
                           text=True, timeout=30)
        print("mps start rc", r.returncode, r.stdout[-500:], r.stderr[-500:], flush=True)
        if r.returncode == 0:
            processes_group("k", 2, env, limit=120)
    finally:
        q = subprocess.run([mps], input="quit\n", env={**os.environ, **env},
                           capture_output=True, text=True, timeout=30)
        print("mps quit rc", q.returncode, flush=True)
        logd = env["CUDA_MPS_LOG_DIRECTORY"]
        for fn in os.listdir(logd):
            with open(os.path.join(logd, fn)) as f:
                print(f"  mps log {fn}: {f.read()[-1500:]}")
    return 0


def cross_card(dev) -> int:
    """``chip_smoke.py`` phase 15(c) alone (see the module's docstring)."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke

    from sparse_matrix_with_flops_tpu_torch import _build

    cards = torch.cuda.device_count()
    if cards < 2:
        print("cross-card: needs more than one card", file=sys.stderr)
        return 1
    _build.library()
    failed = []

    def take(mode, reports):
        for r, rep in enumerate(reports):
            for line in rep["log"]:
                print(f"  [15{mode} rank {r}] {line}", flush=True)
            failed.extend(rep["failed"])

    t0 = time.perf_counter()
    coo = chip_smoke.phase8_graph(torch, np, dev)[0]
    chip_smoke.rank_group(torch, np, dev, coo, "c", min(cards, 4), take, failed)
    print(f"cross-card: {time.perf_counter() - t0:.1f} s; " +
          ("; ".join(failed) if failed else "every check passed"), flush=True)
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("accuracy", "step", "step-one", "kernels", "kernels-one",
                                     "streams", "streams-one", "split", "split-one",
                                     "peaks", "peaks-one", "entry",
                                     "entry-one", "launch", "variants", "cross-card",
                                     "processes", "processes-child", "capture"))
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--unpromoted", action="store_true")
    ap.add_argument("--root", default=HERE,
                    help="launch / variants: the checkout to import the port from")
    args = ap.parse_intermixed_args()
    root = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        print("ring_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.what == "processes-child":
        processes_child(args.roots[0], int(args.roots[1]), int(args.roots[2]), args.roots[3],
                        args.roots[4])
        return 0
    if args.what.endswith("-one"):
        sys.path.insert(0, args.roots[0])
        one = {"step-one": step_one, "kernels-one": kernels_one, "streams-one": streams_one,
               "peaks-one": peaks_one, "entry-one": entry_one, "split-one": split_one}
        print(json.dumps(one[args.what](dev)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.what in ("step", "kernels", "streams", "peaks", "entry"):
        step(args.roots, args.what)
    elif args.what == "split":
        split(args.roots)
    elif args.what == "launch":
        sys.path.insert(0, root)
        launch_costs(dev)
    elif args.what == "variants":
        sys.path.insert(0, root)
        variants(dev, args.roots, root)
    elif args.what == "cross-card":
        return cross_card(dev)
    elif args.what == "processes":
        return processes()
    elif args.what == "capture":
        sys.path.insert(0, HERE)
        capture_costs(dev)
    else:
        sys.path.insert(0, HERE)
        accuracy(dev, not args.unpromoted)
    return 0


if __name__ == "__main__":
    sys.exit(main())
