"""Corpus runner, the tools/runs.sh / mindex2-cuda/run2.sh role (the port
of the JAX package's ``cli/corpus.py``).

The reference iterates its binaries over a fixed SuiteSparse/SNAP matrix
list; that corpus is not shipped, so this runner takes a directory of
matrix files and/or generates the synthetic workload-equivalent corpus
(R-MAT power-law + banded FEM-like) and reports per-matrix SpGEMM GFLOPS
as JSON lines, with the reference's keys plus ``device``, the card's
name.  Runs on the CUDA card unless ``--device`` names another.  On the
card a multiply is timed by the slope of CUDA-event times
(``utils/timing.slope_bench``); on the CPU by the median of the host
clock (``bench_fn``).

Usage: python -m sparse_matrix_with_flops_tpu_torch.cli.corpus --synthetic --scales 14 --kernel auto --check
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

from ..config import resolve_device
from ..formats.csr import CSR
from ..utils.nphost import csr_host

# the reference's ELL-tile skip in the duel: 6 GB, 0.375 of the memory of
# the device it was set for
ELL_TILE_SHARE = 0.375
ELL_TILE_GB_CPU = 6.0


def _platform(device: torch.device) -> dict:
    """The record's device keys."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": device.type, "device": name}


def _time_step(step, device: torch.device) -> tuple[float, str]:
    """(ms per call of ``step()``, how it was timed): the slope of CUDA
    event times on the card, the median host-clock time on the CPU."""
    from ..utils.timing import bench_fn, slope_bench

    if device.type == "cuda":
        with torch.cuda.device(device):
            return slope_bench(step), "slope"
    return bench_fn(step), "host-median"


def _with_zero(x: CSR, zero: torch.Tensor) -> CSR:
    """``x`` with a zero added to its values: each timed call does the
    add, so no call reuses an earlier call's input."""
    return CSR(x.row_ptr, x.col_ind, x.values + zero, x.ncols)


def _scipy_nnzc(a) -> tuple:
    """(value nnz, structural nnz) of A·A per scipy.

    scipy's csr matmul silently DROPS entries whose f32 accumulation
    cancels to exactly 0.0, so the honest oracle is a RANGE: the
    structural count (0/1 pattern product — what the block engine and
    the sort pipeline produce) down to the value-pruned count (what the
    dense hub produces, raw-equal semantics)."""
    import scipy.sparse as sp

    rp, ci, v = a.to_numpy()
    sa = sp.csr_matrix((v, ci, rp), shape=a.shape)
    vn = int((sa @ sa).nnz)
    pat = sa.copy()
    pat.data = np.ones_like(pat.data)
    sn = int((pat @ pat).nnz)
    return vn, sn


def _check(rec: dict, a: CSR, got_nnz: int) -> None:
    vn, sn = _scipy_nnzc(a)
    rec["nnzc"] = got_nnz
    rec["nnzc_scipy"] = vn
    rec["nnzc_structural"] = sn
    rec["nnzc_ok"] = bool(vn <= got_nnz <= sn)


def run_partitioned(
    name, a, parts: int, check: bool = False,
    chunk: int | None = None, max_w: int | None = None,
):
    """Reference-scale row: A row-split into flops-balanced groups, each
    group's fused multiply timed separately (every group is its own
    dispatch — ops/partitioned.py's memory-bounding contract; each is
    the eager warm body, since the partitioned path keeps no CUDA
    graph), total ms = sum of group times.  The host stitch is
    excluded, matching the reference's kernel-only GFLOPS accounting
    (only-somp.cc:36-37); host planning is reported as ``plan_ms`` and
    charged in ``gflops_cold`` because the reference times its
    symbolic/partition phases inside the multiply
    (static_omp_csr_kernel.cc:98-163)."""
    from ..ops.ell_esc import _tiles_impl, spgemm_ell
    from ..ops.ell_plan import plan_ell
    from ..ops.partitioned import csr_row_slice, flops_prefix_partition
    from ..ops.spgemm import spgemm_upper_bounds

    kw = {}
    if chunk is not None:
        kw["chunk"] = chunk
    if max_w is not None:
        kw["max_w"] = max_w
    product_cap, _ = spgemm_upper_bounds(a, a)
    t_plan0 = time.monotonic()
    cuts = flops_prefix_partition(a, a, parts)
    plan_ms = (time.monotonic() - t_plan0) * 1e3
    zero = torch.zeros((), dtype=a.values.dtype, device=a.device)
    total_ms, nnzc = 0.0, 0
    group_ms = []
    how = None
    for r0, r1 in zip(cuts[:-1], cuts[1:]):
        a_g = csr_row_slice(a, r0, r1)
        t0 = time.monotonic()
        plan = plan_ell(a_g, a, **kw)
        plan_ms += (time.monotonic() - t0) * 1e3
        # two-phase: sizes the nnz(C) bucket.  No warm spgemm_ell call
        # follows: it would capture a CUDA graph whose pool the plan keeps
        # through the timed loop, beside the eager working set
        nnzc += int(spgemm_ell(a_g, a, plan).row_ptr[-1])
        cap = getattr(plan, "_nnzc_cache")

        def step(a_g=a_g, plan=plan, cap=cap):
            return _tiles_impl(_with_zero(a_g, zero), a, plan, fused_out_cap=cap)

        g_ms, how = _time_step(step, a.device)
        group_ms.append(round(g_ms, 3))
        total_ms += g_ms
    rec = {
        "matrix": name,
        "kernel": "ell",
        "parts": parts,
        "rows": a.rows,
        "annz": int(a.nnz),
        "oflops": product_cap,
        "ms": round(total_ms, 3),
        "gflops": round(2.0 * product_cap / total_ms / 1e6, 4),
        "plan_ms": round(plan_ms, 1),
        "gflops_cold": round(
            2.0 * product_cap / (plan_ms + total_ms) / 1e6, 4
        ),
        **_platform(a.device),
        "group_ms": group_ms,
        "timing": f"{how}-sum-of-groups",
    }
    if chunk is not None:
        rec["chunk"] = chunk
    if max_w is not None:
        rec["max_w"] = max_w
    if check:
        _check(rec, a, nnzc)
    return rec


def prep_block_step(a):
    """Dense-block benchmark setup: the plan, the exact-nnz output bucket
    sized once, and the step.  Returns ``(fn, plan_ms, cap)`` where
    ``fn(csr)`` assembles the exact flat CSR into the pre-sized
    bucket."""
    from ..ops.block_spgemm import block_spgemm_tiled, plan_block

    t0 = time.monotonic()
    plan = plan_block(a, a)
    plan_ms = (time.monotonic() - t0) * 1e3
    # size the exact-nnz output bucket once (the two-phase symbolic
    # role); the timed step then assembles into that fixed bucket,
    # matching the ELL path's accounting
    cap = int(block_spgemm_tiled(a, a, plan).nnz)

    def fn(x):
        return block_spgemm_tiled(x, x, plan).to_csr(out_cap=cap)

    return fn, plan_ms, cap


def run_one(name, a, kernel: str, check: bool = False,
            chunk: int | None = None, max_w: int | None = None):
    from ..ops.binned import plan_bins, spgemm_binned
    from ..ops.ell_esc import spgemm_ell, spgemm_ell_tiled
    from ..ops.ell_plan import plan_ell
    from ..ops.spgemm import spgemm, spgemm_upper_bounds

    product_cap, out_cap = spgemm_upper_bounds(a, a)
    plan_ms = None
    t_plan0 = time.monotonic()
    routed = None
    if kernel == "auto":
        from ..ops.dispatch import route

        kernel, fill = route(a, a)
        routed = {"fill": round(fill, 4), "kernel": kernel}
    kw = {}
    if chunk is not None:
        kw["chunk"] = chunk
    if max_w is not None:
        kw["max_w"] = max_w
    if kernel == "esc":
        fn = lambda x: spgemm(x, x, product_cap, out_cap)  # noqa: E731
    elif kernel == "binned":
        plan = plan_bins(a, a)
        fn = lambda x: spgemm_binned(x, x, plan)  # noqa: E731
    elif kernel == "ell-tiled":
        plan = plan_ell(a, a, split_hub=False, **kw)
        fn = lambda x: spgemm_ell_tiled(x, x, plan)  # noqa: E731
    elif kernel == "block":
        # host planning = route fill estimate (when we came through
        # 'auto'; t_plan0 predates it) + plan_block; the bucket-sizing
        # device call inside prep_block_step is excluded, as on the ELL
        # path
        pre_ms = (time.monotonic() - t_plan0) * 1e3
        fn, p_ms, _cap = prep_block_step(a)
        plan_ms = pre_ms + p_ms
    else:
        plan = plan_ell(a, a, **kw)
        plan_ms = (time.monotonic() - t_plan0) * 1e3
        # warm twice: the first exact call caches the nnz(C) bucket, the
        # second validates it (on the card: captures the warm call's CUDA
        # graph); the timed op is then the warm call, the fused
        # single-pass multiply with that bucket, as perf's ``ell`` times it
        spgemm_ell(a, a, plan)
        spgemm_ell(a, a, plan)

        def fn(x):
            return spgemm_ell(x, x, plan)

    if plan_ms is None:
        plan_ms = (time.monotonic() - t_plan0) * 1e3

    zero = torch.zeros((), dtype=a.values.dtype, device=a.device)
    ms, how = _time_step(lambda: fn(_with_zero(a, zero)), a.device)
    rec = {
        "matrix": name,
        "kernel": kernel,
        "rows": a.rows,
        "annz": int(a.nnz),
        "oflops": product_cap,
        "ms": round(ms, 3),
        "gflops": round(2.0 * product_cap / ms / 1e6, 4),
        "plan_ms": round(plan_ms, 1),
        "gflops_cold": round(2.0 * product_cap / (plan_ms + ms) / 1e6, 4),
        **_platform(a.device),
        "timing": how,
    }
    if chunk is not None:
        rec["chunk"] = chunk
    if max_w is not None:
        rec["max_w"] = max_w
    if routed is not None:
        rec["routed"] = routed
    if check:
        # exact nnz(C) cross-check vs scipy's Gustavson (host oracle);
        # CSR and TiledCSR (ell-tiled) both give nnz
        _check(rec, a, int(fn(a).nnz))
    return rec


def _ell_tile_gb(a) -> float:
    """Rough single-dispatch ELL tile footprint (GB): pow2-padded row
    widths x 2 planes x 4 B x ~3 live copies through the sort.  Band
    matrices pad brutally (cant: 6240-wide rows -> 8192-wide bins x 62k
    rows ~ 12+ GB) — the duel must know before dispatching."""
    from ..utils.nphost import pow2ceil_arr, segment_sums, snap_chunks_arr

    rp, ci = csr_host(a)
    nnz = int(rp[-1])
    bc = np.diff(rp)
    safe = np.clip(ci[:nnz], 0, a.rows - 1)
    elen = bc[safe]
    chunk = 32
    epw = snap_chunks_arr(np.maximum(-(-elen // chunk), 1)) * chunk
    epw[elen == 0] = 0
    prow = segment_sums(epw, rp)
    wr = pow2ceil_arr(np.maximum(prow, chunk))
    binned = wr[(prow > 0) & (wr <= 8192)]
    return float(binned.sum()) * 2 * 4 * 3 / 1e9


def _ell_tile_limit_gb(device: torch.device) -> float:
    """The ELL tile footprint past which the duel skips the ELL engine:
    the reference's share of device memory on the card; on the CPU the
    reference's own figure, so the CPU run takes the JAX duel's
    decisions."""
    if device.type == "cuda":
        return ELL_TILE_SHARE * torch.cuda.get_device_properties(device).total_memory / 1e9
    return ELL_TILE_GB_CPU


def run_duel(name, a, check: bool = False):
    """Run BOTH engines plus the production route decision, recording
    how much the auto choice loses to the better engine (the dispatch
    boundary validated, not extrapolated from one calibration point per
    side).  When both engines are skipped or fail, the record carries
    ``duel_errors``, no ``ms`` and ``auto_loss`` None."""
    from ..ops.dispatch import route

    kernel, fill = route(a, a)
    recs, errs = {}, {}
    limit = _ell_tile_limit_gb(a.device)
    for k in ("block", "ell"):
        if k == "block" and fill < 0.02:
            # power-law block plans explode (pairs ~ nnz^2/blocks); the
            # boundary question only matters near the threshold
            continue
        if k == "ell":
            gb = _ell_tile_gb(a)
            if gb > limit:
                # a single-dispatch ELL tile footprint past the device's
                # memory doesn't just fail, it can leave the allocator
                # unable to serve the next matrix — pre-estimate and skip;
                # the partitioned driver is the production answer there
                errs[k] = f"skipped: ~{gb:.1f} GB single-dispatch tiles"
                continue
        try:
            recs[k] = run_one(name, a, k, check=check)
        except Exception as e:  # a failed engine is a result of the duel
            errs[k] = f"{type(e).__name__}: {str(e)[:120]}"
    if not recs:
        return {
            "matrix": name,
            "kernel": kernel,
            "rows": a.rows,
            "annz": int(a.nnz),
            **_platform(a.device),
            "routed": {"fill": round(fill, 4), "kernel": kernel},
            "duel_ms": {},
            "duel_errors": errs,
            "auto_loss": None,
        }
    if kernel not in recs:
        kernel = next(iter(recs))
    rec = dict(recs[kernel])
    rec["routed"] = {"fill": round(fill, 4), "kernel": kernel}
    rec["duel_ms"] = {k: r["ms"] for k, r in recs.items()}
    if errs:
        rec["duel_errors"] = errs
    best = min(r["ms"] for r in recs.values())
    rec["auto_loss"] = round(rec["ms"] / best - 1.0, 4)
    return rec


def family_jobs(device=None):
    """Synthetic workload-equivalents of the reference corpus anchors
    (tools/olarge_flops.txt; run2.sh:8 corpus discipline): FEM bands
    spanning in-band densities 0.05-1.0 (block fills ~0.02-0.17) and
    power-law graphs down to the hypersparse web class, built on
    ``device``."""
    from ..utils.generate import banded_csr, rmat_csr

    return [
        ("banded_cant_62k_b32", lambda: banded_csr(62451, bandwidth=32, device=device)),
        (
            "fem_shipsec_60k_b60_d045",
            lambda: banded_csr(60000, bandwidth=60, seed=1, density=0.45, device=device),
        ),
        (
            "fem_consph_83k_b250_d014",
            lambda: banded_csr(83334, bandwidth=250, seed=2, density=0.14, device=device),
        ),
        (
            "fem_pwtk_100k_b100_d025",
            lambda: banded_csr(100000, bandwidth=100, seed=3, density=0.25, device=device),
        ),
        (
            "fem_mid_60k_b400_d005",
            lambda: banded_csr(60000, bandwidth=400, seed=4, density=0.05, device=device),
        ),
        ("rmat_s14", lambda: rmat_csr(14, edge_factor=8, seed=7, device=device)),
        (
            "web_hyper_s16_ef11",
            lambda: rmat_csr(
                16, edge_factor=11, a=0.65, b=0.15, c=0.15, seed=9, device=device
            ),
        ),
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="corpus benchmark runner")
    p.add_argument("--dir", default=None, help="directory of .mtx/.snap files")
    p.add_argument(
        "--synthetic",
        action="store_true",
        help="add the synthetic corpus (rmat scales + banded)",
    )
    p.add_argument("--scales", default="10,12,14")
    p.add_argument("--banded", action="store_true", help="include the banded FEM-like case")
    p.add_argument(
        "--cant",
        action="store_true",
        help="include the reference-scale cant.mtx-class workload "
        "(62451 rows, ~4.06M nnz, ~266M Oflops — the anchors of "
        "tools/res.txt)",
    )
    p.add_argument(
        "--kernel",
        default="ell",
        choices=["esc", "binned", "ell", "ell-tiled", "block", "auto"],
        help="block = dense-block path (band/FEM-class matrices); "
        "auto = route per matrix by measured block fill "
        "(ops.dispatch.spgemm_auto's rule) and record the decision",
    )
    p.add_argument(
        "--check",
        action="store_true",
        help="cross-check exact nnz(C) against scipy per matrix",
    )
    p.add_argument(
        "--mt",
        action="store_true",
        help="also run the 4-thread C++ Gustavson baseline "
        "(io/native.spgemm_mt_baseline — the reference's flagship "
        "kernel class, symbolic phase included in its timing) and "
        "record vs_baseline_mt per matrix",
    )
    p.add_argument(
        "--parts",
        type=int,
        default=1,
        help=">1: row-partitioned driver (ops/partitioned.py law) — "
        "sum of per-group times; needed past one dispatch's memory",
    )
    p.add_argument(
        "--families",
        action="store_true",
        help="add the reference-anchor synthetic corpus "
        "(FEM bands at fills 0.05-0.45 + power-law/web classes)",
    )
    p.add_argument(
        "--duel",
        action="store_true",
        help="run BOTH engines per matrix and record auto_loss "
        "(how much the production route loses to the better engine)",
    )
    p.add_argument("--chunk", type=int, default=None, help="plan chunk override")
    p.add_argument("--max-w", type=int, default=None, help="plan max_w override")
    p.add_argument("--out", default=None, help="append JSON lines here")
    p.add_argument(
        "--device", default=None,
        help="torch device, e.g. cpu or cuda:0 (default: the CUDA card)",
    )
    args = p.parse_args(argv)
    if args.parts > 1 and args.kernel != "ell":
        p.error("--parts > 1 supports only --kernel ell")
    device = resolve_device(args.device, "corpus")

    jobs = []
    if args.dir:
        from ..io import load_coo

        for f in sorted(
            glob.glob(os.path.join(args.dir, "*.mtx"))
            + glob.glob(os.path.join(args.dir, "*.snap"))
        ):
            coo = load_coo(f, is_trans=False, device=device)
            jobs.append((os.path.basename(f), coo.sum_duplicates().to_csr()))
    if args.families:
        for name, build in family_jobs(device):
            jobs.append((name, build()))
    if args.synthetic or not jobs:
        from ..utils.generate import banded_csr, rmat_csr

        for s in [int(x) for x in args.scales.split(",") if x.strip()]:
            jobs.append((f"rmat_s{s}", rmat_csr(s, edge_factor=8, seed=7, device=device)))
        if args.banded:
            jobs.append(("banded_8k_b32", banded_csr(8192, bandwidth=32, device=device)))
        if args.cant:
            # cant.mtx workload equivalent: 62451 rows x (2*32+1) band
            # -> Annz ~4.06M, Oflops ~266M (reference anchors: Annz
            # 4,007,383 / Oflops 269,475,365, tools/res.txt)
            jobs.append(
                ("banded_cant_62k_b32", banded_csr(62451, bandwidth=32, device=device))
            )

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    sink = open(args.out, "a") if args.out else None
    try:
        for name, a in jobs:
            if args.parts > 1:
                rec = run_partitioned(
                    name, a, args.parts, check=args.check,
                    chunk=args.chunk, max_w=args.max_w,
                )
            elif args.duel:
                rec = run_duel(name, a, check=args.check)
            else:
                rec = run_one(
                    name, a, args.kernel, check=args.check,
                    chunk=args.chunk, max_w=args.max_w,
                )
            if args.mt:
                from ..io.native import spgemm_mt_baseline

                rp, ci = csr_host(a)
                mt = spgemm_mt_baseline(rp, ci, a.values.cpu().numpy(), a.ncols)
                if mt is not None:
                    rec["mt_baseline_ms"] = round(mt[0], 3)
                    if "ms" in rec:  # a duel with both engines skipped has none
                        # ratio > 1 means the port beats the 4-thread CPU;
                        # _cold charges the port's host planning too (the
                        # CPU baseline always includes its symbolic phase)
                        rec["vs_baseline_mt"] = round(mt[0] / rec["ms"], 3)
                        rec["vs_baseline_mt_cold"] = round(
                            mt[0] / (rec["ms"] + rec.get("plan_ms", 0.0)), 3
                        )
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
