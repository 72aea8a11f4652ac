#!/usr/bin/env python3
"""Probes of the port's K7 / K8 ring matmul kernels on one CUDA card.

    python3 ring_probe.py accuracy [--unpromoted]
    python3 ring_probe.py step ROOT [ROOT ...]

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
exchange with CUDA events, and K8 alone on that iteration's hub
operands: median, min and max of 7 calls each.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "sparse_matrix_with_flops_tpu_torch"
EXCHANGES = ("fused_ring", "ring", "all_gather", "pallas_ring")


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"csrc/ring.cu changed; cannot find:\n{old}")
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
    return out


def step(roots) -> None:
    rows = []
    for root in roots:
        root = os.path.abspath(root)
        if not os.path.isdir(os.path.join(root, PKG)):
            raise SystemExit(f"ring_probe: no {PKG}/ in {root}")
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "step-one", root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"ring_probe step: {root} failed")
        rows.append((root, json.loads(res.stdout.strip().splitlines()[-1])))
        print(f"{root}: " + "; ".join(
            f"{k} {statistics.median(v):.3f} [{min(v):.3f}, {max(v):.3f}]"
            for k, v in rows[-1][1].items()) + " ms", flush=True)
    print(json.dumps({"step_ms": rows}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("accuracy", "step", "step-one"))
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--unpromoted", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ring_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.what == "step-one":
        sys.path.insert(0, args.roots[0])
        print(json.dumps(step_one(dev)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.what == "step":
        step(args.roots)
    else:
        sys.path.insert(0, HERE)
        accuracy(dev, not args.unpromoted)
    return 0


if __name__ == "__main__":
    sys.exit(main())
