r"""Weak scaling of the sharded static R-MCL (the port of the JAX
package's ``tools/weak_scaling.py``): the problem grows with the shard
count D, so the work a shard holds stays the same, and the efficiency at
D is the time of D = 1 over the time of D.

The reference tool's recipe: ``sharded_rmcl_ell`` with the ``ring``
exchange, 2 iterations, S = 64, on the R-MCL graph of R-MAT at scale
``base + log2(D)`` (edge factor 8, seed 7), one untimed call first (the
kernels' build and first-call costs), then one timed call.

It runs on the mesh the caller has: D shards stacked on one device for
each D asked for, or, under a ``torch.distributed`` group of W ranks,
D = 1 on each rank's own device and then D = W one rank a process (a
rank's time is its slowest rank's).  Stacked shards on one card time the
compute alone and give no scaling figure; so do ranks that share one
card.  It prints one JSON line per D to stdout and writes no file::

    python -m sparse_matrix_with_flops_tpu_torch.parallel.weak_scaling 1 2 4 --base-scale 14
    python -m sparse_matrix_with_flops_tpu_torch.parallel.weak_scaling 1 2 \
        --base-scale 8 --device cpu
    torchrun --nproc-per-node 4 -m sparse_matrix_with_flops_tpu_torch.parallel.weak_scaling
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from ..formats.coo import COO
from ..formats.csr import CSR
from ..models.rmcl import rmcl_init
from ..utils.generate import rmat_csr
from . import collectives, peer
from .mesh import ShardMesh, init_distributed, make_mesh, process_mesh
from .rmcl_ell import sharded_rmcl_ell

ITERS, S, EDGE_FACTOR, SEED = 2, 64, 8, 7  # tools/weak_scaling.py:36-79


def prep(scale: int, device) -> CSR:
    """The R-MCL graph of R-MAT at ``scale`` (edge factor 8, seed 7, unit
    weights) on ``device``, through ``rmcl_init``."""
    g = rmat_csr(scale, edge_factor=EDGE_FACTOR, seed=SEED, device=device)
    rp, ci, v = g.to_numpy()
    coo = COO.from_numpy(np.repeat(np.arange(g.rows), np.diff(rp)), ci, v, g.rows, g.rows,
                         capacity=ci.size + g.rows, device=device)
    return rmcl_init(coo)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _caveat(mesh) -> str:
    if not collectives.is_process(mesh):
        return "" if mesh.num_shards == 1 else (
            f"{mesh.num_shards} shards stacked on one device: the time is compute alone, with "
            "no exchange between devices, and gives no scaling figure")
    if mesh.device.type != "cuda":
        return "one rank a process on the CPU (gloo): no card's time"
    share = peer.card_share(mesh)
    return "" if share == 1 else (f"{share} ranks time-share one card: not a figure across "
                                  "cards")


def _timed(mt0, mesh, exchange: str, group) -> tuple[float, int]:
    """ms an iteration of one warm call (the slowest rank's under a
    process group ``group``, a process mesh) and the final nnz."""
    sharded_rmcl_ell(mt0, mesh, max_iters=ITERS, S=S, exchange=exchange)
    _sync(mesh.device)
    if group is not None:
        dist.barrier()
    t0 = time.perf_counter()
    _, hist = sharded_rmcl_ell(mt0, mesh, max_iters=ITERS, S=S, exchange=exchange)
    _sync(mesh.device)
    ms = (time.perf_counter() - t0) * 1e3 / ITERS
    if group is not None:
        t = torch.tensor([ms], dtype=torch.float64, device=group.device)
        ms = float(collectives.all_gather(group, t).max())
    return ms, int(hist["nnz"][-1])


def weak_scaling_rmcl_ell(devices=(1, 2, 4), base_scale: int = 14, exchange: str = "ring",
                          device=None) -> list:
    """One row a D (the reference tool's keys, with ``mesh``, ``card`` and
    ``caveat``): stacked at each of ``devices`` on ``device`` (by default
    the card), or, under a process group of W ranks, D = 1 on each rank's
    device and D = W on the process mesh (``devices`` is then ignored)."""
    group = None
    if dist.is_available() and dist.is_initialized():
        group = process_mesh(device)
        meshes = [ShardMesh(1, group.device, (1,)), group] if group.num_shards > 1 else [group]
    else:
        meshes = [make_mesh(int(d), device) for d in devices]
    rows = []
    for mesh in meshes:
        d = mesh.num_shards
        scale = base_scale + int(np.log2(d))
        mt0 = prep(scale, mesh.device)
        ms, nnz = _timed(mt0, mesh, exchange, group)
        rows.append({
            "bench": "weak_scaling_rmcl_ell", "exchange": exchange,
            "mesh": "process" if collectives.is_process(mesh) else "stacked",
            "card": _card(mesh.device), "devices": d, "scale": scale, "rows": mt0.rows,
            "ms_per_iter": ms, "nnz_per_s": nnz / (ms / 1e3), "nnz": nnz,
            "caveat": _caveat(mesh),
        })
    for row in rows:
        row["weak_scaling_efficiency_pct"] = rows[0]["ms_per_iter"] / row["ms_per_iter"] * 100.0
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("devices", type=int, nargs="*", default=[1, 2, 4],
                    help="shard counts of the stacked runs (under torchrun: 1 and W)")
    ap.add_argument("--base-scale", type=int, default=14, help="R-MAT scale at D = 1")
    ap.add_argument("--exchange", default="ring")
    ap.add_argument("--device", default=None, help='"cpu" to run without a card')
    args = ap.parse_args(argv)
    init_distributed()  # a no-op unless the environment marks a multi-process launch
    try:
        rows = weak_scaling_rmcl_ell(args.devices, args.base_scale, args.exchange, args.device)
        if not dist.is_initialized() or dist.get_rank() == 0:
            for row in rows:
                print(json.dumps(row), flush=True)
    finally:
        if dist.is_initialized():
            peer.close_all()
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
