"""The multi-shard dry run: one step of each distributed R-MCL path and
the ring SpGEMM on tiny shapes (the port's counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``), with the shards stacked
on one device, or one rank a process under a ``torch.distributed``
group (the counterpart of ``tools/multihost_dryrun.py``: every rank
returns the numbers of the stacked run at the same D).

    python -m sparse_matrix_with_flops_tpu_torch.parallel.dryrun 4           # on the card
    python -m sparse_matrix_with_flops_tpu_torch.parallel.dryrun 4 --device cpu
    torchrun --nproc-per-node 2 -m sparse_matrix_with_flops_tpu_torch.parallel.dryrun
"""

from __future__ import annotations

import argparse

import numpy as np
import torch.distributed as dist

from ..formats.csr import CSR
from ..ops.spgemm import spgemm_upper_bounds
from . import collectives
from .mesh import ProcessMesh, ShardMesh, init_distributed, make_mesh, row_sharding
from .rmcl import plan_shard_capacities, sharded_rmcl_scan
from .rmcl_ell import sharded_rmcl_ell
from .sharded import shard_csr, unshard_csr
from .spgemm import sharded_spgemm_ring


def _tiny_graph(n_rows: int = 24, seed: int = 0, device=None) -> CSR:
    """The reference's tiny row-stochastic graph, from the same seed."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n_rows, n_rows)) < 0.25
    np.fill_diagonal(mask, True)
    dense = np.where(mask, 1.0, 0.0).astype(np.float32)
    dense /= dense.sum(axis=1, keepdims=True)
    return CSR.from_dense(dense, device)


def dryrun_multichip(n_shards=None, device=None) -> tuple[int, int, float]:
    """One step of the static sharded R-MCL (``sharded_rmcl_ell``, S =
    16), one of the dynamic ``sharded_rmcl_scan`` with its operands
    placed through ``row_sharding``, and ``sharded_spgemm_ring``, on
    ``make_mesh(n_shards, device)`` (by default on the card; under a
    process group of W ranks the process mesh, n_shards W or None), or
    on ``n_shards`` itself when it is a mesh.  Prints the reference's
    line (on a process mesh, rank 0 alone) and returns (static nnz,
    dynamic nnz, differs), the same on every rank."""
    mesh = n_shards if isinstance(n_shards, (ShardMesh, ProcessMesh)) else make_mesh(
        n_shards, device)
    n_shards = mesh.num_shards
    mt0 = _tiny_graph(n_rows=8 * n_shards, device=mesh.device)

    # the static fused distributed R-MCL (ELL iterate)
    out, hist = sharded_rmcl_ell(mt0, mesh, max_iters=1, S=16)
    nnz = int(out.nnz)
    if nnz <= 0:
        raise AssertionError("distributed R-MCL produced an empty iterate")

    # the dynamic sharded path (CSR iterate, all-gathered)
    flops, _ = spgemm_upper_bounds(mt0, mt0)
    smgt = shard_csr(mt0, mesh, local_capacity=mt0.capacity)
    smt = shard_csr(mt0, mesh, local_capacity=mt0.capacity)
    pc, cc = plan_shard_capacities(smgt, int(flops) * 4, margin=4.0)
    sh = row_sharding(mesh)
    smgt, smt = sh.put(smgt), sh.put(smt)
    _, dyn_hist = sharded_rmcl_scan(mesh, smgt, smt, pc, cc, max_iters=1)
    if bool(dyn_hist["overflow"].any()):
        raise AssertionError("overflow")

    # the memory-scalable exchange: B's blocks rotated around the ring
    cring, _ = sharded_spgemm_ring(mesh, smgt, smt, int(flops) * 2, int(flops) * 2)
    if int(unshard_csr(cring, mesh).nnz) <= 0:
        raise AssertionError("ring SpGEMM produced nothing")
    dyn_nnz = int(dyn_hist["nnz_mt"][0])
    differs = float(hist["differs"][0])
    if collectives.axis_index(mesh) == 0:
        print(
            f"dryrun_multichip({n_shards}): ok — static nnz={nnz}, "
            f"dynamic nnz={dyn_nnz}, differs={differs:.4f}"
        )
    return nnz, dyn_nnz, differs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_shards", type=int, nargs="?", default=None,
                    help="shards (default 4; under torchrun the world size)")
    ap.add_argument("--device", default=None, help='"cpu" to run without a card')
    args = ap.parse_args(argv)
    init_distributed()  # a no-op unless the environment marks a multi-process launch
    try:
        n = args.n_shards if args.n_shards is not None or dist.is_initialized() else 4
        dryrun_multichip(n, args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
