"""The multi-shard dry run: one step of each distributed R-MCL path and
the ring SpGEMM on tiny shapes, with the shards stacked on one device
(the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -m sparse_matrix_with_flops_tpu_torch.parallel.dryrun 4           # on the card
    python -m sparse_matrix_with_flops_tpu_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from ..formats.csr import CSR
from ..ops.spgemm import spgemm_upper_bounds
from .mesh import make_mesh, row_sharding
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


def dryrun_multichip(n_shards: int, device=None) -> tuple[int, int, float]:
    """One step of the static sharded R-MCL (``sharded_rmcl_ell``, S =
    16), one of the dynamic ``sharded_rmcl_scan`` with its operands
    placed through ``row_sharding``, and ``sharded_spgemm_ring``, on an
    ``n_shards`` mesh on ``device`` (by default the card).  Prints the
    reference's line and returns (static nnz, dynamic nnz, differs)."""
    mesh = make_mesh(n_shards, device)
    mt0 = _tiny_graph(n_rows=8 * n_shards, device=mesh.device)

    # the static fused distributed R-MCL (ELL iterate)
    out, hist = sharded_rmcl_ell(mt0, mesh, max_iters=1, S=16)
    nnz = int(out.nnz)
    if nnz <= 0:
        raise AssertionError("distributed R-MCL produced an empty iterate")

    # the dynamic sharded path (CSR iterate, all-gathered)
    flops, _ = spgemm_upper_bounds(mt0, mt0)
    smgt = shard_csr(mt0, n_shards, local_capacity=mt0.capacity)
    smt = shard_csr(mt0, n_shards, local_capacity=mt0.capacity)
    pc, cc = plan_shard_capacities(smgt, int(flops) * 4, margin=4.0)
    sh = row_sharding(mesh)
    smgt, smt = sh.put(smgt), sh.put(smt)
    _, dyn_hist = sharded_rmcl_scan(mesh, smgt, smt, pc, cc, max_iters=1)
    if bool(dyn_hist["overflow"].any()):
        raise AssertionError("overflow")

    # the memory-scalable exchange: B's blocks rotated around the ring
    cring, _ = sharded_spgemm_ring(mesh, smgt, smt, int(flops) * 2, int(flops) * 2)
    if int(unshard_csr(cring).nnz) <= 0:
        raise AssertionError("ring SpGEMM produced nothing")
    dyn_nnz = int(dyn_hist["nnz_mt"][0])
    differs = float(hist["differs"][0])
    print(
        f"dryrun_multichip({n_shards}): ok — static nnz={nnz}, "
        f"dynamic nnz={dyn_nnz}, differs={differs:.4f}"
    )
    return nnz, dyn_nnz, differs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_shards", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None, help='"cpu" to run without a card')
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_shards, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
