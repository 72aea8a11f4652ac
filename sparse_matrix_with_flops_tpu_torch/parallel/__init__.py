"""Distributed layer of the port: D row shards stacked on one device,
the ring kernels K6-K8, and the sharded static R-MCL loop."""

from .mesh import ROW_AXIS, ShardMesh, make_mesh
from .ring_kernels import ring_all_gather, ring_matmul, ring_matmul_tiled, unrotate
from .rmcl_ell import plan_sharded_rmcl_ell, sharded_rmcl_ell, sharded_rmcl_ell_scan
from .sharded import ShardedCSR, flops_balanced_permutation, shard_csr, unshard_csr

__all__ = [
    "ROW_AXIS",
    "ShardMesh",
    "ShardedCSR",
    "flops_balanced_permutation",
    "make_mesh",
    "plan_sharded_rmcl_ell",
    "ring_all_gather",
    "ring_matmul",
    "ring_matmul_tiled",
    "shard_csr",
    "sharded_rmcl_ell",
    "sharded_rmcl_ell_scan",
    "unrotate",
    "unshard_csr",
]
