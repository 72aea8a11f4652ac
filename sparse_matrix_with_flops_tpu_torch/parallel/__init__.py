"""Distributed layer of the port: D row shards stacked on one device, or
one shard a process of a ``torch.distributed`` group, on a 1-D or a 2-D
mesh (``mesh.py``, with the collectives of each kind in
``collectives.py`` and the ring kernels' peer buffers in ``peer.py``),
the row-sharded SpGEMM (all-gathered, ring and 2-D), the dynamic and
adaptive sharded R-MCL, the ring kernels K6-K8, the sharded static R-MCL
loop, the multi-shard dry run and the weak-scaling run.  Every module
runs on both kinds of mesh."""

from .dryrun import dryrun_multichip
from .mesh import (
    ROW_AXIS,
    ProcessMesh,
    ShardMesh,
    init_distributed,
    make_mesh,
    process_mesh,
    replicated,
    row_sharding,
)
from .ring_kernels import ring_all_gather, ring_matmul, ring_matmul_tiled, unrotate
from .rmcl import (
    plan_shard_capacities,
    sharded_next_flops,
    sharded_rmcl_adaptive,
    sharded_rmcl_scan,
    sharded_rmcl_step,
)
from .rmcl_ell import plan_sharded_rmcl_ell, sharded_rmcl_ell, sharded_rmcl_ell_scan
from .sharded import ShardedCSR, flops_balanced_permutation, shard_csr, unshard_csr
from .spgemm import sharded_spgemm, sharded_spgemm_ring
from .spgemm2d import shard_csr_2d, sharded_spgemm_2d, unshard_2d
from .weak_scaling import weak_scaling_rmcl_ell

__all__ = [
    "ROW_AXIS",
    "ProcessMesh",
    "ShardMesh",
    "ShardedCSR",
    "dryrun_multichip",
    "flops_balanced_permutation",
    "init_distributed",
    "make_mesh",
    "plan_shard_capacities",
    "plan_sharded_rmcl_ell",
    "process_mesh",
    "replicated",
    "ring_all_gather",
    "ring_matmul",
    "ring_matmul_tiled",
    "row_sharding",
    "shard_csr",
    "shard_csr_2d",
    "sharded_next_flops",
    "sharded_rmcl_adaptive",
    "sharded_rmcl_ell",
    "sharded_rmcl_ell_scan",
    "sharded_rmcl_scan",
    "sharded_rmcl_step",
    "sharded_spgemm",
    "sharded_spgemm_2d",
    "sharded_spgemm_ring",
    "unrotate",
    "unshard_2d",
    "unshard_csr",
    "weak_scaling_rmcl_ell",
]
