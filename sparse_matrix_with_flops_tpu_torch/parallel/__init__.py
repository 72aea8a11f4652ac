"""Distributed layer of the port: D row shards stacked on one device, or
one shard a process of a ``torch.distributed`` group (``mesh.py``, with
the collectives of each kind in ``collectives.py`` and the ring kernels'
peer buffers in ``peer.py``), the row-sharded SpGEMM (all-gathered, ring
and 2-D), the dynamic and adaptive sharded R-MCL, the ring kernels
K6-K8, the sharded static R-MCL loop and the multi-shard dry run.  The
all-gathered and ring SpGEMM, the static R-MCL loop and K6-K8 run on
both kinds of mesh; the rest on the stacked one."""

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
    sharded_rmcl_adaptive,
    sharded_rmcl_scan,
    sharded_rmcl_step,
)
from .rmcl_ell import plan_sharded_rmcl_ell, sharded_rmcl_ell, sharded_rmcl_ell_scan
from .sharded import ShardedCSR, flops_balanced_permutation, shard_csr, unshard_csr
from .spgemm import sharded_spgemm, sharded_spgemm_ring

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
    "sharded_rmcl_adaptive",
    "sharded_rmcl_ell",
    "sharded_rmcl_ell_scan",
    "sharded_rmcl_scan",
    "sharded_rmcl_step",
    "sharded_spgemm",
    "sharded_spgemm_ring",
    "unrotate",
    "unshard_csr",
]
