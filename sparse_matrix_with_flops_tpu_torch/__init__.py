"""PyTorch/CUDA port of ``sparse_matrix_with_flops_tpu``.

Flops-aware SpGEMM on one CUDA card: the ELL-ESC lane pipeline and the
dense-block engine behind ``spgemm_auto``, with the pipeline's row
sort, compaction, window-gather and scan kernels written in CUDA C++
(``csrc/``) and built with nvcc at first use; the format zoo (BCSR,
COO, dense, ELL, MCSR, PCSR) with the blocked SpMM kernel
``bcsr_spmm``; the static-ELL R-MCL loop ``rmcl_ell`` and its sharded
form ``sharded_rmcl_ell``, whose ring exchanges (``ring_all_gather``,
``ring_matmul``, ``ring_matmul_tiled``) run the D shards of the ring
stacked on one card; the general R-MCL loop ``rmcl`` (stream ESC,
deterministic on the card) with ``extract_clusters``, checkpoints, the
graph readers behind ``load_coo`` and the ``nrmcl`` command line
(``cli/``).  Tensors on the CPU run each kernel's plain PyTorch twin
instead.
"""

from .formats import BCSR, COO, CSR, ELL, MCSR, PCSR, DenseMatrix, TiledCSR
from .ops.block_spgemm import block_spgemm
from .ops.dispatch import spgemm_auto
from .ops.ell_esc import spgemm_ell
from .io import load_coo
from .models.clusters import extract_clusters
from .models.rmcl import rmcl, rmcl_one_step
from .models.rmcl_ell import rmcl_ell
from .ops.spmm import bcsr_spmm
from .parallel.mesh import make_mesh
from .parallel.ring_kernels import ring_all_gather, ring_matmul, ring_matmul_tiled
from .parallel.rmcl_ell import sharded_rmcl_ell

__all__ = [
    "BCSR",
    "COO",
    "CSR",
    "DenseMatrix",
    "ELL",
    "MCSR",
    "PCSR",
    "TiledCSR",
    "bcsr_spmm",
    "block_spgemm",
    "extract_clusters",
    "load_coo",
    "make_mesh",
    "ring_all_gather",
    "ring_matmul",
    "ring_matmul_tiled",
    "rmcl",
    "rmcl_ell",
    "rmcl_one_step",
    "sharded_rmcl_ell",
    "spgemm_auto",
    "spgemm_ell",
]
