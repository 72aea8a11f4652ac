"""PyTorch/CUDA port of ``sparse_matrix_with_flops_tpu``.

Flops-aware SpGEMM on one CUDA card: the ELL-ESC lane pipeline and the
dense-block engine behind ``spgemm_auto``, with the pipeline's row
sort, compaction, window-gather and scan kernels written in CUDA C++
(``csrc/``) and built with nvcc at first use; the format zoo (BCSR,
COO, dense, ELL, MCSR, PCSR) with the blocked SpMM kernel
``bcsr_spmm``.  Tensors on the CPU run each kernel's plain PyTorch twin
instead.
"""

from .formats import BCSR, COO, CSR, ELL, MCSR, PCSR, DenseMatrix, TiledCSR
from .ops.block_spgemm import block_spgemm
from .ops.dispatch import spgemm_auto
from .ops.ell_esc import spgemm_ell
from .ops.spmm import bcsr_spmm

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
    "spgemm_auto",
    "spgemm_ell",
]
