"""PyTorch/CUDA port of ``sparse_matrix_with_flops_tpu``.

Flops-aware SpGEMM on one CUDA card: the ELL-ESC lane pipeline and the
dense-block engine behind ``spgemm_auto``, with the pipeline's row
sort, compaction, window-gather and scan kernels written in CUDA C++
(``csrc/``) and built with nvcc at first use.  Tensors on the CPU run
each kernel's plain PyTorch twin instead.
"""

from .formats.csr import CSR
from .ops.block_spgemm import block_spgemm
from .ops.dispatch import spgemm_auto
from .ops.ell_esc import spgemm_ell

__all__ = ["CSR", "block_spgemm", "spgemm_auto", "spgemm_ell"]
