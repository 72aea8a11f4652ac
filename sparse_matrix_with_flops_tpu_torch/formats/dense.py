"""DenseMatrix: the CSR <-> dense bridge and the dense-GEMM oracle (the
port of the JAX package's ``formats/dense.py``, after the reference's
``struct DenseMatrix``, nlibs/DenseMatrix.h:3-45)."""

from __future__ import annotations

import dataclasses

import torch

from ..config import QVALUE_DTYPE, true_f32
from .csr import CSR


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    data: torch.Tensor  # f32[rows, cols]

    @property
    def rows(self) -> int:
        return self.data.shape[0]

    @property
    def cols(self) -> int:
        return self.data.shape[1]

    @staticmethod
    def from_csr(a: CSR) -> "DenseMatrix":
        return DenseMatrix(a.to_dense())

    def matmul(self, other: "DenseMatrix") -> "DenseMatrix":
        """The cblas_dgemm role (dense-somp.cc:23-46): one matmul in true
        f32 (``config.true_f32``), as the reference's ``jnp.dot`` on the
        CPU."""
        with true_f32():
            prod = torch.matmul(self.data, other.data)
        return DenseMatrix(prod.to(QVALUE_DTYPE))

    def to_csr(self) -> CSR:
        """Through the host; exact zeros are dropped (``CSR.from_dense``)."""
        return CSR.from_dense(self.data.cpu().numpy(), self.data.device)
