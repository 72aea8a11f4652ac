"""MCSR: a dense top-left region plus a sparse remainder (the port of the
JAX package's ``formats/mcsr.py``, after the reference's ``struct
MCSR``, nlibs/MCSR.h:6, MCSR.cc:16-93).  SpMV / SpMM are a dense matmul
over the corner plus the CSR path over the rest, summed."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import QVALUE_DTYPE, true_f32
from .csr import CSR


@dataclasses.dataclass(frozen=True)
class MCSR:
    dense: torch.Tensor  # f32[block_rows, block_cols] top-left region
    rest: CSR  # everything outside the dense region
    block_rows: int
    block_cols: int

    @property
    def rows(self) -> int:
        return self.rest.rows

    @property
    def ncols(self) -> int:
        return self.rest.ncols

    @staticmethod
    def from_csr(a: CSR, block_rows: int, block_cols: int) -> "MCSR":
        """Split by (row < block_rows) & (col < block_cols) on the host
        (MCSR.cc:16-44); duplicates in the corner are summed."""
        rp, col, val = a.to_numpy()
        erow = np.repeat(np.arange(a.rows, dtype=np.int64), np.diff(rp.astype(np.int64)))
        in_dense = (erow < block_rows) & (col < block_cols)
        dense = np.zeros((block_rows, block_cols), dtype=np.float32)
        np.add.at(dense, (erow[in_dense], col[in_dense]), val[in_dense])
        keep = ~in_dense
        kcounts = np.bincount(erow[keep], minlength=a.rows)
        krp = np.zeros(a.rows + 1, dtype=np.int64)
        np.cumsum(kcounts, out=krp[1:])
        rest = CSR.from_numpy(
            krp.astype(np.int32), col[keep], val[keep], a.ncols, a.device
        )
        return MCSR(torch.from_numpy(dense).to(a.device), rest, block_rows, block_cols)

    def to_dense(self) -> torch.Tensor:
        out = self.rest.to_dense().clone()
        out[: self.block_rows, : self.block_cols] += self.dense
        return out

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.spmm import csr_spmv

        y = csr_spmv(self.rest, x)
        with true_f32():
            part = torch.mv(self.dense, x[: self.block_cols])
        y[: self.block_rows] += part
        return y

    def spmm(self, b: torch.Tensor) -> torch.Tensor:
        """C = A·B; the corner product is one matmul in true f32
        (``config.true_f32``; reference site ``mcsr.py:85``)."""
        from ..ops.spmm import csr_spmm_dense

        c = csr_spmm_dense(self.rest, b)
        with true_f32():
            part = torch.matmul(self.dense, b[: self.block_cols])
        c[: self.block_rows] += part
        return c.to(QVALUE_DTYPE)
