"""PCSR: column-striped CSR (the port of the JAX package's
``formats/pcsr.py``, after the reference's ``struct PCSR``,
nlibs/PCSR.h:5-101).  ``stripes[b]`` holds columns
[b·stride, (b+1)·stride) with local column ids; its one kernel is the
stripe-by-stripe SpGEMM (correctTests/pcsrTest.cc:7-19)."""

from __future__ import annotations

import dataclasses

import numpy as np

from .csr import CSR


@dataclasses.dataclass(frozen=True)
class PCSR:
    stripes: tuple  # tuple[CSR, ...]
    ncols: int

    @property
    def num_stripes(self) -> int:
        return len(self.stripes)

    @property
    def stride(self) -> int:
        return -(-self.ncols // self.num_stripes)  # PCSR.h:20-22

    @property
    def rows(self) -> int:
        return self.stripes[0].rows

    @staticmethod
    def from_csr(a: CSR, num_stripes: int) -> "PCSR":
        stride = -(-a.ncols // num_stripes)
        rp, col, val = a.to_numpy()
        erow = np.repeat(np.arange(a.rows, dtype=np.int64), np.diff(rp.astype(np.int64)))
        stripes = []
        for b in range(num_stripes):
            lo, hi = b * stride, min((b + 1) * stride, a.ncols)
            sel = (col >= lo) & (col < hi)
            counts = np.bincount(erow[sel], minlength=a.rows)
            srp = np.zeros(a.rows + 1, dtype=np.int64)
            np.cumsum(counts, out=srp[1:])
            stripes.append(
                CSR.from_numpy(
                    srp.astype(np.int32), col[sel] - lo, val[sel], hi - lo, a.device
                )
            )
        return PCSR(tuple(stripes), a.ncols)

    def to_csr(self) -> CSR:
        """Stitch the stripes back through a dense host matrix (exact
        zeros are dropped, as the reference's ``CSR.from_dense``)."""
        dense = np.zeros((self.rows, self.ncols), dtype=np.float32)
        stride = self.stride
        for b, s in enumerate(self.stripes):
            dense[:, b * stride : b * stride + s.ncols] += s.to_dense().cpu().numpy()
        return CSR.from_dense(dense, self.stripes[0].device)

    def striped_spgemm(self, a: CSR) -> "PCSR":
        """C = a · self, one stream-ESC SpGEMM per stripe."""
        from ..ops.spgemm import matmul

        return PCSR(tuple(matmul(a, s) for s in self.stripes), self.ncols)
