"""TiledCSR: each row's entries compacted at the front of its own slice
of one flat region (the port of the JAX package's ``formats/tiled.py``).

``(flat_base, counts)`` index the flat region the way ``row_ptr`` indexes
a CSR; ``to_csr`` runs the windowed flat export of ``ops/ell_esc.py``,
``to_host_csr`` the same export on the host, ``as_bview`` lets the
stream ESC of ``ops/spgemm.py`` read it as B, and ``spmv`` works on the
flat region directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..ops.segments import exclusive_cumsum
from .csr import CSR


@dataclasses.dataclass(frozen=True)
class TiledCSR:
    flat_col: torch.Tensor  # int32[T]; sentinel col = ncols outside rows
    flat_val: torch.Tensor  # f32[T]
    counts: torch.Tensor  # int32[rows]
    flat_base: torch.Tensor  # int32[rows]: first entry of each row
    ncols: int

    @property
    def rows(self) -> int:
        return self.counts.shape[0]

    @property
    def shape(self):
        return (self.rows, self.ncols)

    @property
    def nnz(self) -> torch.Tensor:
        return self.counts.sum()

    def row_ptr(self) -> torch.Tensor:
        return exclusive_cumsum(self.counts)

    def as_bview(self):
        """The ``BView`` of ``ops/spgemm.py``: B rows read in place."""
        from ..ops.spgemm import BView

        return BView(
            col=self.flat_col,
            val=self.flat_val,
            row_start=self.flat_base,
            row_count=self.counts,
            ncols=self.ncols,
        )

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A·x without leaving tile form.  The owner row of each flat
        slot comes from an interval delta scan: +(row + 1) at each
        region's start, -(row + 1) at its end, so the running sum is
        row + 1 inside a region and 0 in the gaps.  The scatters go into
        a buffer one slot longer, whose last slot takes the ends the
        reference drops."""
        t = self.flat_col.shape[0]
        dev = self.flat_col.device
        valid = self.flat_col < self.ncols
        safe = self.flat_col.long().clamp(0, self.ncols - 1)
        prod = torch.where(valid, self.flat_val * x[safe], 0.0)
        ok = self.counts > 0
        rid1 = torch.where(
            ok, torch.arange(1, self.rows + 1, dtype=INDEX_DTYPE, device=dev), 0
        ).to(INDEX_DTYPE)
        delta = torch.zeros(t + 2, dtype=INDEX_DTYPE, device=dev)
        for pos, sign in ((self.flat_base, 1), (self.flat_base + self.counts, -1)):
            idx = torch.where(ok, pos, t).long().clamp(0, t + 1)
            delta.index_add_(0, idx, sign * rid1)
        seg = torch.cumsum(delta[:t], 0).to(INDEX_DTYPE) - 1
        y = torch.zeros(self.rows + 1, dtype=QVALUE_DTYPE, device=dev)
        y.index_add_(0, seg.long().clamp(0, self.rows), torch.where(seg >= 0, prod, 0.0))
        return y[: self.rows]

    def to_csr(self, out_cap: int | None = None, exact: bool = True) -> CSR:
        """Flat CSR export (the windowed gather)."""
        from ..ops.ell_esc import _flat_assemble

        return _flat_assemble(
            self.flat_col,
            self.flat_val,
            self.counts,
            self.flat_base,
            self.ncols,
            out_cap,
            exact,
        )

    def to_host_csr(self) -> CSR:
        """Flat CSR export stitched on the host (one ragged gather of each
        row's range, no device gather); the CSR is put on this matrix's
        device."""
        from ..utils.nphost import concat_ranges

        counts = self.counts.cpu().numpy().astype(np.int64)
        base = self.flat_base.cpu().numpy().astype(np.int64)
        rp = np.zeros(self.rows + 1, dtype=np.int64)
        np.cumsum(counts, out=rp[1:])
        src = concat_ranges(base, base + counts)
        return CSR.from_numpy(
            rp,
            self.flat_col.cpu().numpy()[src],
            self.flat_val.cpu().numpy()[src],
            self.ncols,
            self.flat_col.device,
        )
