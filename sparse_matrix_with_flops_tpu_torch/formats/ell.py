"""ELL: padded fixed-width rows (the port of the JAX package's
``formats/ell.py``).  ``[rows, width]`` col/val planes; padding lanes
hold (ncols, 0)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import QVALUE_DTYPE
from ..utils.nphost import concat_ranges, fast_repeat
from .csr import CSR


@dataclasses.dataclass(frozen=True)
class ELL:
    col: torch.Tensor  # int32[rows, width]; sentinel ncols on padding
    val: torch.Tensor  # f32[rows, width]; 0 on padding
    ncols: int

    @property
    def rows(self) -> int:
        return self.col.shape[0]

    @property
    def width(self) -> int:
        return self.col.shape[1]

    @property
    def nnz(self) -> torch.Tensor:
        return (self.col < self.ncols).sum()

    @staticmethod
    def from_csr(a: CSR, width: int | None = None) -> "ELL":
        """Host-side CSR -> ELL; ``width`` defaults to the longest row.
        Rows longer than a given width are truncated to their first
        ``width`` entries, as the reference does."""
        rp, cols, vals = a.to_numpy()
        rp = rp.astype(np.int64)
        counts = np.diff(rp)
        w = int(counts.max()) if counts.size and width is None else int(width or 1)
        w = max(w, 1)
        col = np.full((a.rows, w), a.ncols, dtype=np.int32)
        val = np.zeros((a.rows, w), dtype=np.float32)
        k = np.minimum(counts, w)
        src = concat_ranges(rp[:-1], rp[:-1] + k)
        dr = fast_repeat(np.arange(a.rows), k)
        excl = np.concatenate([[0], np.cumsum(k)[:-1]])
        dc = np.arange(src.shape[0], dtype=np.int64) - excl[dr]
        col[dr, dc] = cols[src]
        val[dr, dc] = vals[src]
        return ELL(
            torch.from_numpy(col).to(a.device),
            torch.from_numpy(val).to(a.device),
            a.ncols,
        )

    def to_dense(self) -> torch.Tensor:
        w = self.ncols + 1
        out = torch.zeros(self.rows * w, dtype=QVALUE_DTYPE, device=self.col.device)
        rix = torch.arange(self.rows, device=self.col.device)[:, None] * w
        out.index_add_(0, (rix + self.col.long()).reshape(-1), self.val.reshape(-1))
        return out.view(self.rows, w)[:, : self.ncols]

    def _gather(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        safe = self.col.long().clamp(0, self.ncols - 1)
        return x[safe], self.col < self.ncols

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A·x: one gather and one lane sum per row."""
        g, ok = self._gather(x)
        return torch.where(ok, g * self.val, 0.0).sum(1).to(QVALUE_DTYPE)

    def spmm(self, b: torch.Tensor) -> torch.Tensor:
        """C = A·B with dense B: a gather of B rows per lane, then a lane
        sum.  Memory O(rows · width · N): for narrow widths."""
        g, ok = self._gather(b)  # [rows, width, N]
        g = torch.where(ok[:, :, None], g * self.val[:, :, None], 0.0)
        return g.sum(1).to(QVALUE_DTYPE)
