"""TiledCSR: each row's entries compacted at the front of its own slice
of one flat region (the port of the JAX package's ``formats/tiled.py``).

``(flat_base, counts)`` index the flat region the way ``row_ptr`` indexes
a CSR; ``to_csr`` runs the windowed flat export of ``ops/ell_esc.py``.
"""

from __future__ import annotations

import dataclasses

import torch

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
