"""BCSR: block-compressed sparse rows with dense (br x bc) blocks (the
port of the JAX package's ``formats/bcsr.py``, after the reference's
nlibs/BCSR.h:6-64).

* blocks are one dense ``[capacity, br, bc]`` tensor; the default block
  is (8, 128);
* block slots in [nblocks, capacity) are zero blocks pointing at block
  column ``nbcols`` (the sentinel); ``from_csr`` always stores at least
  one slot, so an empty matrix holds one padding block.

``ops/spmm.bcsr_spmm`` (kernel K5) multiplies it by a dense matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from .csr import CSR


@dataclasses.dataclass(frozen=True)
class BCSR:
    """Block CSR; ``rows`` / ``cols`` are the unpadded matrix shape."""

    block_row_ptr: torch.Tensor  # int32[nbrows + 1]
    block_col: torch.Tensor  # int32[capacity]; sentinel nbcols for padding
    blocks: torch.Tensor  # f32[capacity, br, bc]
    rows: int
    cols: int
    br: int
    bc: int

    @property
    def nbrows(self) -> int:
        return self.block_row_ptr.shape[0] - 1

    @property
    def nbcols(self) -> int:
        return -(-self.cols // self.bc)

    @property
    def block_capacity(self) -> int:
        return self.block_col.shape[0]

    @property
    def nblocks(self) -> torch.Tensor:
        """Number of stored blocks (a 0-d tensor on the BCSR's device)."""
        return self.block_row_ptr[-1]

    @property
    def device(self) -> torch.device:
        return self.block_row_ptr.device

    def nonzero_density(self) -> torch.Tensor:
        """Fill ratio of the stored blocks (BCSR::nonzeroDensity)."""
        nz = (self.blocks.abs() > 0).sum()
        return nz / torch.clamp(self.nblocks * self.br * self.bc, min=1)

    # ---- conversion --------------------------------------------------------
    @staticmethod
    def from_csr(a: CSR, br: int = 8, bc: int = 128) -> "BCSR":
        """Two-pass CSR -> BCSR on the host (BCSR.cc:10-66): the block
        pattern from one stable sort of the block keys, then a numeric
        fill that sums duplicate entries.  The same numpy code as the
        reference, so the arrays are bit-identical."""
        rp, col, val = a.to_numpy()
        rp = rp.astype(np.int64)
        erow = np.repeat(np.arange(a.rows, dtype=np.int64), np.diff(rp))
        brow = erow // br
        bcol = col // bc
        nbrows = -(-a.rows // br)
        nbcols = -(-a.cols // bc)
        key = brow * nbcols + bcol
        order = np.argsort(key, kind="stable")
        skey = key[order]
        first = np.ones(skey.shape[0], dtype=bool)
        first[1:] = skey[1:] != skey[:-1]
        block_id = np.cumsum(first) - 1
        nblocks = int(block_id[-1]) + 1 if skey.size else 0
        ukey = skey[first]
        ubrow = (ukey // nbcols).astype(np.int64)
        ubcol = (ukey % nbcols).astype(np.int32)
        counts = np.bincount(ubrow, minlength=nbrows)
        brp = np.zeros(nbrows + 1, dtype=np.int32)
        np.cumsum(counts, out=brp[1:])
        blocks = np.zeros((max(nblocks, 1), br, bc), dtype=np.float32)
        rr = (erow[order] % br).astype(np.int64)
        cc = (col[order] % bc).astype(np.int64)
        np.add.at(blocks, (block_id, rr, cc), val[order])
        bcol_arr = np.full(max(nblocks, 1), nbcols, dtype=np.int32)
        bcol_arr[:nblocks] = ubcol[:nblocks]
        dev = a.device
        return BCSR(
            block_row_ptr=torch.from_numpy(brp).to(dev),
            block_col=torch.from_numpy(bcol_arr).to(dev),
            blocks=torch.from_numpy(blocks).to(dev),
            rows=a.rows,
            cols=a.cols,
            br=br,
            bc=bc,
        )

    def to(self, device: torch.device | str) -> "BCSR":
        return dataclasses.replace(
            self,
            block_row_ptr=self.block_row_ptr.to(device),
            block_col=self.block_col.to(device),
            blocks=self.blocks.to(device),
        )

    def block_rows(self) -> torch.Tensor:
        """Block row of every block slot (int64); padding slots past
        ``nblocks`` land in the last block row, as the reference's
        ``searchsorted``."""
        q = torch.arange(self.block_capacity, dtype=INDEX_DTYPE, device=self.device)
        return torch.searchsorted(self.block_row_ptr, q, right=True).long() - 1

    def to_dense(self) -> torch.Tensor:
        """Scatter the blocks to a dense (padded) matrix, then crop.  A
        padding slot (sentinel column) goes to one dump block past the
        end, where the reference drops it."""
        nbc, nbr = self.nbcols, self.nbrows
        brows = self.block_rows()
        bcols = self.block_col.long()
        ok = (brows < nbr) & (bcols < nbc)
        slot = torch.where(ok, brows * nbc + bcols, nbr * nbc)
        out = torch.zeros(
            (nbr * nbc + 1, self.br, self.bc), dtype=QVALUE_DTYPE, device=self.device
        )
        out.index_add_(0, slot, self.blocks)
        dense = out[:-1].view(nbr, nbc, self.br, self.bc).transpose(1, 2)
        dense = dense.reshape(nbr * self.br, nbc * self.bc)
        return dense[: self.rows, : self.cols]

    def is_equal(self, a: CSR, tol: float = 1e-6) -> bool:
        """Differential check against the CSR it came from
        (BCSR::isEqual, BCSR.cc:67-116)."""
        return bool(((self.to_dense() - a.to_dense()).abs() <= tol).all())
