"""COO: triplet container and the graph-ingestion ops (the port of the
JAX package's ``formats/coo.py``, after the reference's ``class COO``,
nlibs/COO.h).

* ``add_self_loops`` — COO::addSelfLoopIfNeeded (COO.cc:160-188)
* ``make_ordered``   — COO::makeOrdered (COO.cc:222-235)
* ``sum_duplicates`` — COO::orderedAndDuplicatesRemoving (COO.cc:237-265)
* ``to_csr``         — COO::toCSR (COO.cc:268-291)

Padding: slots in [nnz, capacity) hold (row = nrows, col = ncols,
val = 0), which sort after every real entry.  ``nnz`` is a 0-d int32
tensor on the COO's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE, resolve_device
from ..ops.segments import exclusive_cumsum, segment_boundaries, segment_sum
from .csr import CSR


@dataclasses.dataclass(frozen=True)
class COO:
    row: torch.Tensor  # int32[capacity]
    col: torch.Tensor  # int32[capacity]
    val: torch.Tensor  # f32[capacity]
    nnz: torch.Tensor  # int32 0-d
    nrows: int
    ncols: int

    @property
    def rows(self) -> int:
        return self.nrows

    @property
    def cols(self) -> int:
        return self.ncols

    @property
    def capacity(self) -> int:
        return self.row.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row.device

    def valid(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.nnz

    # ---- constructors -----------------------------------------------------
    @staticmethod
    def from_numpy(
        row,
        col,
        val,
        nrows: int,
        ncols: int,
        capacity: int | None = None,
        device: torch.device | str | None = None,
    ) -> "COO":
        """Build from host triplets on ``device`` (by default the card:
        ``config.resolve_device``), padding out to ``capacity``."""
        device = resolve_device(device, "COO")
        row = np.asarray(row, dtype=np.int32)
        col = np.asarray(col, dtype=np.int32)
        val = np.asarray(val, dtype=np.float32)
        nnz = row.shape[0]
        cap = nnz if capacity is None else int(capacity)
        if cap < nnz:
            raise ValueError(f"capacity {cap} < nnz {nnz}")
        pr = np.full(cap, nrows, dtype=np.int32)
        pc = np.full(cap, ncols, dtype=np.int32)
        pv = np.zeros(cap, dtype=np.float32)
        pr[:nnz], pc[:nnz], pv[:nnz] = row, col, val
        return COO(
            row=torch.from_numpy(pr).to(device),
            col=torch.from_numpy(pc).to(device),
            val=torch.from_numpy(pv).to(device),
            nnz=torch.tensor(nnz, dtype=INDEX_DTYPE, device=device),
            nrows=int(nrows),
            ncols=int(ncols),
        )

    # ---- preprocessing ops ------------------------------------------------
    def add_self_loops(self) -> "COO":
        """Append (i, i, 1.0) for every row without a diagonal entry.
        Square matrices only; the padded tail takes the new entries, and
        those past the capacity are dropped (as the reference drops them)."""
        if self.nrows != self.ncols:
            raise ValueError("self loops need a square matrix")
        n, cap, dev = self.nrows, self.capacity, self.device
        diag = self.valid() & (self.row == self.col)
        has_diag = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        has_diag.index_fill_(0, torch.where(diag, self.row, n).long(), True)
        missing = ~has_diag[:n]
        need = torch.cumsum(missing, 0).to(INDEX_DTYPE)  # inclusive
        total_new = need[-1] if n else torch.zeros((), dtype=INDEX_DTYPE, device=dev)
        slot = torch.where(missing, self.nnz + need - 1, cap).clamp(max=cap).long()
        ids = torch.arange(n, dtype=INDEX_DTYPE, device=dev)

        def put(x, v):  # one dump slot past the capacity takes the rows not missing
            out = torch.cat([x, x.new_zeros(1)])
            out[slot] = v
            return out[:cap]

        return COO(
            put(self.row, ids),
            put(self.col, ids),
            put(self.val, torch.ones(n, dtype=QVALUE_DTYPE, device=dev)),
            self.nnz + total_new,
            self.nrows,
            self.ncols,
        )

    def make_ordered(self) -> "COO":
        """Stable sort of the triplets by (row, col)."""
        key = self.row.long() * (self.ncols + 1) + self.col.long()
        order = torch.sort(key, stable=True).indices
        return COO(
            self.row[order], self.col[order], self.val[order], self.nnz,
            self.nrows, self.ncols,
        )

    def sum_duplicates(self) -> "COO":
        """Sort, then merge duplicate (row, col) entries by summing."""
        c = self.make_ordered()
        valid = c.valid()
        cap = c.capacity
        flags = segment_boundaries(c.row, c.col, valid)
        seg = torch.cumsum(flags, 0).to(INDEX_DTYPE) - 1
        seg = torch.where(valid, seg, cap - 1).long()
        new_val = segment_sum(torch.where(valid, c.val, 0.0), seg, cap)
        new_row = torch.full((cap,), self.nrows, dtype=INDEX_DTYPE, device=c.device)
        new_col = torch.full((cap,), self.ncols, dtype=INDEX_DTYPE, device=c.device)
        new_row.scatter_reduce_(0, seg, torch.where(valid, c.row, self.nrows), reduce="amin")
        new_col.scatter_reduce_(0, seg, torch.where(valid, c.col, self.ncols), reduce="amin")
        new_nnz = flags.sum(dtype=INDEX_DTYPE)
        live = torch.arange(cap, device=c.device) < new_nnz
        return COO(
            torch.where(live, new_row, self.nrows),
            torch.where(live, new_col, self.ncols),
            torch.where(live, new_val, 0.0),
            new_nnz,
            self.nrows,
            self.ncols,
        )

    def to_csr(self) -> CSR:
        """Ordered COO -> CSR (the triplet arrays become its padding too)."""
        # a scatter, not torch.bincount, which reads its input's max from the card
        idx = torch.where(self.valid(), self.row, self.nrows).long()
        counts = torch.zeros(self.nrows + 1, dtype=INDEX_DTYPE, device=self.device)
        counts.index_add_(0, idx, torch.ones_like(idx, dtype=INDEX_DTYPE))
        return CSR(
            exclusive_cumsum(counts[: self.nrows]), self.col, self.val, self.ncols
        )

    def transpose(self) -> "COO":
        """Swap rows and cols."""
        return COO(self.col, self.row, self.val, self.nnz, self.ncols, self.nrows)

    def to_dense(self) -> torch.Tensor:
        """Scatter-add to dense; entries outside the shape are dropped."""
        size = self.nrows * self.ncols
        r, c = self.row.long(), self.col.long()
        inside = (r >= 0) & (r < self.nrows) & (c >= 0) & (c < self.ncols)
        out = torch.zeros(size + 1, dtype=self.val.dtype, device=self.device)
        out.index_add_(0, torch.where(inside, r * self.ncols + c, size), self.val)
        return out[:size].view(self.nrows, self.ncols)
