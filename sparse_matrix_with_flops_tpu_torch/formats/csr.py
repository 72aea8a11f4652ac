"""CSR: the central sparse container, as a frozen dataclass of tensors.

The port of the JAX package's ``formats/csr.py`` (the reference's
``struct CSR``, nlibs/CSR.h:23-38).  The layout is the same:

* ``col_ind`` / ``values`` have a capacity ``>= nnz``; slots in
  ``[nnz, capacity)`` are padding with ``col == ncols`` and value 0;
* ``nnz == row_ptr[rows]``;
* all three tensors live on one device.

The comparator trio mirrors CSR.h: ``is_equal`` (exact structure + 1e-7
abs, CSR.h:195-245), ``is_raw_equal`` (ignores explicit zeros,
CSR.h:249-282), ``is_relative_equal`` (CSR.h:284-321).  They return
Python bools.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import ABS_TOL, INDEX_DTYPE, QVALUE_DTYPE, resolve_device
from ..ops.segments import entry_rows, exclusive_cumsum


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix with padded capacity."""

    row_ptr: torch.Tensor  # int32[rows + 1]
    col_ind: torch.Tensor  # int32[capacity]; padding slots hold ncols
    values: torch.Tensor  # f32[capacity]; padding slots hold 0
    ncols: int

    # ---- geometry -------------------------------------------------------
    @property
    def rows(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def cols(self) -> int:
        return self.ncols

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.ncols)

    @property
    def capacity(self) -> int:
        return self.col_ind.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @property
    def nnz(self) -> torch.Tensor:
        """Number of stored entries (a 0-d tensor on the CSR's device)."""
        return self.row_ptr[-1]

    def entry_rows(self) -> torch.Tensor:
        """Row id per slot; sentinel ``rows`` for padding slots."""
        return entry_rows(self.row_ptr, self.capacity)

    def entry_valid(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.nnz

    def row_counts(self) -> torch.Tensor:
        """nnz per row (int32)."""
        return self.row_ptr[1:] - self.row_ptr[:-1]

    # ---- constructors and conversion -----------------------------------
    @staticmethod
    def from_numpy(
        row_ptr,
        col_ind,
        values,
        ncols: int,
        device: torch.device | str | None = None,
        capacity: int | None = None,
    ) -> "CSR":
        """Build from tight host arrays on ``device`` (by default the
        card: ``config.resolve_device``), padding out to
        ``capacity``.  The counterpart of the JAX ``CSR.from_arrays``:
        the same numpy arrays give the same matrix in both packages."""
        device = resolve_device(device, "CSR")
        row_ptr = np.asarray(row_ptr, dtype=np.int32)
        col_ind = np.asarray(col_ind, dtype=np.int32)
        values = np.asarray(values, dtype=np.float32)
        nnz = int(row_ptr[-1])
        cap = nnz if capacity is None else int(capacity)
        if cap < nnz:
            raise ValueError(f"capacity {cap} < nnz {nnz}")
        pc = np.full(cap, ncols, dtype=np.int32)
        pv = np.zeros(cap, dtype=np.float32)
        pc[:nnz] = col_ind[:nnz]
        pv[:nnz] = values[:nnz]
        out = CSR(
            row_ptr=torch.from_numpy(row_ptr.copy()).to(device),
            col_ind=torch.from_numpy(pc).to(device),
            values=torch.from_numpy(pv).to(device),
            ncols=int(ncols),
        )
        # the host arrays are authoritative: seed the planners' host-view
        # cache (utils/nphost.csr_host) so planning never copies back
        object.__setattr__(out, "_host_rp_ci", (row_ptr.astype(np.int64), pc))
        return out

    @staticmethod
    def from_arrays(
        row_ptr,
        col_ind,
        values,
        ncols: int,
        capacity: int | None = None,
        device: torch.device | str | None = None,
    ) -> "CSR":
        """``from_numpy`` with the JAX ``CSR.from_arrays`` argument order."""
        return CSR.from_numpy(row_ptr, col_ind, values, ncols, device, capacity)

    @staticmethod
    def from_dense(dense, device: torch.device | str | None = None) -> "CSR":
        """Dense (host) matrix -> CSR; parity with CSR.h:54-82."""
        dense = np.asarray(dense)
        rows, cols = dense.shape
        mask = dense != 0
        row_ptr = np.zeros(rows + 1, dtype=np.int32)
        np.cumsum(mask.sum(axis=1), out=row_ptr[1:])
        r, c = np.nonzero(mask)
        return CSR.from_numpy(row_ptr, c, dense[r, c], cols, device)

    def to(self, device: torch.device | str) -> "CSR":
        out = CSR(
            self.row_ptr.to(device),
            self.col_ind.to(device),
            self.values.to(device),
            self.ncols,
        )
        cached = getattr(self, "_host_rp_ci", None)
        if cached is not None:
            object.__setattr__(out, "_host_rp_ci", cached)
        return out

    def with_capacity(self, capacity: int) -> "CSR":
        """Grow or shrink the padding (through the host; nnz must fit)."""
        rp, ci, v = self.to_numpy()
        return CSR.from_numpy(rp, ci, v, self.ncols, self.device, capacity)

    def deep_copy(self) -> "CSR":
        """A copy that shares no storage (CSR::deepCopy, CSR.cc:97-106)."""
        return CSR(
            self.row_ptr.clone(), self.col_ind.clone(), self.values.clone(),
            self.ncols,
        )

    def to_abs(self) -> "CSR":
        """values <- |values| (CSR::toAbs, CSR.h:152-157)."""
        return CSR(self.row_ptr, self.col_ind, self.values.abs(), self.ncols)

    def to_one_based(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host ``(row_ptr + 1, col_ind + 1, values)``, tight, for 1-based
        interop (CSR::toOneBasedCSR, CSR.h:170-180)."""
        rp, ci, v = self.to_numpy()
        return rp + 1, ci + 1, v

    @staticmethod
    def from_one_based(
        row_ptr, col_ind, values, ncols: int, device: torch.device | str | None = None
    ) -> "CSR":
        """Inverse of :meth:`to_one_based` (CSR::toZeroBasedCSR)."""
        return CSR.from_numpy(
            np.asarray(row_ptr) - 1, np.asarray(col_ind) - 1, values, ncols, device
        )

    def output(self, path: str | None = None, name: str = "csr") -> str:
        """Text dump (CSR::output debugging aid, CSR.h:109-128), the same
        text as the reference's; written to ``path`` when given."""
        rp, col, val = self.to_numpy()
        lines = [f"{name} rows={self.rows} cols={self.ncols} nnz={int(rp[-1])}"]
        for i in range(self.rows):
            ent = " ".join(f"({col[j]},{val[j]:.6g})" for j in range(rp[i], rp[i + 1]))
            lines.append(f"{i}: {ent}")
        text = "\n".join(lines) + "\n"
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def make_ordered(self) -> "CSR":
        """Sort columns within each row (CSR::makeOrdered, CSR.cc:73-86):
        one stable sort by (entry row, col); padding sorts to the tail."""
        key = self.entry_rows().long() * (self.ncols + 1) + self.col_ind.long()
        order = torch.sort(key, stable=True).indices
        return CSR(self.row_ptr, self.col_ind[order], self.values[order], self.ncols)

    # ---- R-MCL init and permutations (CSR.cc:88-95, 431-494) ------------
    def aver_and_norm_rows(self) -> "CSR":
        """values[j] = 1 / rowCount(row(j)) (CSR::averAndNormRowQValue,
        CSR.cc:88-95): the row-stochastic init of R-MCL."""
        counts = self.row_counts()
        own = self.entry_rows().long().clamp(0, max(self.rows - 1, 0))
        cnt = torch.clamp(counts[own], min=1).to(QVALUE_DTYPE)
        val = torch.where(self.entry_valid(), 1.0 / cnt, 0.0)
        return CSR(self.row_ptr, self.col_ind, val, self.ncols)

    def permute_rows(self, p) -> "CSR":
        """P·M: out row i = in row p[i] (CSR::PM semantics)."""
        p = torch.as_tensor(p, device=self.device).long()
        cap = self.capacity
        row_ptr = exclusive_cumsum(self.row_counts()[p].to(INDEX_DTYPE))
        erow_out = entry_rows(row_ptr, cap)
        safe_row = erow_out.long().clamp(0, max(self.rows - 1, 0))
        offset = torch.arange(cap, device=self.device) - row_ptr[safe_row]
        src = self.row_ptr[p[safe_row]] + offset
        valid = erow_out < self.rows
        src = torch.where(valid, src, cap - 1).long()
        col = torch.where(valid, self.col_ind[src], self.ncols)
        val = torch.where(valid, self.values[src], 0.0)
        return CSR(row_ptr, col.to(INDEX_DTYPE), val, self.ncols)

    def permute_cols(self, p_t) -> "CSR":
        """M·P with column map: out col = p_t[in col] (CSR::MP semantics);
        the result is re-ordered."""
        p_t = torch.as_tensor(p_t, device=self.device)
        safe = self.col_ind.long().clamp(0, self.ncols - 1)
        col = torch.where(self.entry_valid(), p_t[safe].to(INDEX_DTYPE), self.ncols)
        return CSR(self.row_ptr, col.to(INDEX_DTYPE), self.values, self.ncols).make_ordered()

    def conjugate_permute(self, p) -> "CSR":
        """P·M·Pᵗ (CSR::PMPt): rows by p, cols by the inverse of p."""
        p = torch.as_tensor(p, device=self.device)
        p_t = torch.zeros_like(p)
        p_t[p.long()] = torch.arange(p.shape[0], dtype=p.dtype, device=self.device)
        return self.permute_rows(p).permute_cols(p_t)

    def row_descending_order_permutation(self) -> torch.Tensor:
        """Row ids by descending nnz, equal counts in row order
        (CSR::rowDescendingOrderPermutation, CSR.cc:484-494; the
        reference's stable key/value sort on the negated counts)."""
        order = torch.sort(-self.row_counts(), stable=True).indices
        return order.to(INDEX_DTYPE)

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Tight host arrays ``(row_ptr, col_ind[:nnz], values[:nnz])``."""
        rp = self.row_ptr.cpu().numpy()
        nnz = int(rp[-1])
        return (
            rp,
            self.col_ind[:nnz].cpu().numpy(),
            self.values[:nnz].cpu().numpy(),
        )

    def to_dense(self) -> torch.Tensor:
        """Scatter to dense; padding (col == ncols / row == rows) is dropped."""
        out = torch.zeros(
            (self.rows + 1) * (self.ncols + 1),
            dtype=self.values.dtype,
            device=self.device,
        )
        erow = self.entry_rows().long()
        col = self.col_ind.long().clamp(0, self.ncols)
        out.index_add_(0, erow * (self.ncols + 1) + col, self.values)
        return out.view(self.rows + 1, self.ncols + 1)[: self.rows, : self.ncols]

    # ---- comparators (CSR.h:195-321) ------------------------------------
    def _masked(self, fill_col: int):
        valid = self.entry_valid()
        col = torch.where(valid, self.col_ind, fill_col)
        val = torch.where(valid, self.values, 0.0)
        return col, val

    def _same_structure(self, other: "CSR") -> bool:
        if self.shape != other.shape:
            return False
        if not torch.equal(self.row_ptr, other.row_ptr.to(self.device)):
            return False
        ca, _ = self._masked(-1)
        cb, _ = other._masked(-1)
        cb = cb.to(self.device)
        n = min(self.capacity, other.capacity)
        return (
            torch.equal(ca[:n], cb[:n])
            and bool((ca[n:] == -1).all())
            and bool((cb[n:] == -1).all())
        )

    def is_equal(self, other: "CSR", tol: float = ABS_TOL) -> bool:
        """Exact structural equality + abs tolerance on values."""
        if not self._same_structure(other):
            return False
        n = min(self.capacity, other.capacity)
        _, da = self._masked(-1)
        _, db = other._masked(-1)
        return bool(((da[:n] - db.to(self.device)[:n]).abs() <= tol).all())

    def _drop_explicit_zeros(self) -> "CSR":
        """Compact away entries with value exactly 0 (isRawEqual semantics)."""
        keep = self.entry_valid() & (self.values != 0)
        counts = torch.bincount(
            self.entry_rows()[keep].long(), minlength=self.rows
        )[: self.rows]
        row_ptr = exclusive_cumsum(counts.to(INDEX_DTYPE))
        nkeep = int(keep.sum())
        col = torch.full_like(self.col_ind, self.ncols)
        val = torch.zeros_like(self.values)
        col[:nkeep] = self.col_ind[keep]
        val[:nkeep] = self.values[keep]
        return CSR(row_ptr, col, val, self.ncols)

    def is_raw_equal(self, other: "CSR", tol: float = ABS_TOL) -> bool:
        """Equality ignoring explicitly stored zeros (CSR.h:249-282)."""
        return self._drop_explicit_zeros().is_equal(
            other._drop_explicit_zeros(), tol
        )

    def is_relative_equal(self, other: "CSR", rel: float) -> bool:
        """Structure-equal + relative value tolerance (CSR.h:284-321)."""
        if not self._same_structure(other):
            return False
        n = min(self.capacity, other.capacity)
        _, da = self._masked(-1)
        _, db = other._masked(-1)
        da, db = da[:n], db.to(self.device)[:n]
        denom = torch.maximum(da.abs(), db.abs()).clamp(min=1e-30)
        return bool(((da - db).abs() <= rel * denom).all())

    # ---- diff metrics (CSR.cc:213-240, 381-415) -------------------------
    def differs(self, other: "CSR") -> torch.Tensor:
        """Relative L2 distance ||A - B||_F / ||A||_F through the dense
        forms (CSR::differs, CSR.cc:213-240); a 0-d tensor.  The sparse
        form that the R-MCL loops track is ``ops.metrics.differs``."""
        da = self.to_dense()
        db = other.to_dense().to(self.device)
        num = torch.sqrt(((da - db) ** 2).sum())
        return num / torch.sqrt((da**2).sum()).clamp(min=1e-30)

    def row_growth_stats(
        self, other: "CSR", bounds=(-30.0, -20.0, -5.0, 0.0, 5.0, 20.0, 30.0, 100.0)
    ) -> torch.Tensor:
        """Histogram of per-row nnz percent change from ``self`` to
        ``other`` (differsStats, CSR.cc:381-415; bucket bounds from
        qrmcl.cc:17)."""
        from ..ops.metrics import row_growth_histogram

        return row_growth_histogram(self, other, bounds)
