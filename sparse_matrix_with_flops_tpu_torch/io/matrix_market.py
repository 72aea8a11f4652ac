"""MatrixMarket coordinate reader / writer (a copy of the JAX package's
``io/matrix_market.py``: host numpy, no device).

Host-side equivalent of the reference's vendored NIST reader
(nlibs/tools/mm_io.{h,cc}); only the entry point the reference actually
uses is required (``mm_read_unsymmetric_sparse``, mm_io.cc:485, called from
COO.cc:43-46), plus a writer for round-tripping.  Supports general /
symmetric real, integer and pattern coordinate matrices.
"""

from __future__ import annotations

import numpy as np


def read_matrix_market(
    path: str, expand_symmetric: bool = True
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Returns (row, col, val, nrows, ncols), 0-based host arrays."""
    with open(path, "r") as f:
        banner = f.readline().split()
        if len(banner) < 5 or not banner[0].startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        obj, fmt, field, symm = (t.lower() for t in banner[1:5])
        if obj != "matrix" or fmt != "coordinate":
            raise ValueError(f"{path}: only coordinate matrices supported")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrows, ncols, nnz = (int(t) for t in line.split())
        rows = np.empty(nnz, dtype=np.int32)
        cols = np.empty(nnz, dtype=np.int32)
        vals = np.ones(nnz, dtype=np.float32)
        for k in range(nnz):
            toks = f.readline().split()
            rows[k] = int(toks[0]) - 1
            cols[k] = int(toks[1]) - 1
            if field != "pattern" and len(toks) >= 3:
                vals[k] = np.float32(toks[2])
    if symm in ("symmetric", "skew-symmetric", "hermitian") and expand_symmetric:
        off = rows != cols
        sign = np.float32(-1.0) if symm == "skew-symmetric" else np.float32(1.0)
        new_rows = np.concatenate([rows, cols[off]])
        new_cols = np.concatenate([cols, rows[off]])
        vals = np.concatenate([vals, sign * vals[off]])
        rows, cols = new_rows, new_cols
    return rows, cols, vals, nrows, ncols


def write_matrix_market(path: str, row, col, val, nrows: int, ncols: int) -> None:
    row = np.asarray(row)
    col = np.asarray(col)
    val = np.asarray(val)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{nrows} {ncols} {row.shape[0]}\n")
        for r, c, v in zip(row, col, val):
            f.write(f"{int(r) + 1} {int(c) + 1} {float(v):.9g}\n")
