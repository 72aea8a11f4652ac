"""SNAP / MatrixMarket-body edge-list reader (a copy of the JAX
package's ``io/snap.py``: host numpy, no device).

Host-side (numpy) re-implementation of ``COO::readSNAPFile``
(reference nlibs/COO.cc:48-158) with the same quirky semantics:

* Leading ``#`` / ``%`` comment lines are skipped.  If the *first* line is a
  5-token ``%%MatrixMarket ...`` banner, the storage scheme is honoured and
  indices become 1-based (COO.cc:62-71).
* The first non-comment line is a header: ``rows nnz`` (2 fields, square) or
  ``rows cols nnz`` (3 fields) (COO.cc:79-89).
* Body lines: ``from to [value]``; a missing value defaults to 1.0
  (COO.cc:149-151).
* ``symmetric`` banner mirrors each off-diagonal entry (COO.cc:92-122).
* ``is_trans=True`` (the R-MCL default, COO.h:19-20) stores (to, from) so the
  matrix is read transposed for the column-stochastic iteration
  (COO.cc:141-148).
"""

from __future__ import annotations

import numpy as np


def read_snap(
    path: str, is_trans: bool = True
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Parse a SNAP/MM-body file.

    Returns (row, col, val, nrows, ncols) host arrays (int32/int32/float32).
    """
    with open(path, "r") as f:
        lines = f.readlines()

    is_mtx = False
    symmetric = False
    i = 0
    if lines and lines[0].startswith("%"):
        toks = lines[0].split()
        if len(toks) == 5:
            is_mtx = True
            symmetric = toks[4].lower() == "symmetric"
    while i < len(lines) and (lines[i].startswith("#") or lines[i].startswith("%")):
        i += 1
    if i >= len(lines):
        return (
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            np.zeros(0, np.float32),
            0,
            0,
        )

    header = lines[i].split()
    i += 1
    if len(header) == 2:
        nrows = int(header[0])
        ncols = nrows
        nnz = int(header[1])
    else:
        nrows, ncols, nnz = int(header[0]), int(header[1]), int(header[2])

    base = 1 if is_mtx else 0

    # Fast vectorized body parse when every line has the same token count
    # (the overwhelmingly common case): one fromstring over the joined
    # body instead of a per-line Python loop.
    body = lines[i : i + nnz]
    ntok = len(body[0].split()) if body else 0
    if nnz and ntok in (2, 3):
        import warnings

        with warnings.catch_warnings():
            # np.fromstring(sep=...) is soft-deprecated but is the only
            # zero-copy C-speed text parser in numpy; fall back on the
            # slow path if it ever goes away (returns wrong-size array).
            warnings.simplefilter("ignore", DeprecationWarning)
            flat = np.fromstring(" ".join(body), sep=" ")
        if flat.shape[0] == nnz * ntok:
            tok = flat.reshape(nnz, ntok)
            frm = tok[:, 0].astype(np.int32) - base
            to = tok[:, 1].astype(np.int32) - base
            val = (
                tok[:, 2].astype(np.float32)
                if ntok == 3
                else np.ones(nnz, np.float32)
            )
            if symmetric:
                off = frm != to
                rows = np.concatenate([frm, to[off]])
                cols = np.concatenate([to, frm[off]])
                vals = np.concatenate([val, val[off]])
            elif is_trans:
                rows, cols, vals = to, frm, val
            else:
                rows, cols, vals = frm, to, val
            return (
                rows.astype(np.int32),
                cols.astype(np.int32),
                vals.astype(np.float32),
                nrows,
                ncols,
            )

    if nnz > 1_000_000:
        import warnings

        warnings.warn(
            f"read_snap: falling back to the per-line Python parser for "
            f"{nnz} entries (mixed token counts?) — this is O(nnz) Python "
            "and may take minutes; prefer the native loader "
            "(io.native.read_graph_native).",
            RuntimeWarning,
            stacklevel=2,
        )

    rows = np.empty(2 * nnz if symmetric else nnz, dtype=np.int32)
    cols = np.empty_like(rows)
    vals = np.empty(rows.shape[0], dtype=np.float32)
    top = 0
    for k in range(nnz):
        toks = lines[i + k].split()
        frm = int(toks[0]) - base
        to = int(toks[1]) - base
        val = np.float32(toks[2]) if len(toks) >= 3 else np.float32(1.0)
        if symmetric:
            rows[top], cols[top], vals[top] = frm, to, val
            top += 1
            if frm != to:
                rows[top], cols[top], vals[top] = to, frm, val
                top += 1
        else:
            if is_trans:
                rows[k], cols[k], vals[k] = to, frm, val
            else:
                rows[k], cols[k], vals[k] = frm, to, val
            top = k + 1
    return rows[:top], cols[:top], vals[:top], nrows, ncols
