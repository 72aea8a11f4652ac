"""The benchmark's own input generators, host NumPy.

``rmat`` and ``band`` make the same RNG calls as the port's
``utils/generate.py`` (and the JAX package's), so the same seed gives
the same matrix; the copy keeps the yardstick fixed when the program's
generators change.  ``graph500`` adds what the Graph500 benchmark does
to the R-MAT edges and the port's generator does not.  Each
returns tight CSR host arrays ``(row_ptr int64[n+1], col int64[nnz],
val float32[nnz])``.
"""

from __future__ import annotations

import numpy as np


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, weights: str = "unit"):
    """R-MAT (Graph500 Kronecker) graph of 2^scale nodes and
    2^scale · edge_factor drawn edges: duplicates summed, self loops kept.
    ``weights``: 'unit' (1.0) or 'random' (uniform (0, 1])."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    pa, pb, pc = a, a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        rbit = (r >= pb).astype(np.int64)
        cbit = (((r >= pa) & (r < pb)) | (r >= pc)).astype(np.int64)
        rows |= rbit << bit
        cols |= cbit << bit
    if weights == "unit":
        vals = np.ones(m, dtype=np.float32)
    else:
        vals = rng.random(m).astype(np.float32) + np.float32(1e-6)
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    first = np.ones(m, dtype=bool)
    first[1:] = key[1:] != key[:-1]
    seg = np.cumsum(first) - 1
    sval = np.zeros(int(seg[-1]) + 1 if m else 0, dtype=np.float64)
    np.add.at(sval, seg, vals)
    counts = np.bincount(rows[first], minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr, cols[first], sval.astype(np.float32)


def graph500(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
             c: float = 0.19, seed: int = 0):
    """The Graph500 benchmark's graph: the R-MAT edges of :func:`rmat`,
    every vertex renamed by a random permutation drawn from ``seed`` (so
    the hubs do not sit in the low rows), and made undirected (each edge
    stored both ways).  Equal edges are summed, self loops kept; the
    value of an entry is its edge count."""
    rp, col, val = rmat(scale, edge_factor, a, b, c, seed)
    n = rp.shape[0] - 1
    perm = np.random.default_rng([seed, 500]).permutation(n)
    src = perm[np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))]
    dst = perm[col]
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    vals = np.concatenate([val, val]).astype(np.float64)
    loop = np.flatnonzero(src == dst)  # a self loop is one edge, not two
    vals[src.shape[0] + loop] = 0.0
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    first = np.ones(key.shape[0], dtype=bool)
    first[1:] = key[1:] != key[:-1]
    sval = np.add.reduceat(vals, np.flatnonzero(first)) if key.shape[0] else vals
    ukey = key[first]
    counts = np.bincount(ukey // n, minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr, ukey % n, sval.astype(np.float32)


def band(n: int, bandwidth: int = 32, seed: int = 0):
    """Every row holds the entries of its ±``bandwidth`` window, with
    standard normal values: a dense band, the repository's stand-in for a
    FEM stiffness matrix of that size (it is not any real matrix's
    pattern)."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-bandwidth, bandwidth + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), offs.shape[0])
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    counts = np.bincount(rows, minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr, cols, vals


def matrix(cfg: dict, seed: int | None = None):
    """The CSR host arrays of a configuration (``configs/<name>.json``);
    ``seed`` replaces the configuration's generator seed."""
    s = cfg["seed"] if seed is None else seed
    if cfg["generator"] == "graph500":
        return graph500(cfg["scale"], cfg["edgefactor"], cfg["a"], cfg["b"], cfg["c"], s)
    if cfg["generator"] == "band":
        return band(cfg["rows"], cfg["bandwidth"], s)
    raise ValueError(f"unknown generator {cfg['generator']!r}")


def relabel(row_ptr, col, perm):
    """The graph with node ``i`` renamed ``perm[i]`` (rows and columns):
    the same graph, so the same work, under other labels.  Returns CSR
    host arrays with each row's columns sorted."""
    n = row_ptr.shape[0] - 1
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))
    r, c = perm[src], perm[col]
    order = np.argsort(r * n + c, kind="stable")
    counts = np.bincount(r, minlength=n)
    out = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=out[1:])
    return out, c[order]

