"""Synthetic matrix generators (the port of the JAX package's
``utils/generate.py``).

Each generator makes the same numpy RNG calls as the reference, so the
host arrays, and therefore the matrices, are bit-identical; only the
container differs.  The matrices land on the card unless ``device`` says
otherwise (``CSR.from_numpy``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.coo import COO
from ..formats.csr import CSR


def rmat_csr(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    weights: str = "unit",
    device: torch.device | str | None = None,
) -> CSR:
    """R-MAT (Graph500-style) power-law adjacency matrix, 2^scale nodes.

    Duplicate edges are summed; self loops kept.  ``weights``: 'unit'
    (1.0) or 'random' (uniform (0,1])."""
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
    # dedup-sum (orderedAndDuplicatesRemoving semantics, COO.cc:237-265)
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    first = np.ones(m, dtype=bool)
    first[1:] = key[1:] != key[:-1]
    seg = np.cumsum(first) - 1
    nseg = int(seg[-1]) + 1 if m else 0
    sval = np.zeros(nseg, dtype=np.float64)
    np.add.at(sval, seg, vals)
    counts = np.bincount(rows[first], minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return CSR.from_numpy(
        row_ptr.astype(np.int32),
        cols[first].astype(np.int32),
        sval.astype(np.float32),
        n,
        device,
    )


def banded_csr(
    n: int,
    bandwidth: int = 32,
    seed: int = 0,
    density: float = 1.0,
    device: torch.device | str | None = None,
) -> CSR:
    """Banded FEM-like matrix: every row has entries in a +/- bandwidth
    window (the cant.mtx workload shape).  ``density < 1`` keeps each
    in-band entry with that probability (the diagonal always kept)."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-bandwidth, bandwidth + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), offs.shape[0])
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    if density < 1.0:
        keep &= (rng.random(rows.shape[0]) < density) | (cols == rows)
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    counts = np.bincount(rows, minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return CSR.from_numpy(
        row_ptr.astype(np.int32), cols.astype(np.int32), vals, n, device
    )


def planted_partition_coo(
    n_clusters: int,
    cluster_size: int,
    p_in: float = 0.3,
    p_out: float = 0.002,
    seed: int = 0,
    device: torch.device | str | None = None,
):
    """Planted-partition (stochastic block model) graph: ``n_clusters``
    communities of ``cluster_size`` nodes, edge probability ``p_in``
    inside a community and ``p_out`` between (symmetric, unit weights).
    Returns (COO with room for the self loops, int64 host labels), where
    labels[i] is node i's planted community."""
    rng = np.random.default_rng(seed)
    n = n_clusters * cluster_size
    rows, cols = [], []
    for c in range(n_clusters):
        base = c * cluster_size
        mask = rng.random((cluster_size, cluster_size)) < p_in
        r, co = np.nonzero(np.triu(mask, 1))
        rows.append(base + r)
        cols.append(base + co)
    # edges between communities: p_out * n^2 / 2 pairs expected
    m_out = rng.poisson(p_out * n * n / 2)
    if m_out:
        r = rng.integers(0, n, size=m_out)
        co = rng.integers(0, n, size=m_out)
        keep = (r // cluster_size) != (co // cluster_size)
        rows.append(r[keep])
        cols.append(co[keep])
    r = np.concatenate(rows)
    co = np.concatenate(cols)
    # symmetrise (the reference mirrors symmetric inputs, COO.cc:92-122)
    ar = np.concatenate([r, co]).astype(np.int64)
    ac = np.concatenate([co, r]).astype(np.int64)
    v = np.ones(ar.shape[0], np.float32)
    labels = np.repeat(np.arange(n_clusters, dtype=np.int64), cluster_size)
    coo = COO.from_numpy(ar, ac, v, n, n, capacity=ar.shape[0] + n, device=device)
    return coo, labels


def cluster_purity(found: np.ndarray, planted: np.ndarray) -> float:
    """Purity of a found clustering against planted labels: each found
    cluster's share of its majority community, weighted by its size
    (1.0: every found cluster lies inside one community)."""
    total = 0
    for lab in np.unique(found):
        members = planted[found == lab]
        _, counts = np.unique(members, return_counts=True)
        total += int(counts.max())
    return total / found.shape[0]
