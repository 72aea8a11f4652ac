"""Cluster extraction from a converged R-MCL iterate (the port of the JAX
package's ``models/clusters.py``).

Nodes belong to one cluster iff they are connected in the symmetrised
support of the converged matrix (attractor components): MCL's
interpretation step, which the reference leaves to the user.  A host
union-find with path halving, O(nnz α(n)): the converged matrix holds
few entries a row after pruning.
"""

from __future__ import annotations

import numpy as np

from ..formats.csr import CSR


def extract_clusters(mt: CSR, weight_floor: float = 1e-6) -> np.ndarray:
    """Cluster label per node (labels are the component's smallest node
    id), int64 on the host.  ``weight_floor`` drops numerically dead
    entries before linking."""
    rp, col, val = mt.to_numpy()
    rp = rp.astype(np.int64)
    row = np.repeat(np.arange(mt.rows, dtype=np.int64), np.diff(rp))
    keep = val > weight_floor
    row, col = row[keep], col[keep].astype(np.int64)

    parent = np.arange(mt.rows, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(row, col):
        if b >= mt.rows:
            continue
        ra, rb = find(a), find(b)
        if ra != rb:
            if ra < rb:
                parent[rb] = ra
            else:
                parent[ra] = rb
    return np.fromiter((find(i) for i in range(mt.rows)), np.int64, mt.rows)


def cluster_sizes(labels: np.ndarray) -> dict:
    """{label: member count}, descending by size."""
    uniq, counts = np.unique(labels, return_counts=True)
    order = np.argsort(-counts)
    return {int(uniq[i]): int(counts[i]) for i in order}
