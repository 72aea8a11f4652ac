"""Permutation-vector helpers (the port of the JAX package's
``utils/perm.py``; nlibs/tools/util.cc:151-168 parity).

``permutation_transpose`` inverts a permutation (Pt[P[i]] = i), which is
what ``CSR.permute_cols`` expects when conjugating (P·M·Pᵗ).  Host
(numpy) arrays, as in the reference.
"""

from __future__ import annotations

import numpy as np


def random_permutation_vector(n: int, seed: int | None = None) -> np.ndarray:
    """Uniform random permutation of [0, n) (util.cc:151-161)."""
    return np.random.default_rng(seed).permutation(n).astype(np.int32)


def permutation_transpose(p: np.ndarray) -> np.ndarray:
    """Inverse permutation: out[p[i]] = i (util.cc:163-168)."""
    p = np.asarray(p)
    pt = np.empty_like(p)
    pt[p] = np.arange(p.shape[0], dtype=p.dtype)
    return pt
