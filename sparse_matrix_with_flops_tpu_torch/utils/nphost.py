"""Host-side (numpy) primitives for the SpGEMM planners.

Copied from the JAX package's ``utils/nphost.py`` so the planners make
the same plans.  The reference's glibc heap tuning and its transparent
huge-page numpy allocator (a C file compiled into the package at import)
are not carried over: they tuned page-fault cost on the TPU host.
"""

from __future__ import annotations

import numpy as np


def repeat_idx(counts: np.ndarray, total: int | None = None) -> np.ndarray:
    """``np.repeat(np.arange(len(counts)), counts)`` as int32, via the
    marker-scatter + cumsum trick (ragged np.repeat is far slower).
    Zero counts are allowed."""
    counts = np.asarray(counts)
    ends = np.cumsum(counts, dtype=np.int64)
    t = int(ends[-1]) if counts.size else 0
    if total is None:
        total = t
    if counts.size <= 1:
        return np.zeros(total, dtype=np.int32)
    inner = ends[:-1]
    inner = inner[inner < total]
    out = np.bincount(inner, minlength=total).astype(np.int32, copy=False)
    np.cumsum(out, out=out)
    return out


def fast_repeat(
    values: np.ndarray, counts: np.ndarray, total: int | None = None
) -> np.ndarray:
    """``np.repeat(values, counts)`` via one gather on ``repeat_idx``."""
    return np.asarray(values)[repeat_idx(counts, total)]


def concat_ranges(
    starts: np.ndarray, ends: np.ndarray, dtype=np.int64
) -> np.ndarray:
    """Concatenation of ``[starts[i], ends[i])`` ranges without a Python
    loop: equals ``np.concatenate([np.arange(s, e) for s, e in ...])``."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(ends, dtype=np.int64) - starts
    idx = repeat_idx(lens)
    excl = np.concatenate([[0], np.cumsum(lens)[:-1]])
    within = np.arange(idx.shape[0], dtype=np.int64) - excl[idx]
    return (starts[idx] + within).astype(dtype, copy=False)


def segment_sums(ent_vals: np.ndarray, row_ptr: np.ndarray) -> np.ndarray:
    """Per-row sums of entry values laid out row-major under ``row_ptr``
    (int64 accumulate; the cumsum-difference identity — exact for ints)."""
    cs = np.zeros(ent_vals.shape[0] + 1, dtype=np.int64)
    np.cumsum(ent_vals, dtype=np.int64, out=cs[1:])
    rp = np.asarray(row_ptr, dtype=np.int64)
    return cs[rp[1:]] - cs[rp[:-1]]


def pow2ceil_arr(n: np.ndarray) -> np.ndarray:
    """Elementwise next power of two (>=1) in pure integer ops."""
    v = np.asarray(n, dtype=np.int64) - 1
    v = np.maximum(v, 0)
    for s in (1, 2, 4, 8, 16, 32):
        v |= v >> s
    return v + 1


def snap_chunks_arr(n: np.ndarray) -> np.ndarray:
    """Snap positive counts up to the nearest {2^k, 3*2^k} value (the
    ELL width-class lattice; caps per-segment padding at 1.33x)."""
    n = np.maximum(np.asarray(n, dtype=np.int64), 1)
    p2 = pow2ceil_arr(n)
    p3 = 3 * np.maximum(p2 >> 2, 1)
    return np.where((p3 >= n) & (p3 < p2), p3, p2)


def csr_host(csr) -> tuple[np.ndarray, np.ndarray]:
    """Host views ``(row_ptr int64, col_ind int32)`` of a CSR, cached on
    the instance (the planners read the same arrays many times, and a
    CSR on the card would otherwise pay a device-to-host copy each
    time)."""
    cached = getattr(csr, "_host_rp_ci", None)
    if cached is not None:
        return cached
    rp = csr.row_ptr.cpu().numpy().astype(np.int64)
    ci = csr.col_ind.cpu().numpy().astype(np.int32, copy=False)
    pair = (rp, ci)
    object.__setattr__(csr, "_host_rp_ci", pair)
    return pair
