"""The benchmark's arithmetic: percentiles, the bytes and
operations of a multiply, the least time a chip could take, and the
device's busy time from a trace's intervals.  Plain Python and NumPy, so
that the tests check it on hand-made inputs."""

from __future__ import annotations

import json
import os

import numpy as np

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def percentile(values, p: float) -> float:
    """The ``p``-th percentile (0-100) with linear interpolation between
    order statistics (NumPy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * p / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def csr_bytes(rows: int, nnz: int) -> int:
    """Bytes of a CSR with int32 row pointers and columns, float32 values."""
    return 4 * (rows + 1) + 8 * nnz


def square_bytes(rows: int, nnz: int, nnz_c: int) -> int:
    """What C = A·A has to move at the least: A read once (it is both
    operands), C written once."""
    return csr_bytes(rows, nnz) + csr_bytes(rows, nnz_c)


def peaks(kind: str) -> dict:
    """The published peaks of the card named ``kind`` (``peaks.json``,
    matched by the first key contained in the name)."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    for key, row in table.items():
        if key in kind:
            return row
    raise KeyError(f"no peaks for {kind!r} in {PEAKS_FILE}")


def least_time(flops: float, nbytes: float, peak: dict) -> tuple[float, str]:
    """(seconds, bound): the larger of the operations at the card's f32
    rate and the bytes at its memory bandwidth, and which of the two it
    is ("bytes" or "ops")."""
    t_ops = flops / peak["f32_flops_per_s"]
    t_bytes = nbytes / peak["hbm_bytes_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")


def union(intervals) -> list[tuple[float, float]]:
    """Merge ``(start, end)`` intervals into disjoint sorted ones."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy(intervals, lo: float, hi: float) -> float:
    """Time inside [lo, hi] covered by at least one interval."""
    return sum(e - s for s, e in union(clip(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def idle_pct(busy_s: float, window_s: float) -> float:
    return 100.0 * (1.0 - busy_s / window_s)


def row_flops_total(row_ptr, col) -> int:
    """Σ rowFlops of A·A from A's host CSR arrays."""
    ent = np.diff(row_ptr)[col]
    return int(ent.sum(dtype=np.int64))
