"""Segment / scan primitives shared by the sparse kernels (torch).

The port of the JAX package's ``ops/segments.py``.  Results keep the
reference's int32 index type.  JAX drops out-of-range scatters
(``mode="drop"``, and the segment ops drop ids outside
``[0, num_segments)``); torch raises, so every scatter here goes into a
buffer one slot longer whose last slot takes those indices.
"""

from __future__ import annotations

import torch

from ..config import INDEX_DTYPE


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum with the total appended: len(out) == len(x) + 1.

    ``out[i] = sum(x[:i])``, ``out[-1] = sum(x)``, in x's dtype:
    ``torch.cumsum`` widens int32 to int64, so the result is cast back
    (int32 wrap-around, as the JAX version)."""
    out = torch.zeros(x.shape[0] + 1, dtype=x.dtype, device=x.device)
    out[1:] = torch.cumsum(x, 0).to(x.dtype)
    return out


def entry_rows(row_ptr: torch.Tensor, capacity: int) -> torch.Tensor:
    """Row id of every entry slot of a CSR array, sentinel ``rows`` for
    padding: slot q lies in row i with ``row_ptr[i] <= q < row_ptr[i+1]``,
    or is padding if ``q >= nnz``."""
    rows = row_ptr.shape[0] - 1
    q = torch.arange(capacity, device=row_ptr.device, dtype=row_ptr.dtype)
    rid = torch.searchsorted(row_ptr[1:], q, right=True).to(INDEX_DTYPE)
    return torch.where(q < row_ptr[-1], rid, rows)


def _dump_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int64 scatter indices with every id outside ``[0, n)`` sent to the
    dump slot ``n``."""
    ids = ids.long()
    return torch.where((ids >= 0) & (ids < n), ids, n)


def repeat_segments(
    starts: torch.Tensor, valid: torch.Tensor, total: int
) -> torch.Tensor:
    """Map output position q in [0, total) to the segment it belongs to:
    a max-scatter of segment ids at their (distinct, valid) starts, then
    a running max.  Invalid segments scatter nothing."""
    num = starts.shape[0]
    seg_plus1 = torch.where(
        valid, torch.arange(1, num + 1, dtype=INDEX_DTYPE, device=starts.device), 0
    ).to(INDEX_DTYPE)
    idx = _dump_ids(torch.where(valid, starts, total), total)
    marks = torch.zeros(total + 1, dtype=INDEX_DTYPE, device=starts.device)
    marks.scatter_reduce_(0, idx, seg_plus1, reduce="amax")
    return torch.cummax(marks[:total], 0).values - 1


def segment_boundaries(
    keys_a: torch.Tensor, keys_b: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Flags marking the first element of each (keys_a, keys_b) run of
    lexicographically sorted keys; invalid elements start no segment."""
    first = torch.ones(min(keys_a.shape[0], 1), dtype=torch.bool, device=keys_a.device)
    diff = (keys_a[1:] != keys_a[:-1]) | (keys_b[1:] != keys_b[:-1])
    return torch.cat([first, diff]) & valid


def segment_sum(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """``jax.ops.segment_sum``: per-segment sums, ids out of range dropped."""
    out = torch.zeros(
        (num_segments + 1, *values.shape[1:]), dtype=values.dtype, device=values.device
    )
    out.index_add_(0, _dump_ids(segment_ids, num_segments), values)
    return out[:num_segments]


def run_sums(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Sums of the contiguous runs ``values[offsets[i]:offsets[i + 1]]``
    (an empty run sums to 0), each added up in a fixed order: the same
    stream gives the same bits in every call.  On CUDA (CUB's segmented
    reduce) the order also depends on where a run starts in ``values``,
    so the same run at another offset can differ in its last bits.
    :func:`segment_sum`'s scatter-add is float atomics on CUDA, whose
    order changes from call to call.  ``offsets`` must be non-decreasing
    and within ``[0, len(values)]``; values past ``offsets[-1]`` are
    left out."""
    return torch.segment_reduce(values, "sum", offsets=offsets.long(), unsafe=True)


def segment_max(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-segment maxima over a zero start (the reference's
    ``zeros().at[seg].max(v, mode="drop")``), ids out of range dropped."""
    out = torch.zeros(
        (num_segments + 1, *values.shape[1:]), dtype=values.dtype, device=values.device
    )
    out.scatter_reduce_(0, _dump_ids(segment_ids, num_segments), values, reduce="amax")
    return out[:num_segments]
