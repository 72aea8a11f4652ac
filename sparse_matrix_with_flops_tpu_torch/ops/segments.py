"""Segment / scan primitives shared by the sparse kernels (torch).

The port of the JAX package's ``ops/segments.py``.  Results keep the
reference's int32 index type.  JAX drops out-of-range scatters
(``mode="drop"``, and the segment ops drop ids outside
``[0, num_segments)``); torch raises, so a scatter here goes into a
buffer with a dump region of DUMP_SLOTS slots past its end, and the
index of the q-th write that JAX would drop is ``n + q % DUMP_SLOTS``:
on the card, writes to one address queue, and millions of padding
writes on a single dump slot cost tens of ms.

``last_marked`` is the reference's "scatter + running max" of
``repeat_segments`` done with scatters whose targets are unique and an
int32 scan (K4): ``torch.cummax`` walks a whole row from one thread
block on the card.  ``repeat_segments_plain`` keeps the running max as
the plain version the tests hold it against.

``run_sums`` launches K9 (``csrc/run_sums.cu``) for tensors on the card
and runs ``run_sums_plain`` for tensors on the CPU.
"""

from __future__ import annotations

import torch

from .._build import check_tensor, counted, launch, on_card
from ..config import INDEX_DTYPE
from .scan_kernels import cumsum_i32

# K9 gives a run a warp of its own when the stream holds at least this
# many slots a run (row sums), else a lane (the products of one entry)
WARP_RUN_SLOTS = 32
# slots of a scatter's dump region: dropped writes spread over them
DUMP_SLOTS = 4096


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


def dump_region(q: torch.Tensor, n: int) -> torch.Tensor:
    """int64 indices ``n + q % DUMP_SLOTS``: where a buffer of
    ``n + DUMP_SLOTS`` slots takes the q-th dropped write."""
    return n + q.long() % DUMP_SLOTS


def _dump_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int64 scatter indices into a buffer of ``n + DUMP_SLOTS`` slots:
    every id outside ``[0, n)`` goes to the dump region."""
    ids = ids.long()
    q = torch.arange(ids.shape[0], device=ids.device)
    return torch.where((ids >= 0) & (ids < n), ids, dump_region(q, n))


def last_marked(marks: torch.Tensor, valid: torch.Tensor, total: int) -> torch.Tensor:
    """int32 [total]: for each position q, the largest s with ``valid[s]``
    and ``marks[s] <= q``, or -1 where there is none.  The marks of the
    valid entries must be non-negative and non-decreasing in s; marks at
    or past ``total`` mark nothing.  This equals the running max of a
    max-scatter of s at ``marks[s]`` (:func:`repeat_segments_plain`).

    Done with unique scatter targets and scans: the valid entries are
    compacted in order; of each run of equal marks below ``total`` only
    the last (the largest s) writes, ``s + 1`` at its mark, and
    subtracts the same at the next run's mark; the inclusive scan of
    those deltas, less one, is the answer.  Writes with nowhere to go
    land on distinct dump slots.  No host read."""
    num, dev = marks.shape[0], marks.device
    if total == 0 or num == 0:
        return torch.full((total,), -1, dtype=INDEX_DTYPE, device=dev)
    s = torch.arange(num, dtype=INDEX_DTYPE, device=dev)
    c = cumsum_i32(valid.to(INDEX_DTYPE))
    slot = torch.where(valid, c - 1, num + s).long()  # invalid: distinct dump slots
    inside = valid & (marks >= 0) & (marks < total)
    cm = torch.full((2 * num,), total, dtype=INDEX_DTYPE, device=dev)
    cm.scatter_(0, slot, torch.where(inside, marks, total).to(INDEX_DTYPE))
    cid = torch.zeros(2 * num, dtype=INDEX_DTYPE, device=dev)
    cid.scatter_(0, slot, s + 1)
    cm, cid = cm[:num], cid[:num]
    nxt = torch.cat([cm[1:], cm.new_full((1,), total)])
    last = (cm < total) & (nxt != cm)
    dump = (total + s).long()
    delta = torch.zeros(total + num, dtype=INDEX_DTYPE, device=dev)
    delta.scatter_(0, torch.where(last, cm.long(), dump), cid)
    delta.scatter_add_(0, torch.where(last & (nxt < total), nxt.long(), dump), -cid)
    delta[:1] -= 1
    return cumsum_i32(delta[:total])


# the reference's name: output position q's segment is the last valid one
# starting at or before q (``starts`` non-decreasing where valid, as
# exclusive prefix sums are)
repeat_segments = last_marked


def repeat_segments_plain(
    starts: torch.Tensor, valid: torch.Tensor, total: int
) -> torch.Tensor:
    """:func:`repeat_segments` as the reference writes it: a max-scatter
    of segment ids at their starts (one dump slot for the rest), then a
    running max.  The plain version the tests compare against; no card
    path calls it."""
    num = starts.shape[0]
    seg_plus1 = torch.where(
        valid, torch.arange(1, num + 1, dtype=INDEX_DTYPE, device=starts.device), 0
    ).to(INDEX_DTYPE)
    idx = starts.long()
    idx = torch.where(valid & (idx >= 0) & (idx < total), idx, total)
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
        (num_segments + DUMP_SLOTS, *values.shape[1:]), dtype=values.dtype,
        device=values.device,
    )
    out.index_add_(0, _dump_ids(segment_ids, num_segments), values)
    return out[:num_segments]


def run_sums_plain(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """K9's plain version: ``torch.segment_reduce``.  On the CPU it adds
    each run left to right from 0.0, K9's order; on the card it is CUB's
    segmented reduce, whose order depends on where a run starts."""
    return torch.segment_reduce(values, "sum", offsets=offsets.long(), unsafe=True)


@counted
def run_sums(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Sums of the contiguous runs ``values[offsets[i]:offsets[i + 1]]``
    of a 1-D f32 stream, each added left to right in run-local order
    from 0.0 (an empty run sums to 0), so a run gives the same bits in
    every call, at every offset of the stream, on the card (K9) and on
    the CPU (``run_sums_plain``).  :func:`segment_sum`'s scatter-add is
    float atomics on CUDA, whose order changes from call to call.
    ``offsets`` (int32 or int64) must be non-decreasing and within
    ``[0, len(values)]``; values past ``offsets[-1]`` are left out."""
    check_tensor(values, "run_sums", torch.float32, 1)
    if offsets.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"run_sums: offsets must be int32 or int64, got {offsets.dtype}")
    if offsets.dim() != 1 or not offsets.is_contiguous() or offsets.shape[0] < 1:
        raise ValueError("run_sums: offsets must be a non-empty contiguous 1-D tensor")
    if not on_card("run_sums", values, offsets):
        return run_sums_plain(values, offsets)
    runs = offsets.shape[0] - 1
    out = torch.empty(runs, dtype=torch.float32, device=values.device)
    if runs == 0:
        return out
    launch("smf_run_sums", values.device, values.data_ptr(), offsets.data_ptr(),
           int(offsets.dtype == torch.int64), out.data_ptr(), runs,
           int(values.shape[0] >= WARP_RUN_SLOTS * runs))
    run_sums.launches += 1
    return out


RUN_BLOCK = 32  # values a block of blocked_run_sums


def blocked_run_sums(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """:func:`run_sums` with each run added in blocks of RUN_BLOCK values
    counted from the run's own start: the blocks' sums first, then each
    run's block sums, both by ``run_sums``.  The order is still fixed by
    the run alone (a run gives the same bits at any offset, on the card
    and on the CPU), but a sum of n values carries about RUN_BLOCK +
    n / RUN_BLOCK roundings instead of n: the prune's rows reach
    thousands of values, where a strictly sequential f32 sum moved a
    row's threshold past the f64 oracle's flip allowance.  No host
    read."""
    runs = offsets.shape[0] - 1
    if runs == 0:
        return run_sums(values, offsets)
    o = offsets.long()
    nb = (o[1:] - o[:-1] + RUN_BLOCK - 1) // RUN_BLOCK
    boff = exclusive_cumsum(nb)
    # sum(ceil(len / RUN_BLOCK)) <= len(values) // RUN_BLOCK + runs
    q = torch.arange(values.shape[0] // RUN_BLOCK + runs, device=o.device)
    r = (torch.searchsorted(boff, q, right=True) - 1).clamp(max=runs - 1)
    starts = torch.where(q < boff[-1], o[r] + RUN_BLOCK * (q - boff[r]), o[-1])
    return run_sums(run_sums(values, torch.cat([starts, o[-1:]])), boff)


def segment_max(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-segment maxima over a zero start (the reference's
    ``zeros().at[seg].max(v, mode="drop")``), ids out of range dropped."""
    out = torch.zeros(
        (num_segments + DUMP_SLOTS, *values.shape[1:]), dtype=values.dtype,
        device=values.device,
    )
    out.scatter_reduce_(0, _dump_ids(segment_ids, num_segments), values, reduce="amax")
    return out[:num_segments]


def equal_partition(prefix_sum: torch.Tensor, num_parts: int) -> torch.Tensor:
    """Split [0, n) into ``num_parts`` contiguous ranges of about equal
    cost (``arrayEqualPartition``, util.cc:137-149): ``prefix_sum`` has
    n + 1 entries from 0 to the total; returns int32 ``ends`` of length
    num_parts + 1 with ends[0] == 0 and ends[-1] == n.  Ranges may be
    empty."""
    n = prefix_sum.shape[0] - 1
    dev = prefix_sum.device
    total = prefix_sum[n]
    chunk = (total + num_parts - 1) // num_parts
    targets = chunk * torch.arange(1, num_parts, dtype=prefix_sum.dtype, device=dev)
    targets = torch.minimum(targets, total)
    mids = torch.searchsorted(prefix_sum, targets, right=True).to(INDEX_DTYPE) - 1
    mids = mids.clamp(0, n)
    zero = torch.zeros(1, dtype=INDEX_DTYPE, device=dev)
    last = torch.full((1,), n, dtype=INDEX_DTYPE, device=dev)
    return torch.cat([zero, mids, last])


def prefix_sum_to_counts(prefix_sum: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`exclusive_cumsum` (util.cc:117-121)."""
    return prefix_sum[1:] - prefix_sum[:-1]


def key_value_sort(keys: torch.Tensor, values: torch.Tensor, descending: bool = False):
    """Paired stable sort by key (key_value_qsort.h:14-42).  Descending
    sorts the negated keys ascending and negates back, as the reference
    does, so ties keep their order and signed zeros and the int32
    minimum come out as the reference's."""
    k = -keys if descending else keys
    order = torch.sort(k, stable=True).indices
    k, v = k[order], values[order]
    return (-k if descending else k), v
