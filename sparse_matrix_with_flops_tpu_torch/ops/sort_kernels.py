"""K1-K3: the row sort/compaction kernels of the ELL-ESC pipeline (port
of the JAX package's ``ops/pallas_sort.py``).

Each wrapper checks its arguments, then launches its CUDA kernel
(``csrc/*.cu``) for tensors on the card, or runs its plain twin below
for tensors on the CPU.  ``<wrapper>.launches`` counts kernel launches.

* ``sort_dedup_compact`` (K1): per row, sort lanes by column, sum runs
  of equal columns, drop ``col >= ncols``, compact left;
* ``compact_nonzero_rows`` (K2): dense rows -> (cols, vals) of their
  nonzero lanes, in column order;
* ``window_gather`` (K3): ``W``-lane windows of a flat stream at given
  start positions.
"""

from __future__ import annotations

import torch

from .._build import check_tensor, counted, launch, on_card

# K1 holds a row of (int32, f32) pairs in shared memory: 8 bytes a lane.
# Up to 16384 lanes (128 KB) a row runs on one block; 32768 lanes
# (256 KB, above the 227 KB one block can use on Hopper) on a cluster of
# two blocks, one half each.  Wider rows have no kernel.
MAX_SORT_W = 32768


def _is_pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


# ---------------------------------------------------------------------------
# K1: sort / dedup / compact
# ---------------------------------------------------------------------------
def sort_dedup_compact_plain(
    tc: torch.Tensor, tv: torch.Tensor, ncols: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's twin: stable sort by column, within-run prefix sums (the
    log-step segmented scan of the reference's kernel), keep each run's
    last lane if its column is < ncols, then a stable sort compacts the
    survivors left.  Padding is (ncols, 0.0)."""
    r, w = tc.shape
    col, order = torch.sort(tc, dim=1, stable=True)
    val = torch.gather(tv, 1, order)
    lane = torch.arange(w, device=tc.device)
    d = 1
    while d < w:
        same = torch.zeros_like(col, dtype=torch.bool)
        same[:, d:] = col[:, d:] == col[:, :-d]
        add = torch.zeros_like(val)
        add[:, d:] = val[:, :-d]
        val = val + torch.where(same & (lane >= d), add, 0.0)
        d *= 2
    nxt = torch.full_like(col, ncols)
    nxt[:, :-1] = col[:, 1:]
    is_last = (col != nxt) & (col < ncols)
    key = torch.where(is_last, col, ncols)
    key, order = torch.sort(key, dim=1, stable=True)
    val = torch.gather(val, 1, order)
    return key, torch.where(key < ncols, val, 0.0)


@counted
def sort_dedup_compact(
    tc: torch.Tensor, tv: torch.Tensor, ncols: int, presorted: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """[R, W] tile -> (compacted cols, summed vals), both [R, W].

    ``presorted > 1`` promises that every aligned run of that many lanes
    is sorted, runs alternating ascending / descending by run parity
    (even runs ascending), so the kernel's bitonic network starts at
    k = 2 * presorted.  The twin ignores the hint; the output is the
    same either way."""
    check_tensor(tc, "sort_dedup_compact tc", torch.int32, 2)
    check_tensor(tv, "sort_dedup_compact tv", torch.float32, 2)
    if tc.shape != tv.shape:
        raise ValueError(f"tc {tuple(tc.shape)} != tv {tuple(tv.shape)}")
    r, w = tc.shape
    if not _is_pow2(w) or not _is_pow2(presorted):
        raise ValueError(f"W={w} and presorted={presorted} must be powers of two")
    if not on_card("sort_dedup_compact", tc, tv):
        return sort_dedup_compact_plain(tc, tv, ncols)
    if w > MAX_SORT_W:
        raise ValueError(f"sort_dedup_compact: W={w} > {MAX_SORT_W} has no kernel")
    kout = torch.empty_like(tc)
    vout = torch.empty_like(tv)
    if r:
        launch(
            "smf_sort_dedup_compact", tc.device,
            tc.data_ptr(), tv.data_ptr(), kout.data_ptr(), vout.data_ptr(),
            r, w, ncols, presorted,
        )
        sort_dedup_compact.launches += 1
    return kout, vout


# ---------------------------------------------------------------------------
# K2: dense rows -> compacted nonzero lanes
# ---------------------------------------------------------------------------
def compact_nonzero_rows_plain(
    vals: torch.Tensor, ncols: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's twin: a stable sort of the keep-masked lane keys."""
    n = vals.shape[1]
    lane = torch.arange(n, dtype=torch.int32, device=vals.device)
    keep = (vals != 0) & (lane < ncols)
    key = torch.where(keep, lane, ncols).to(torch.int32)
    key, order = torch.sort(key, dim=1, stable=True)
    out = torch.gather(vals, 1, order)
    return key, torch.where(key < ncols, out, 0.0)


@counted
def compact_nonzero_rows(
    vals: torch.Tensor, ncols: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense [R, N] f32 rows -> ([R, N] int32 cols, [R, N] f32 vals): the
    lanes with a nonzero value and an index < ncols, at the front in
    column order; padding (ncols, 0.0).  Exact zeros are dropped."""
    check_tensor(vals, "compact_nonzero_rows vals", torch.float32, 2)
    if not on_card("compact_nonzero_rows", vals):
        return compact_nonzero_rows_plain(vals, ncols)
    r, n = vals.shape
    kout = torch.empty(vals.shape, dtype=torch.int32, device=vals.device)
    vout = torch.empty_like(vals)
    if r and n:
        launch(
            "smf_compact_nonzero_rows", vals.device,
            vals.data_ptr(), kout.data_ptr(), vout.data_ptr(), r, n, ncols,
        )
        compact_nonzero_rows.launches += 1
    return kout, vout


# ---------------------------------------------------------------------------
# K3: unaligned window gather
# ---------------------------------------------------------------------------
def _window_starts(p0: torch.Tensor, nr: int, w: int) -> torch.Tensor:
    """Clipped start of each window: the reference's ``wr * W + off``
    with ``wr = clip(p0 // W, 0, nr - 2)``, ``off = clip(p0 - wr * W, 0,
    W - 1)`` (int64)."""
    p = p0.long()
    wr = torch.clamp(torch.div(p, w, rounding_mode="floor"), 0, nr - 2)
    off = torch.clamp(p - wr * w, 0, w - 1)
    return wr * w + off


def window_gather_plain(
    src_c: torch.Tensor, src_v: torch.Tensor, p0: torch.Tensor, w: int,
    p1: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """K3's twin: an index gather of ``W`` lanes from each start (of
    ``p0``, then of ``p1`` when given)."""
    outs = []
    for p in (p0,) if p1 is None else (p0, p1):
        start = _window_starts(p, src_c.shape[0] // w, w)
        idx = start[:, None] + torch.arange(w, device=p.device)
        outs += [src_c[idx], src_v[idx]]
    return tuple(outs)


@counted
def window_gather(
    src_c: torch.Tensor, src_v: torch.Tensor, p0: torch.Tensor, w: int = 128,
    p1: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """``out[q, l] = src[s(q) + l]`` for the int32 cols and value bits,
    ``s(q)`` the clipped start of :func:`_window_starts`.  The sources
    hold ``nr * W`` lanes, ``nr >= 2``; ``p0`` is int32 [Q].  Equals the
    reference's two row takes + ``align_windows`` on the same ``p0``.
    Returns ``(cols, bits)`` [Q, W]; with a second int32 position list
    ``p1`` [Q1], one launch also gathers its windows and the result is
    ``(cols, bits, cols1, bits1)``."""
    check_tensor(src_c, "window_gather src_c", torch.int32, 1)
    check_tensor(src_v, "window_gather src_v", torch.int32, 1)
    check_tensor(p0, "window_gather p0", torch.int32, 1)
    lists = (p0,) if p1 is None else (p0, p1)
    if p1 is not None:
        check_tensor(p1, "window_gather p1", torch.int32, 1)
    t = src_c.shape[0]
    if w < 1 or src_v.shape[0] != t or t % w or t < 2 * w:
        raise ValueError(
            f"window_gather: sources of {t} / {src_v.shape[0]} lanes, "
            f"need equal multiples of W={w}, at least 2W"
        )
    if not on_card("window_gather", src_c, src_v, *lists):
        return window_gather_plain(src_c, src_v, p0, w, p1)
    q0, q1 = p0.shape[0], 0 if p1 is None else p1.shape[0]
    # [2, Q0 + Q1, W]: the cols, then the bits, of p0's windows, then p1's
    out = torch.empty((2, q0 + q1, w), dtype=torch.int32, device=p0.device)
    if q0 + q1:
        launch(
            "smf_window_gather", p0.device,
            src_c.data_ptr(), src_v.data_ptr(), p0.data_ptr(), q0,
            p1.data_ptr() if q1 else 0, q1, out.data_ptr(), t // w, w,
        )
        window_gather.launches += 1
    if p1 is None:
        return out[0], out[1]
    return out[0, :q0], out[1, :q0], out[0, q0:], out[1, q0:]
