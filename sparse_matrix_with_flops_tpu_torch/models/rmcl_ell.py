"""Static-shape fused R-MCL on one card (the port of the JAX package's
``models/rmcl_ell.py``).

Mgt is fixed across iterations (qrmcl.cc:141), and capping the iterate at
``S`` survivors a row (the MCL selection number) makes every shape of the
loop static:

* Mt lives as an ELL pair ``cols/vals [n, S]`` (sentinel-padded, each
  row's columns sorted and unique);
* expansion is one row gather: the segment of A entry e is Mt row
  ``col_e``;
* rows of Mgt are binned once by degree class; a degree-2^d row's
  product tile is ``[*, 2^d · S]``, the concatenation of its entries'
  sorted segments, so K1 (``sort_dedup_compact``) sorts, sums and
  compacts it from presorted runs of S lanes;
* inflate / threshold / prune (util.cc:4-69), top-S selection and
  renormalisation of those tiles are one launch of K11
  (``ops/select_kernels.prune_select``), a block a tile row, where the
  tile's width fits its shared memory; wider tiles take two stable
  sorts a tile (``_prune_select_lanes``);
* hub rows (degree beyond the largest tile) take a dense f32 matmul of
  Mgt's hub block against the densified iterate rows they reference.

``rmcl_ell_scan`` keeps the iterate on the device for the whole run and
the per-iteration statistics as tensors until the end; on the card its
step is a CUDA graph kept on the plan, captured once the iterations run
on it reach the step's break-even count, and replayed
(``utils/graphs.py``).

Spans and counters of the port's tracer (``utils.timing.TRACE``):
``rmcl_ell`` (a job) with ``.init``, ``.plan``, ``.load``, ``.scan`` and
``.read``; in each step run eagerly (never in one being captured, which
runs no device work) ``rmcl_ell.step`` with ``.gather``, ``.tile``,
``.select`` (one of each a chunk of a degree bin), ``.hub`` and
``.drift``; on the host for every iteration, replays included, the
counters ``rmcl_ell.lanes`` (the step's tile lanes, Σ R_b · D · S),
``rmcl_ell.select_rows`` (the tile rows sent to K11, Σ R_b over its
bins) and ``rmcl_ell.hub_rows``; every read from the card through
``TRACE.host_read`` (sites ``rmcl_ell.csr_host``, ``rmcl_ell.ordered``,
``rmcl_ell.to_csr``, ``rmcl_ell.history``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE, true_f32
from ..formats.coo import COO
from ..formats.csr import CSR
from ..ops.densify import ell_rows_to_dense, entries_to_dense
from ..ops.prune import compute_threshold
from ..ops.select_kernels import MAX_SELECT_W, prune_select
from ..ops.sort_kernels import (
    MAX_SORT_W,
    _is_pow2,
    sort_dedup_compact,
    sort_dedup_compact_plain,
)
from ..utils import graphs
from ..utils.nphost import csr_host, repeat_idx
from ..utils.timing import TRACE

# the hub matmul's dense iterate slab is kept under this many bytes
# (the reference's 512 MB budget, models/rmcl_ell.py:240-242)
_HUB_SLAB_BYTES = 1 << 29
# a degree bin's product tiles are built and reduced in chunks of rows
# whose tile pair (int32 columns, f32 values) stays under this many
# bytes: the chunk's sort, prune and selection temporaries are a small
# multiple of it, where a whole bin's were tens of GB at 2^19 rows
_TILE_BYTES = 1 << 30
_NULL = contextlib.nullcontext()


def _pow2ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True, eq=False)
class RmclEllPlan:
    """Static structure derived from Mgt (fixed for the whole run); the
    same fields, and for the same Mgt the same values, as the
    reference's plan."""

    n: int
    S: int  # selection cap (iterate width)
    bins: tuple  # ((D, row_ids np.int32[R_b], ent_src np.int32[R_b*D]), ...)
    huge_rows: np.ndarray  # degrees > max tile
    huge_src: np.ndarray  # entry indices of huge rows (concatenated)
    huge_lens: np.ndarray
    hub_precision: str = "f32"  # "bf16": bf16 densify, f32 products
    # hub contraction restricted to the union of iterate rows the hub
    # rows reference (a plan constant: Mgt is static)
    hub_krows: np.ndarray | None = None  # int32[khp], -1 padded
    hub_kmap: np.ndarray | None = None  # int32[n]: global -> local, -1
    hub_kh: int = 0  # padded union size (multiple of 128)

    __hash__ = object.__hash__


def plan_rmcl_ell(
    mgt: CSR, S: int = 128, max_tile: int = 16384, hub_precision: str = "f32"
) -> RmclEllPlan:
    """Bin Mgt rows by degree class; ent_src holds each row's A-entry ids
    (sentinel -1 padding).  Host numpy, copied from the reference."""
    rp, ci = csr_host(mgt, "rmcl_ell.csr_host")
    m = mgt.rows
    deg = np.diff(rp)
    # largest power-of-two degree class that fits the tile budget; rows
    # above it go dense
    dmax = 1
    while dmax * 2 <= max(max_tile // S, 1):
        dmax *= 2
    bins = []
    d = 1
    while d <= dmax:
        lo = d // 2 + 1 if d > 1 else 1
        sel = np.nonzero((deg >= lo) & (deg <= d))[0]
        if sel.size:
            k = np.arange(d)
            ent_src = np.where(k < deg[sel][:, None], rp[sel][:, None] + k, -1)
            bins.append(
                (int(d), sel.astype(np.int32), ent_src.reshape(-1).astype(np.int32))
            )
        d *= 2
    huge = np.nonzero((deg > dmax))[0].astype(np.int32)
    huge_src = (
        np.concatenate([np.arange(rp[r], rp[r + 1]) for r in huge]).astype(np.int32)
        if huge.size
        else np.zeros(0, np.int32)
    )
    huge_lens = deg[huge].astype(np.int32)
    hub_krows, hub_kmap, hub_kh = None, None, 0
    if huge.size:
        krows = np.unique(np.clip(ci[huge_src], 0, m - 1))
        kh = int(krows.size)
        khp = max(128, -(-kh // 128) * 128)
        hub_krows = np.full(khp, -1, np.int32)
        hub_krows[:kh] = krows
        hub_kmap = np.full(m, -1, np.int32)
        hub_kmap[krows] = np.arange(kh, dtype=np.int32)
        hub_kh = khp
    return RmclEllPlan(
        n=m,
        S=int(S),
        bins=tuple(bins),
        huge_rows=huge,
        huge_src=huge_src,
        huge_lens=huge_lens,
        hub_precision=hub_precision,
        hub_krows=hub_krows,
        hub_kmap=hub_kmap,
        hub_kh=hub_kh,
    )


def _plan_tensors(plan: RmclEllPlan, device: torch.device) -> dict:
    """The plan's index arrays on ``device``, uploaded once per plan."""
    cache = plan.__dict__.setdefault("_dev", {})
    key = str(device)
    if key not in cache:
        # int32 on the wire (half the bytes), widened on the device
        up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device).long()  # noqa: E731
        cache[key] = {
            "bins": [(d, up(rid), up(src)) for d, rid, src in plan.bins],
            "huge_rows": up(plan.huge_rows),
            "hub_krows": None if plan.hub_krows is None else up(plan.hub_krows),
        }
    return cache[key]


def mt_to_ell(mt: CSR, S: int):
    """Initial iterate: duplicate-sum + first-S truncation + renormalise.
    Establishes the ELL invariant every step keeps: each row's columns
    sorted and unique.  Returns (cols int32, vals f32) [n, S] on
    ``mt``'s device.

    Rows already column-sorted and unique (an ``rmcl_init`` result, told
    by one read of a flag) are laid out on the device; other input is
    merged on the host, its duplicates summed in float64 in entry
    order."""
    rp_h, ci_h = csr_host(mt, "rmcl_ell.csr_host")
    n = mt.rows
    nnz = int(rp_h[-1])
    dev = mt.device
    rp = mt.row_ptr.long()
    erow = torch.repeat_interleave(torch.arange(n, device=dev), rp[1:] - rp[:-1],
                                   output_size=nnz)
    c = mt.col_ind[:nnz].long()
    key = erow * (mt.ncols + 1) + c
    if nnz < 2 or bool(TRACE.host_read("rmcl_ell.ordered", (key[1:] > key[:-1]).all())):
        rank = torch.arange(nnz, device=dev) - rp[erow]
        at = torch.where(rank < S, erow * S + rank, n * S)  # slot n * S: the dropped
        cols = torch.full((n * S + 1,), mt.ncols, dtype=INDEX_DTYPE, device=dev)
        vals = torch.zeros(n * S + 1, dtype=QVALUE_DTYPE, device=dev)
        cols[at] = c.to(INDEX_DTYPE)
        vals[at] = mt.values[:nnz]
        cols, vals = cols[:-1].view(n, S), vals[:-1].view(n, S)
        s = _pairwise_row_sum(vals)[:, None]
        return cols, torch.where(s > 0, vals / torch.clamp(s, min=1e-30), vals)
    return _mt_to_ell_host(rp_h, ci_h[:nnz].astype(np.int64),
                           TRACE.host_read("rmcl_ell.csr_host", mt.values[:nnz]).numpy(),
                           n, mt.ncols, S, dev)


def _pairwise_row_sum(x):
    """Each row's float32 sum in NumPy's order (``pairwise_sum``: up to
    128 lanes, eight running sums over blocks of 8 lanes, then the rest
    one by one; above 128, the two halves), so that the device's first
    iterate holds the bits of :func:`_mt_to_ell_host`'s."""
    w = x.shape[1]
    if w < 8:
        res = torch.zeros_like(x[:, 0])
        for i in range(w):
            res = res + x[:, i]
        return res
    if w <= 128:
        body = w - w % 8
        r = x[:, :8]
        for i in range(8, body, 8):
            r = r + x[:, i:i + 8]
        res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + ((r[:, 4] + r[:, 5])
                                                             + (r[:, 6] + r[:, 7]))
        for i in range(body, w):
            res = res + x[:, i]
        return res
    half = w // 2 - (w // 2) % 8
    return _pairwise_row_sum(x[:, :half]) + _pairwise_row_sum(x[:, half:])


def _mt_to_ell_host(rp, c, v, n: int, ncols: int, S: int, device):
    """:func:`mt_to_ell` of rows in any order, with duplicates: a global
    (row, col) sort and per-row unique prefix sums, all bulk NumPy."""
    nnz = c.shape[0]
    erow = repeat_idx(np.diff(rp), nnz).astype(np.int64)
    order = np.argsort(erow * (ncols + 1) + c, kind="stable")
    re, ce, ve = erow[order], c[order], v[order].astype(np.float64)
    first = np.ones(nnz, dtype=bool)
    first[1:] = (re[1:] != re[:-1]) | (ce[1:] != ce[:-1])
    seg = np.cumsum(first) - 1
    nseg = int(seg[-1]) + 1 if nnz else 0
    uv = np.zeros(nseg, np.float64)
    np.add.at(uv, seg, ve)
    ur = re[first]
    uc = ce[first]
    # rank of each unique col within its row (uniques are row-contiguous)
    row_start = np.zeros(n + 1, np.int64)
    np.add.at(row_start, ur + 1, 1)
    np.cumsum(row_start, out=row_start)
    rank = np.arange(nseg, dtype=np.int64) - row_start[ur]
    keep = rank < S
    cols = np.full((n, S), ncols, np.int32)
    vals = np.zeros((n, S), np.float32)
    cols[ur[keep], rank[keep]] = uc[keep].astype(np.int32)
    vals[ur[keep], rank[keep]] = uv[keep].astype(np.float32)
    s = vals.sum(axis=1, keepdims=True)
    vals = np.where(s > 0, vals / np.maximum(s, 1e-30), vals)
    return (
        torch.from_numpy(cols).to(device),
        torch.from_numpy(np.ascontiguousarray(vals, np.float32)).to(device),
    )


def ell_to_csr(cols, vals, ncols: int) -> CSR:
    """Iterate back to a tight CSR (end of run), on the iterate's device
    (numpy input: on the CPU): the lanes with a column below ``ncols``,
    in row-major order, placed on the device; one read, of nnz."""
    cols, vals = torch.as_tensor(cols), torch.as_tensor(vals)
    n = cols.shape[0]
    keep = cols < ncols
    row_ptr = torch.zeros(n + 1, dtype=INDEX_DTYPE, device=cols.device)
    torch.cumsum(keep.sum(dim=1), 0, dtype=INDEX_DTYPE, out=row_ptr[1:])
    nnz = int(TRACE.host_read("rmcl_ell.to_csr", row_ptr[-1]))
    keep = keep.reshape(-1)
    at = torch.where(keep, torch.cumsum(keep, 0) - 1, nnz)  # slot nnz: the padding
    col = torch.empty(nnz + 1, dtype=INDEX_DTYPE, device=cols.device)
    val = torch.empty(nnz + 1, dtype=QVALUE_DTYPE, device=cols.device)
    col[at] = cols.reshape(-1).to(INDEX_DTYPE)
    val[at] = vals.reshape(-1).to(QVALUE_DTYPE)
    return CSR(row_ptr, col[:nnz], val[:nnz], int(ncols))


def _prune_select_lanes(key, uval, n: int, S: int):
    """Fused inflate/threshold/prune + top-S selection + renormalise on a
    compacted [R, W] tile (util.cc:4-69 semantics + MCL selection): the
    route of tiles too wide for K11 (the hub rows', n lanes).

    The two sorts are stable (the reference's ``lax.sort``): the input
    lanes are column-sorted, so a tie in value at the S cut keeps the
    lower column.  A tile narrower than S is padded to S lanes."""
    r, w_in = key.shape
    if w_in < S:
        key = torch.cat([key, key.new_full((r, S - w_in), n)], dim=1)
        uval = torch.cat([uval, uval.new_zeros((r, S - w_in))], dim=1)
    valid = key < n
    w = torch.where(valid, uval * uval, 0.0)  # inflation v^2
    rsum = w.sum(dim=1)
    rmax = w.amax(dim=1)
    rcount = valid.sum(dim=1).to(QVALUE_DTYPE)
    avg = rsum / torch.clamp(rcount, min=1.0)
    thresh = compute_threshold(avg, rmax)
    keep = valid & (w >= thresh[:, None])
    truncated = keep.sum(dim=1) > S
    # top-S by inflated value: sort by (-w | +inf), slice, re-sort by col
    vkey = torch.where(keep, -w, torch.inf)
    vs, order = torch.sort(vkey, dim=1, stable=True)
    kept = torch.isfinite(vs[:, :S])
    order = order[:, :S]
    sc = torch.where(kept, torch.gather(key, 1, order), n)
    sw = torch.where(kept, torch.gather(w, 1, order), 0.0)
    sc, order = torch.sort(sc, dim=1, stable=True)
    sw = torch.gather(sw, 1, order)
    ksum = sw.sum(dim=1, keepdim=True)
    sw = torch.where(sc < n, sw / torch.clamp(ksum, min=1e-30), 0.0)
    return sc.to(INDEX_DTYPE), sw.to(QVALUE_DTYPE), truncated


def _hub_dense_products(a_dense, cols, vals, n: int, precision: str = "f32", *, krows, khp: int):
    """C_hub = A_hub_dense · dense(iterate) (shared by the single-chip and
    sharded steps).

    ``a_dense`` is [H, khp] over the union of iterate rows the hub rows
    reference, ``krows`` (int64 on the iterate's device, -1 padded) those
    rows, the only ones densified.  The dense slab stays under 512 MB
    (the reference's budget); each slab is one ``torch.matmul`` in true
    f32 (``config.true_f32``).

    ``precision="bf16"``: the iterate is densified in bf16 and A rounded
    to bf16; the product of two bf16 values is exact in f32 and the sums
    are f32, the arithmetic of a bf16 matmul with f32 accumulation."""
    safe = krows.clamp(0, n - 1)
    ok = (krows >= 0)[:, None]
    cols = torch.where(ok, cols[safe], n)
    vals = torch.where(ok, vals[safe], 0.0)
    dt = torch.bfloat16 if precision == "bf16" else QVALUE_DTYPE
    slab = n
    while khp * slab * dt.itemsize > _HUB_SLAB_BYTES and slab > 1024:
        slab = -(-slab // 2)
    a_op = a_dense.to(dt).to(QVALUE_DTYPE)
    parts = []
    for s0 in range(0, n, slab):
        md = ell_rows_to_dense(cols, vals, n, s0, slab, dt)
        with true_f32():
            parts.append(torch.matmul(a_op, md.to(QVALUE_DTYPE)))
    out = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return out[:, :n]


def _dedup_tile(tc, tv, n: int, run: int = 0):
    """Sort + duplicate-sum + compact one [R, W] product tile (the ESC
    core shared by the single-chip and sharded steps).

    ``run > 0``: the tile rows are concatenations of ``run``-wide sorted
    segments, so where the reference's test for its Pallas kernel holds
    (W >= 128, W a multiple of ``run``, ``run`` a power of two; here also
    W a power of two up to K1's limit) the odd segments are reversed and
    K1 runs from presorted runs (on a CPU tensor the same call reaches
    K1's twin).  Other widths take K1's twin directly: its run sums are
    exact per run, where the reference's cumsum difference is not."""
    w = tc.shape[1]
    if (
        run
        and 128 <= w <= MAX_SORT_W
        and w % run == 0
        and _is_pow2(run)
        and _is_pow2(w)
    ):
        nseg = w // run
        if nseg > 1:
            # reverse odd segments: the bitonic alternating-run invariant
            tc3 = tc.view(-1, nseg, run)
            tv3 = tv.view(-1, nseg, run)
            tc3[:, 1::2] = tc3[:, 1::2].flip(-1)
            tv3[:, 1::2] = tv3[:, 1::2].flip(-1)
        return sort_dedup_compact(tc, tv, n, presorted=run)
    return sort_dedup_compact_plain(tc, tv, n)


def _ell_drift_sq(old_c, old_v, new_c, new_v, n: int):
    """(||new − old||_F², ||old||_F²) on merged sorted ELL rows (the
    CSR::differs role; shared by both steps)."""
    mc = torch.cat([old_c, new_c], dim=1)
    mv = torch.cat([-old_v, new_v], dim=1)
    key2, runs = _dedup_tile(mc, mv, n, run=old_c.shape[1])
    runs = torch.where(key2 < n, runs, 0.0)
    return (runs * runs).sum(), (old_v * old_v).sum()


def _tile(a: CSR, mt_cols, mt_vals, src, n: int, width: int):
    """The [R, width] product tile of the A entries ``src`` (-1: a
    padding entry): entry e's S lanes are the iterate's row ``col_e``
    scaled by its value, a padding entry's the sentinel (n, 0.0)."""
    ok = (src >= 0)[:, None]
    e = src.clamp(min=0)
    col = a.col_ind[e].long().clamp(0, n - 1)
    tc = torch.where(ok, mt_cols[col], n).reshape(-1, width)
    tv = torch.where(ok, mt_vals[col] * a.values[e][:, None], 0.0).reshape(-1, width)
    return tc, tv


def _hub_rows(c_h, rows, n: int, S: int, out_c, out_v, counts):
    """Prune/select the dense hub product rows ``c_h`` (lanes with a
    nonzero value are a row's entries) into rows ``rows`` of ``out_c`` /
    ``out_v`` and ``counts`` (shared by both steps).  A padding row (-1)
    lands on the output's last row, a caller's dump, and counts nothing."""
    lanes = torch.arange(c_h.shape[1], device=c_h.device, dtype=INDEX_DTYPE)
    key = torch.where(c_h != 0, lanes[None, :], n)
    sc, sw, truncated = _prune_select_lanes(key, c_h, n, S)
    ok = rows >= 0
    tgt = torch.where(ok, rows, out_c.shape[0] - 1).long()
    out_c[tgt] = sc
    out_v[tgt] = sw
    counts[0] += (ok[:, None] & (sc < n)).sum()
    counts[1] += (ok & truncated).sum()


def _no_span(name: str):
    return _NULL


def _reduce_bins(bins, gather, n: int, S: int, out_c, out_v, counts, span):
    """The degree bins ``(D, rows, src)`` of a step (shared by both
    steps), in chunks of rows whose tile pair stays under
    ``_TILE_BYTES``: the tile ``gather(src of the chunk, D · S)`` is
    sorted, summed and compacted, then pruned, selected and renormalised
    into ``rows`` of ``out_c`` / ``out_v`` and ``counts`` (K11 where the
    width fits its shared memory).  Every row is reduced on its own, so
    the chunks give one whole-bin tile's bits.  ``span`` records
    ``rmcl_ell.step.gather``, ``.tile`` and ``.select`` once a chunk."""
    for D, rid, src in bins:
        W = D * S
        step = max(_TILE_BYTES // (8 * W), 1)
        for r0 in range(0, rid.shape[0], step):
            r1 = min(r0 + step, rid.shape[0])
            with span("rmcl_ell.step.gather"):
                tc, tv = gather(src[r0 * D:r1 * D], W)
            with span("rmcl_ell.step.tile"):
                key2, uval = _dedup_tile(tc, tv, n, run=S)
            del tc, tv
            with span("rmcl_ell.step.select"):
                if W <= MAX_SELECT_W:
                    prune_select(key2, uval, n, S, rid[r0:r1], out_c, out_v, counts)
                else:
                    sc, sw, truncated = _prune_select_lanes(key2, uval, n, S)
                    out_c[rid[r0:r1]] = sc
                    out_v[rid[r0:r1]] = sw
                    counts[0] += (sc < n).sum()
                    counts[1] += truncated.sum()
            del key2, uval


def rmcl_ell_step(plan: RmclEllPlan, a: CSR, a_dense_huge, mt_cols, mt_vals):
    """One fused iteration on the ELL iterate.  ``a_dense_huge`` is the
    dense block of Mgt's hub rows over the hub union ([H, hub_kh], from
    :func:`_dense_huge`).  The degree bins go through
    :func:`_reduce_bins` (static shapes: the plan's bins fix them).
    Returns (new cols, new vals, stats)."""
    n, S = plan.n, plan.S
    dev = mt_cols.device
    pt = _plan_tensors(plan, dev)
    # a step being captured runs no device work: it records no span
    span = _no_span if dev.type == "cuda" and torch.cuda.is_current_stream_capturing() \
        else TRACE.span
    with span("rmcl_ell.step"):
        new_cols = torch.full((n, S), n, dtype=INDEX_DTYPE, device=dev)
        new_vals = torch.zeros((n, S), dtype=QVALUE_DTYPE, device=dev)
        counts = torch.zeros(2, dtype=torch.int64, device=dev)  # survivors, truncated rows
        _reduce_bins(pt["bins"], lambda src, w: _tile(a, mt_cols, mt_vals, src, n, w),
                     n, S, new_cols, new_vals, counts, span)

        if plan.huge_rows.size:
            # hub rows: dense matmul against the densified iterate,
            # restricted to the union of iterate rows the hub references
            with span("rmcl_ell.step.hub"):
                c_h = _hub_dense_products(
                    a_dense_huge, mt_cols, mt_vals, n, plan.hub_precision,
                    krows=pt["hub_krows"], khp=plan.hub_kh,
                )
                _hub_rows(c_h, pt["huge_rows"], n, S, new_cols, new_vals, counts)

        # convergence drift ||new - old||_F / ||old||_F on merged ELL rows
        with span("rmcl_ell.step.drift"):
            d2, n2 = _ell_drift_sq(mt_cols, mt_vals, new_cols, new_vals, n)
            differs = torch.sqrt(d2) / torch.clamp(torch.sqrt(n2), min=1e-30)
    stats = {
        "nnz": counts[0].to(INDEX_DTYPE),
        "truncated_rows": counts[1].to(INDEX_DTYPE),
        "differs": differs,
    }
    return new_cols, new_vals, stats


def _dense_huge(mgt: CSR, plan: RmclEllPlan):
    """Dense Mgt hub-row block over the union contraction space
    ([H, hub_kh]; columns remapped through hub_kmap)."""
    dev = mgt.device
    if not plan.huge_rows.size:
        return torch.zeros((0, max(plan.hub_kh, 1)), dtype=QVALUE_DTYPE, device=dev)
    h = plan.huge_rows.size
    rows_rep = torch.from_numpy(
        np.repeat(np.arange(h, dtype=np.int64), plan.huge_lens)).to(dev)
    src = torch.from_numpy(plan.huge_src.astype(np.int64)).to(dev)
    kmap = torch.from_numpy(plan.hub_kmap.astype(np.int64)).to(dev)
    kcol = kmap[mgt.col_ind[src].long().clamp(0, plan.n - 1)]
    return entries_to_dense(rows_rep, kcol.clamp(0, plan.hub_kh - 1), mgt.values[src],
                            h, plan.hub_kh)


_HIST = (("nnz", INDEX_DTYPE), ("truncated_rows", INDEX_DTYPE), ("differs", QVALUE_DTYPE))


def _scan_graph(plan: RmclEllPlan, a: CSR, a_dense_huge, mt_cols, mt_vals, length: int):
    """The plan's captured step (the reference's jitted ``lax.scan``
    body) for these inputs, loaded: static copies of Mgt and its hub
    block, the iterate as the carry (``graphs.scan_body``)."""
    ref = weakref.ref(plan)  # a strong one would keep the plan and its pool alive
    ncols = a.ncols

    def step(rp, ci, v, adh, cols, vals):
        nc, nv, stats = rmcl_ell_step(ref(), CSR(rp, ci, v, ncols), adh, cols, vals)
        return (nc, nv), stats

    ins = (a.row_ptr, a.col_ind, a.values, a_dense_huge, mt_cols, mt_vals)
    return graphs.scan_body(plan, "rmcl_ell_scan", ncols, ins, 2, _HIST, length, step)


def plan_lanes(plan: RmclEllPlan) -> int:
    """The tile lanes of one step, Σ R_b · D · S over the degree bins."""
    return sum(int(rid.size) * D * plan.S for D, rid, _ in plan.bins)


def plan_select_rows(plan: RmclEllPlan) -> int:
    """The tile rows one step sends to K11, Σ R_b over the degree bins
    whose width D · S it takes."""
    return sum(int(rid.size) for D, rid, _ in plan.bins if D * plan.S <= MAX_SELECT_W)


def rmcl_ell_scan(plan, a: CSR, a_dense_huge, mt_cols, mt_vals, max_iters: int):
    """Device-resident loop over the fused step (the reference's jitted
    ``lax.scan``): the iterate stays on the device, and the statistics
    stay tensors, one [max_iters] history each.

    On the card the step is a CUDA graph kept on the plan, under
    ``utils/graphs.captures``: a call whose iterations, with those
    already run eagerly on the plan, reach the step's break-even count
    runs iteration 1 eagerly, captures the step and replays it
    ``max_iters - 1`` times; a shorter one stays eager; a later call
    with inputs of the same shapes replays every iteration.  On the CPU
    the same body runs eagerly.  Returns fresh tensors."""
    if max_iters <= 0:
        return mt_cols, mt_vals, {k: torch.zeros(0) for k, _ in _HIST}
    _plan_tensors(plan, mt_cols.device)  # uploads, never inside a capture
    if TRACE.on():  # from the plan, on the host: replays count too
        lanes, rows = plan_lanes(plan), plan_select_rows(plan)
        for _ in range(max_iters):
            TRACE.count("rmcl_ell.lanes", lanes)
            TRACE.count("rmcl_ell.select_rows", rows)
            TRACE.count("rmcl_ell.hub_rows", int(plan.huge_rows.size))
    g = _scan_graph(plan, a, a_dense_huge, mt_cols, mt_vals, max_iters)
    (cols, vals), hist = graphs.run_scan(g, max_iters)
    return cols, vals, hist


def rmcl_ell(
    graph,
    max_iters: int = 5,
    S: int = 128,
    max_tile: int = 8192,
    hub_precision: str = "f32",
):
    """End-to-end static fused R-MCL.

    ``graph``: COO (raw; initialised via rmcl_init) or CSR (taken as the
    initialised Mgt).  Runs on the graph's device.  Returns (final CSR,
    stats history dict of numpy arrays)."""
    from .rmcl import rmcl_init

    with TRACE.span("rmcl_ell"):
        with TRACE.span("rmcl_ell.init"):
            mt0 = rmcl_init(graph) if isinstance(graph, COO) else graph
            # the presorted dedup needs column-sorted rows; normalise once
            mt0 = mt0.make_ordered()
        with TRACE.span("rmcl_ell.plan"):
            plan = plan_rmcl_ell(mt0, S=S, max_tile=max_tile, hub_precision=hub_precision)
        with TRACE.span("rmcl_ell.load"):
            cols, vals = mt_to_ell(mt0, S)
            a_d = _dense_huge(mt0, plan)
            _plan_tensors(plan, mt0.device)
        with TRACE.span("rmcl_ell.scan"):
            cols, vals, hist = rmcl_ell_scan(plan, mt0, a_d, cols, vals, max_iters)
        with TRACE.span("rmcl_ell.read"):
            out = ell_to_csr(cols, vals, mt0.ncols)
            hist = {k: TRACE.host_read("rmcl_ell.history", v).numpy() for k, v in hist.items()}
    return out, hist
