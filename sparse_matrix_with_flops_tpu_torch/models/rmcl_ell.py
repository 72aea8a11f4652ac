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
  renormalisation are lane-axis ops on those tiles;
* hub rows (degree beyond the largest tile) take a dense f32 matmul of
  Mgt's hub block against the densified iterate rows they reference.

``rmcl_ell_scan`` keeps the iterate on the device for the whole run and
the per-iteration statistics as tensors until the end; on the card its
step is a CUDA graph kept on the plan, captured once the iterations run
on it reach the step's break-even count, and replayed
(``utils/graphs.py``).
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE, true_f32
from ..formats.coo import COO
from ..formats.csr import CSR
from ..ops.prune import compute_threshold
from ..ops.sort_kernels import (
    MAX_SORT_W,
    _is_pow2,
    sort_dedup_compact,
    sort_dedup_compact_plain,
)
from ..utils import graphs
from ..utils.nphost import csr_host, repeat_idx

# the hub matmul's dense iterate slab is kept under this many bytes
# (the reference's 512 MB budget, models/rmcl_ell.py:240-242)
_HUB_SLAB_BYTES = 1 << 29


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
    rp, ci = csr_host(mgt)
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
            ent_src = np.full((sel.size, d), -1, dtype=np.int64)
            for k in range(d):
                has = deg[sel] > k
                ent_src[has, k] = rp[sel[has]] + k
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
        up = lambda x: torch.from_numpy(np.asarray(x, np.int64)).to(device)  # noqa: E731
        cache[key] = {
            "bins": [(d, up(rid), up(src)) for d, rid, src in plan.bins],
            "huge_rows": up(plan.huge_rows),
            "hub_krows": None if plan.hub_krows is None else up(plan.hub_krows),
        }
    return cache[key]


def mt_to_ell(mt: CSR, S: int):
    """Initial iterate: duplicate-sum + first-S truncation + renormalise
    (host).  Establishes the ELL invariant every step keeps: each row's
    columns sorted and unique.  Returns (cols int32, vals f32) [n, S] on
    ``mt``'s device."""
    rp, c_all = csr_host(mt)
    n = mt.rows
    nnz = int(rp[-1])
    c = c_all[:nnz].astype(np.int64)
    v = mt.values[:nnz].cpu().numpy().astype(np.float64)
    # global (row, col) sort -> per-row unique prefix sums, all bulk ops
    erow = repeat_idx(np.diff(rp), nnz).astype(np.int64)
    order = np.argsort(erow * (mt.ncols + 1) + c, kind="stable")
    re, ce, ve = erow[order], c[order], v[order]
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
    cols = np.full((n, S), mt.ncols, np.int32)
    vals = np.zeros((n, S), np.float32)
    cols[ur[keep], rank[keep]] = uc[keep].astype(np.int32)
    vals[ur[keep], rank[keep]] = uv[keep].astype(np.float32)
    s = vals.sum(axis=1, keepdims=True)
    vals = np.where(s > 0, vals / np.maximum(s, 1e-30), vals)
    return (
        torch.from_numpy(cols).to(mt.device),
        torch.from_numpy(np.ascontiguousarray(vals, np.float32)).to(mt.device),
    )


def ell_to_csr(cols, vals, ncols: int) -> CSR:
    """Iterate back to CSR (host side, end of run), on the iterate's
    device."""
    device = cols.device if isinstance(cols, torch.Tensor) else "cpu"
    cols_np = cols.cpu().numpy() if isinstance(cols, torch.Tensor) else np.asarray(cols)
    vals_np = vals.cpu().numpy() if isinstance(vals, torch.Tensor) else np.asarray(vals)
    n = cols_np.shape[0]
    keep = cols_np < ncols
    rp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=rp[1:])
    return CSR.from_numpy(rp.astype(np.int32), cols_np[keep], vals_np[keep], ncols, device)


def _prune_select_lanes(key, uval, n: int, S: int):
    """Fused inflate/threshold/prune + top-S selection + renormalise on a
    compacted [R, W] tile (util.cc:4-69 semantics + MCL selection).

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


def _hub_dense_products(
    a_dense, cols, vals, n: int, precision: str = "f32", krows=None, khp: int = 0,
):
    """C_hub = A_hub_dense · dense(iterate) (shared by the single-chip and
    sharded steps).

    With ``krows/khp``, ``a_dense`` is [H, khp] over the union of iterate
    rows the hub rows reference, and only those rows are densified.  The
    dense slab stays under 512 MB (the reference's budget); each slab is
    one ``torch.matmul`` in true f32 (``config.true_f32``).

    ``precision="bf16"``: the iterate is densified in bf16 and A rounded
    to bf16; the product of two bf16 values is exact in f32 and the sums
    are f32, the arithmetic of a bf16 matmul with f32 accumulation."""
    S = cols.shape[1]
    dev = cols.device
    if krows is not None:
        kr = krows if isinstance(krows, torch.Tensor) else torch.from_numpy(
            np.asarray(krows, np.int64)).to(dev)
        kr = kr.long()
        safe = kr.clamp(0, n - 1)
        ok = (kr >= 0)[:, None]
        cols = torch.where(ok, cols[safe], n)
        vals = torch.where(ok, vals[safe], 0.0)
        rows = khp
    else:
        rows = n
    dt = torch.bfloat16 if precision == "bf16" else QVALUE_DTYPE
    isz = 2 if precision == "bf16" else 4
    slab = n
    while rows * slab * isz > _HUB_SLAB_BYTES and slab > 1024:
        slab = -(-slab // 2)
    a_op = a_dense.to(dt).to(QVALUE_DTYPE)
    rix = torch.arange(rows, device=dev)[:, None]
    lane_s = torch.arange(S, device=dev)[None, :]
    vd = vals.to(dt)
    parts = []
    for s0 in range(0, n, slab):
        loc = cols.long() - s0
        # out-of-slab and sentinel lanes land on distinct dummy columns
        tgt = torch.where((loc >= 0) & (loc < slab), loc, slab + lane_s)
        md = torch.zeros((rows, slab + S), dtype=dt, device=dev)
        md[rix, tgt] = vd
        with true_f32():
            parts.append(torch.matmul(a_op, md[:, :slab].to(QVALUE_DTYPE)))
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


def _segments(a: CSR, mt_cols, mt_vals, n: int):
    """Per-entry segments (one row gather of the iterate, scaled by the
    entry's value) plus a sentinel segment at the end."""
    S = mt_cols.shape[1]
    safe_col = a.col_ind.long().clamp(0, n - 1)
    ev = a.entry_valid()[:, None]
    seg_c = torch.where(ev, mt_cols[safe_col], n)
    seg_v = torch.where(ev, mt_vals[safe_col] * a.values[:, None], 0.0)
    seg_c = torch.cat([seg_c, seg_c.new_full((1, S), n)])
    seg_v = torch.cat([seg_v, seg_v.new_zeros((1, S))])
    return seg_c, seg_v


def _hub_rows(c_h, n: int, S: int):
    """Prune/select the dense hub product rows: lanes with a nonzero
    value are the row's entries."""
    lanes = torch.arange(c_h.shape[1], device=c_h.device, dtype=INDEX_DTYPE)
    key = torch.where(c_h != 0, lanes[None, :], n)
    return _prune_select_lanes(key, c_h, n, S)


def rmcl_ell_step(plan: RmclEllPlan, a: CSR, a_dense_huge, mt_cols, mt_vals):
    """One fused iteration on the ELL iterate.  ``a_dense_huge`` is the
    dense block of Mgt's hub rows over the hub union ([H, hub_kh], from
    :func:`_dense_huge`).  Returns (new cols, new vals, stats)."""
    n, S = plan.n, plan.S
    dev = mt_cols.device
    pt = _plan_tensors(plan, dev)
    seg_c, seg_v = _segments(a, mt_cols, mt_vals, n)
    sent = seg_c.shape[0] - 1

    new_cols = torch.full((n, S), n, dtype=INDEX_DTYPE, device=dev)
    new_vals = torch.zeros((n, S), dtype=QVALUE_DTYPE, device=dev)
    nnz_out = torch.zeros((), dtype=torch.int64, device=dev)
    trunc_rows = torch.zeros((), dtype=torch.int64, device=dev)
    for D, rid, src in pt["bins"]:
        src = torch.where(src >= 0, src, sent)
        W = D * S
        tc = seg_c[src].reshape(-1, W)
        tv = seg_v[src].reshape(-1, W)
        key2, uval = _dedup_tile(tc, tv, n, run=S)
        sc, sw, truncated = _prune_select_lanes(key2, uval, n, S)
        new_cols[rid] = sc
        new_vals[rid] = sw
        nnz_out += (sc < n).sum()
        trunc_rows += truncated.sum()

    if plan.huge_rows.size:
        # hub rows: dense matmul against the densified iterate, restricted
        # to the union of iterate rows the hub references
        c_h = _hub_dense_products(
            a_dense_huge, mt_cols, mt_vals, n, plan.hub_precision,
            krows=pt["hub_krows"], khp=plan.hub_kh,
        )
        sc, sw, truncated = _hub_rows(c_h, n, S)
        new_cols[pt["huge_rows"]] = sc
        new_vals[pt["huge_rows"]] = sw
        nnz_out += (sc < n).sum()
        trunc_rows += truncated.sum()

    # convergence drift ||new - old||_F / ||old||_F on merged ELL rows
    d2, n2 = _ell_drift_sq(mt_cols, mt_vals, new_cols, new_vals, n)
    differs = torch.sqrt(d2) / torch.clamp(torch.sqrt(n2), min=1e-30)
    stats = {
        "nnz": nnz_out.to(INDEX_DTYPE),
        "truncated_rows": trunc_rows.to(INDEX_DTYPE),
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
    a_d = torch.zeros(h * plan.hub_kh, dtype=QVALUE_DTYPE, device=dev)
    a_d.index_add_(0, rows_rep * plan.hub_kh + kcol.clamp(0, plan.hub_kh - 1),
                   mgt.values[src])
    return a_d.view(h, plan.hub_kh)


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

    mt0 = rmcl_init(graph) if isinstance(graph, COO) else graph
    # the presorted dedup needs column-sorted rows; normalise once
    mt0 = mt0.make_ordered()
    plan = plan_rmcl_ell(mt0, S=S, max_tile=max_tile, hub_precision=hub_precision)
    cols, vals = mt_to_ell(mt0, S)
    a_d = _dense_huge(mt0, plan)
    cols, vals, hist = rmcl_ell_scan(plan, mt0, a_d, cols, vals, max_iters)
    out = ell_to_csr(cols, vals, mt0.ncols)
    return out, {k: v.cpu().numpy() for k, v in hist.items()}
