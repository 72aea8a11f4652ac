"""ELL-ESC SpGEMM, device side (port of the JAX package's
``ops/ell_esc.py``, ``_tiles_impl`` .. ``spgemm_ell_symbolic``).

The host planner (``ops/ell_plan.py``) lays every output row out as a
row tile of ``W`` lanes built from ``chunk``-wide slices of B rows.  On
the device:

1. **B-ELL classes**: B rows (or hub-split pieces of them) padded to
   their class width, viewed as ``[chunks, chunk]``;
2. **row tiles**: per width bin, one gather of each row's chunks, scaled
   by the owning A value; odd chunks are lane-reversed so the tile is a
   run of alternating sorted chunks;
3. **sort / dedup / compact** per bin: kernel K1 up to ``MAX_SORT_W``
   lanes (the reference's ``PALLAS_MAX_SORT_W``, 32768), the plain sort
   above, chosen by width as the reference chooses its XLA branch;
4. **hub** for rows too wide for any bin, by group: a group whose
   products fill less than ``HUB_SPARSE_BELOW`` of its dense volume
   sums each (row, column slab) in a shared-memory accumulator and
   compacts it into the flat stream (kernel K10); a denser one is
   densified per column slab, multiplied in f32 and compacted (K2);
5. **assembly**: counts -> row_ptr; 128-lane windows of the flat tile
   stream are gathered at each window's source position (kernel K3),
   the first slots of every row are repaired from an exact head gather,
   and the slots to take from the repair are found with one long int32
   scan (kernel K4).

Plan index arrays are uploaded once per (plan, device) and memoised on
the plan, and so is the CUDA graph of the warm call (``spgemm_ell``).
Counts are scattered into buffers one slot longer than the rows, whose
last slot takes what the reference dropped out of range.
"""

from __future__ import annotations

import warnings
import weakref

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE, true_f32
from ..formats.csr import CSR
from ..utils import graphs
from ..utils.nphost import repeat_idx
from ..utils.timing import TRACE
from .densify import entries_to_dense
from .ell_plan import EllPlan, _flat_layout, plan_ell
from .hub_kernels import MAX_TILES as HUB_MAX_TILES
from .hub_kernels import META as HUB_META
from .hub_kernels import TILE as HUB_TILE
from .hub_kernels import hub_accumulate
from .scan_kernels import cumsum_i32
from .segments import DUMP_SLOTS, dump_region, exclusive_cumsum, last_marked
from .sort_kernels import (
    MAX_SORT_W,
    compact_nonzero_rows,
    sort_dedup_compact,
    sort_dedup_compact_plain,
    window_gather,
)

_WA = 128  # assembly window width
_HUB_ROW_CHUNK = 1024  # hub rows densified per matmul
# a hub group whose products fill less than this share of its dense
# volume (hg * khp * ncols) takes K10, the sparse accumulator; a denser
# one the dense matmul.  Where the two routes' tile phases cross on an
# H100 (700 W): Graph500 s12 at edge factors 16 to 1024 (power-law
# groups, short B segments), K10 / matmul 0.62 at a fill of 5.9e-4, 0.73
# at 4.1e-3, 0.92 at 1.6e-2, 1.09 at 2.9e-2, crossing near 2.1e-2;
# uniform random 4096 x 4096 squares, 0.13 at 6.1e-5, 0.62 at 1.6e-2,
# 0.85 at 3.1e-2, 1.40 at 6.3e-2, crossing near 3.9e-2.  The lower holds.
HUB_SPARSE_BELOW = 2e-2


def _upload(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x)).to(device)


def _long(x: np.ndarray, device) -> torch.Tensor:
    return _upload(np.asarray(x, dtype=np.int64), device)


def _hub_sparse(g, ncols: int) -> bool:
    """Whether hub group ``g`` takes K10: its products fill less than
    ``HUB_SPARSE_BELOW`` of its dense volume (``hg * khp * ncols``
    multiply-adds of the matmul)."""
    return g._products < HUB_SPARSE_BELOW * g.rows.size * g.khp * ncols


def _virtual_starts(plan: EllPlan) -> np.ndarray:
    return (
        plan.vstart
        if plan.vstart is not None
        else np.arange(plan.rows + 1, dtype=np.int32)
    )


def _dense_hub_group(plan: EllPlan, gi: int, device) -> dict:
    """Hub group ``gi``'s index arrays for the dense route: A's row
    chunks, and per slab B's scatter positions and, per row chunk, the
    virtual rows, the windows of each compacted row that its flat cap
    keeps and where they go in the hub's part of the flat stream."""
    g = plan.hub_groups[gi]
    vst = _virtual_starts(plan)
    lay = _flat_layout(plan)
    hg = g.rows.size
    hlens = np.diff(g.srp)
    chunks = []
    for h0 in range(0, hg, _HUB_ROW_CHUNK):
        h1 = min(h0 + _HUB_ROW_CHUNK, hg)
        e0, e1 = int(g.srp[h0]), int(g.srp[h1])
        chunks.append(
            (
                h0,
                h1 - h0,
                _long(g.src[e0:e1], device),
                _long(repeat_idx(hlens[h0:h1]), device),
            )
        )
    slabs = []
    nw_row = g.slab // _WA
    for sl in range(g.n_slabs):
        e0, e1 = int(g.sptr[sl]), int(g.sptr[sl + 1])
        per_chunk = []
        for h0, hc, _, _ in chunks:
            ids = vst[g.rows[h0 : h0 + hc]].astype(np.int64) + sl
            # pack each compacted row to its (row, slab) flat cap:
            # the first cap // 128 windows of the row
            caps = g.caps_rs[h0 : h0 + hc, sl].astype(np.int64)
            swin = np.concatenate(
                [np.zeros(0, np.int64)]
                + [
                    np.arange(cw // _WA, dtype=np.int64) + i * nw_row
                    for i, cw in enumerate(caps)
                ]
            )
            off = int(lay["flat_base"][ids[0]] - lay["huge_start"])
            per_chunk.append((_long(ids, device), _long(swin, device), off))
        slabs.append(
            (_long(g.lin[e0:e1], device), _long(g.eorder[e0:e1], device),
             per_chunk)
        )
    return {"gi": gi, "kmap": _long(g.kmap, device), "chunks": chunks, "slabs": slabs}


def _sparse_hub_groups(plan: EllPlan, gis: list, device) -> dict | None:
    """K10's arrays for hub groups ``gis`` (``ops/hub_kernels``): the
    items, region-ordered (group, slab, row); the hub entries' A entry ids
    and the offsets of their groups' kmaps; each group's kmap into its
    segment table; the tables (one a (slab, tile), over the union rows)
    concatenated with one final offset; B's tile-local columns and entry
    ids in table order."""
    if not gis:
        return None
    vst = _virtual_starts(plan)
    lay = _flat_layout(plan)
    metas, kmaps, srcs, kofs, boffs, bcols, eorders = [], [], [], [], [], [], []
    ebase = kbase = bbase = tile_max = warps = 0
    for gl, gi in enumerate(gis):
        g = plan.hub_groups[gi]
        kh = int(np.count_nonzero(g.kmap >= 0))
        tile = max(min(g.slab, HUB_TILE), g.slab // HUB_MAX_TILES)
        ntile = g.slab // tile  # tiles a slab: a warp each
        lin = g.lin.astype(np.int64)
        u, lc = lin // g.slab, lin % g.slab
        sl = repeat_idx(np.diff(g.sptr), lin.size).astype(np.int64)
        # a slab's entries keep union-row order: with one tile a slab the
        # table keys are sorted already
        key = (sl * ntile + lc // tile) * kh + u
        order = np.argsort(key, kind="stable") if ntile > 1 else slice(None)
        cnt = np.bincount(key, minlength=g.n_slabs * ntile * kh)
        boffs.append(bbase + np.cumsum(cnt) - cnt)
        bcols.append((lc % tile)[order].astype(np.int16))
        eorders.append(g.eorder[order])
        kmaps.append(np.where(g.kmap >= 0, kbase + g.kmap, 0).astype(np.int32))
        srcs.append(g.src)
        kofs.append(np.full(g.src.size, gl * g.kmap.size, np.int64))
        s = np.arange(g.n_slabs, dtype=np.int64)[:, None]
        vrow = vst[g.rows].astype(np.int64)[None, :] + s
        fields = (
            ebase + g.srp[:-1][None, :], ebase + g.srp[1:][None, :],
            s * ntile * kh, kh, tile, lay["flat_base"][vrow] - lay["huge_start"],
            g.caps_rs.T, s * g.slab, np.minimum(g.slab, plan.ncols - s * g.slab), vrow,
        )
        metas.append(np.stack(np.broadcast_arrays(*fields), -1).reshape(-1, HUB_META))
        ebase += g.src.size
        kbase += g.n_slabs * ntile * kh
        bbase += key.size
        tile_max = max(tile_max, tile)
        warps = max(warps, ntile)
    return {
        "meta": _long(np.concatenate(metas), device),
        "src": _long(np.concatenate(srcs), device),
        "kofs": _long(np.concatenate(kofs), device),
        "kmap": _upload(np.concatenate(kmaps), device),
        "boff": _long(np.concatenate(boffs + [np.array([bbase])]), device),
        "bcol": _upload(np.concatenate(bcols), device),
        "eorder": _long(np.concatenate(eorders), device),
        "tile": tile_max,
        "warps": warps,
    }


def _plan_tensors(plan: EllPlan, device: torch.device) -> dict:
    """The plan's index arrays on ``device``, uploaded once and memoised
    on the plan (keyed by device)."""
    cache = getattr(plan, "_dev_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(plan, "_dev_cache", cache)
    key = str(device)
    if key in cache:
        return cache[key]
    nv = plan.v_rows
    b_classes = []
    for cls in plan.b_classes:
        if len(cls) == 2:
            b_classes.append((cls[0], _long(cls[1], device), None))
        else:
            b_classes.append(
                (cls[0], _long(cls[1], device), _long(cls[2], device))
            )
    bins = []
    for w, row_ids, tile_src, tile_ent in plan.bins:
        rid = np.where(row_ids >= 0, row_ids, nv)
        bins.append(
            (
                int(w),
                _long(rid, device),
                _long(tile_src, device),
                _long(tile_ent, device),
            )
        )
    sparse = [gi for gi, g in enumerate(plan.hub_groups) if _hub_sparse(g, plan.ncols)]
    dense = [gi for gi in range(len(plan.hub_groups)) if gi not in sparse]
    lay = _flat_layout(plan)
    out = {
        "b_classes": b_classes,
        "bins": bins,
        "hub": {
            "lanes": int(lay["flat_total"] - lay["huge_start"]),
            "sparse": _sparse_hub_groups(plan, sparse, device),
            "dense": [_dense_hub_group(plan, gi, device) for gi in dense],
            # the (row, slab) rows of each route, for the tracer's counters
            "rows": tuple(
                sum(plan.hub_groups[gi].caps_rs.size for gi in gis)
                for gis in (sparse, dense)
            ),
        },
        "flat_base": _upload(lay["flat_base"].astype(np.int32), device),
        "vstart": (
            _long(plan.vstart, device) if plan.vstart is not None else None
        ),
    }
    cache[key] = out
    return out


# ---------------------------------------------------------------------------
# phase 1: tiles
# ---------------------------------------------------------------------------
def _b_ell_chunks(b: CSR, plan: EllPlan, dev: dict):
    """The B-ELL class arrays in chunk view: ``[total_chunks, chunk]``
    cols and values, each class followed by one all-sentinel row."""
    chunk, ncols, device = plan.chunk, plan.ncols, b.device
    cs, vs = [], []
    for s, x, cnts in dev["b_classes"]:
        if cnts is None:  # whole B rows
            ok = x >= 0
            safe = x.clamp(0, b.rows - 1)
            start = b.row_ptr[safe].long()
            cnt = torch.where(ok, b.row_ptr[safe + 1].long() - start, 0)
        else:  # hub-split pieces: explicit (start, count) sub-ranges
            start, cnt = x, cnts
        lanes = torch.arange(s, device=device)
        valid = lanes[None, :] < cnt[:, None]
        idx = (start[:, None] + lanes[None, :]).clamp(0, b.capacity - 1)
        ec = torch.where(valid, b.col_ind[idx], ncols)
        ev = torch.where(valid, b.values[idx], 0.0)
        cs += [ec.reshape(-1, chunk), torch.full((s // chunk, chunk), ncols,
                                                 dtype=INDEX_DTYPE, device=device)]
        vs += [ev.reshape(-1, chunk), torch.zeros((s // chunk, chunk),
                                                  dtype=QVALUE_DTYPE, device=device)]
    if not cs:
        cs = [torch.full((1, chunk), ncols, dtype=INDEX_DTYPE, device=device)]
        vs = [torch.zeros((1, chunk), dtype=QVALUE_DTYPE, device=device)]
    return torch.cat(cs), torch.cat(vs)


def _bin_tiles(a: CSR, prod_c, prod_v, tile_src, tile_ent, w: int, chunk: int):
    """One bin's ``[R, W]`` product tiles: gathered chunks scaled by their
    A value, odd chunks lane-reversed (the presorted-run invariant K1's
    bitonic network starts from)."""
    aval = a.values[tile_ent][:, None]
    tc = prod_c[tile_src].reshape(-1, w)
    tv = (prod_v[tile_src] * aval).reshape(-1, w)
    nch = w // chunk
    if nch > 1:
        tc3 = tc.view(-1, nch, chunk)
        tv3 = tv.view(-1, nch, chunk)
        tc3[:, 1::2] = tc3[:, 1::2].flip(-1)
        tv3[:, 1::2] = tv3[:, 1::2].flip(-1)
    return tc, tv


def _hub_products(a: CSR, b: CSR, plan: EllPlan, groups: list):
    """Dense hub: per group of ``groups`` (``_dense_hub_group``), column
    slab and row chunk, yield ``(group, slab, its index arrays of the
    chunk, valid width, part)`` with ``part = A_dense @ B_slab`` in true
    f32.  Each B slab is built, used by every row chunk, then dropped."""
    k_rows = b.rows
    for gd in groups:
        g = plan.hub_groups[gd["gi"]]
        a_ds = []
        for _, hc, src, rows_rep in gd["chunks"]:
            kcol = gd["kmap"][a.col_ind[src].long().clamp(0, k_rows - 1)]
            kcol = kcol.clamp(0, g.khp - 1)
            a_ds.append(entries_to_dense(rows_rep, kcol, a.values[src], hc, g.khp))
        for sl, (lin, eorder, per_chunk) in enumerate(gd["slabs"]):
            bd = torch.zeros(g.khp * g.slab, dtype=QVALUE_DTYPE, device=b.device)
            bd[lin] = b.values[eorder]
            bd = bd.view(g.khp, g.slab)
            vw = int(min(g.slab, plan.ncols - sl * g.slab))
            for a_d, where in zip(a_ds, per_chunk):
                with true_f32():
                    part = a_d @ bd
                yield g, sl, where, vw, part


def _hub_sparse_products(a: CSR, b: CSR, sp: dict, hc, hv, counts) -> None:
    """Sparse hub (K10): every item of the K10 groups written into its
    region of ``hc`` / ``hv`` and its count into ``counts``.  The hub
    entries' table rows and A values, and B's values in table order, are
    gathered here, since the values change from call to call."""
    cols = a.col_ind[sp["src"]].long().clamp(0, b.rows - 1)
    krow = sp["kmap"][sp["kofs"] + cols]
    hub_accumulate(
        sp["meta"], krow, a.values[sp["src"]], sp["boff"], sp["bcol"],
        b.values[sp["eorder"]], hc, hv, counts, b.ncols, sp["tile"], sp["warps"],
    )


def _tiles_impl(a: CSR, b: CSR, plan: EllPlan, fused_out_cap: int | None = None):
    """Phase 1: B-ELL build, row tiles, sort/dedup/compact, hub.

    Returns ``(flat cols, flat vals, counts [v_rows], flat_base)``; with
    ``fused_out_cap`` the assembly runs at once with that capacity and
    ``(csr, nnz(C) tensor)`` is returned."""
    ncols, chunk, nv = plan.ncols, plan.chunk, plan.v_rows
    dev = _plan_tensors(plan, a.device)
    lay = _flat_layout(plan)
    total = int(lay["flat_total"])
    prod_c, prod_v = _b_ell_chunks(b, plan, dev)
    counts = torch.zeros(nv + 1, dtype=INDEX_DTYPE, device=a.device)
    # the flat stream is built in place in the assembly's window source
    # (``_window_source``'s buffers: cols, value bits, padded past the
    # stream), each part at its layout offset
    src = _stream_buffers(total, ncols, a.device)
    fc, fv = src[0], src[1].view(QVALUE_DTYPE)
    for (w, rid, tile_src, tile_ent), start in zip(dev["bins"], lay["bin_starts"]):
        tc, tv = _bin_tiles(a, prod_c, prod_v, tile_src, tile_ent, w, chunk)
        if w <= MAX_SORT_W:
            key, val = sort_dedup_compact(tc, tv, ncols, presorted=chunk)
        else:  # the reference's XLA branch (ell_esc.py:1247-1273)
            key, val = sort_dedup_compact_plain(tc, tv, ncols)
        counts[rid] = (key < ncols).sum(1, dtype=INDEX_DTYPE)
        fc[start : start + key.numel()] = key.reshape(-1)
        fv[start : start + val.numel()] = val.reshape(-1)
    # the hub's part of the flat stream: each (row, slab) region filled
    # by its group's route.  Both drop products that cancel to exactly
    # 0.0 (the tile path keeps them): the dense route cannot represent an
    # explicit zero, and K10 follows it
    hub = dev["hub"]
    if hub["lanes"]:
        hc, hv = fc[lay["huge_start"] : total], fv[lay["huge_start"] : total]
        if hub["sparse"] is not None:
            _hub_sparse_products(a, b, hub["sparse"], hc, hv, counts)
        for g, sl, (ids, swin, off), vw, part in _hub_products(a, b, plan, hub["dense"]):
            key, val = compact_nonzero_rows(part, vw)
            counts[ids] = (key < vw).sum(1, dtype=INDEX_DTYPE)
            keyg = torch.where(key < vw, key + sl * g.slab, ncols)
            n = swin.shape[0] * _WA
            torch.index_select(keyg.view(-1, _WA), 0, swin, out=hc[off : off + n].view(-1, _WA))
            torch.index_select(val.view(-1, _WA), 0, swin, out=hv[off : off + n].view(-1, _WA))
    counts = counts[:nv]
    flat_c, flat_v = fc[: max(total, 1)], fv[: max(total, 1)]
    flat_base = dev["flat_base"]
    if fused_out_cap is not None:
        csr = _assemble_body(
            flat_c, flat_v, counts, flat_base, ncols, fused_out_cap,
            vstart=dev["vstart"], src=src,
        )
        return csr, counts.sum()
    return flat_c, flat_v, counts, flat_base


# ---------------------------------------------------------------------------
# phase 2: assembly
# ---------------------------------------------------------------------------
def _roll_right(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-row lane roll of ``x`` [Q, L] right by ``t`` [Q]."""
    w = x.shape[1]
    idx = (torch.arange(w, device=x.device)[None, :] - t[:, None].long()) % w
    return torch.gather(x, 1, idx)


def _stream_buffers(total: int, ncols: int, device):
    """Empty window-source buffers for a flat stream of ``total`` lanes
    (an empty stream counts as one lane ``(0, 0.0)``, as the reference's
    does), the padding past it already written: int32 cols (pad
    ``ncols``) and value bits (pad 0), whole windows plus two."""
    t = max(total, 1)
    tpad = -(-t // _WA) * _WA + 2 * _WA
    fc = torch.empty(tpad, dtype=INDEX_DTYPE, device=device)
    fvb = torch.empty(tpad, dtype=torch.int32, device=device)
    fc[total:] = ncols
    fvb[total:] = 0
    if total == 0:
        fc[0] = 0
    return fc, fvb


def _window_source(flat_c, flat_v, ncols: int):
    """The flat stream padded to whole windows plus two: int32 cols
    (pad ``ncols``) and value bits (pad 0)."""
    t = flat_c.shape[0]
    fc, fvb = _stream_buffers(t, ncols, flat_c.device)
    fc[:t] = flat_c
    fvb[:t] = flat_v.contiguous().view(torch.int32)
    return fc, fvb


def _window_positions(counts, flat_base, starts, nwin: int):
    """Source position of every output window: ``k * W + d[r(k)]``, with
    ``r(k)`` the last nonempty row starting at or before window k (a row
    marks window ceil(start / W); ``starts`` is an exclusive cumsum, so
    the marks are non-decreasing: ``last_marked``) and ``d`` its
    flat-to-CSR offset."""
    nonempty = counts > 0
    d = torch.where(nonempty, flat_base - starts, 0)
    rwin = last_marked((starts + _WA - 1) // _WA, nonempty, nwin).clamp(min=0).long()
    k = torch.arange(nwin, dtype=torch.int64, device=counts.device)
    return (k * _WA + d[rwin].long()).to(INDEX_DTYPE)


def _row_start_deltas(counts, starts, ocap: int):
    """``dds`` [ocap]: at each nonempty row's start, its start minus the
    previous nonempty row's start, so that the inclusive scan of ``dds``
    is the start of the row covering each slot."""
    m = counts.shape[0]
    nonempty = counts > 0
    ds = torch.where(nonempty, starts, 0)
    # forward fill of the last nonempty row's start (0 before the first):
    # row i marks itself
    rid = torch.arange(m, dtype=INDEX_DTYPE, device=counts.device)
    last = last_marked(rid, nonempty, m)
    filled = torch.where(last >= 0, ds[last.clamp(min=0)], 0)
    prevs = torch.cat([filled.new_zeros(1), filled[:-1]])
    # nonempty rows start apart; the empty ones write to the dump region
    dds = torch.zeros(ocap + DUMP_SLOTS, dtype=INDEX_DTYPE, device=counts.device)
    tgt = torch.where(nonempty & (starts < ocap), starts.long(), dump_region(rid, ocap))
    dds.scatter_(0, tgt, torch.where(nonempty, ds - prevs, 0).to(INDEX_DTYPE))
    return dds[:ocap]


def _assemble_body(
    flat_c, flat_v, counts, flat_base, ncols: int, out_cap: int, vstart=None, src=None
) -> CSR:
    """counts -> row_ptr; 128-lane window gathers build the flat CSR.

    Each output window k copies the 128 flat lanes at its source
    position (K3).  A window that crosses a row boundary is right only
    up to it, so the first <= 127 slots of every row are repaired: the
    row's exact head is gathered from its ``flat_base`` (K3, in the same
    launch as the windows), rolled
    right by ``start % 128`` and added into the one or two windows it
    lands in, under disjoint masks.  A slot takes the repair iff it lies
    within 128 of its row's start, which one long scan gives (K4).
    ``src``: the stream's window source (``_window_source``), where the
    caller built the stream in it."""
    w = _WA
    m = counts.shape[0]
    device = counts.device
    out_rp = exclusive_cumsum(counts)
    ocap = -(-out_cap // w) * w
    nwin = ocap // w
    total = out_rp[-1]
    nonempty = counts > 0
    starts = out_rp[:-1]

    fc, fvb = _window_source(flat_c, flat_v, ncols) if src is None else src
    wc, wvb, fix_c, fix_vb = window_gather(
        fc, fvb, _window_positions(counts, flat_base, starts, nwin), w,
        torch.where(nonempty, flat_base, 0).to(INDEX_DTYPE),
    )
    lane = torch.arange(w, dtype=INDEX_DTYPE, device=device)[None, :]
    okf = nonempty[:, None] & (lane < counts[:, None])
    t = torch.where(nonempty, starts % w, 0)
    q0 = starts // w
    rc = _roll_right(fix_c, t)
    rvb = _roll_right(fix_vb, t)
    rm = _roll_right(okf.to(INDEX_DTYPE), t) > 0
    m_a = rm & (lane >= t[:, None])  # head part in window q0
    m_b = rm & (lane < t[:, None])  # spill into window q0 + 1
    tgt_a = torch.where(nonempty, q0, nwin).clamp(max=nwin).long()
    tgt_b = torch.where(nonempty & (t > 0), q0 + 1, nwin).clamp(max=nwin).long()
    acc = torch.zeros((nwin + 1, 2 * w), dtype=torch.int32, device=device)
    for tgt, msk in ((tgt_a, m_a), (tgt_b, m_b)):
        src = torch.cat([torch.where(msk, rc, 0), torch.where(msk, rvb, 0)], 1)
        acc.index_add_(0, tgt, src)
    acc = acc[:nwin]

    start_q = cumsum_i32(_row_start_deltas(counts, starts, ocap))
    q = torch.arange(ocap, dtype=INDEX_DTYPE, device=device)
    fixed = ((q - start_q) < w).view(nwin, w)
    ccol = torch.where(fixed, acc[:, :w], wc).reshape(-1)
    cval = torch.where(
        fixed, acc[:, w:].view(torch.float32), wvb.view(torch.float32)
    ).reshape(-1)
    qvalid = q < total
    ccol = torch.where(qvalid, ccol, ncols).to(INDEX_DTYPE)
    cval = torch.where(qvalid, cval, 0.0).to(QVALUE_DTYPE)
    if vstart is not None:
        # split-hub plans count VIRTUAL rows (consecutive per parent):
        # the parent row_ptr is the virtual one at each first sub-row
        out_rp = out_rp[vstart]
    return CSR(torch.clamp(out_rp, max=ocap), ccol, cval, ncols)


def _nnz_bucket(nnzc: int) -> int:
    """Output capacity for ``nnzc`` entries: geometric 1.25x buckets of
    1024, so nearby sizes share a capacity."""
    cap = 1024
    while cap < nnzc:
        cap = int(cap * 1.25 + 1023) & ~1023
    return cap


def _flat_assemble(
    flat_c, flat_v, counts, flat_base, ncols: int, out_cap: int | None,
    exact: bool, vstart=None,
) -> CSR:
    """Shared flat-CSR export (also used by ``formats.tiled.TiledCSR``)."""
    if out_cap is None:
        if exact:
            out_cap = _nnz_bucket(int(TRACE.host_read("assemble.nnz", counts.sum())))
        else:
            out_cap = int(counts.shape[0]) * ncols
    return _assemble_body(
        flat_c, flat_v, counts, flat_base, ncols, int(out_cap), vstart
    )


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def spgemm_ell_tiled(a: CSR, b: CSR, plan: EllPlan | None = None):
    """C = A·B in ``TiledCSR`` form (no assembly)."""
    from ..formats.tiled import TiledCSR

    if plan is None:
        # TiledCSR's (counts, flat_base) are per parent row, so the tiled
        # form needs an unsplit plan
        plan = plan_ell(a, b, split_hub=False)
    if plan.vstart is not None:
        raise ValueError(
            "spgemm_ell_tiled needs an unsplit plan; build it with "
            "plan_ell(a, b, split_hub=False)"
        )
    flat_c, flat_v, counts, flat_base = _tiles_impl(a, b, plan)
    return TiledCSR(flat_c, flat_v, counts, flat_base, plan.ncols)


def _warm_graph(a: CSR, b: CSR, plan: EllPlan, cap: int):
    """The plan's captured warm body (the reference's jitted
    ``_tiles_impl(fused_out_cap=cap)``) for these operands, loaded: its
    outputs are C's arrays and nnz(C) (``graphs.bound``)."""
    ins = (a.row_ptr, a.col_ind, a.values, b.row_ptr, b.col_ind, b.values)
    ref = weakref.ref(plan)  # a strong one would keep the plan and its pool alive

    def build(st):
        sa, sb = CSR(*st[:3], a.ncols), CSR(*st[3:], b.ncols)

        def body():
            c, nnzc = _tiles_impl(sa, sb, ref(), fused_out_cap=cap)
            return c.row_ptr, c.col_ind, c.values, nnzc

        return graphs.CapturedBody("spgemm_ell", body, st)

    return graphs.bound(plan, "spgemm_ell", (cap, a.ncols, b.ncols), ins, build)


def spgemm_ell(
    a: CSR,
    b: CSR,
    plan: EllPlan | None = None,
    out_cap: int | None = None,
    exact: bool = True,
) -> CSR:
    """C = A·B via the ELL-ESC pipeline (ordered, duplicate-summed).

    ``exact=True`` reads nnz(C) back after the tile phase and sizes the
    output to its bucket, which is cached on the plan: a later call runs
    both phases back to back with that capacity and then checks nnz(C)
    against it (the hub drops exact-zero products, so counts can
    change with the values).  On the card that warm body is a CUDA graph
    kept on the plan: captured by the warm call that reaches its
    break-even count of warm calls on operands of those shapes
    (``utils/graphs.captures``; its own eager run first), replayed by
    every later one.  An overflowed capacity truncated the
    output, which is discarded with a warning; the graph is dropped with
    the bucket, and the call falls back to the two-phase path.
    ``exact=False`` uses the plan's bound."""
    with TRACE.span("ell"):
        if plan is None:
            plan = plan_ell(a, b)
        dev = _plan_tensors(plan, a.device)
        vstart = dev["vstart"]
        TRACE.count("ell.hub.sparse", dev["hub"]["rows"][0])
        TRACE.count("ell.hub.dense", dev["hub"]["rows"][1])
        cached = getattr(plan, "_nnzc_cache", None)
        if out_cap is None and exact and cached is not None:
            with TRACE.span("ell.load"):
                warm = _warm_graph(a, b, plan, cached)
            with TRACE.span("ell.replay"):
                row_ptr, col_ind, values, nnzc = warm.run()
            nnzc = int(TRACE.host_read("ell.nnzc", nnzc))  # the one read
            if nnzc <= cached:
                return CSR(row_ptr, col_ind, values, plan.ncols)
            warnings.warn(
                "spgemm_ell: fused nnz(C) bucket overflowed "
                f"(nnzc={nnzc} > cap={cached}); the fused output was "
                "truncated and is discarded. Re-deriving two-phase.",
                RuntimeWarning,
                stacklevel=2,
            )
            graphs.drop(plan, "spgemm_ell")
            object.__setattr__(plan, "_nnzc_cache", None)
        with TRACE.span("ell.tiles"):
            flat_c, flat_v, counts, flat_base = _tiles_impl(a, b, plan)
        if out_cap is None and not exact:
            out_cap = plan.out_cap
        if out_cap is None and exact:
            out_cap = _nnz_bucket(int(TRACE.host_read("ell.nnz", counts.sum())))
            object.__setattr__(plan, "_nnzc_cache", out_cap)
        with TRACE.span("ell.assemble"):
            return _flat_assemble(
                flat_c, flat_v, counts, flat_base, plan.ncols, out_cap, exact,
                vstart=vstart,
            )


def spgemm_ell_symbolic(a: CSR, b: CSR, plan: EllPlan | None = None):
    """Exact ``(row_ptr, nnz(C))`` of C = A·B without assembly."""
    if plan is None:
        plan = plan_ell(a, b)
    _, _, counts, _ = _tiles_impl(a, b, plan)
    row_ptr = exclusive_cumsum(counts)
    vstart = _plan_tensors(plan, a.device)["vstart"]
    if vstart is not None:
        row_ptr = row_ptr[vstart]
    return row_ptr, row_ptr[-1]
