"""Host planner of the ELL-ESC SpGEMM pipeline (pure numpy).

The port of the planning half of the JAX package's ``ops/ell_esc.py``
(``auto_chunk`` .. ``plan_ell`` and ``_flat_layout``), copied so that the
same matrices give the same :class:`EllPlan`.  The cost constants in
``_auto_chunk_full`` and ``_plan_hub_groups`` were measured on a TPU and
are kept unchanged so the plans match; retuning them for the H100 is
separate work.  Differences from the reference:

* the planner's environment knobs are gone: ``split_hub`` is a plain
  parameter (default True) and the hub slab budget is a constant;
* ``_auto_chunk_full`` clips B-row lengths to the table it indexes, so a
  B whose longest row A never references no longer raises IndexError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as _scipy_sparse

from ..formats.csr import CSR
from ..utils.nphost import (
    concat_ranges,
    csr_host,
    fast_repeat,
    pow2ceil_arr,
    repeat_idx,
    segment_sums,
    snap_chunks_arr,
)


def _pow2ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


# Largest row tile; wider rows take the dense hub (or the column-slab
# split).  The reference measured the hub winning past ~8K lanes on its
# chip; the same default keeps the plans equal.
MAX_W = 8192
AUTO_CHUNKS = (16, 32, 64, 128)  # auto-select candidate lattice


def auto_chunk(
    elen: np.ndarray,
    rp: np.ndarray,
    ncols: int,
    max_w: int,
    candidates: tuple = AUTO_CHUNKS,
) -> int:
    """Pick the tile chunk width from B's row-length distribution
    (see :func:`_auto_chunk_full` for the cost model)."""
    return _auto_chunk_full(elen, rp, ncols, max_w, candidates)[0]


def _auto_chunk_full(
    elen: np.ndarray,
    rp: np.ndarray,
    ncols: int,
    max_w: int,
    candidates: tuple = AUTO_CHUNKS,
    bcounts: np.ndarray | None = None,
    acol: np.ndarray | None = None,
):
    """Pick the tile chunk width from B's row-length distribution.

    Returns ``(chunk, epw, prow, rf)`` — the winner's per-entry padded
    widths, per-row padded widths, and raw per-row flops, so plan_ell
    reuses them instead of recomputing (the tables are already evaluated
    here for every candidate).

    With ``bcounts``/``acol`` supplied, the per-row padded widths of ALL
    candidates come from ONE scipy CSR·dense matmat (prow_c = A_pattern ·
    pw_c where pw_c[k] = tbl_c[nnz(B[k,:])] — the per-B-row width table),
    a single C pass instead of per-candidate nnz-scale numpy chains; the
    raw flops column rides along.  Without them, the table-gather +
    cumsum formulation is used (same results).

    The cost model is the reference's, with constants measured on a TPU
    (kept so the plans match): tile gathers cost one descriptor per
    chunk, so kernel time ~ padded tile volume / chunk.  Rows whose
    padded width exceeds ``max_w`` take the dense hub, whose per-row
    cost is ~4 compaction/matmul passes over the full round128(ncols)
    dense row — charged as 4*ncp/128 descriptor equivalents.
    Minimising this total over the candidate lattice is the
    data-adaptive classifier role of the C++ original
    (mindex2-cuda/flops.cu:131-140, nGpuSpMM.cc:48-83); without it,
    banded 65-entry-row matrices (cant.mtx class) would all go to the
    hub at chunk=64.

    Ties within 2% prefer the larger chunk (fewer descriptors per byte
    moved and a shallower bitonic start).
    """
    ncp = -(-int(ncols) // 128) * 128
    hub_desc = 4.0 * ncp / 128.0  # densify/compact traffic per hub row
    # hub matmul term: the dense path contracts [hub, kh] x [kh, ncp]
    # (kh = union of B rows the hub touches), so per-row cost also
    # carries 2*kh*ncp flops; 1 descriptor ~ 180k matmul flops on the
    # TPU the constants come from.  Without this term banded matrices
    # score all-hub as "cheap" and the dense hub runs out of memory.
    mxu_flops_per_desc = 180_000.0
    best_c, best_j = candidates[0], float("inf")
    scores = {}
    # per-entry padded widths via value tables over the (small) set of
    # possible B-row lengths, evaluated for ALL candidates in one 2-D
    # gather + one 2-D cumsum
    maxlen = int(elen.max()) if elen.size else 0
    lens = np.arange(maxlen + 1, dtype=np.int64)
    elen32 = elen.astype(np.int32, copy=False)
    tbls = np.stack(
        [snap_chunks_arr(-(-lens // c)) * c for c in candidates]
    ).astype(np.int32)
    tbls[:, 0] = 0
    epw_all = None
    rf = None
    if bcounts is not None and acol is not None and elen.size:
        _sp = _scipy_sparse
        # per-B-row width tables for all candidates + the raw-length
        # column (rf rides along): one CSR·dense matmat — exact in f64
        # for volumes < 2^53
        pw = np.empty((bcounts.shape[0], len(candidates) + 1), np.float64)
        for i in range(len(candidates)):
            # B rows longer than any row A references index past the
            # table; their pattern column is all zeros, so any width does
            pw[:, i] = tbls[i][np.minimum(bcounts, maxlen)]
        pw[:, -1] = bcounts
        pat = _sp.csr_matrix(
            (
                np.ones(elen.shape[0], np.float64),
                acol,
                np.asarray(rp, dtype=np.int64),
            ),
            shape=(len(rp) - 1, bcounts.shape[0]),
        )
        pr = pat @ pw  # (m, n_cand + 1)
        prow_all = pr[:, :-1].T.astype(np.int64)
        rf = pr[:, -1].astype(np.int64)
    else:
        # table gather + row-segment cumsum (int32 scan when the
        # worst-case padded volume provably fits)
        epw_all = tbls[:, elen32]  # (n_cand, nnz)
        vol_bound = (
            int(elen.shape[0]) * int(tbls.max()) if elen.size else 0
        )
        cdt = np.int32 if vol_bound < 2**31 else np.int64
        cs_all = np.empty(
            (len(candidates), epw_all.shape[1] + 1), dtype=cdt
        )
        cs_all[:, 0] = 0
        np.cumsum(epw_all, axis=1, dtype=cdt, out=cs_all[:, 1:])
        rp64 = np.asarray(rp, dtype=np.int64)
        prow_all = cs_all[:, rp64[1:]] - cs_all[:, rp64[:-1]]
    for i, c in enumerate(candidates):
        prow = prow_all[i]
        wr_p2 = pow2ceil_arr(np.maximum(prow, c))
        nonempty = prow > 0
        hub = nonempty & (wr_p2 > max_w)
        binned = nonempty & ~hub
        wb = wr_p2[binned]
        # descriptor term (gather) + bitonic lane-op term: the presorted
        # bitonic runs merge levels log2(2c)+1 .. log2(W), level k costs
        # ~k passes over W lanes, so lane-ops ~ W*(L^2 - L0^2)/2 with
        # L = log2(W), L0 = log2(2c).  The relative weight (1 lane-op ~
        # descriptor/585) was calibrated on a TPU from two cant-class
        # points (benchmarks/results_r3.jsonl, results_r4.jsonl).
        lw = np.log2(np.maximum(wb, 1)).astype(np.float64)
        l0 = float(np.log2(2 * c))
        lane_ops = wb * np.maximum(lw * lw - l0 * l0, 0.0) / 2.0
        kh_est = min(float(ncols), float(prow[hub].sum()))
        hub_row_cost = hub_desc + 2.0 * kh_est * ncp / mxu_flops_per_desc
        # B-ELL build term: every B row pads to a multiple of c, and the
        # windowed build moves ~2 descriptors + 2c lanes per chunk
        if bcounts is not None:
            bvol = float(tbls[i][np.minimum(bcounts, maxlen)].sum())
        else:
            bvol = 0.0
        j = (
            float(wb.sum()) / c
            + float(lane_ops.sum()) / 585.0
            + hub_row_cost * int(hub.sum())
            + bvol / c  # chunk descriptors of the B-ELL class build
            + bvol / 4.0  # window roll-select
        )
        scores[c] = j
        if j < best_j:
            best_c, best_j = c, j
    for c in sorted(candidates, reverse=True):
        if scores[c] <= best_j * 1.02:
            best_c = c
            break
    i = candidates.index(best_c)
    epw = epw_all[i] if epw_all is not None else tbls[i][elen32]
    return best_c, epw, prow_all[i], rf


@dataclasses.dataclass(frozen=True, eq=False)
class EllPlan:
    """Static per-structure plan (identity-hashed jit static arg)."""

    # B re-layout: one ELL array per segment-width class.  Two entry
    # forms: ``(S, b_row_ids)`` reads whole B rows; ``(S, starts, cnts)``
    # reads explicit sub-ranges of B's entry stream (the hub-split piece
    # classes — column-slab slices of B rows, see plan_ell split_hub)
    b_classes: tuple
    # chunk base of each class segment region in the global chunk array
    class_chunk_base: tuple  # int per class
    total_chunks: int  # incl. 1 sentinel chunk at index total_chunks-1
    # row tiles: per width-class bin
    bins: tuple  # tuple[(W, np.int32[R_b] row_ids, np.int32[R_b*W/CHUNK] tile_src)]
    huge_rows: np.ndarray  # rows on the dense hub path (may be empty)
    huge_flops: int
    # assembly
    rows: int
    ncols: int
    out_cap: int
    row_bin: np.ndarray  # int32[v_rows]: bin id, -1 none, -2 hub
    row_slot: np.ndarray  # int32[v_rows]: slot in its bin
    chunk: int = 128  # row-gather granularity this plan was built with
    # dense-hub layout: per-group union-restricted column-slabbed
    # contractions with per-slab compaction (see HubGroup); each
    # (hub row, slab) is a virtual output row
    hub_groups: tuple = ()
    # hub splitting: rows too wide for the sort classes are
    # split by COLUMN SLAB into virtual sub-rows that ride the normal
    # bins — disjoint column ranges need no merge pass and nnz(C) stays
    # exact.  ``v_rows`` is the virtual row count (== rows when unsplit);
    # ``vstart[i]`` is parent row i's first virtual index (int32[rows+1],
    # None when unsplit) — the final row_ptr is the virtual row_ptr
    # gathered at vstart.
    v_rows: int = 0  # filled in __post_init__ when 0
    vstart: np.ndarray | None = None

    def __post_init__(self):
        if self.v_rows == 0:
            object.__setattr__(self, "v_rows", self.rows)

    __hash__ = object.__hash__


def _qpad8(n: int) -> int:
    """Quantised padding: next power of two, min 8 — keeps bin shapes in a
    small set so re-planning across R-MCL iterations hits the jit cache."""
    return max(8, _pow2ceil(n))


_SPLIT_S_CAP = 4096  # max column slabs per hub row before dense fallback
_SPLIT_GRID_CAP = 1 << 27  # max U*S piece-grid cells


def _plan_hub_split(
    huge, rp, safe, brp, bci, ncols, chunk, max_w, prow_huge
):
    """Column-slab splitting of hub rows.

    Rows whose padded product width exceeds ``max_w`` are split into
    per-column-slab virtual sub-rows that flow through the ORDINARY sort
    bins: each sub-row's products are the parent entries' B-segment
    slices falling in one column slab.  Because sub-rows own disjoint
    column ranges, their deduped outputs concatenate (slab-ascending)
    into the exact parent row — no merge pass, no dense hub, no new
    kernel widths: more sub-rows of the same proven shape.

    The slab count S doubles until every sub-row's padded width fits
    ``max_w`` (exact check on per-(row,slab) padded widths via one
    pattern-matmat); duplicates concentrated on one column bound the
    reachable width from below, so pathological skews past _SPLIT_S_CAP
    return None and the caller keeps the dense hub for those rows.

    Returns a dict with the piece-class tables, the per-virtual-row tile
    entry table, and the virtual-row layout, or None for fallback.
    """
    H = huge.size
    h_cnt = (rp[huge + 1] - rp[huge]).astype(np.int64)
    n_he = int(h_cnt.sum())
    h_ents = concat_ranges(rp[huge], rp[huge + 1], dtype=np.int64)
    h_parent = repeat_idx(h_cnt, n_he)  # local parent index
    h_brow = safe[h_ents]
    # cheap fragmentation pre-filter (before any S search): each entry
    # costs >= chunk lanes PER SLAB it touches, so an optimistic
    # (undercounting) split-volume estimate already over the 2x
    # inflation cap can never succeed — drop those rows to the dense
    # hub without paying the slab search
    len_e = (brp[h_brow + 1] - brp[h_brow]).astype(np.int64)
    # iterate: the slab count is GLOBAL (chosen for the worst surviving
    # row), so dropping the worst rows lowers it for the rest; repeat
    # until the survivor set is stable — a few bincounts, no S search
    # for doomed candidates
    alive = np.ones(H, np.bool_)
    while True:
        surv = alive[h_parent]
        if not alive.any():
            return None
        s_glob = int(
            pow2ceil_arr(
                np.maximum(-(-prow_huge[alive].max() // max_w), 1)
            )
        )
        est = np.bincount(
            h_parent[surv],
            weights=np.minimum(len_e[surv], s_glob) * float(chunk),
            minlength=H,
        )
        good0 = alive & (est <= 2.0 * np.maximum(prow_huge, 1))
        if bool((good0 == alive).all()):
            break
        alive = good0
    if not bool(alive.all()):
        return _plan_hub_split(
            huge[alive], rp, safe, brp, bci, ncols, chunk, max_w,
            prow_huge[alive],
        )
    u, h_bl = np.unique(h_brow, return_inverse=True)
    U = int(u.size)
    u_cnt = (brp[u + 1] - brp[u]).astype(np.int64)
    ub_n = int(u_cnt.sum())
    ub_e = concat_ranges(brp[u], brp[u + 1], dtype=np.int64)
    ub_local = repeat_idx(u_cnt, ub_n)
    ub_col = bci[ub_e].astype(np.int64)
    # A-pattern over the union with entry multiplicities: V = pat @ pw
    pat = _scipy_sparse.coo_matrix(
        (np.ones(n_he, np.float64), (h_parent, h_bl)), shape=(H, U)
    ).tocsr()
    S = max(2, _pow2ceil(-(-int(prow_huge.max()) // max_w)))
    galive = np.ones(H, np.bool_)
    while True:
        if U * S > _SPLIT_GRID_CAP:
            return None
        cw = -(-ncols // S)
        slab_of = ub_col // cw
        hist = np.bincount(
            (ub_local * np.int64(S) + slab_of), minlength=U * S
        )
        maxlen = int(hist.max()) if hist.size else 0
        lens = np.arange(maxlen + 1, dtype=np.int64)
        wtbl = snap_chunks_arr(-(-lens // chunk)) * chunk
        wtbl[0] = 0
        pw_grid = wtbl[hist]  # padded piece width per (u_local, slab)
        V = pat @ pw_grid.reshape(U, S).astype(np.float64)  # (H, S)
        # fragmentation guard INSIDE the search: every slab a short
        # entry touches costs a full chunk of padding, and the padded
        # volume only grows with S — drop rows over the 2x inflation cap
        # NOW so S stops escalating for doomed candidates
        galive &= V.sum(axis=1) <= 2.0 * np.maximum(prow_huge, 1)
        if not bool(galive.any()):
            return None
        vmax = int(V[galive].max()) if V.size else 0
        if vmax <= max_w:
            break
        if S >= _SPLIT_S_CAP:
            return None
        S *= 2
    if not bool(galive.all()):
        # rebuild tightly on the surviving subset (smaller union/pieces)
        return _plan_hub_split(
            huge[galive], rp, safe, brp, bci, ncols, chunk, max_w,
            prow_huge[galive],
        )
    # ---- piece enumeration (u-major, slab-minor = column order) -------
    nz = np.nonzero(hist)[0]
    plens = hist[nz]
    pw_nz = pw_grid[nz].astype(np.int64)
    hist2 = hist.reshape(U, S)
    excl = (np.cumsum(hist2, axis=1) - hist2).reshape(U * S)
    pstart_nz = (brp[u][(nz // S)] + excl[nz]).astype(np.int64)
    # ---- tile-entry expansion: (hub entry) x (its B row's pieces) ----
    u_nz_cnt = np.count_nonzero(hist2, axis=1).astype(np.int64)
    u_nz_ptr = np.zeros(U + 1, np.int64)
    np.cumsum(u_nz_cnt, out=u_nz_ptr[1:])
    te_per_ent = u_nz_cnt[h_bl]
    te_total = int(te_per_ent.sum())
    te_nzidx = concat_ranges(
        u_nz_ptr[h_bl], u_nz_ptr[h_bl] + te_per_ent, dtype=np.int64
    )
    te_ae = fast_repeat(h_ents, te_per_ent, te_total)
    te_parent = fast_repeat(h_parent, te_per_ent, te_total)
    te_slab = nz[te_nzidx] % S
    # virtual-row grouping: stable sort by (parent, slab) — slab order
    # within a parent IS column order, which makes the concatenated
    # sub-row outputs the exact parent row
    key = te_parent.astype(np.int64) * S + te_slab
    order = np.argsort(key, kind="stable")
    te_key = key[order]
    te_nzidx = te_nzidx[order]
    te_ae = te_ae[order]
    first = np.ones(te_key.size, np.bool_)
    first[1:] = te_key[1:] != te_key[:-1]
    vr_first = np.nonzero(first)[0]
    vr_keys = te_key[vr_first]
    vr_parent_local = (vr_keys // S).astype(np.int64)
    vr_slab = (vr_keys % S).astype(np.int64)
    vr_te_ptr = np.append(vr_first, te_key.size).astype(np.int64)
    vr_w = V[vr_parent_local, vr_slab].astype(np.int64)
    return {
        "S": int(S),
        "rows": huge,  # the rows actually split (inflation-filtered)
        "piece_lens": plens.astype(np.int32),
        "piece_widths": pw_nz,
        "piece_starts": pstart_nz,
        "te_nzidx": te_nzidx,  # index into the nz piece list
        "te_ae": te_ae.astype(np.int64),
        "vr_parent_local": vr_parent_local,
        "vr_te_ptr": vr_te_ptr,
        "vr_w": vr_w,
        "n_vr": int(vr_keys.size),
    }


@dataclasses.dataclass(frozen=True, eq=False)
class HubGroup:
    """One dense-hub row group: its own B-row union (contraction space)
    and column-slab layout.  Grouping hub rows shrinks each group's
    union, collapsing the dense contraction waste inside one plan.

    ``_products`` (set by the planner, not a field: the reference's
    groups have none) is the group's exact count of products, which the
    port's hub route (``ops/ell_esc._hub_route``) weighs against the
    group's dense volume."""

    rows: np.ndarray  # int32[hg] parent row ids, ascending
    src: np.ndarray  # int32[] A-entry ids of the rows, row-major
    srp: np.ndarray  # int64[hg+1] entry offsets per row
    kmap: np.ndarray  # int32[b.rows]: global -> union-local, -1
    khp: int  # padded union size (multiple of 128)
    slab: int  # column-slab width (power of two)
    n_slabs: int
    eorder: np.ndarray  # int32[] B entry ids, slab-major, union-restricted
    lin: np.ndarray  # int32[] khp*slab-local scatter positions
    sptr: np.ndarray  # int64[n_slabs+1] entry offsets per slab
    caps_rs: np.ndarray  # int32[hg, n_slabs] per-(row,slab) flat caps

    __hash__ = object.__hash__


_HUB_SLAB_MAX = 16384  # per-slab compaction width (production kernel)
_HUB_SLAB_BYTES = 1 << 29  # dense B slab budget (khp * slab * 4 bytes)


def _plan_hub_groups(hub_rows, rp, safe, brp, bci, N, K, rf):
    """Group hub rows (contiguous, equal-footprint) and lay out each
    group's union-restricted, column-slabbed dense contraction.

    Per-slab output compaction means every compaction runs at
    production widths (<= _HUB_SLAB_MAX) instead of round128(ncols),
    and each (row, slab) becomes a virtual output row with a tight flat
    cap from the exact per-slab product counts."""
    H = hub_rows.size
    hubflops = rf[hub_rows].astype(np.float64)
    ents_cnt = (rp[hub_rows + 1] - rp[hub_rows]).astype(np.int64)
    src_all = concat_ranges(rp[hub_rows], rp[hub_rows + 1], dtype=np.int64)
    e_parent = repeat_idx(ents_cnt, src_all.size)
    e_brow = safe[src_all].astype(np.int64)
    ncp = -(-int(N) // 128) * 128
    # G search on a union-occupancy bitmap over 64 equal-flops micro-
    # buckets: kh of any power-of-two grouping is an OR-reduction of
    # bucket rows — no per-candidate nnz-scale unique/sort
    MB = 1 << max(0, min(64, H).bit_length() - 1)  # pow2: G | MB
    cum = np.concatenate([[0.0], np.cumsum(hubflops)])
    btargets = cum[-1] * np.arange(1, MB) / MB
    bcuts = np.concatenate(
        [[0], np.searchsorted(cum, btargets), [H]]
    ).astype(np.int64)
    bcuts = np.maximum.accumulate(bcuts)
    mb_of_row = np.searchsorted(bcuts[1:], np.arange(H), side="right")
    occ = np.zeros((MB, K), np.bool_)
    occ[mb_of_row[e_parent], e_brow] = True
    # pick G by a combined cost whose coefficients were measured on a
    # TPU (kept so the plans match): device = matmul seconds + B-densify
    # scatter seconds (group overlap duplicates union entries as G
    # grows); host = group-build numpy per union entry and per group.
    # Warm callers reuse the plan across many multiplies, so the device
    # term is weighted 4x.
    blen = (brp[1:] - brp[:-1]).astype(np.float64)
    best_g, best_j, occ_best = 1, np.inf, None
    G = 1
    while G <= MB:
        occ_g = occ.reshape(G, MB // G, K).any(axis=1)
        kh_g = np.count_nonzero(occ_g, axis=1)
        hc_g = bcuts[:: MB // G][1:] - bcuts[:: MB // G][:-1]
        khp_g = np.maximum(128, -(-kh_g // 128) * 128)
        flops = float((2.0 * hc_g * khp_g).sum()) * ncp
        host_ents = float((occ_g @ blen).sum())
        dev_s = flops / 28e12 + host_ents * 2.5e-8
        host_s = host_ents * 1.56e-7 + G * 3e-3
        j = 4.0 * dev_s + host_s
        if j < best_j:
            best_g, best_j, occ_best = G, j, occ_g
        G *= 2
    G = best_g
    occ_g = occ_best
    cuts = bcuts[:: MB // G]
    budget = _HUB_SLAB_BYTES
    ents_off = np.zeros(H + 1, np.int64)
    np.cumsum(ents_cnt, out=ents_off[1:])
    groups = []
    for g in range(G):
        r0, r1 = int(cuts[g]), int(cuts[g + 1])
        if r1 <= r0:
            continue
        rows_g = hub_rows[r0:r1]
        hg = rows_g.size
        u_g = np.nonzero(occ_g[g])[0]  # sorted union B rows
        kh = int(u_g.size)
        khp = max(128, -(-kh // 128) * 128)
        kmap = np.full(K, -1, np.int32)
        kmap[u_g] = np.arange(kh, dtype=np.int32)
        # slab >= 128: the flat pack moves 128-lane windows, so caps and
        # slab widths must be 128-granular
        slab = max(128, min(_HUB_SLAB_MAX, _pow2ceil(N)))
        while khp * slab * 4 > budget and slab > 256:
            slab //= 2
        n_slabs = -(-N // slab)
        # B entries of the union rows directly (entry ranges of u_g) —
        # no nnz(B)-wide membership pass
        u_cnt = (brp[u_g + 1] - brp[u_g]).astype(np.int64)
        eo = concat_ranges(brp[u_g], brp[u_g + 1], dtype=np.int64)
        bcol_g = bci[eo].astype(np.int64)
        brow_local = repeat_idx(u_cnt, eo.size).astype(np.int64)
        sl_id = bcol_g // slab
        order = (
            np.argsort(sl_id, kind="stable")
            if n_slabs > 1
            else slice(None)
        )
        lin = brow_local[order] * slab + (
            bcol_g[order] - sl_id[order] * slab
        )
        sptr = (
            np.searchsorted(sl_id[order], np.arange(n_slabs + 1))
            if n_slabs > 1
            else np.asarray([0, eo.size])
        ).astype(np.int64)
        # exact per-(row, slab) product counts -> tight flat caps
        hist = np.bincount(
            brow_local * n_slabs + sl_id, minlength=kh * n_slabs
        ).reshape(kh, n_slabs)
        srp = np.zeros(hg + 1, np.int64)
        np.cumsum(ents_cnt[r0:r1], out=srp[1:])
        off0 = int(ents_off[r0])
        src_g = src_all[off0 : off0 + int(srp[-1])]
        pat = _scipy_sparse.coo_matrix(
            (
                np.ones(src_g.size, np.float64),
                (
                    repeat_idx(ents_cnt[r0:r1], src_g.size),
                    kmap[safe[src_g]],
                ),
            ),
            shape=(hg, kh),
        ).tocsr()
        flops_rs = pat @ hist.astype(np.float64)
        vw = np.minimum(slab, N - np.arange(n_slabs) * slab)
        caps = np.minimum(
            -(-flops_rs.astype(np.int64) // 128) * 128,
            -(-vw // 128) * 128,
        )
        caps = np.minimum(caps, slab).astype(np.int32)
        group = HubGroup(
            rows=rows_g.astype(np.int32),
            src=src_g.astype(np.int32),
            srp=srp,
            kmap=kmap,
            khp=int(khp),
            slab=int(slab),
            n_slabs=int(n_slabs),
            eorder=eo[order].astype(np.int32),
            lin=lin.astype(np.int32),
            sptr=sptr,
            caps_rs=caps,
        )
        object.__setattr__(group, "_products", int(flops_rs.sum()))
        groups.append(group)
    return tuple(groups)


def plan_ell(
    a: CSR,
    b: CSR,
    chunk: int | None = None,
    max_w: int = MAX_W,
    quantize: bool = False,
    split_hub: bool = True,
) -> EllPlan:
    """Host structure plan for the ELL-ESC pipeline.

    ``split_hub`` (default on) routes
    rows too wide for the sort classes through column-slab virtual
    sub-rows (:func:`_plan_hub_split`) instead of the dense hub —
    exact nnz(C) with no dense blow-up, at the cost of a slightly larger
    plan.  Falls back to the dense hub automatically when splitting is
    not applicable."""
    if quantize:
        # quantized plans promise jit-cache-stable bin shapes across
        # structurally-similar replans (the R-MCL loop); column-split
        # virtual rows are structure-dependent, so hub rows keep the
        # dense path there
        split_hub = False
    rp, acol_all = csr_host(a)
    nnz = int(rp[-1])
    acol = acol_all[:nnz]
    brp, _ = csr_host(b)
    bcounts = np.diff(brp)
    m = a.rows

    safe = np.clip(acol, 0, b.rows - 1)
    elen = bcounts[safe]
    rf = None
    if chunk is None:
        # data-adaptive chunk from B's row-length distribution (the
        # reference classifies per run, flops.cu:131-140); the winner's
        # per-entry/per-row padded widths + raw per-row flops are
        # reused below
        chunk, epw, prow_w, rf = _auto_chunk_full(
            elen, rp, b.ncols, max_w, bcounts=bcounts, acol=safe
        )
    else:
        # per-entry padded width (0 for empty segments — they emit
        # nothing): the B segment's class width, a {2^k, 3*2^k} multiple
        # of chunk — via a value table over possible B-row lengths (one
        # gather at nnz scale instead of nnz-scale snap arithmetic)
        _lens = np.arange(
            int(elen.max()) + 1 if elen.size else 1, dtype=np.int64
        )
        _wtbl = snap_chunks_arr(-(-_lens // chunk)) * chunk
        _wtbl[0] = 0
        epw = _wtbl[elen.astype(np.int32, copy=False)]
        prow_w = segment_sums(epw, rp)  # padded row width
    if rf is None:
        rf = segment_sums(elen, rp)

    # ---- row padded widths / hub classification -------------------------
    # (before the class layout: hub splitting adds piece classes to it)
    wr = np.where(prow_w > 0, np.maximum(chunk, prow_w), 0)
    wr_p2 = np.where(wr > 0, pow2ceil_arr(wr), 0)
    huge_all = np.nonzero(wr_p2 > max_w)[0].astype(np.int64)
    split = None
    split_rows = np.zeros(0, np.int64)
    if split_hub and huge_all.size:
        # column-slab splitting can never beat the per-entry chunk
        # padding floor (each nonempty entry costs >= chunk lanes in
        # every slab it touches), so it applies only to few-entries /
        # long-segment hub rows — the FEM/band class.  Power-law hub
        # rows (many short entries) keep the dense hub, now grouped
        # + per-slab-compacted below.
        n_act = segment_sums((elen > 0).astype(np.int64), rp)
        floor_ok = n_act[huge_all] * chunk <= max_w
        split_rows = huge_all[floor_ok]
        if split_rows.size:
            split = _plan_hub_split(
                split_rows, rp, safe, brp,
                csr_host(b)[1], b.ncols, chunk, max_w,
                prow_w[split_rows],
            )
            # the split may keep only a subset (fragmentation guard)
            split_rows = (
                split["rows"] if split is not None
                else np.zeros(0, np.int64)
            )
    huge = np.setdiff1d(huge_all, split_rows).astype(np.int32)
    hub_groups = ()
    if huge.size:
        hub_groups = _plan_hub_groups(
            huge.astype(np.int64), rp, safe, brp, csr_host(b)[1],
            b.ncols, b.rows, rf,
        )

    # ---- B classes ------------------------------------------------------
    bpw = np.where(
        bcounts > 0, snap_chunks_arr(-(-bcounts // chunk)) * chunk, 0
    )
    b_classes = []
    b_class_of_row = np.full(b.rows, -1, np.int32)
    b_slot_of_row = np.zeros(b.rows, np.int32)
    for s in np.unique(bpw[bpw > 0]):
        sel = np.nonzero(bpw == s)[0]
        b_class_of_row[sel] = len(b_classes)
        b_slot_of_row[sel] = np.arange(sel.size, dtype=np.int32)
        if quantize:
            pad = _qpad8(sel.size) - sel.size
            sel = np.concatenate([sel, np.full(pad, -1, sel.dtype)])
        b_classes.append((int(s), sel.astype(np.int32)))
    # hub-split piece classes: explicit (start, count) sub-ranges of B's
    # entry stream, grouped by padded width like whole rows
    if split is not None:
        pw_nz = split["piece_widths"]
        pclass_of_nz = np.zeros(pw_nz.size, np.int32)
        pslot_of_nz = np.zeros(pw_nz.size, np.int32)
        for s_w in np.unique(pw_nz):
            selp = np.nonzero(pw_nz == s_w)[0]
            pclass_of_nz[selp] = len(b_classes)
            pslot_of_nz[selp] = np.arange(selp.size, dtype=np.int32)
            starts = split["piece_starts"][selp].astype(np.int32)
            cnts = split["piece_lens"][selp].astype(np.int32)
            if quantize:
                pad = _qpad8(selp.size) - selp.size
                starts = np.concatenate([starts, np.zeros(pad, np.int32)])
                cnts = np.concatenate([cnts, np.zeros(pad, np.int32)])
            b_classes.append((int(s_w), starts, cnts))

    # ---- chunk layout over the B-ELL class arrays -----------------------
    # tile gathers read B-ELL chunks DIRECTLY (values scaled by the A value
    # per chunk afterwards) — no intermediate per-entry product copy.
    class_chunk_base = []
    chunk_base = 0
    for ci, cls in enumerate(b_classes):
        class_chunk_base.append(chunk_base)
        cpe = cls[0] // chunk
        # each class array carries its rows + 1 sentinel row
        chunk_base += (cls[1].shape[0] + 1) * cpe
    total_chunks = chunk_base
    # global pad chunk: the sentinel row of the first class (all-sentinel)
    if b_classes:
        S0, rows0 = b_classes[0][0], b_classes[0][1]
        sentinel_chunk = class_chunk_base[0] + rows0.shape[0] * (S0 // chunk)
    else:
        sentinel_chunk = 0
    if total_chunks >= 2**31:
        raise ValueError(
            f"B-ELL layout needs {total_chunks} chunks (>= 2^31); "
            "partition the multiply (ops/partitioned.py) instead"
        )
    # first B-ELL chunk of each A entry (vectorised over classes: the
    # class id indexes small per-class tables — no per-class nnz pass;
    # int32 throughout — chunk ids < total_chunks < 2^31, guarded above)
    cls0 = np.maximum(b_class_of_row[safe], 0)
    ccb_tab = np.zeros(max(len(b_classes), 1), dtype=np.int32)
    cpe_tab = np.zeros(max(len(b_classes), 1), dtype=np.int32)
    for ci, cls in enumerate(b_classes):
        ccb_tab[ci] = class_chunk_base[ci]
        cpe_tab[ci] = cls[0] // chunk
    # empty segments produce zero chunks, so their (junk) start values
    # are never read — no act-masking pass needed
    ent_chunk_start = ccb_tab[cls0] + b_slot_of_row[safe] * cpe_tab[cls0]

    # ---- virtual row space + tile-entry table ---------------------------
    # normal rows are their own virtual row; split hub rows expand into
    # per-slab virtual sub-rows IN PLACE (so virtual order == row-major
    # column order and the assembled flat stream is the exact CSR body)
    ecs32 = ent_chunk_start.astype(np.int32, copy=False)
    ne_all = (epw // chunk).astype(np.int32, copy=False)  # chunks/entry
    if split is not None or hub_groups:
        cnt_v = np.ones(m, np.int64)
        if split is not None:
            nvp = np.bincount(
                split["vr_parent_local"], minlength=split_rows.size
            ).astype(np.int64)
            cnt_v[split_rows] = nvp
        for g_ in hub_groups:
            cnt_v[g_.rows] = g_.n_slabs
        vstart = np.zeros(m + 1, np.int64)
        np.cumsum(cnt_v, out=vstart[1:])
        n_v = int(vstart[-1])
        vr_p2 = np.zeros(n_v, np.int64)
        normal_mask = np.ones(m, np.bool_)
        normal_mask[huge_all] = False
        nrm = np.nonzero(normal_mask)[0]
        vr_p2[vstart[nrm]] = wr_p2[nrm]
        te_start = np.zeros(n_v, np.int64)
        te_end = np.zeros(n_v, np.int64)
        te_start[vstart[nrm]] = rp[nrm]
        te_end[vstart[nrm]] = rp[nrm + 1]
        if split is not None:
            p_nc_nz = (split["piece_widths"] // chunk).astype(np.int32)
            ccb64 = np.asarray(class_chunk_base, np.int64)
            p_cs_nz = (
                ccb64[pclass_of_nz]
                + pslot_of_nz.astype(np.int64) * p_nc_nz
            ).astype(np.int32)
            offs = np.zeros(split_rows.size + 1, np.int64)
            np.cumsum(nvp, out=offs[1:])
            vrp = split["vr_parent_local"]
            vr_global = vstart[split_rows[vrp]] + (
                np.arange(split["n_vr"], dtype=np.int64) - offs[vrp]
            )
            vr_p2[vr_global] = pow2ceil_arr(
                np.maximum(split["vr_w"], chunk)
            )
            te_start[vr_global] = nnz + split["vr_te_ptr"][:-1]
            te_end[vr_global] = nnz + split["vr_te_ptr"][1:]
            te_cs = np.concatenate([ecs32, p_cs_nz[split["te_nzidx"]]])
            te_nc = np.concatenate([ne_all, p_nc_nz[split["te_nzidx"]]])
            te_ae = np.concatenate(
                [
                    np.arange(nnz, dtype=np.int32),
                    split["te_ae"].astype(np.int32),
                ]
            )
        else:
            te_cs, te_nc, te_ae = ecs32, ne_all, None
        vstart32 = vstart.astype(np.int32)
    else:
        n_v = m
        vstart32 = None
        vr_p2 = wr_p2
        te_start, te_end = rp[:-1], rp[1:]
        te_cs, te_nc, te_ae = ecs32, ne_all, None

    # ---- row tile bins (vectorised tile_src construction) ---------------
    bins = []
    row_bin = np.full(n_v, -1, np.int32)
    row_slot = np.zeros(n_v, np.int32)
    # all chunk-scale arithmetic in int32: chunk ids are bounded by the
    # B-ELL chunk count and tile positions by the padded tile volume,
    # both far below 2^31 for any single-chip-feasible plan (guarded)
    # single global pass over all binned rows (class-major order): the
    # expensive nnz-/chunk-scale constructions (range concat, repeat,
    # cumsum) run ONCE instead of once per width class, then each class
    # slices its contiguous region
    sels, widths_list = [], []
    w = chunk
    while w <= max_w:
        sel = np.nonzero(vr_p2 == w)[0]
        if sel.size:
            sels.append(sel)
            widths_list.append(int(w))
        w *= 2
    if sels:
        all_rows = np.concatenate(sels)
        e_all = concat_ranges(
            te_start[all_rows], te_end[all_rows], dtype=np.int32
        )
        ne = te_nc[e_all]
        cs = np.cumsum(ne, dtype=np.int64)
        tot_all = int(cs[-1]) if ne.size else 0
        if tot_all >= 2**31:
            raise ValueError(
                f"row tiles need {tot_all} chunks (>= 2^31); "
                "partition the multiply (ops/partitioned.py) instead"
            )
        rep = repeat_idx(ne, tot_all)  # chunk -> global entry index
        ne_excl = (cs - ne).astype(np.int32, copy=False)
        within = np.arange(tot_all, dtype=np.int32)
        within -= ne_excl[rep]
        src_all = te_cs[e_all][rep] + within
        ent_all = (e_all if te_ae is None else te_ae[e_all])[rep]
        # every bin's [rpad, cpr] tile array is a VIEW of one flat
        # region filled by a single global scatter: per-chunk flat
        # destination = row's region base + within-row chunk position
        # (per-bin mask assignments were ~1/3 of the s14 plan cost and
        # several full passes over the 8M-chunk cant tile volume)
        n_all = all_rows.shape[0]
        cprs = np.asarray([w // chunk for w in widths_list], np.int64)
        nrows_b = np.asarray([s.size for s in sels], np.int64)
        rpads_b = (
            np.asarray([_qpad8(s.size) for s in sels], np.int64)
            if quantize
            else nrows_b
        )
        region_sz = rpads_b * cprs
        region_base = np.concatenate([[0], np.cumsum(region_sz)])
        flat_total = int(region_base[-1])
        row_off = np.concatenate([[0], np.cumsum(nrows_b)])
        bin_of_local = repeat_idx(nrows_b, n_all)  # local row -> bin
        slot_local = (
            np.arange(n_all, dtype=np.int64) - row_off[bin_of_local]
        )
        row_base = (
            region_base[bin_of_local] + slot_local * cprs[bin_of_local]
        )
        # per-virtual-row chunk counts from the entry-stream scan (valid
        # for split sub-rows too, where prow_w is parent-indexed)
        e_len = te_end[all_rows] - te_start[all_rows]
        e_off = np.zeros(n_all + 1, np.int64)
        np.cumsum(e_len, out=e_off[1:])
        cs_pad0 = np.concatenate([[0], cs])
        nch_all = cs_pad0[e_off[1:]] - cs_pad0[e_off[:-1]]
        rce = np.cumsum(nch_all) - nch_all  # row's first global chunk
        r_of_chunk = repeat_idx(nch_all, tot_all)
        dest = (row_base - rce)[r_of_chunk]
        dest += np.arange(tot_all, dtype=np.int64)
        tile_src_flat = np.full(flat_total, sentinel_chunk, dtype=np.int32)
        tile_src_flat[dest] = src_all
        tile_ent_flat = np.zeros(flat_total, dtype=np.int32)
        tile_ent_flat[dest] = ent_all
        for bi, (w, sel) in enumerate(zip(widths_list, sels)):
            row_bin[sel] = bi
            row_slot[sel] = np.arange(sel.size, dtype=np.int32)
            rpad = int(rpads_b[bi])
            sel_p = (
                np.concatenate(
                    [sel, np.full(rpad - sel.size, -1, sel.dtype)]
                )
                if rpad > sel.size
                else sel
            )
            r0, r1 = int(region_base[bi]), int(region_base[bi + 1])
            bins.append(
                (
                    int(w),
                    sel_p.astype(np.int32),
                    tile_src_flat[r0:r1],
                    tile_ent_flat[r0:r1],
                )
            )
    # dense-hub rows: mark their virtual sub-rows (one per column slab)
    # and record the hub-entry summary; all layout lives in hub_groups
    if huge.size:
        vst = vstart32 if vstart32 is not None else np.arange(
            m + 1, dtype=np.int32
        )
        for g_ in hub_groups:
            ids = (
                vst[g_.rows][:, None].astype(np.int64)
                + np.arange(g_.n_slabs, dtype=np.int64)[None, :]
            ).reshape(-1)
            row_bin[ids] = -2
    huge_flops = max(int(rf[huge].sum()), 1) if huge.size else 1

    out_cap = int(np.minimum(rf, b.ncols).sum())
    return EllPlan(
        b_classes=tuple(b_classes),
        class_chunk_base=tuple(class_chunk_base),
        total_chunks=total_chunks,
        bins=tuple(bins),
        huge_rows=huge,
        huge_flops=huge_flops,
        hub_groups=hub_groups,
        rows=m,
        ncols=b.ncols,
        out_cap=max(out_cap, 1),
        row_bin=row_bin,
        row_slot=row_slot,
        chunk=int(chunk),
        v_rows=n_v,
        vstart=vstart32,
    )



def _flat_layout(plan: EllPlan):
    """Host-side flat region layout of all compacted tiles + the huge-row
    stream (memoised on the plan object itself)."""
    lay = getattr(plan, "_layout_cache", None)
    if lay is not None:
        return lay
    base = 0
    bin_starts = []
    flat_base = np.zeros(plan.v_rows, dtype=np.int64)
    for W, row_ids, _, _e in plan.bins:
        bin_starts.append(base)
        valid = row_ids >= 0
        flat_base[row_ids[valid]] = (
            base + np.arange(row_ids.size, dtype=np.int64)[valid] * W
        )
        base += row_ids.size * W
    huge_start = base
    # hub virtual rows: one region per (row, slab), laid out in the
    # exact order the device appends parts — group-major, slab-major,
    # row-ascending.  Caps are the exact per-(row,slab) product counts
    # rounded to 128 (128 alignment keeps the assembly repair aligned).
    if plan.hub_groups:
        vst = (
            plan.vstart
            if plan.vstart is not None
            else np.arange(plan.rows + 1, dtype=np.int32)
        )
        for g in plan.hub_groups:
            capsT = g.caps_rs.T.astype(np.int64)  # (n_slabs, hg)
            sizes = capsT.reshape(-1)
            offs = base + np.concatenate(
                [np.zeros(1, np.int64), np.cumsum(sizes)[:-1]]
            )
            vr_ids = (
                np.arange(g.n_slabs, dtype=np.int64)[:, None]
                + vst[g.rows][None, :].astype(np.int64)
            ).reshape(-1)
            flat_base[vr_ids] = offs
            base += int(sizes.sum())
    lay = {
        "bin_starts": tuple(bin_starts),
        "flat_base": flat_base,
        "huge_start": huge_start,
        "flat_total": base,
    }
    object.__setattr__(plan, "_layout_cache", lay)
    return lay
