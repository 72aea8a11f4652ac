"""Distributed static fused R-MCL (the port of the JAX package's
``parallel/rmcl_ell.py``), on a stacked mesh (the D shards on one
device) or a process mesh (one shard a rank).

The sharded counterpart of ``models/rmcl_ell.py``.  Mgt is row-sharded
once; the per-shard degree-bin plans are unified to common shapes (the
host planner is a numpy copy of the reference's, so the plans are equal
field by field).  Per iteration each shard needs the iterate rows its
entries reference, through one of four exchanges:

* ``"ring"``: the iterate blocks ``[lr, S]`` rotate around the shards
  (the reference's ``ppermute`` is a roll of the stacked shard axis);
  at step k shard me fills the entries the planner assigned to step k,
  and the hub accumulators rotate with the blocks;
* ``"all_gather"``: every shard reads the whole ``[n, S]`` iterate (the
  stacked shards are that all-gather);
* ``"pallas_ring"``: the all-gather through kernel K6
  (``ring_all_gather``, one launch for the cols and the vals) and
  ``unrotate``;
* ``"fused_ring"``: the segments as in ``"ring"``, the hub contraction
  through kernel K8 (``ring_matmul_tiled``).

The per-shard body is written once, for the shards this process holds
(the leading axis of the iterate and of every per-shard array): a
stacked mesh runs it for each of its D shards, a process mesh once, for
its rank.  The exchanges and the statistics' sums go through
``parallel/collectives.py`` (the reference's ``all_gather``,
``ppermute`` and ``psum``; on a process mesh on the card the peer route,
K6 one rank a launch, and on the CPU ``torch.distributed``'s, with the
sums added in the stacked path's order), and K6 / K8 launch one rank at
a time on a process mesh, so a rank's iterate and statistics are bit
for bit the stacked path's at the same D.

On the card the scan's step is a CUDA graph kept on the plan, captured
once the iterations run on it reach the step's break-even count, and
replayed (``utils/graphs.py``), the counterpart of the reference's
jitted ``shard_map`` of a ``lax.scan``, on a stacked mesh and on a
process mesh alike; the step reads the plan's index arrays from uploads
made once a plan (:func:`_plan_tensors`) and makes no host read.  On a
process mesh its exchanges and its statistics' sums take the peer route
(K6 one rank a launch, ``ring_kernels.peer_all_gather`` /
``peer_ppermute``), never ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE, true_f32
from ..formats.coo import COO
from ..formats.csr import CSR
from ..models.rmcl_ell import (
    _HIST,
    _ell_drift_sq,
    _hub_dense_products,
    _hub_rows,
    _no_span,
    _pow2ceil,
    _reduce_bins,
    ell_to_csr,
    mt_to_ell,
)
from ..ops.densify import ell_rows_to_dense, entries_to_dense
from ..utils import graphs
from ..utils.nphost import concat_ranges, fast_repeat
from . import collectives
from .mesh import ShardMesh
from .ring_kernels import (
    peer_all_gather,
    peer_ppermute,
    ring_all_gather,
    ring_matmul_tiled,
    unrotate,
)
from .sharded import ShardedCSR, shard_csr

EXCHANGES = ("ring", "all_gather", "pallas_ring", "fused_ring")


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedRmclPlan:
    n: int  # global (padded) rows = D * lr
    lr: int  # local rows per shard
    S: int
    bin_shapes: tuple  # ((D_class, R_pad), ...) common across shards
    hmax: int  # unified hub-row count per shard
    num_shards: int = 0
    step_widths: tuple = ()  # ring mode: per-rotation-step entry-group pad
    # gather-mode hub union (global across shards; plan constants)
    hub_krows: np.ndarray | None = None  # int32[hub_kh], -1 padded
    hub_kh: int = 0
    # fused-ring hub layout: per-owner union slices (plan constants)
    hub_lrk: int = 0  # max union rows owned by one shard (padded)
    hub_owner_cols: np.ndarray | None = None  # int32[D, lrk] khp positions
    hub_owner_loc: np.ndarray | None = None  # int32[D, lrk] local rows

    __hash__ = object.__hash__


def _host_arrays(smgt: ShardedCSR) -> tuple:
    return (
        smgt.row_ptr.cpu().numpy().astype(np.int64),
        smgt.col_ind.cpu().numpy(),
        smgt.values.cpu().numpy(),
    )


def plan_sharded_rmcl_ell(mgt: CSR, num_shards: int, S: int = 128, max_tile: int = 8192,
                          mesh=None):
    """Shard Mgt + build the unified per-shard degree-bin arrays.

    Returns (plan, arrays, smgt): ``arrays`` is a dict of stacked
    [D, ...] tensors on Mgt's device (lists of them for the per-bin and
    per-step arrays), the reference's keys and contents.  On a process
    mesh every rank plans from the same Mgt and keeps its own shard's
    rows of ``arrays`` and ``smgt`` (a leading axis of 1); the plan, with
    the ring schedule, is the same on every rank."""
    smgt = shard_csr(mgt, num_shards)
    lr = smgt.local_rows
    rp_all, col_all, val_all = _host_arrays(smgt)
    dmax = 1
    while dmax * 2 <= max(max_tile // S, 1):
        dmax *= 2
    classes = []
    d = 1
    while d <= dmax:
        classes.append(d)
        d *= 2
    per_shard = []
    for sh in range(num_shards):
        rp = rp_all[sh]
        deg = np.diff(rp)
        shard_bins = {}
        for dc in classes:
            lo = dc // 2 + 1 if dc > 1 else 1
            shard_bins[dc] = np.nonzero((deg >= lo) & (deg <= dc))[0]
        huge = np.nonzero(deg > dmax)[0]
        per_shard.append((rp, deg, shard_bins, huge))
    hmax = max(ps[3].size for ps in per_shard)

    bin_shapes = []
    arrays = {"row_ids": [], "ent_src": []}
    for dc in classes:
        rmax = max(ps[2][dc].size for ps in per_shard)
        if rmax == 0:
            continue
        rpad = max(8, _pow2ceil(rmax))
        bin_shapes.append((dc, rpad))
        rid_stack = np.full((num_shards, rpad), -1, np.int32)
        src_stack = np.full((num_shards, rpad * dc), -1, np.int32)
        for sh, (rp, deg, shard_bins, _) in enumerate(per_shard):
            sel = shard_bins[dc]
            rid_stack[sh, : sel.size] = sel
            es = np.full((sel.size, dc), -1, np.int64)
            for k in range(dc):
                has = deg[sel] > k
                es[has, k] = rp[sel[has]] + k
            src_stack[sh, : sel.size * dc] = es.reshape(-1)
        arrays["row_ids"].append(rid_stack)
        arrays["ent_src"].append(src_stack)

    # unified hub rows, built sparsely: bulk scatters on hub entries only
    n_pad = smgt.padded_rows
    hrow_stack = np.full((num_shards, max(hmax, 1)), -1, np.int32)
    hub_ent = []  # [(sh, slot_arr, col_arr, val_arr)]
    for sh, (rp, deg, _, huge) in enumerate(per_shard):
        hrow_stack[sh, : huge.size] = huge
        if huge.size:
            src = concat_ranges(rp[huge], rp[huge + 1])
            slot = fast_repeat(
                np.arange(huge.size, dtype=np.int64), rp[huge + 1] - rp[huge]
            ).astype(np.int64)
            hub_ent.append(
                (sh, slot, np.clip(col_all[sh][src], 0, n_pad - 1), val_all[sh][src])
            )
    arrays["huge_rows"] = hrow_stack
    # gather-mode hub: the dense contraction over the union of iterate
    # rows any shard's hub rows reference
    if hub_ent:
        krows = np.unique(np.concatenate([c for _, _, c, _ in hub_ent]))
        kh = int(krows.size)
        khp = max(128, -(-kh // 128) * 128)
        kr_pad = np.full(khp, -1, np.int32)
        kr_pad[:kh] = krows
        pos = np.zeros(n_pad, np.int64)  # global col -> union slot
        pos[krows] = np.arange(kh)
        a_dense_u = np.zeros((num_shards, max(hmax, 1), khp), np.float32)
        for sh, slot, c, v in hub_ent:
            np.add.at(a_dense_u[sh], (slot, pos[c]), v)
        # fused-ring hub layout: the union partitioned by owner shard
        owner_of_kr = krows // lr
        lrk = max(int(np.bincount(owner_of_kr, minlength=num_shards).max()), 1)
        lrk = max(8, _pow2ceil(lrk))
        hoc = np.full((num_shards, lrk), -1, np.int32)
        hol = np.full((num_shards, lrk), -1, np.int32)
        for j in range(num_shards):
            sel = np.nonzero(owner_of_kr == j)[0]
            hoc[j, : sel.size] = sel
            hol[j, : sel.size] = krows[sel] - j * lr
    else:
        khp = 128
        kr_pad = np.full(khp, -1, np.int32)
        a_dense_u = np.zeros((num_shards, max(hmax, 1), khp), np.float32)
        lrk = 8
        hoc = np.full((num_shards, lrk), -1, np.int32)
        hol = np.full((num_shards, lrk), -1, np.int32)
    arrays["a_dense_u"] = a_dense_u
    # ring-mode hub layout: per (me, owner) pair, the owner's hub entries
    # inside me's block as (slot, union-pos, val) triplets, densified per
    # step on the device; pads carry slot -1 and drop out
    pair_loc = [[None] * num_shards for _ in range(num_shards)]
    khb, emax = 1, 1
    for sh, slot, c, v in hub_ent:
        owner_blk = c // lr
        for me in range(num_shards):
            inb = owner_blk == me
            loc = np.unique(c[inb] - me * lr)
            pair_loc[me][sh] = loc
            khb = max(khb, int(loc.size))
            emax = max(emax, int(inb.sum()))
    khb = max(8, _pow2ceil(khb))
    emax = max(8, _pow2ceil(emax))
    kidx = np.full((num_shards, num_shards, khb), -1, np.int32)
    h_slot = np.full((num_shards, num_shards, emax), -1, np.int32)
    h_pos = np.zeros((num_shards, num_shards, emax), np.int32)
    h_val = np.zeros((num_shards, num_shards, emax), np.float32)
    for sh, slot, c, v in hub_ent:
        owner_blk = c // lr
        for me in range(num_shards):
            loc = pair_loc[me][sh]
            if loc is None or not loc.size:
                continue
            kidx[me, sh, : loc.size] = loc
            lpos = np.zeros(lr, np.int64)
            lpos[loc] = np.arange(loc.size)
            inb = owner_blk == me
            ne = int(inb.sum())
            h_slot[me, sh, :ne] = slot[inb]
            h_pos[me, sh, :ne] = lpos[c[inb] - me * lr]
            h_val[me, sh, :ne] = v[inb]
    arrays["hub_ent_slot"] = h_slot
    arrays["hub_ent_pos"] = h_pos
    arrays["hub_ent_val"] = h_val
    arrays["hub_kidx"] = kidx

    # ring-exchange entry groups: entry e of shard sh is served at the
    # rotation step k where the resident block's owner (sh - k) mod D
    # equals owner(col_e) = col_e // lr; each step's group is padded to
    # the max across shards, -1 pads dropped by the scatter
    step_groups = [[] for _ in range(num_shards)]
    for sh in range(num_shards):
        nnz_sh = int(rp_all[sh][-1])
        owner = np.clip(col_all[sh][:nnz_sh], 0, n_pad - 1) // lr
        k_of_e = (sh - owner) % num_shards
        for k in range(num_shards):
            step_groups[sh].append(np.nonzero(k_of_e == k)[0].astype(np.int32))
    step_widths = []
    arrays["step_ents"] = []
    for k in range(num_shards):
        emax = max(max(g[k].size for g in step_groups), 1)
        emax = max(8, _pow2ceil(emax))
        step_widths.append(emax)
        stack = np.full((num_shards, emax), -1, np.int32)
        for sh in range(num_shards):
            g = step_groups[sh][k]
            stack[sh, : g.size] = g
        arrays["step_ents"].append(stack)

    plan = ShardedRmclPlan(
        n=n_pad,
        lr=lr,
        S=int(S),
        bin_shapes=tuple(bin_shapes),
        hmax=int(hmax),
        num_shards=num_shards,
        step_widths=tuple(step_widths),
        hub_krows=kr_pad,
        hub_kh=int(khp),
        hub_lrk=int(lrk),
        hub_owner_cols=hoc,
        hub_owner_loc=hol,
    )
    dev = mgt.device
    keep = slice(None)
    if collectives.is_process(mesh):
        keep = slice(mesh.rank, mesh.rank + 1)
        smgt = smgt.rank_block(mesh.rank)
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x[keep])).to(dev)  # noqa: E731
    arrays = {k: [up(x) for x in v] if isinstance(v, list) else up(v) for k, v in arrays.items()}
    return plan, arrays, smgt


def _plan_tensors(plan: ShardedRmclPlan, device: torch.device, ranks) -> dict:
    """The plan's index arrays that the step reads, on ``device``, for the
    held ``ranks`` (contiguous): uploaded once per (plan, device, ranks),
    never inside a step."""
    cache = plan.__dict__.setdefault("_dev", {})
    key = (str(device), tuple(ranks))
    if key not in cache:
        up = lambda x: torch.from_numpy(np.asarray(x, np.int64)).to(device)  # noqa: E731
        cache[key] = {
            "hub_krows": up(plan.hub_krows),
            "hub_owner_cols": up(plan.hub_owner_cols.reshape(-1)),
            "hub_owner_loc": up(plan.hub_owner_loc[ranks[0]:ranks[-1] + 1]),
        }
    return cache[key]


def _segments_gathered(plan, a_rp, a_ci, a_v, g_cols, g_vals):
    """One shard's per-entry segments from a fully gathered [n, S]
    iterate, plus a sentinel segment."""
    n, S = plan.n, plan.S
    cap = a_ci.shape[0]
    safe_col = a_ci.long().clamp(0, n - 1)
    valid = (torch.arange(cap, device=a_ci.device) < a_rp[-1])[:, None]
    seg_c = torch.where(valid, g_cols[safe_col], n)
    seg_v = torch.where(valid, g_vals[safe_col] * a_v[:, None], 0.0)
    seg_c = torch.cat([seg_c, seg_c.new_full((1, S), n)])
    seg_v = torch.cat([seg_v, seg_v.new_zeros((1, S))])
    return seg_c, seg_v


def _segments_ring(plan, smgt, arrays, lc, lv, hub: bool = True, mesh=None):
    """Per-entry segments of every held shard (+ the hub products when
    ``hub``) through the ring: the iterate blocks rotate rightwards, so
    at step k shard me holds owner (me - k) mod D's block and fills the
    entries the planner assigned to step k.

    The hub rows rotate their accumulators instead: each shard densifies
    its own block once, and at step k the accumulator on shard me (that
    of shard v = (me - k) mod D) adds v's hub rows times me's columns;
    after D rotations every accumulator is home."""
    n, S, lr, d = plan.n, plan.S, plan.lr, plan.num_shards
    cap = smgt.local_capacity
    dev = lc.device
    a_ci, a_v = smgt.col_ind, smgt.values
    ranks = collectives.local_ranks(mesh, d)
    held = len(ranks)
    # rows cap + 1 take the -1 pads (the reference drops them)
    seg_c = torch.full((held, cap + 2, S), n, dtype=INDEX_DTYPE, device=dev)
    seg_v = torch.zeros((held, cap + 2, S), dtype=QVALUE_DTYPE, device=dev)
    hmax = plan.hmax if hub else 0
    c_h = md_me = None
    if hmax:  # every held shard's iterate block as dense rows [L, lr, n]
        md_me = ell_rows_to_dense(lc.reshape(-1, S), lv.reshape(-1, S), n, 0, n).view(held, lr, n)
        c_h = torch.zeros((held, hmax, n), dtype=QVALUE_DTYPE, device=dev)
    block_c, block_v = lc, lv
    for k in range(d):
        ids_k = arrays["step_ents"][k].long()
        for i, me in enumerate(ranks):
            owner = (me - k) % d
            ids = ids_k[i]
            safe_ids = ids.clamp(0, cap - 1)
            loc = (a_ci[i][safe_ids].long() - owner * lr).clamp(0, lr - 1)
            tgt = torch.where(ids >= 0, ids, cap + 1)
            seg_c[i][tgt] = block_c[i][loc]
            seg_v[i][tgt] = block_v[i][loc] * a_v[i][safe_ids][:, None]
            if hmax:
                slot = arrays["hub_ent_slot"][i][owner].long()
                pos = arrays["hub_ent_pos"][i][owner].long()
                idx = arrays["hub_kidx"][i][owner].long()
                ab = entries_to_dense(slot, pos, arrays["hub_ent_val"][i][owner], hmax,
                                      idx.shape[0])
                with true_f32():
                    part = torch.matmul(ab, md_me[i][idx.clamp(0, lr - 1)])
                c_h[i] = c_h[i] + part
        if hmax:
            c_h = peer_ppermute(c_h, mesh=mesh)[0]  # i -> i + 1
        if k + 1 < d:
            block_c, block_v = peer_ppermute(block_c, block_v, mesh=mesh)
    return seg_c[:, : cap + 1], seg_v[:, : cap + 1], c_h


def fused_hub_operands(plan, arrays, lc, lv, mesh=None):
    """The operands of the fused ring's hub contraction for every held
    shard: ``(a_cols [L, hmax, D*lrk], md_loc [L, lrk, npad], nt)``, the
    owner-major A columns cut from the union-dense operand and each
    shard's dense B block over its own union rows (N padded to a
    multiple of the tile width ``nt``)."""
    n, S, lr = plan.n, plan.S, plan.lr
    held = lc.shape[0]
    lrk, dev = plan.hub_lrk, lc.device
    pt = _plan_tensors(plan, dev, collectives.local_ranks(mesh, held))
    flat, hol = pt["hub_owner_cols"], pt["hub_owner_loc"]
    a_u = arrays["a_dense_u"]
    a_cols = torch.where(flat >= 0, a_u[:, :, flat.clamp(0, plan.hub_kh - 1)], 0.0)
    ntile = min(2048, 1 << (n - 1).bit_length())
    npad = -(-n // ntile) * ntile
    okr = (hol >= 0)[:, :, None]
    safe_r = hol.clamp(0, lr - 1)
    shard = torch.arange(held, device=dev)[:, None]
    bc = torch.where(okr, lc[shard, safe_r], n)  # [L, lrk, S]
    bv = torch.where(okr, lv[shard, safe_r], 0.0)
    md_loc = ell_rows_to_dense(bc.reshape(-1, S), bv.reshape(-1, S), n, 0, npad)
    return a_cols.contiguous(), md_loc.view(held, lrk, npad), ntile


def _fused_hub(plan, arrays, lc, lv, mesh=None):
    """The hub products of every held shard through K8, contracted
    around the leftward ring (one rank a launch on a process mesh)."""
    a_cols, md_loc, ntile = fused_hub_operands(plan, arrays, lc, lv, mesh)
    return ring_matmul_tiled(a_cols, md_loc, nt=ntile, mesh=mesh)[:, :, : plan.n]


def _local_step(plan, a_rp, row_ids, ent_src, huge_rows, seg_c, seg_v, c_h=None):
    """Fused step on one shard's rows given its per-entry segments (and
    its hub products)."""
    n, S, lr = plan.n, plan.S, plan.lr
    dev = seg_c.device
    sent = seg_c.shape[0] - 1
    # row lr: the dump; a padding row's tile is all sentinel (the
    # sentinel segment), so it writes (n, 0.0) and counts nothing
    new_cols = torch.full((lr + 1, S), n, dtype=INDEX_DTYPE, device=dev)
    new_vals = torch.zeros((lr + 1, S), dtype=QVALUE_DTYPE, device=dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)  # survivors, truncated rows
    bins = [(dc, torch.where(rid >= 0, rid, lr).long(), src)
            for (dc, _), rid, src in zip(plan.bin_shapes, row_ids, ent_src)]

    def gather(src, width):
        s = torch.where(src >= 0, src, sent).long()
        return seg_c[s].reshape(-1, width), seg_v[s].reshape(-1, width)

    _reduce_bins(bins, gather, n, S, new_cols, new_vals, counts, _no_span)
    if plan.hmax:
        _hub_rows(c_h, huge_rows, n, S, new_cols, new_vals, counts)
    return new_cols[:lr], new_vals[:lr], counts[0], counts[1]


def _sharded_step(plan, smgt, arrays, lc, lv, exchange: str, mesh=None):
    """One iteration on the held shards' [L, lr, S] iterate (all D on a
    stacked mesh, this rank's on a process mesh)."""
    n, S = plan.n, plan.S
    a_rp = smgt.row_ptr
    held = lc.shape[0]
    c_h = None
    if exchange in ("ring", "fused_ring"):
        seg_c, seg_v, c_h = _segments_ring(plan, smgt, arrays, lc, lv,
                                           hub=exchange == "ring", mesh=mesh)
        if exchange == "fused_ring" and plan.hmax:
            c_h = _fused_hub(plan, arrays, lc, lv, mesh)
    else:
        if exchange == "pallas_ring":  # one launch for the cols and the vals
            g_c, g_v = (unrotate(g, mesh) for g in ring_all_gather(lc, lv, mesh=mesh))
            views = [(g_c[i], g_v[i]) for i in range(held)]
        else:  # the all-gathered iterate (stacked: the held shards themselves)
            g_c, g_v = (g.reshape(n, S) for g in peer_all_gather(lc, lv, mesh=mesh))
            views = [(g_c, g_v)] * held
        segs = [
            _segments_gathered(plan, a_rp[i], smgt.col_ind[i], smgt.values[i], gc, gv)
            for i, (gc, gv) in enumerate(views)
        ]
        seg_c = [s[0] for s in segs]
        seg_v = [s[1] for s in segs]
        if plan.hmax:
            pt = _plan_tensors(plan, lc.device, collectives.local_ranks(mesh, held))
            c_h = [
                _hub_dense_products(arrays["a_dense_u"][i], gc, gv, n,
                                    krows=pt["hub_krows"], khp=plan.hub_kh)
                for i, (gc, gv) in enumerate(views)
            ]
    out_c, out_v, nnz, trunc, d2, n2 = [], [], [], [], [], []
    for i in range(held):
        nc, nv, nz, tr = _local_step(
            plan, a_rp[i],
            [r[i] for r in arrays["row_ids"]],
            [s[i] for s in arrays["ent_src"]],
            arrays["huge_rows"][i],
            seg_c[i], seg_v[i],
            None if c_h is None else c_h[i],
        )
        ld2, ln2 = _ell_drift_sq(lc[i], lv[i], nc, nv, n)
        for acc, x in zip((out_c, out_v, nnz, trunc, d2, n2), (nc, nv, nz, tr, ld2, ln2)):
            acc.append(x)
    # the four sums in one gather (on a process mesh: one K6 launch)
    d2, n2, nnz, trunc = collectives.psums(mesh, [torch.stack(x) for x in (d2, n2, nnz, trunc)])
    stats = {
        "nnz": nnz.to(INDEX_DTYPE),
        "truncated_rows": trunc.to(INDEX_DTYPE),
        "differs": torch.sqrt(d2) / torch.clamp(torch.sqrt(n2), min=1e-30),
    }
    return torch.stack(out_c), torch.stack(out_v), stats


def _flat_arrays(arrays) -> tuple:
    """(layout, tensors): the tensors of ``arrays`` in order, its lists
    flattened; :func:`_unflat_arrays` rebuilds the dict from them."""
    layout, flat = [], []
    for k, v in arrays.items():
        layout.append((k, len(v) if isinstance(v, list) else None))
        flat += v if isinstance(v, list) else [v]
    return tuple(layout), flat


def _unflat_arrays(layout, flat) -> dict:
    out, i = {}, 0
    for k, size in layout:
        out[k] = flat[i] if size is None else list(flat[i:i + size])
        i += 1 if size is None else size
    return out


def _scan_graph(mesh, plan, smgt, arrays, cols, vals, exchange: str, length: int):
    """The plan's captured step (the reference's jitted ``shard_map`` of
    a ``lax.scan``) for these inputs, loaded: static copies of Mgt's
    shards and of every plan array, the iterate as the carry
    (``graphs.scan_body``)."""
    ref = weakref.ref(plan)  # a strong one would keep the plan and its pool alive
    layout, flat = _flat_arrays(arrays)
    meta = (smgt.ncols, smgt.global_rows, smgt.shards, smgt.rank)

    def step(rp, ci, v, *rest):
        sm = ShardedCSR(rp, ci, v, *meta)
        nc, nv, stats = _sharded_step(ref(), sm, _unflat_arrays(layout, rest[:-2]), *rest[-2:],
                                      exchange, mesh)
        return (nc, nv), stats

    ins = (smgt.row_ptr, smgt.col_ind, smgt.values, *flat, cols, vals)
    static = (exchange, plan.n, plan.S, plan.lr, plan.num_shards, layout, meta)
    process = collectives.is_process(mesh)
    return graphs.scan_body(plan, scan_name(mesh), static, ins, 2, _HIST, length, step,
                            process)


def scan_name(mesh) -> str:
    """The name of the sharded scan's program on ``mesh`` (its graph's
    name on the plan and its ``graphs.BREAK_EVEN`` entry)."""
    return "sharded_rmcl_ell_scan" + ("_process" if collectives.is_process(mesh) else "")


def sharded_rmcl_ell_scan(
    mesh: ShardMesh,
    plan: ShardedRmclPlan,
    smgt: ShardedCSR,
    arrays,
    mt_cols,
    mt_vals,
    max_iters: int,
    exchange: str = "ring",
):
    """Device-resident multi-shard loop; ``mt_cols/vals`` are the held
    shards' [L, lr, S] (all D stacked; this rank's one on a process
    mesh).  Returns (cols, vals, stats history of tensors, the same on
    every rank).

    On the card the step is a CUDA graph kept on the plan, with every
    exchange, under ``utils/graphs.captures``: a call whose iterations,
    with those already run eagerly on the plan with this exchange, reach
    the step's break-even count runs iteration 1 eagerly, captures the
    step and replays it ``max_iters - 1`` times; a shorter one stays
    eager; a later call with inputs of the same shapes and the same
    exchange replays every iteration.  On a process mesh the same holds,
    every rank deciding alike (``graphs.BREAK_EVEN`` of
    ``sharded_rmcl_ell_scan_process``), except that a fresh plan's first
    iteration never captures: it makes the peer sets of K6 / K8
    (collectively), and the capture comes at iteration 2.  There the
    step's exchanges and sums take the peer route
    (``parallel/collectives.py``: K6 one rank a launch, epochs on the
    card), so it makes no ``torch.distributed`` call and no host read.
    On the CPU the same body runs eagerly over the caller's tensors, its
    exchanges the group's calls.  Returns fresh tensors."""
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be one of {EXCHANGES}, got {exchange!r}")
    held = collectives.local_ranks(mesh)
    if mt_cols.shape[0] != len(held) or plan.num_shards != mesh.num_shards:
        raise ValueError("iterate, plan and mesh disagree on the shard count")
    if max_iters <= 0:
        return mt_cols, mt_vals, {k: torch.zeros(0) for k, _ in _HIST}
    _plan_tensors(plan, mt_cols.device, held)  # uploads, never inside a capture
    g = _scan_graph(mesh, plan, smgt, arrays, mt_cols, mt_vals, exchange, max_iters)
    (cols, vals), hist = graphs.run_scan(g, max_iters)
    return cols, vals, hist


def sharded_rmcl_ell(
    graph,
    mesh: ShardMesh,
    max_iters: int = 5,
    S: int = 128,
    max_tile: int = 8192,
    balance: bool = False,
    exchange: str = "ring",
):
    """End-to-end distributed static R-MCL on ``mesh``'s device.  Returns
    (CSR, stats dict of numpy arrays); on a process mesh every rank
    passes the same graph and gets the same result (the iterate is
    all-gathered once at the end).

    ``balance=True`` relabels the graph with the footprint-balanced snake
    permutation (``sharded.flops_balanced_permutation``) so every shard
    carries near-equal first-iteration work; the result is relabelled
    back before returning."""
    from ..models.rmcl import rmcl_init
    from ..ops.flops import footprint_row_costs
    from .sharded import flops_balanced_permutation

    mt0 = rmcl_init(graph) if isinstance(graph, COO) else graph
    mt0 = mt0.to(mesh.device).make_ordered()
    num_shards = mesh.num_shards
    inv_perm = None
    if balance:
        rf = footprint_row_costs(mt0, mt0, chunk=S)
        perm = flops_balanced_permutation(rf, num_shards)
        inv_perm = np.zeros_like(perm)
        inv_perm[perm] = np.arange(perm.size, dtype=perm.dtype)
        # conjugate relabel (P M Pt): rows and cols, so the iteration is
        # isomorphic
        mt0 = mt0.conjugate_permute(torch.from_numpy(perm))
    plan, arrays, smgt = plan_sharded_rmcl_ell(mt0, num_shards, S=S, max_tile=max_tile,
                                               mesh=mesh)
    cols, vals = mt_to_ell(mt0, S)
    # the ELL sentinel (ncols) becomes the padded global sentinel (n)
    cols = torch.where(cols >= mt0.ncols, plan.n, cols)
    pad = plan.n - mt0.rows
    if pad:
        cols = torch.cat([cols, cols.new_full((pad, S), plan.n)])
        vals = torch.cat([vals, vals.new_zeros((pad, S))])
    held = collectives.local_ranks(mesh)
    fc, fv, hist = sharded_rmcl_ell_scan(
        mesh, plan, smgt, arrays,
        cols.reshape(num_shards, plan.lr, S)[held[0]:held[-1] + 1],
        vals.reshape(num_shards, plan.lr, S)[held[0]:held[-1] + 1],
        max_iters, exchange,
    )
    fc, fv = (collectives.all_gather(mesh, x) for x in (fc, fv))
    out = ell_to_csr(
        fc.reshape(plan.n, S)[: mt0.rows], fv.reshape(plan.n, S)[: mt0.rows], mt0.ncols
    )
    if inv_perm is not None:
        out = out.conjugate_permute(torch.from_numpy(inv_perm))
    return out, {k: v.cpu().numpy() for k, v in hist.items()}
