"""Distributed dynamic R-MCL (the port of the JAX package's
``parallel/rmcl.py``): Mt' = prune(inflate(Mgt · Mt)) with Mgt and the
iterate Mt row-sharded, on a stacked mesh (the D shards on one device)
or a process mesh (one shard a rank).

Each shard reads the whole iterate (the reference's all-gather: stacked,
the blocks through one ``BView``, which on one card moves no bytes, so
the times are compute only; one rank a process, ``torch.distributed``'s
all-gather) and runs the fused local step of
``models/rmcl.rmcl_one_step`` on its own rows: expand, sort, the
fixed-order compress (``esc_compress``), then the prune at the shard's
capacity.  Pruning is row-local, so the only collectives are the iterate
all-gather and the sums over the shard axis of the statistics and of the
drift (the reference's ``psum``, in shard order on both mesh kinds).
The per-shard bodies loop over the shards this process holds
(``collectives.local_ranks``), so a rank's blocks and statistics are
the stacked path's bit for bit.

* :func:`sharded_rmcl_scan` loops ``max_iters`` steps with no
  device-to-host read (the reference is a ``lax.scan``), the statistics
  stacked as [max_iters] tensors.
* :func:`sharded_rmcl_adaptive` re-deals the rows between iterations by
  the flops of the next multiply (the HYB trigger lifted to the mesh):
  the flops, the snake permutation and the relabel all run on the
  device, and each iteration reads its decision scalars in one read.
  On a process mesh every decision comes from gathered values added in
  the stacked order, so every rank reads the same bits and takes the
  same branch (ranks that disagree would wait on each other forever).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..formats.csr import CSR
from ..ops.metrics import csr_frobenius_diff
from ..ops.prune import inflate_prune_normalize_stream
from ..ops.segments import entry_rows, repeat_segments, segment_sum
from ..ops.spgemm import bview_from_blocks, esc_compress, esc_expand_view, esc_sort
from . import collectives
from .mesh import ROW_AXIS, ShardMesh
from .sharded import ShardedCSR, shard_csr, unshard_csr
from .spgemm import _check_mesh


def _local_fused_step(a_rp, a_ci, a_v, bv, ncols, product_cap, c_cap, mt_cap):
    """Fused local ESC SpGEMM + inflate/prune/normalize on this shard's
    rows (the distributed body of ``models/rmcl.rmcl_one_step``)."""
    a = CSR(a_rp, a_ci, a_v, bv.rows)
    m = a.rows
    prow, pcol, pval, flops = esc_expand_view(a, bv, product_cap)
    prow, pcol, pval, _, flags, seg, nnzc = esc_sort(prow, pcol, pval, m)
    crow, ccol, cval = esc_compress(prow, pcol, pval, flags, seg, nnzc, flops, m, ncols, c_cap)
    del prow, pcol, pval, flags, seg  # the product streams, before the prune's own
    row_ptr, col, val, overflow = inflate_prune_normalize_stream(
        crow, ccol, cval, crow < m, m, ncols, mt_cap
    )
    info = {
        "flops": flops,
        "nnz_c": nnzc,
        "nnz_mt": row_ptr[-1],
        "overflow": (flops > product_cap) | (nnzc > c_cap) | overflow,
    }
    return row_ptr, col, val, info


def sharded_rmcl_step(
    mesh: ShardMesh,
    mgt: ShardedCSR,
    mt: ShardedCSR,
    product_cap: int,
    c_cap: int,
    axis: str = ROW_AXIS,
    track_differs: bool = True,
):
    """One distributed R-MCL iteration; caps are per-shard.  Returns
    (new Mt, stats of 0-d tensors: ``flops``, ``nnz_mt``, ``overflow``,
    ``differs``, the same on every rank), with no device-to-host read."""
    _check_mesh(mesh, mgt, mt)
    ncols = mt.ncols
    bv = bview_from_blocks(*(collectives.all_gather(mesh, x)
                             for x in (mt.row_ptr, mt.col_ind, mt.values)), ncols)
    outs, d2s, n2s = [], [], []
    for i, me in enumerate(collectives.local_ranks(mesh)):
        n_rp, n_ci, n_v, info = _local_fused_step(
            mgt.row_ptr[i], mgt.col_ind[i], mgt.values[i], bv, ncols, product_cap, c_cap,
            mt.local_capacity,
        )
        outs.append((n_rp, n_ci, n_v, info))
        if track_differs:  # convergence drift: local squared norms, summed below
            d2, n2 = csr_frobenius_diff(mt.local_block(me), CSR(n_rp, n_ci, n_v, ncols))
            d2s.append(d2)
            n2s.append(n2)
    if track_differs:
        d2, n2 = (collectives.psum(mesh, torch.stack(x)) for x in (d2s, n2s))
        differs = torch.sqrt(d2) / torch.clamp(torch.sqrt(n2), min=1e-30)
    else:
        differs = torch.zeros((), dtype=QVALUE_DTYPE, device=mt.row_ptr.device)
    infos = [o[3] for o in outs]

    def total(key, dtype=INDEX_DTYPE):
        return collectives.psum(mesh, torch.stack([i[key].to(dtype) for i in infos]),
                                dtype=dtype)

    stats = {
        "flops": total("flops"),
        "nnz_mt": total("nnz_mt"),
        "overflow": total("overflow", torch.int32) > 0,
        "differs": differs,
    }
    new_mt = ShardedCSR(*(torch.stack([o[i] for o in outs]) for i in range(3)), ncols,
                        mt.global_rows, mt.shards, mt.rank)
    return new_mt, stats


def sharded_rmcl_scan(
    mesh: ShardMesh,
    mgt: ShardedCSR,
    mt: ShardedCSR,
    product_cap: int,
    c_cap: int,
    max_iters: int,
    axis: str = ROW_AXIS,
    track_differs: bool = True,
):
    """``max_iters`` sharded steps with the iterate on the device (the
    reference's ``lax.scan``): no device-to-host read.  Returns (final
    Mt, dict of [max_iters] tensors: flops, nnz_mt, overflow, differs)."""
    hist = []
    cur = mt
    for _ in range(max_iters):
        cur, stats = sharded_rmcl_step(mesh, mgt, cur, product_cap, c_cap, axis, track_differs)
        hist.append(stats)
    keys = ("flops", "nnz_mt", "overflow", "differs")
    return cur, {
        k: torch.stack([h[k] for h in hist]) if hist else torch.zeros(0, device=mt.row_ptr.device)
        for k in keys
    }


def plan_shard_capacities(
    mgt: ShardedCSR, mt_global_flops: int, margin: float = 1.5
) -> tuple[int, int]:
    """Per-shard capacity planning: balanced shards need ~total/D
    products, with headroom for imbalance and nnz growth."""
    d = mgt.num_shards
    per = int(np.ceil(mt_global_flops / d * margin))
    per = max(per, 16)
    return per, per


# HYB adaptive trigger (hybrid_omp_csr_kernel.cc:14): re-balance while the
# iterate still changes more than alpha per iteration.
REBALANCE_ALPHA = 0.008


def _spread(tots: torch.Tensor) -> torch.Tensor:
    """(max - min) / mean of the per-shard costs (f32)."""
    return (tots.max() - tots.min()) / torch.clamp(tots.mean(), min=1.0)


def sharded_next_flops(mesh: ShardMesh, mgt: ShardedCSR, mt: ShardedCSR, axis=ROW_AXIS):
    """Per-row flops of the NEXT multiply Mgt·Mt plus the footprint
    terms, and the current layout's per-shard spread, on the device.
    Returns (rf [L, lr] int32 of the held shards, spread 0-d f32, total
    0-d f32; the last two the same on every rank)."""
    _check_mesh(mesh, mgt, mt)
    cnt_g = collectives.all_gather(mesh, mt.row_ptr[:, 1:] - mt.row_ptr[:, :-1]).reshape(-1)
    n_glob = cnt_g.shape[0]
    m, cap = mgt.local_rows, mgt.local_capacity
    rfs = []
    for i in range(len(collectives.local_ranks(mesh))):
        a_rp0, a_ci0 = mgt.row_ptr[i], mgt.col_ind[i]
        valid = torch.arange(cap, device=a_rp0.device) < a_rp0[-1]
        ef = torch.where(valid, cnt_g[a_ci0.long().clamp(0, n_glob - 1)], 0).to(INDEX_DTYPE)
        rf = segment_sum(ef, entry_rows(a_rp0, cap), m)
        # footprint terms (footPrintsCrowiCount, static_omp_csr_kernel.cc:28-62):
        # output-write upper bound + A-row reads on top of the multiply count
        annz = (a_rp0[1:] - a_rp0[:-1]).to(INDEX_DTYPE)
        rfs.append(rf + torch.clamp(rf, max=n_glob) + annz + 32)
    rf = torch.stack(rfs)
    tots = collectives.all_gather(mesh, rf.sum(dim=1, dtype=INDEX_DTYPE)).to(torch.float32)
    return rf, _spread(tots), tots.sum()


def _snake_perm_device(rf, rows: int, d: int, lr: int):
    """Device analogue of ``sharded.flops_balanced_permutation`` over the
    PADDED row space: real rows deal boustrophedon over valid slots by
    descending flops (stable), padding rows fill the invalid tail slots,
    the same layout as the host version (holes only in trailing
    shards).  Returns perm [n_pad] int32, new row i = old row perm[i]."""
    n_pad = d * lr
    idx = torch.arange(n_pad, dtype=INDEX_DTYPE, device=rf.device)
    rfx = torch.where(idx < rows, rf.long(), -1)
    order = torch.argsort(-rfx, stable=True).to(INDEX_DTYPE)
    k = idx // lr
    r = idx % lr
    snakecol = torch.where(r % 2 == 0, k, d - 1 - k)
    rank = r * d + snakecol
    sizes = torch.clamp(rows - k * lr, 0, lr)
    key = torch.where(r < sizes, rank, n_pad + rank)
    slot_order = torch.argsort(key)  # the keys are distinct
    return torch.zeros(n_pad, dtype=INDEX_DTYPE, device=rf.device).index_put_(
        (slot_order,), order)


def _regather(g: ShardedCSR, old, inv):
    """One new local block: rows ``old`` of the gathered global CSR
    ``g`` (all its shards), columns relabelled through ``inv``; with the
    overflow flag of its capacity."""
    lr, lcap, n_pad, ncols = g.local_rows, g.local_capacity, inv.shape[0], g.ncols
    rpf = g.row_ptr.reshape(-1)  # [d*(lr+1)]
    base = (old // lr) * (lr + 1) + old % lr
    start = (old // lr) * lcap + rpf[base]
    ln = rpf[base + 1] - rpf[base]
    new_rp = torch.cat([ln.new_zeros(1), torch.cumsum(ln, 0).to(INDEX_DTYPE)])
    overflow = new_rp[-1] > lcap
    # non-decreasing starts (a cumsum of ln >= 0); a nonempty row starts
    # apart from the others
    p = repeat_segments(new_rp[:-1], ln > 0, lcap)
    slot = torch.arange(lcap, dtype=INDEX_DTYPE, device=old.device)
    pv = slot < new_rp[-1]
    sp = p.clamp(0, lr - 1).long()
    src = (start[sp] + (slot - new_rp[sp])).clamp(0, g.col_ind.numel() - 1).long()
    col = g.col_ind.reshape(-1)[src]
    val = g.values.reshape(-1)[src]
    newcol = torch.where(
        pv & (col < ncols), inv[col.long().clamp(0, n_pad - 1)], ncols
    ).to(INDEX_DTYPE)
    newval = torch.where(pv, val, 0.0).to(QVALUE_DTYPE)
    return new_rp, newcol, newval, overflow


def _device_repartition_pair(
    mesh: ShardMesh, mgt: ShardedCSR, mt: ShardedCSR, rf, rows: int, axis=ROW_AXIS
):
    """Conjugate-relabel (P·M·Pᵗ) and re-deal BOTH sharded operands on
    the device with the flops-balanced snake permutation computed from
    ``rf`` ([L, lr], the held shards'): the repartition with no round
    trip through the host.  Both operands and ``rf`` are all-gathered,
    as the reference does, so every rank builds the same permutation by
    the same stable sorts and regathers its own new rows.  Returns
    (new_mgt, new_mt, perm [n_pad], overflow, spread after; the last
    three the same on every rank)."""
    _check_mesh(mesh, mgt, mt)
    d, lr = mgt.num_shards, mgt.local_rows
    n_pad = d * lr
    rf_g = collectives.all_gather(mesh, rf).reshape(-1)
    perm = _snake_perm_device(rf_g, rows, d, lr)
    inv = torch.zeros(n_pad, dtype=INDEX_DTYPE, device=perm.device).index_put_(
        (perm.long(),), torch.arange(n_pad, dtype=INDEX_DTYPE, device=perm.device))
    ga, gb = (ShardedCSR(*(collectives.all_gather(mesh, x)
                           for x in (s.row_ptr, s.col_ind, s.values)), s.ncols, s.global_rows)
              for s in (mgt, mt))
    new_a, new_b, myf, ovf = [], [], [], []
    for me in collectives.local_ranks(mesh):
        old = perm[me * lr : (me + 1) * lr].long()
        *na, ova = _regather(ga, old, inv)
        *nb, ovb = _regather(gb, old, inv)
        new_a.append(na)
        new_b.append(nb)
        myf.append(rf_g[old].sum(dtype=INDEX_DTYPE))
        ovf.append((ova | ovb).to(torch.int32))
    spread = _spread(collectives.all_gather(mesh, torch.stack(myf)).to(torch.float32))
    overflow = collectives.psum(mesh, torch.stack(ovf), dtype=torch.int32) > 0

    def stacked(blocks, like):
        return ShardedCSR(*(torch.stack([b[i] for b in blocks]) for i in range(3)), like.ncols,
                          like.global_rows, like.shards, like.rank)

    return stacked(new_a, mgt), stacked(new_b, mt), perm, overflow, spread


def sharded_rmcl_adaptive(
    mt0: CSR,
    mesh: ShardMesh,
    max_iters: int,
    alpha: float = REBALANCE_ALPHA,
    spread_threshold: float = 0.10,
    margin: float = 2.0,
    axis: str = ROW_AXIS,
):
    """Distributed R-MCL with flops-driven repartitioning BETWEEN
    iterations: the HYB adaptive strategy
    (hybrid_omp_csr_kernel.cc:14-34,67-74) lifted to the shards.

    Each iteration re-estimates the per-row flops of the NEXT multiply on
    the device; while the iterate still changes (``differs > alpha``, the
    reference's trigger) and the current layout's per-shard spread
    exceeds ``spread_threshold``, the rows are re-dealt with the
    flops-balanced snake permutation and both operands conjugately
    relabelled (P·M·Pᵗ keeps the iteration isomorphic).  Once the iterate
    settles the layout freezes.  The product capacities grow in 1.5×
    buckets as the flops do.  The only host traffic an iteration is ONE
    read of the scalars that drive the decision (differs, spread, total,
    nnz, overflow); the unshard and the final un-relabel happen once at
    the end.  On a process mesh every rank passes the same ``mt0``, holds
    its own row of shards and returns the same result (the final unshard
    is collective).  Returns (final CSR in the ORIGINAL labelling, history
    dict of numpy arrays: one entry an iteration, and ``perm_total``, the
    final relabelling over the padded rows, new row i = original row
    ``perm_total[i]``)."""
    from ..ops.flops import row_flops

    d = mesh.num_shards
    mt0 = mt0.to(mesh.device)
    n = mt0.rows
    lr = -(-n // d)
    n_pad = d * lr

    # one-time setup: shard the natural layout, record its spread
    rf0 = row_flops(mt0, mt0).cpu().numpy().astype(np.int64)
    padded = np.concatenate([rf0, np.zeros(n_pad - n, rf0.dtype)])
    per0 = padded.reshape(d, lr).sum(axis=1)
    spread0 = float((per0.max() - per0.min()) / max(per0.mean(), 1.0))
    total = int(rf0.sum())
    pc = cc = max(16, int(np.ceil(total / d * margin)))
    lcap_t = max(cc, int(mt0.capacity))
    smgt = shard_csr(mt0, mesh, local_capacity=lcap_t)
    smt = shard_csr(mt0, mesh, local_capacity=lcap_t)
    held = collectives.local_ranks(mesh)
    rf_blocks = torch.from_numpy(
        np.concatenate([rf0.astype(np.int32), np.zeros(n_pad - n, np.int32)]).reshape(d, lr)
        [held[0]:held[-1] + 1]
    ).to(mesh.device)
    perm_total = torch.arange(n_pad, dtype=INDEX_DTYPE, device=mesh.device)

    prev_differs = np.inf
    spread = spread0
    hist = {k: [] for k in ("differs", "nnz", "spread_before", "spread_after", "rebalanced",
                            "overflow")}
    no_value = torch.full((), float("nan"), dtype=torch.float64, device=mesh.device)
    for it in range(max_iters):
        rebal = it == 0 or (prev_differs > alpha and spread > spread_threshold)
        hist["spread_before"].append(spread)
        hist["rebalanced"].append(bool(rebal))
        r_ovf = sp_after = no_value
        if rebal:
            smgt, smt, perm, r_ovf, sp_after = _device_repartition_pair(
                mesh, smgt, smt, rf_blocks, n, axis
            )
            perm_total = perm_total[perm.long()]
        new_smt, stats = sharded_rmcl_step(mesh, smgt, smt, pc, cc, axis)
        rf_blocks, next_spread, next_total = sharded_next_flops(mesh, smgt, new_smt, axis)
        smt = new_smt
        # the iteration's one read: the decision scalars, in one tensor,
        # each from gathered values (the same bits on every rank)
        host = torch.stack([
            x.to(torch.float64) for x in (stats["differs"], sp_after, next_spread, next_total,
                                          stats["nnz_mt"], stats["overflow"], r_ovf)
        ]).cpu().numpy()
        prev_differs = float(host[0])
        if rebal:
            spread = float(host[1])
        hist["spread_after"].append(spread)
        spread = float(host[2])
        # flops can grow across early iterations: bump the capacities in
        # x1.5 buckets
        need = max(16, int(np.ceil(float(host[3]) / d * margin)))
        while pc < need:
            pc = cc = int(pc * 1.5) + 16
        hist["differs"].append(prev_differs)
        hist["nnz"].append(int(host[4]))
        hist["overflow"].append(bool(host[5]) or (rebal and bool(host[6])))

    mt_final = unshard_csr(smt, mesh)
    hist["perm_total"] = perm_total.cpu().numpy()
    inv_np = np.zeros(n_pad, np.int32)
    inv_np[hist["perm_total"]] = np.arange(n_pad, dtype=np.int32)
    out = mt_final.conjugate_permute(torch.from_numpy(inv_np[:n]))
    return out, {k: np.asarray(v) for k, v in hist.items()}
