"""Distributed SpGEMM (the port of the JAX package's ``parallel/spgemm.py``):
A and C row-sharded, B all-gathered (:func:`sharded_spgemm`) or rotated
around the ring (:func:`sharded_spgemm_ring`).

Each shard runs one body, the single-card stream ESC on its rows
(Gustavson rows are independent, so there is no cross-shard reduction):
on a stacked mesh (``parallel/mesh.py``) a Python loop runs it for every
shard, on a process mesh each rank runs it once for its own.  B's
all-gather and the ring's ``ppermute`` are ``parallel/collectives.py``'s:
stacked, the blocks read through one ``BView``
(``ops/spgemm.bview_from_blocks``, no bytes moved on one card) and a
``torch.roll`` of the stack; one rank a process, ``torch.distributed``'s
all-gather and send / receive.  C's values are the fixed-order run sums
of ``esc_compress`` where the reference scatter-adds: two calls give the
same bits on the card, and a rank's block equals the stacked path's
block.  With capacities (and, for the ring, a plan) passed in, a call
makes no device-to-host read, as the reference runs under ``jit``; on
the card the ring's warm body is then a CUDA graph kept on its plan
(``utils/graphs.py``), the counterpart of the jitted ``_ring_impl``, on
a stacked mesh and on a process mesh alike: there the ring's
``ppermute`` of B's three arrays takes the peer route (one K6 launch of
one hop, ``ring_kernels.peer_ppermute``), not ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..formats.csr import CSR
from ..ops.segments import entry_rows, exclusive_cumsum, repeat_segments
from ..ops.spgemm import bview_from_blocks, esc_compress, esc_expand_view, esc_sort
from ..utils import graphs
from . import collectives
from .mesh import ROW_AXIS, ShardMesh
from .ring_kernels import peer_ppermute
from .sharded import ShardedCSR


def _check_mesh(mesh: ShardMesh, *shards: ShardedCSR) -> None:
    ranks = collectives.local_ranks(mesh)
    for s in shards:
        if s.num_shards != mesh.num_shards:
            raise ValueError(f"{s.num_shards} shards on a mesh of {mesh.num_shards}")
        if (s.row_ptr.shape[0], s.rank) != (len(ranks), ranks[0]):
            raise ValueError("the blocks held are not the mesh's shards of this process")


def _compress(prow, pcol, pval, total, rows: int, ncols: int, out_cap: int):
    """One shard's C from its unsorted product streams: (row_ptr, col,
    val, nnz(C)), padded out to ``out_cap``."""
    prow, pcol, pval, _, flags, seg, nnzc = esc_sort(prow, pcol, pval, rows)
    crow, ccol, cval = esc_compress(prow, pcol, pval, flags, seg, nnzc, total, rows, ncols,
                                    out_cap)
    row_ptr = torch.searchsorted(
        crow, torch.arange(rows + 1, dtype=INDEX_DTYPE, device=crow.device)
    ).to(INDEX_DTYPE)
    return row_ptr, ccol, cval, nnzc


def _local_spgemm(a_rp, a_ci, a_v, bv, ncols: int, product_cap: int, out_cap: int):
    """Single-shard ESC SpGEMM of the local A block against a B view."""
    a = CSR(a_rp, a_ci, a_v, bv.rows)
    prow, pcol, pval, flops = esc_expand_view(a, bv, product_cap)
    row_ptr, ccol, cval, nnzc = _compress(prow, pcol, pval, flops, a.rows, ncols, out_cap)
    return row_ptr, ccol, cval, flops, nnzc


def _stack_result(outs, ncols: int, like: ShardedCSR) -> tuple[ShardedCSR, dict]:
    rp, ci, v, flops, nnzc = (torch.stack(x) for x in zip(*outs))
    return (ShardedCSR(rp, ci, v, ncols, like.global_rows, like.shards, like.rank),
            {"flops": flops, "nnz": nnzc})


def sharded_spgemm(
    mesh: ShardMesh,
    a: ShardedCSR,
    b: ShardedCSR,
    product_cap: int,
    out_cap: int,
    axis: str = ROW_AXIS,
) -> tuple[ShardedCSR, dict]:
    """C = A·B with A, B, C all row-sharded over ``mesh``.

    ``product_cap`` / ``out_cap`` are *per-shard* capacities (flops-balanced
    sharding keeps them near total/D).  Returns (C sharded, info dict
    with the per-shard flops and nnz as [L] tensors, L the shards this
    process holds: D stacked, 1 on a process mesh)."""
    _check_mesh(mesh, a, b)
    bv = bview_from_blocks(*(collectives.all_gather(mesh, x)
                             for x in (b.row_ptr, b.col_ind, b.values)), b.ncols)
    outs = [
        _local_spgemm(a.row_ptr[i], a.col_ind[i], a.values[i], bv, b.ncols,
                      product_cap, out_cap)
        for i in range(a.row_ptr.shape[0])
    ]
    return _stack_result(outs, b.ncols, a)


@dataclasses.dataclass(frozen=True, eq=False)
class RingPlan:
    """Static shapes of the per-step entry groups and product streams."""

    step_widths: tuple  # Ek: padded entry-group size per rotation step
    step_prod_caps: tuple  # PK: padded product count per rotation step

    __hash__ = object.__hash__


def plan_spgemm_ring(a: ShardedCSR, b: ShardedCSR, mesh=None):
    """Host planner for the ring exchange: group each shard's A entries
    by the rotation step that delivers their B row, and size each step's
    product stream exactly (B's structure is fixed, so the per-(shard,
    step) product counts are host constants: the reference's P2
    cost-model law, util.cc:123-149, applied to ring steps).  A numpy
    copy of the reference's planner.  On a process mesh the blocks'
    structure is first all-gathered, so every rank makes the same plan.

    Returns (RingPlan, step_ents) with step_ents[k] an int32 [D, Ek]
    tensor of local entry indices (-1 padded), uploaded once to A's
    device."""
    d = a.num_shards
    lr = b.local_rows
    brp = collectives.all_gather(mesh, b.row_ptr).cpu().numpy()
    blen = (brp[:, 1:] - brp[:, :-1]).reshape(-1).astype(np.int64)  # [D*lr]
    arp = collectives.all_gather(mesh, a.row_ptr).cpu().numpy()
    aci = collectives.all_gather(mesh, a.col_ind).cpu().numpy()
    groups = [[] for _ in range(d)]
    for sh in range(d):
        nnz_sh = int(arp[sh, -1])
        col = aci[sh, :nnz_sh]
        owner = np.clip(col, 0, d * lr - 1) // lr
        k_of_e = (sh - owner) % d
        for k in range(d):
            groups[k].append(np.nonzero(k_of_e == k)[0].astype(np.int32))
    widths, pcaps, step_ents = [], [], []
    for k in range(d):
        emax = max(max(g.size for g in groups[k]), 1)
        emax = -(-emax // 8) * 8
        widths.append(emax)
        stack = np.full((d, emax), -1, np.int32)
        pk = 1
        for sh in range(d):
            g = groups[k][sh]
            stack[sh, : g.size] = g
            if g.size:
                cols_g = np.clip(aci[sh][g], 0, d * lr - 1)
                pk = max(pk, int(blen[cols_g].sum()))
        pcaps.append(int(pk))
        step_ents.append(torch.from_numpy(stack).to(a.row_ptr.device))
    return RingPlan(tuple(widths), tuple(pcaps)), step_ents


def _ring_step_products(a_rp0, a_ci0, a_v0, erow, blk_rp, blk_ci, blk_v, ids, owner: int,
                        lr: int, pk: int, ncols: int):
    """One rotation step on one shard: the products of the A entries
    ``ids`` (-1 padded) against the resident block of shard ``owner``,
    as streams of length ``pk``, and their count."""
    m, cap = a_rp0.shape[0] - 1, a_ci0.shape[0]
    lcap = blk_ci.shape[0]
    ek = ids.shape[0]
    okid = ids >= 0
    safe_ids = ids.clamp(0, cap - 1).long()
    acol = a_ci0[safe_ids]
    loc = (acol - owner * lr).clamp(0, lr - 1).long()
    bs = blk_rp[loc]
    cnt = torch.where(okid, blk_rp[loc + 1] - bs, 0).to(INDEX_DTYPE)
    starts = exclusive_cumsum(cnt)
    tot_k = starts[-1]
    # non-decreasing starts (a cumsum of cnt >= 0); a segment with
    # products starts apart from the others
    p = repeat_segments(starts[:-1], okid & (cnt > 0), pk)
    q = torch.arange(pk, dtype=INDEX_DTYPE, device=ids.device)
    pv = q < tot_k
    sp = p.clamp(0, ek - 1).long()
    e = safe_ids[sp]
    t = q - starts[sp]
    b_idx = (bs[sp] + t).clamp(0, lcap - 1).long()
    rows = torch.where(pv, erow[e], m).to(INDEX_DTYPE)
    cols = torch.where(pv, blk_ci[b_idx], ncols).to(INDEX_DTYPE)
    vals = torch.where(pv, a_v0[e] * blk_v[b_idx], 0.0).to(QVALUE_DTYPE)
    return rows, cols, vals, tot_k


def _ring_impl(mesh, caps: tuple, a: ShardedCSR, b: ShardedCSR, step_ents, out_cap: int):
    """The ring's body: ``caps`` the plan's per-step product counts."""
    d, lr, ncols = a.num_shards, b.local_rows, b.ncols
    cap = a.local_capacity
    ranks = collectives.local_ranks(mesh)
    erows = [entry_rows(a.row_ptr[i], cap) for i in range(len(ranks))]
    parts = [[] for _ in ranks]
    totals = [torch.zeros((), dtype=INDEX_DTYPE, device=a.row_ptr.device)] * len(ranks)
    blk_rp, blk_ci, blk_v = b.row_ptr, b.col_ind, b.values
    for k in range(d):
        for i, me in enumerate(ranks):  # the resident block is that of shard (me - k) mod d
            *streams, tot_k = _ring_step_products(
                a.row_ptr[i], a.col_ind[i], a.values[i], erows[i],
                blk_rp[i], blk_ci[i], blk_v[i], step_ents[k][me], (me - k) % d, lr,
                caps[k], ncols,
            )
            parts[i].append(streams)
            totals[i] = totals[i] + tot_k
        if k + 1 < d:  # ppermute i -> i + 1 (a process mesh on the card: one K6 launch)
            blk_rp, blk_ci, blk_v = peer_ppermute(blk_rp, blk_ci, blk_v, mesh=mesh)
    outs = []
    for i in range(len(ranks)):  # the step streams in step order
        prow, pcol, pval = (torch.cat(x) for x in zip(*parts[i]))
        row_ptr, ccol, cval, nnzc = _compress(prow, pcol, pval, totals[i], a.local_rows, ncols,
                                             out_cap)
        outs.append((row_ptr, ccol, cval, totals[i], nnzc))
    return _stack_result(outs, ncols, a)


def _ring_graph(mesh, plan: RingPlan, a: ShardedCSR, b: ShardedCSR, step_ents, out_cap: int):
    """The plan's captured warm body (the reference's jitted
    ``_ring_impl``) for these operands, loaded: static copies of A's and
    B's stacked arrays and of the step entries; its outputs are C's
    stacked arrays and the per-shard flops and nnz (``graphs.bound``)."""
    ins = (a.row_ptr, a.col_ind, a.values, b.row_ptr, b.col_ind, b.values, *step_ents)
    caps = plan.step_prod_caps
    process = collectives.is_process(mesh)
    name = ring_name(mesh)

    def build(st):
        sa = ShardedCSR(*st[:3], a.ncols, a.global_rows, a.shards, a.rank)
        sb = ShardedCSR(*st[3:6], b.ncols, b.global_rows, b.shards, b.rank)

        def body():
            c, info = _ring_impl(mesh, caps, sa, sb, st[6:], out_cap)
            return c.row_ptr, c.col_ind, c.values, info["flops"], info["nnz"]

        return graphs.CapturedBody(name, body, st, process=process)

    return graphs.bound(plan, name, (out_cap, b.ncols, a.num_shards), ins, build)


def ring_name(mesh) -> str:
    """The name of the warm ring's program on ``mesh`` (its graph's name
    on the plan and its ``graphs.BREAK_EVEN`` entry)."""
    return "sharded_spgemm_ring" + ("_process" if collectives.is_process(mesh) else "")


def sharded_spgemm_ring(
    mesh: ShardMesh,
    a: ShardedCSR,
    b: ShardedCSR,
    product_cap: int | None = None,
    out_cap: int = 1,
    axis: str = ROW_AXIS,
    plan: RingPlan | None = None,
    step_ents=None,
) -> tuple[ShardedCSR, dict]:
    """C = A·B with B's blocks ROTATED around the shards instead of
    all-gathered (the memory-scalable exchange): the planner
    (:func:`plan_spgemm_ring`) groups each shard's A entries by the
    rotation step that delivers their B row and sizes each step's
    product stream exactly, so a shard's work per step is the products
    of that step.  Prefer :func:`sharded_spgemm` when B fits.

    ``product_cap`` is accepted for API compatibility; stream sizes come
    from the planner.  With a prebuilt (plan, step_ents) the call makes
    no device-to-host read, and on the card its body is a CUDA graph
    kept on the plan, captured by the call that reaches its break-even
    count of calls on operands of those shapes (``utils/graphs.captures``;
    on a process mesh every rank alike, never at a plan's first call,
    which makes the peer set of its ``ppermute``) and replayed by every
    later one.  A call that plans stays eager."""
    _check_mesh(mesh, a, b)
    if plan is None:
        plan, step_ents = plan_spgemm_ring(a, b, mesh)
    else:
        rp, ci, v, flops, nnzc = _ring_graph(mesh, plan, a, b, step_ents, int(out_cap)).run()
        return (ShardedCSR(rp, ci, v, b.ncols, a.global_rows, a.shards, a.rank),
                {"flops": flops, "nnz": nnzc})
    return _ring_impl(mesh, plan.step_prod_caps, a, b, step_ents, int(out_cap))
