"""The host-side logic that the Hopper kernels K1 (``sort_dedup_compact``),
K2 (``compact_nonzero_rows``), K3 (``window_gather``) and K5
(``bcsr_spmm``) rest on, emulated in numpy and held against the JAX
package's Pallas kernels (interpret mode), the twins and f64 products.

* K1 (``csrc/sort_dedup_compact.cu``): the 64-bit packed (column, value
  bits) key order; the plan of stages (inside a thread, by shuffles, in
  groups through shared memory, across the cluster) that must run every
  stage of the bitonic network once and in order; the swizzle of the
  shared-memory words; and the whole per-row pipeline (network from
  ``2 presorted``, per-thread sums, the Kogge-Stone scan of (run
  started, sum, kept lanes) across threads and warps, the cluster's
  halves) on tiles whose presorted runs repeat columns.
* K5 (``csrc/bcsr_spmm.cu``): the work items that ``BCSR.from_csr``
  builds (``formats/bcsr.spmm_schedule``), and the kernel's arithmetic
  over them: 3xTF32 products whose tensor-core sums truncate, each k8
  step's chain promoted into f32, rows summed in stage order, pieces
  of split rows summed in order.  Held to 1e-7 + 1e-4 |A||B| of the f64
  product, and to the Pallas kernel within the same bound.
* K2 (``csrc/compact_nonzero_rows.cu``): the split of a row over a
  cluster of CTAs, each CTA's count and the offsets from the exchanged
  counts, the packed block scan of a piece, the staged write shifted by
  the output's alignment and the padding, every output position written
  once; bit-equal to the Pallas kernel and the twin.
* K3 (``csrc/window_gather.cu``): the clipped start in C integer
  arithmetic, the aligned vector reads (all inside the source) realigned
  by a neighbour's vector, the two-list walk; bit-equal to the
  reference's row takes + ``align_windows`` and the twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.ops import spmm as jspmm
from sparse_matrix_with_flops_tpu.ops.pallas_sort import align_windows
from sparse_matrix_with_flops_tpu.ops.pallas_sort import compact_nonzero_rows as j_compact
from sparse_matrix_with_flops_tpu.ops.pallas_sort import sort_dedup_compact as j_sdc
from sparse_matrix_with_flops_tpu.utils import generate as jgen
from sparse_matrix_with_flops_tpu_torch.formats.bcsr import (
    SPMM_BLOCKS,
    SPMM_DEPTH,
    SPMM_GROUP,
    SPMM_ROWS,
)
from sparse_matrix_with_flops_tpu_torch.ops.sort_kernels import (
    compact_nonzero_rows_plain,
    sort_dedup_compact_plain,
    window_gather_plain,
)

from torch_port_util import assert_close_values, both_bcsr, jax_random_csr

# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


def k1_geometry(w: int):
    """(L, E, TPR, SW, pair) of K1's instance for width w (Cfg)."""
    pair = w == 32768
    lanes = w // 2 if pair else w
    e = lanes if lanes <= 8 else (8 if lanes <= 8192 else 16)
    tpr = lanes // e
    return lanes, e, tpr, min(tpr, 32), pair


def k1_stage_plan(w: int, kstart: int):
    """The stages (k, j, where) in the order K1's ``network`` runs them."""
    lanes, e, _, sw, pair = k1_geometry(w)
    plan = []
    k = kstart
    while k <= w:
        j = k >> 1
        if j >= 32 * e:
            if pair and j == lanes:
                plan.append((k, j, "cluster"))
                j >>= 1
            low = 32 * e
            while j >= low:
                span = (j // low).bit_length() - 1
                js = 3 if span >= 2 else span + 1
                plan += [(k, j >> q, f"group{js}") for q in range(js)]
                j >>= js
        m = sw // 2
        while m > 0:
            if m * e < k:
                plan.append((k, m * e, "shuffle"))
            m >>= 1
        jj = e // 2
        while jj > 0:
            if jj < k:
                plan.append((k, jj, "register"))
            jj >>= 1
        k <<= 1
    return plan


def bitonic_stages(w: int, kstart: int):
    out = []
    k = kstart
    while k <= w:
        j = k >> 1
        while j > 0:
            out.append((k, j))
            j >>= 1
        k <<= 1
    return out


@pytest.mark.parametrize("w", [2 ** p for p in range(0, 16)])
def test_k1_plan_runs_every_bitonic_stage_once_in_order(w):
    lanes, e, _, _, pair = k1_geometry(w)
    for presorted in sorted({1, 2, max(w // 64, 1), max(w // 2, 1), w}):
        kstart = 2 * presorted if presorted > 1 else 2
        plan = k1_stage_plan(w, kstart)
        assert [(k, j) for k, j, _ in plan] == bitonic_stages(w, kstart)
        for k, j, where in plan:
            if where == "register":
                assert j < e
            elif where == "shuffle":
                assert e <= j < 32 * e and j // e < lanes // e
            elif where == "cluster":
                assert pair and j == lanes
            else:
                assert j >= 32 * e and j < lanes
    # shared-memory round trips at W = 8192 from k = 512 (PERF.md, PR 6)
    if w == 8192:
        plan = k1_stage_plan(w, 16)
        groups = [(k, where) for k, j, where in plan if where.startswith("group")]
        passes = {}
        for k, where in groups:
            passes[(k, where)] = passes.get((k, where), 0) + 1
        n_pass = sum(c // int(wh[-1]) for (_, wh), c in passes.items())
        n_trips = len({k for k, _ in groups})
        assert (n_pass, n_trips) == (7, 5)


def k1_phys(i, e):
    i = np.asarray(i)
    if e >= 4:
        return i ^ (((i >> 4) & (e // 2 - 1)) << 1)
    return i


@pytest.mark.parametrize("e", [1, 2, 4, 8, 16])
def test_k1_swizzle_is_a_bijection_and_spreads_each_quarter_warp(e):
    n = 4096 * max(e, 1)
    p = k1_phys(np.arange(n), e)
    assert np.array_equal(np.sort(p), np.arange(n))
    if e >= 2:
        # a 16-byte access of chunk c by the 8 threads of a quarter warp:
        # 8 distinct 16-byte bank groups (word pairs mod 16 words)
        for c in range(e // 2):
            for q in range(0, 256, 8):
                t = np.arange(q, q + 8)
                words = k1_phys(t * e + 2 * c, e)
                assert np.unique((words // 2) % 8).size == 8


@pytest.mark.parametrize("js", [1, 2, 3])
@pytest.mark.parametrize("j,lanes", [(256, 1024), (1024, 8192), (4096, 16384)])
def test_k1_group_pass_covers_each_pair_once(js, j, lanes):
    s = j >> (js - 1)
    lgs = s.bit_length() - 1
    g = np.arange(lanes >> js)
    b = ((g >> lgs) << (lgs + js)) | (g & (s - 1))
    members = b[:, None] + np.arange(1 << js)[None, :] * s
    assert np.array_equal(np.sort(members.ravel()), np.arange(lanes))
    for q in range(js):  # every stage's pairs lie inside one group
        dist = s << q
        lo = np.arange(lanes)[(np.arange(lanes) & dist) == 0]
        grp_of = np.empty(lanes, np.int64)
        grp_of[members.ravel()] = np.repeat(g, 1 << js)
        assert np.array_equal(grp_of[lo], grp_of[lo + dist])


def k1_pack(tc, tv):
    hi = (tc.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000
    lo = tv.astype(np.float32).view(np.uint32).astype(np.uint64)
    return (hi.astype(np.uint64) << np.uint64(32)) | lo


def k1_network(keys, kstart):
    """The bitonic network on packed keys [R, W] from merge kstart."""
    x = keys.copy()
    r, w = x.shape
    lane = np.arange(w)
    for k, j in bitonic_stages(w, kstart):
        lo = lane[(lane & j) == 0]
        a, b = x[:, lo], x[:, lo + j]
        asc = ((lo & k) == 0)[None, :]
        mn, mx = np.minimum(a, b), np.maximum(a, b)
        x[:, lo] = np.where(asc, mn, mx)
        x[:, lo + j] = np.where(asc, mx, mn)
    return x


def _combine(a, b):
    """K1's Agg combine, a before b, elementwise over arrays."""
    fa, va, ka = a
    fb, vb, kb = b
    v = np.where(fb, vb, (va + vb).astype(np.float32))
    return fa | fb, v.astype(np.float32), ka + kb


def k1_emulate(tc, tv, ncols, presorted):
    """K1's pipeline for each row: network, per-thread flags and sums,
    the shuffle-group and warp scans, the cluster's carry, compaction."""
    r, w = tc.shape
    lanes, e, tpr, sw, pair = k1_geometry(w)
    x = k1_network(k1_pack(tc, tv), 2 * presorted if presorted > 1 else 2)
    col = ((x >> np.uint64(32)).astype(np.int64) ^ 0x80000000).astype(np.int64)
    col = np.where(col >= 2 ** 31, col - 2 ** 32, col)
    key = (x >> np.uint64(32)).astype(np.uint64)
    val = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.float32)
    kout = np.full((r, w), ncols, np.int32)
    vout = np.zeros((r, w), np.float32)
    for row in range(r):
        kr, vr, cr = key[row], val[row], col[row]
        start = np.ones(w, bool)
        start[1:] = kr[1:] != kr[:-1]
        last = np.ones(w, bool)
        last[:-1] = kr[:-1] != kr[1:]
        keep = last & (cr < ncols)
        halves = []
        for h in range(2 if pair else 1):
            sl = slice(h * lanes, (h + 1) * lanes)
            st = start[sl].reshape(tpr, e)
            v = vr[sl].reshape(tpr, e)
            s = np.zeros_like(v)
            for q in range(e):  # each thread's own lanes, in order
                s[:, q] = v[:, q] if q == 0 else np.where(
                    st[:, q], v[:, q], (s[:, q - 1] + v[:, q]).astype(np.float32))
            mine = (st.any(1), s[:, -1].copy(), keep[sl].reshape(tpr, e).sum(1))
            # Kogge-Stone in shuffle groups of sw threads
            inc = tuple(np.array(m) for m in mine)
            gl = np.arange(tpr) % sw
            d = 1
            while d < sw:
                prev = tuple(np.roll(m, d) for m in inc)
                comb = _combine(prev, inc)
                inc = tuple(np.where(gl >= d, c, m) for c, m in zip(comb, inc))
                d *= 2
            ex = tuple(np.where(gl >= 1, np.roll(m, 1), 0) for m in inc)
            ex = (ex[0].astype(bool), ex[1].astype(np.float32), ex[2])
            if tpr > 32:  # warp totals in order
                wt = tuple(m[31::32] for m in inc)
                carry = (np.zeros(1, bool), np.zeros(1, np.float32), np.zeros(1, np.int64))
                wc = [carry]
                for q in range(tpr // 32 - 1):
                    carry = _combine(carry, tuple(m[q:q + 1] for m in wt))
                    wc.append(carry)
                wcs = tuple(np.concatenate([c[i] for c in wc]) for i in range(3))
                wcs = tuple(np.repeat(m, 32) for m in wcs)
                ex = _combine(wcs, ex)
            total = _combine(tuple(m[-1:] for m in ex), tuple(m[-1:] for m in mine))
            halves.append((st, s, ex, total))
        out_slot = 0
        for h, (st, s, ex, total) in enumerate(halves):
            if h == 1:  # the first half's open run goes on here
                t0 = halves[0][3]
                ex = _combine((t0[0], t0[1], np.zeros(1, np.int64)), ex)
            kp = keep[h * lanes:(h + 1) * lanes].reshape(tpr, e)
            cr_h = cr[h * lanes:(h + 1) * lanes].reshape(tpr, e)
            seen = np.cumsum(st, axis=1) > 0
            fin = np.where(seen, s, (ex[1][:, None] + s).astype(np.float32))
            slot = ex[2][:, None] + np.cumsum(kp, axis=1) - kp
            kout[row, out_slot + slot[kp]] = cr_h[kp]
            vout[row, out_slot + slot[kp]] = fin[kp]
            out_slot += int(total[2][0])
    return kout, vout


def _k1_tiles(rng, r, w, ncols, presorted, one_column=False):
    tc = rng.integers(0, ncols + 1, size=(r, w)).astype(np.int32)
    if one_column:
        tc[:] = 3
    tv = np.where(tc < ncols, rng.standard_normal((r, w)), 0.0).astype(np.float32)
    if presorted > 1:
        sh = (r, -1, presorted)
        order = np.argsort(tc.reshape(sh), axis=2, kind="stable")
        tc = np.take_along_axis(tc.reshape(sh), order, axis=2)
        tv = np.take_along_axis(tv.reshape(sh), order, axis=2)
        tc[:, 1::2] = tc[:, 1::2, ::-1]
        tv[:, 1::2] = tv[:, 1::2, ::-1]
    return np.ascontiguousarray(tc.reshape(r, w)), np.ascontiguousarray(tv.reshape(r, w))


@pytest.mark.parametrize(
    "w,presorted,ncols,one_column",
    [(1, 1, 3, False), (4, 2, 3, False), (64, 1, 20, False), (64, 8, 40, False),
     (256, 16, 50, False), (512, 1, 300, False), (2048, 64, 700, False),
     (2048, 256, 5, True), (4096, 8, 4097, False)],
)
def test_k1_emulation_matches_the_pallas_kernel(rng, w, presorted, ncols, one_column):
    tc, tv = _k1_tiles(rng, 8, w, ncols, presorted, one_column)
    jk, jv = j_sdc(jnp.asarray(tc), jnp.asarray(tv), ncols, interpret=True,
                   presorted=presorted)
    ek, ev = k1_emulate(tc, tv, ncols, presorted)
    np.testing.assert_array_equal(ek, np.asarray(jk))
    assert_close_values(ev.ravel(), np.asarray(jv).ravel())


@pytest.mark.parametrize("ncols,presorted", [(5, 64), (3000, 1), (20000, 256)])
def test_k1_emulation_of_the_cluster_halves_matches_the_twin(rng, ncols, presorted):
    """W = 32768: runs that cross the halves (few columns), more than
    16384 survivors (many), all in the two-CTA split of the emulation."""
    tc, tv = _k1_tiles(rng, 1, 32768, ncols, presorted)
    pk, pv = sort_dedup_compact_plain(torch.from_numpy(tc), torch.from_numpy(tv), ncols)
    ek, ev = k1_emulate(tc, tv, ncols, presorted)
    np.testing.assert_array_equal(ek, pk.numpy())
    assert_close_values(ev.ravel(), pv.numpy().ravel())


def test_k1_packed_order_breaks_ties_by_value_bits_and_orders_signed_columns():
    tc = np.array([[5, -2, 5, 7, 5, -2, 9, 0]], np.int32)
    tv = np.array([[3.0, 1.0, -1.0, 2.0, 0.5, 4.0, 0.0, 8.0]], np.float32)
    x = k1_network(k1_pack(tc, tv), 2)[0]
    col = ((x >> np.uint64(32)).astype(np.int64) ^ 0x80000000)
    col = np.where(col >= 2 ** 31, col - 2 ** 32, col)
    assert col.tolist() == sorted(tc[0].tolist())
    # equal columns: ascending unsigned value bits, whatever the input order
    bits = (x & np.uint64(0xFFFFFFFF)).astype(np.uint64)
    for c in (-2, 5):
        b = bits[col == c]
        assert np.all(np.diff(b.astype(np.int64)) >= 0)
    perm = np.random.default_rng(0).permutation(8)
    x2 = k1_network(k1_pack(tc[:, perm], tv[:, perm]), 2)[0]
    assert np.array_equal(x, x2)  # the order depends on the contents only


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


def _csr_parts(ja):
    rp = np.asarray(ja.row_ptr)
    nnz = int(rp[-1])
    return rp, np.asarray(ja.col_ind)[:nnz], np.asarray(ja.values)[:nnz]


K5_MATRICES = {
    # a hub block row of ~300 blocks: many pieces
    "hub": lambda rng: _hub(rng),
    "band": lambda rng: jgen.banded_csr(300, bandwidth=12, seed=2),
    "rmat": lambda rng: jgen.rmat_csr(9, edge_factor=8, seed=3, weights="random"),
    "empty_rows": lambda rng: jax_random_csr(rng, 90, 70, 0.2, range(10, 50)),
}


def _hub(rng):
    from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR

    d = np.where(rng.random((80, 2400)) < 0.01, rng.standard_normal((80, 2400)), 0.0)
    d[3, ::2] = rng.standard_normal(1200)  # every other column: 150 blocks of 8 cols
    d[40:48] = 0.0  # an empty block row
    return JCSR.from_dense(d.astype(np.float32))


@pytest.mark.parametrize("name", list(K5_MATRICES))
@pytest.mark.parametrize("br,bc", [(8, 8), (8, 16), (4, 5), (2, 128), (1, 3), (12, 200)])
def test_k5_schedule_covers_every_block_row_once(rng, name, br, bc):
    ja = K5_MATRICES[name](rng)
    _, tb = both_bcsr(ja, br, bc)
    brp = tb.block_row_ptr.numpy().astype(np.int64)
    bcol = tb.block_col.numpy()
    sched = tb.schedule
    assert sched is not None and sched.nblocks == int(brp[-1])
    assert sched.group in (1, SPMM_GROUP)
    items = sched.items.numpy().astype(np.int64)
    stages = sched.stages.numpy().astype(np.int64)
    splits = sched.splits.numpy().astype(np.int64).reshape(-1, 3)
    nbrows = brp.size - 1
    passes = -(-br // 8)
    chunks = -(-bc // SPMM_DEPTH)
    covered = np.zeros(nbrows, np.int64)
    slots = []
    if name == "band" and bc == 16:  # its block rows share block columns
        assert sched.group == SPMM_GROUP and stages[:, 3].mean() > 2
    if name == "hub" and bc == 128:  # a few scattered blocks a row: one a stage
        assert sched.group == 1
    assert items[-1, 3] == stages.shape[0]
    assert stages[:, 3].sum() == sched.nblocks * chunks * passes
    for row0, nrows, s0, s1, slot in items:
        st = stages[s0:s1]
        krow, k0, rh, fresh, nb = st[:, 0], st[:, 1], st[:, 2] >> 1, st[:, 2] & 1, st[:, 3]
        blocks, arows = st[:, 4:4 + SPMM_GROUP], st[:, 4 + SPMM_GROUP:]
        assert np.all((1 <= nb) & (nb <= sched.group))
        used = np.arange(SPMM_GROUP)[None, :] < nb[:, None]
        assert np.all(blocks[~used] == -1) and np.all(arows[~used] == -1)
        blk = blocks[used]
        nblk = np.unique(blk).size
        assert nblk <= SPMM_BLOCKS
        if slot < 0:
            assert nrows * passes <= SPMM_ROWS or nrows == 1
            covered[row0:row0 + nrows] += 1
            assert nblk == brp[row0 + nrows] - brp[row0]
        else:
            assert nrows == 1 and brp[row0 + 1] - brp[row0] > SPMM_BLOCKS
            slots.append(slot)
        # each of the item's blocks once a (depth chunk, pass)
        trip = np.stack([blk, np.repeat(k0, nb), np.repeat(rh, nb)], 1)
        assert np.unique(trip, axis=0).shape[0] == trip.shape[0] == nblk * chunks * passes
        assert set(np.unique(k0)) <= set(range(0, bc, SPMM_DEPTH))
        assert rh.size == 0 or rh.max() < passes
        # a stage's blocks share a block column; its accumulator rows
        bc_of = np.where(used, bcol[np.maximum(blocks, 0)], -1)
        assert np.all((bc_of == bc_of[:, :1]) | ~used)
        assert np.array_equal(krow, bc_of[:, 0].astype(np.int64) * bc + k0)
        brow = np.searchsorted(brp, blk, side="right") - 1
        assert np.array_equal(arows[used], (brow - row0) * passes + np.repeat(rh, nb))
        # a new B slab exactly where (block column, depth chunk) changes,
        # and each (block column, depth chunk) read in one run of stages
        key = krow
        assert fresh.size == 0 or fresh[0] == 1
        assert np.array_equal(fresh[1:], (key[1:] != key[:-1]).astype(int))
        assert np.unique(key).size == int(fresh.sum())
    for row, slot0, pieces in splits:
        covered[row] += 1
        n = brp[row + 1] - brp[row]
        assert pieces == -(-n // SPMM_BLOCKS)
        assert sorted(s for s in slots if slot0 <= s < slot0 + pieces) == list(
            range(slot0, slot0 + pieces))
    assert np.all(covered == 1)
    assert sched.slots == len(slots)
    if name == "hub" and bc <= 16:  # row 3 holds >= 150 blocks
        assert splits.shape[0] >= 1 and splits[:, 2].max() >= 3


def tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x1000) & ~np.uint64(0x1FFF)).astype(np.uint32)
    return b.view(np.float32)


def trunc_f32(x64):
    """f64 -> f32 rounded toward zero (the tensor cores' accumulation)."""
    r = x64.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x64)
    return np.where(over, np.nextafter(r, np.float32(0)), r).astype(np.float32)


def k5_emulate(tb, b, promote=True):
    """K5 on the host: items and their stages in order, each stage's
    blocks against its B slab, 3xTF32 k8 steps (tensor-core sums
    truncated) each promoted into f32 (or, with ``promote=False``, one
    truncating accumulator chained over the stage), stages added into
    their accumulator rows, pieces summed in order."""
    br, bc, rows, cols = tb.br, tb.bc, tb.rows, tb.cols
    n = b.shape[1]
    blocks = tb.blocks.numpy()
    s = tb.schedule
    passes = -(-br // 8)
    c = np.zeros((rows, n), np.float32)
    partial = np.zeros((max(s.slots, 1), br, n), np.float32)
    stages = s.stages.numpy()
    for row0, nrows, s0, s1, slot in s.items.numpy():
        acc = np.zeros((nrows * passes, 8, n), np.float32)
        for st in stages[s0:s1]:
            krow, k0, rh, nb = st[0], st[1], st[2] >> 1, st[3]
            kw = min(SPMM_DEPTH, bc - k0)
            steps = SPMM_DEPTH // 8  # past the block's depth both operands are 0
            bb = np.zeros((steps * 8, n), np.float32)
            take = max(0, min(kw, cols - krow))
            bb[:take] = b[krow:krow + take]
            bh = tf32(bb)
            bl = tf32(bb - bh)
            for blk, arow in zip(st[4:4 + nb], st[4 + SPMM_GROUP:4 + SPMM_GROUP + nb]):
                a = np.zeros((8, steps * 8), np.float32)
                part = blocks[blk, 8 * rh:8 * rh + 8, k0:k0 + kw]
                a[: part.shape[0], :kw] = part
                ah = tf32(a)
                al = tf32(a - ah)
                stage = np.zeros((8, n), np.float32)
                d = np.zeros((8, n), np.float32)
                for q in range(steps):
                    sl = slice(8 * q, 8 * q + 8)
                    if promote:  # a fresh chain every k8 step
                        d = np.zeros((8, n), np.float32)
                    for x, y in ((al, bh), (ah, bl), (ah, bh)):
                        d = trunc_f32(x[:, sl].astype(np.float64) @ y[sl].astype(np.float64)
                                      + d.astype(np.float64))
                    if promote:
                        stage = (stage + d).astype(np.float32)
                acc[arow] = (acc[arow] + (stage if promote else d)).astype(np.float32)
        out = acc.reshape(nrows, passes * 8, n)[:, :br]
        if slot >= 0:
            partial[slot] = out[0]
        else:
            r0 = row0 * br
            out = out.reshape(nrows * br, n)[: max(0, min(nrows * br, rows - r0))]
            c[r0:r0 + out.shape[0]] = out
    for row, slot0, pieces in s.splits.numpy().reshape(-1, 3):
        tot = partial[slot0].copy()
        for q in range(1, pieces):
            tot = (tot + partial[slot0 + q]).astype(np.float32)
        r0 = row * br
        c[r0:r0 + br] = tot[: max(0, min(br, rows - r0))]
    return c


def _k5_bound(ja, x):
    a = np.asarray(ja.to_dense(), np.float64)
    return a @ x.astype(np.float64), 1e-7 + 1e-4 * (np.abs(a) @ np.abs(x.astype(np.float64)))


@pytest.mark.parametrize("name,br,bc,n", [
    ("hub", 8, 16, 20), ("band", 8, 128, 37), ("rmat", 4, 5, 9), ("empty_rows", 2, 7, 16),
    ("rmat", 12, 200, 8), ("band", 1, 3, 5), ("hub", 8, 128, 11),
])
def test_k5_emulation_holds_the_f64_bound_and_matches_pallas(rng, name, br, bc, n):
    ja = K5_MATRICES[name](rng)
    jb, tb = both_bcsr(ja, br, bc)
    x = np.random.default_rng(n).standard_normal((ja.ncols, n)).astype(np.float32)
    got = k5_emulate(tb, x)
    want, bound = _k5_bound(ja, x)
    assert np.all(np.abs(got - want) <= bound)
    if br <= 8:  # the reference's Pallas kernel, interpret mode on the CPU
        pallas = np.asarray(jspmm.bcsr_spmm(jb, jnp.asarray(x), n_tile=128, kernel="pallas"))
        assert np.all(np.abs(got - pallas) <= 2 * bound)


def test_k5_promotion_is_what_keeps_long_sums_accurate():
    """The stage-wise promotion matters: one truncating accumulator over
    each 64-deep stage drifts low, its mean signed error several times
    that of the k8 steps' chains promoted into f32, as the tensor cores'
    own sums did in K7 / K8."""
    from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR

    rng = np.random.default_rng(11)
    d = (rng.random((8, 2048)) + 0.5).astype(np.float32)
    ja = JCSR.from_dense(d)
    _, tb = both_bcsr(ja, 8, 2048)
    x = (rng.random((2048, 16)) + 0.5).astype(np.float32)
    want = d.astype(np.float64) @ x.astype(np.float64)
    err_p = (k5_emulate(tb, x) - want) / want.max()
    err_t = (k5_emulate(tb, x, promote=False) - want) / want.max()
    assert np.abs(err_p).max() < 1e-6
    assert err_t.mean() < -2e-7 and abs(err_p.mean()) < abs(err_t.mean()) / 4


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------
UNWRITTEN = -0x2152411  # a value the emulated outputs start with


def k2_geometry(n, threads=256, vecs=2, max_cluster=8):
    """(G, S, piece) of K2's launch for rows of n lanes: the cluster's
    CTAs, the lanes (and output positions) a CTA owns, a piece's lanes."""
    piece = threads * 4 * vecs
    g = min(max(-(-n // piece), 1), max_cluster)
    return g, (-(-n // g) + 3) & ~3, piece


def k2_block_excl(x, threads):
    """K2's ``block_excl``: warp Kogge-Stone scans in uint32, the warp
    totals scanned by every warp; (exclusive scan, block total)."""
    mask = 0xFFFFFFFF

    def warp_incl(v):
        v = v.copy()
        d = 1
        while d < 32:
            y = np.zeros_like(v)
            y[..., d:] = v[..., :-d]
            v = (v + y) & mask
            d *= 2
        return v

    nw = threads // 32
    incl = warp_incl(x.reshape(nw, 32).astype(np.uint64))
    t = np.zeros(32, np.uint64)
    t[:nw] = incl[:, 31]
    tincl = warp_incl(t)
    before = (tincl - t)[:nw]
    excl = (before[:, None] + incl - x.reshape(nw, 32)) & mask
    return excl.reshape(-1), int(tincl[nw - 1])


def k2_write_out(cols, vals, writes, a, b, stage_c, stage_v, sh, vec, pad, ncols):
    """K2's ``write_out`` on one row: positions [a, b) from the staging
    area (slot = position - a + sh) or the padding; VEC: 16-byte vectors
    from a rounded down, whole ones stored at once, the ends by lane."""
    if a >= b:
        return
    if not vec:
        for p in range(a, b):
            cols[p] = ncols if pad else stage_c[p - a + sh]
            vals[p] = 0 if pad else stage_v[p - a + sh]
            writes[p] += 1
        return
    v0 = a & ~3
    for i in range((b - v0 + 3) >> 2):
        p = v0 + 4 * i
        c = [ncols] * 4 if pad else stage_c[4 * i:4 * i + 4]
        v = [0] * 4 if pad else stage_v[4 * i:4 * i + 4]
        whole = p >= a and p + 4 <= b
        for k in range(4):
            if whole or a <= p + k < b:
                cols[p + k], vals[p + k] = c[k], v[k]
                writes[p + k] += 1


def k2_emulate(vals, ncols, threads=256, vecs=2, max_cluster=8):
    """K2 (``csrc/compact_nonzero_rows.cu``) on [R, N] f32 rows: the
    cluster split, each CTA's count, the counts exchanged, a packed block
    scan a piece, the staged survivors shifted by the output's alignment,
    the vector writes, the padding of the positions a CTA owns.  Returns
    (cols, value bits, writes a position)."""
    assert vecs == 2  # two 16-bit counts packed in a word
    r, n = vals.shape
    g, s, piece = k2_geometry(n, threads, vecs, max_cluster)
    vec = n % 4 == 0
    bits = vals.view(np.int32)
    cols = np.full((r, n), UNWRITTEN, np.int64)
    out = np.full((r, n), UNWRITTEN, np.int64)
    writes = np.zeros((r, n), np.int64)
    t = np.arange(threads)
    for row in range(r):
        spans = []
        for rank in range(g):
            lo = min(rank * s, n)
            hi = min(lo + s, n)
            spans.append((lo, hi, min(hi, ncols), -(-(hi - lo) // piece)))

        def flags(lo, hi, lim, pc, j):
            e = lo + pc * piece + (j * threads + t) * 4
            lane = e[:, None] + np.arange(4)
            x = np.where(lane < hi, vals[row, np.minimum(lane, n - 1)], 0.0)
            return lane, (x != 0) & (lane < lim)

        cnt = []
        for lo, hi, lim, pieces in spans:
            mine = np.zeros(threads, np.uint64)
            for pc in range(pieces):
                for j in range(vecs):
                    mine += flags(lo, hi, lim, pc, j)[1].sum(1).astype(np.uint64)
            cnt.append(k2_block_excl(mine, threads)[1])
        total = sum(cnt)
        for rank, (lo, hi, lim, pieces) in enumerate(spans):
            base = sum(cnt[:rank])
            for pc in range(pieces):
                f = [flags(lo, hi, lim, pc, j) for j in range(vecs)]
                packed = f[0][1].sum(1).astype(np.uint64) | (
                    f[1][1].sum(1).astype(np.uint64) << np.uint64(16))
                excl, ptotal = k2_block_excl(packed, threads)
                sh = base & 3 if vec else 0
                stage_c = np.full(piece + 4, UNWRITTEN + 1, np.int64)
                stage_v = np.full(piece + 4, UNWRITTEN + 1, np.int64)
                slots = [excl & 0xFFFF, (ptotal & 0xFFFF) + (excl >> 16)]
                for j, (lane, keep) in enumerate(f):
                    for ti in range(threads):
                        slot = int(slots[j][ti])
                        for k in np.nonzero(keep[ti])[0]:
                            stage_c[sh + slot] = lane[ti, k]
                            stage_v[sh + slot] = bits[row, lane[ti, k]]
                            slot += 1
                m = (ptotal & 0xFFFF) + (ptotal >> 16)
                k2_write_out(cols[row], out[row], writes[row], base, base + m,
                             stage_c, stage_v, sh, vec, False, ncols)
                base += m
            k2_write_out(cols[row], out[row], writes[row], max(lo, total), hi,
                         None, None, 0, vec, True, ncols)
    return cols, out, writes


def _k2_rows(rng, r, n):
    """Rows of every kind: all zero, all nonzero, -0.0 and NaN lanes."""
    x = np.where(rng.random((r, n)) < 0.3, rng.standard_normal((r, n)), 0.0)
    x = x.astype(np.float32)
    special = rng.random((r, n))
    x[special < 0.05] = -0.0
    x[special > 0.97] = np.nan
    if r > 2:
        x[0] = 0.0
        x[1] = rng.random(n).astype(np.float32) + 0.5
    return x


@pytest.mark.parametrize("r,n,ncols,threads", [
    (1, 1, 1, 256), (1, 3, 3, 256), (3, 5, 4, 32), (4, 130, 100, 256),
    (3, 2049, 2049, 256), (3, 4097, 3000, 256), (2, 16384, 16300, 256),
    (4, 3000, 2900, 32), (3, 6001, 6001, 32), (3, 700, 0, 32),
])
def test_k2_emulation_matches_the_pallas_kernel_and_the_twin(rng, r, n, ncols, threads):
    # threads = 32 shrinks a piece to 256 lanes, so that clusters of 8
    # CTAs with several pieces each run at small widths
    x = _k2_rows(rng, r, n)
    ek, ev, writes = k2_emulate(x, ncols, threads=threads)
    assert (writes == 1).all()  # every output position once
    jk, jv = j_compact(jnp.asarray(x), ncols, interpret=True, rows_per_step=1)
    np.testing.assert_array_equal(ek, np.asarray(jk))
    np.testing.assert_array_equal(ev, np.asarray(jv).view(np.int32))
    tk, tv = compact_nonzero_rows_plain(torch.from_numpy(x), ncols)
    np.testing.assert_array_equal(ek, tk.numpy())
    np.testing.assert_array_equal(ev, tv.numpy().view(np.int32))


@pytest.mark.parametrize("n", [1, 4, 2048, 2049, 16384, 16385, 65536, 131072, 131075])
def test_k2_geometry_covers_each_row_once(n):
    g, s, piece = k2_geometry(n)
    assert 1 <= g <= 8 and s % 4 == 0 and (g == 8 or s <= piece)
    spans = [(min(k * s, n), min(min(k * s, n) + s, n)) for k in range(g)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(lo < hi for lo, hi in spans)  # no CTA without lanes
    # the scan's 16-bit halves hold a piece's count
    assert piece // 2 < 1 << 16


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------
def k3_start(p, nr, w):
    """K3's ``clipped_start`` in C integer arithmetic (division truncates
    toward zero, the remainder takes the dividend's sign)."""
    q = abs(p) // w * (1 if p >= 0 else -1)
    fq = q - (1 if p - q * w < 0 else 0)
    wr = min(max(fq, 0), nr - 2)
    return wr * w + min(max(p - wr * w, 0), w - 1)


def k3_emulate(src_c, src_v, lists, w=128):
    """K3's W = 128 kernel: per window, the aligned 16-byte vectors
    a + lane (a = start // 4) of each stream, lane 31 also a + 32 when the
    start is off the grid (every read inside the source), the right
    neighbour's vector by a shuffle, the 4 words at start % 4.  Windows
    are walked as the launch does: a window a warp, grid-stride over the
    lists one after the other."""
    assert w == 128
    t = src_c.size
    nr = t // w
    vc, vv = src_c.reshape(-1, 4), src_v.reshape(-1, 4)
    outs = [np.full((p.size, w), UNWRITTEN, np.int64) for p in lists for _ in (0, 1)]
    q_all = sum(p.size for p in lists)
    grid = min(-(-q_all // 8), 132 * 4)  # resident CTAs of 8 warps
    seen = np.zeros(q_all, np.int64)
    for warp in range(grid * 8):
        for q in range(warp, q_all, grid * 8):
            seen[q] += 1
            li, row = (0, q) if q < lists[0].size else (1, q - lists[0].size)
            s = k3_start(int(lists[li][row]), nr, w)
            a, r = s >> 2, s & 3
            for src, out in ((vc, outs[2 * li]), (vv, outs[2 * li + 1])):
                assert 0 <= a and a + 31 < src.shape[0]
                own = src[a:a + 32]
                nxt = np.empty_like(own)
                nxt[:31] = own[1:]
                if r:
                    assert a + 32 < src.shape[0]
                    nxt[31] = src[a + 32]
                words = np.concatenate([own, nxt], axis=1)
                out[row] = words[:, r:r + 4].reshape(-1)
    assert (seen == 1).all()
    return outs


def _k3_positions(rng, nr, w, q):
    """Offsets 0, 1, 3, 4, 5 and 127 at random windows, then starts
    clipped at both ends."""
    offs = np.array([0, 1, 3, 4, 5, 127])
    p = rng.integers(0, nr, q) * w + offs[np.arange(q) % offs.size]
    ends = [-1, -(2**31), -w - 3, (nr - 1) * w, (nr - 1) * w + 64, nr * w - 1, nr * w,
            nr * w + 5 * w + 1, 2**31 - 1]
    p[:min(q, len(ends))] = ends[:min(q, len(ends))]
    return p.astype(np.int32)


@pytest.mark.parametrize("nr,q0,q1", [(2, 16, 0), (6, 40, 0), (9, 24, 16), (40, 104, 48)])
def test_k3_emulation_matches_align_windows_and_the_twin(rng, nr, q0, q1):
    w = 128
    src_c = rng.integers(-(2**31), 2**31 - 1, size=nr * w).astype(np.int32)
    src_v = rng.integers(-(2**31), 2**31 - 1, size=nr * w).astype(np.int32)
    lists = [_k3_positions(rng, nr, w, q) for q in (q0, q1)]
    got = k3_emulate(src_c, src_v, lists if q1 else lists[:1])
    src = np.concatenate([src_c.reshape(-1, w), src_v.reshape(-1, w)], axis=1)
    twin = window_gather_plain(torch.from_numpy(src_c), torch.from_numpy(src_v),
                               torch.from_numpy(lists[0]), w,
                               torch.from_numpy(lists[1]) if q1 else None)
    for li, p in enumerate(lists[:2 if q1 else 1]):
        # the reference: two row takes of the window source, align_windows
        wr = np.clip(p.astype(np.int64) // w, 0, nr - 2)
        off = np.clip(p - wr * w, 0, w - 1)
        g = np.concatenate([src[wr], src[wr + 1]], axis=1)
        jc, jv = align_windows(jnp.asarray(g), jnp.asarray(off[:, None].astype(np.int32)),
                               interpret=True)
        np.testing.assert_array_equal(got[2 * li], np.asarray(jc))
        np.testing.assert_array_equal(got[2 * li + 1], np.asarray(jv))
        np.testing.assert_array_equal(got[2 * li], twin[2 * li].numpy())
        np.testing.assert_array_equal(got[2 * li + 1], twin[2 * li + 1].numpy())
