"""The port's CUDA kernels and main path on a card, held against their
plain PyTorch twins and the CPU path.  Marked ``cuda``: without a card
every test skips.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import importlib

import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu_torch import _build
from sparse_matrix_with_flops_tpu_torch.config import ABS_TOL, REL_TOL
from sparse_matrix_with_flops_tpu_torch.formats.bcsr import BCSR
from sparse_matrix_with_flops_tpu_torch.formats.coo import COO
from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR
from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
from sparse_matrix_with_flops_tpu_torch.ops.block_spgemm import block_spgemm
from sparse_matrix_with_flops_tpu_torch.ops.dispatch import spgemm_auto
from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
from sparse_matrix_with_flops_tpu_torch.ops.scan_kernels import (
    TILE,
    cumsum_i32,
    cumsum_i32_plain,
    scratch_words,
)
from sparse_matrix_with_flops_tpu_torch.ops.spmm import bcsr_spmm, bcsr_spmm_plain
from sparse_matrix_with_flops_tpu_torch.ops.sort_kernels import (
    compact_nonzero_rows,
    compact_nonzero_rows_plain,
    sort_dedup_compact,
    sort_dedup_compact_plain,
    window_gather,
    window_gather_plain,
)
from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh, sharded_rmcl_ell
from sparse_matrix_with_flops_tpu_torch.parallel.ring_kernels import (
    ring_all_gather,
    ring_all_gather_plain,
    ring_matmul,
    ring_matmul_plain,
    ring_matmul_tiled,
    ring_matmul_tiled_plain,
    unrotate,
)
from sparse_matrix_with_flops_tpu_torch.parallel.rmcl_ell import (
    plan_sharded_rmcl_ell as sharded_plan,
)
from sparse_matrix_with_flops_tpu_torch.utils.generate import banded_csr, rmat_csr

RMCL = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl_ell")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _assert_vals(got, want):
    err = (got.double() - want.double()).abs()
    bound = torch.clamp(
        REL_TOL * torch.maximum(got.abs(), want.abs()).double(), min=ABS_TOL
    )
    assert bool((err <= bound).all()), float(err.max())


def _assert_run_sums(got, tc, tv, ncols):
    """K1's sums against the twin's within 1e-7 + 1e-5 of the sum of
    the run's |values|: a bound on f32 rounding in any order, which a
    sum that cancels to near zero still meets."""
    _, want = sort_dedup_compact_plain(tc, tv, ncols)
    _, mag = sort_dedup_compact_plain(tc, tv.abs(), ncols)
    err = (got.double() - want.double()).abs()
    assert bool((err <= 1e-7 + 1e-5 * mag.double()).all()), float(err.max())


def _presorted_tiles(rng, r, w, ncols, presorted, dev):
    tc = rng.integers(0, ncols + 1, size=(r, w)).astype(np.int32)
    tv = np.where(tc < ncols, rng.random((r, w)) + 0.5, 0.0).astype(np.float32)
    if presorted > 1:
        order = np.argsort(tc.reshape(r, -1, presorted), axis=2, kind="stable")
        tc = np.take_along_axis(tc.reshape(r, -1, presorted), order, axis=2)
        tv = np.take_along_axis(tv.reshape(r, -1, presorted), order, axis=2)
        tc[:, 1::2] = tc[:, 1::2, ::-1]
        tv[:, 1::2] = tv[:, 1::2, ::-1]
    return (
        torch.from_numpy(np.ascontiguousarray(tc.reshape(r, w))).to(dev),
        torch.from_numpy(np.ascontiguousarray(tv.reshape(r, w))).to(dev),
    )


@pytest.mark.parametrize(
    "w,presorted,r",
    [
        (32, 1, 5), (64, 64, 7), (1024, 1, 9), (1024, 64, 33), (16384, 64, 3),
        (32768, 1, 3), (32768, 64, 4), (32768, 16384, 2),
    ],
)
def test_sort_dedup_compact_kernel_matches_twin(dev, w, presorted, r):
    rng = np.random.default_rng(w + presorted)
    tc, tv = _presorted_tiles(rng, r, w, w // 3 + 1, presorted, dev)
    before = sort_dedup_compact.launches
    k, v = sort_dedup_compact(tc, tv, w // 3 + 1, presorted=presorted)
    pk, pv = sort_dedup_compact_plain(tc, tv, w // 3 + 1)
    torch.cuda.synchronize()
    assert sort_dedup_compact.launches == before + 1
    assert torch.equal(k, pk)
    _assert_vals(v, pv)


@pytest.mark.parametrize("ncols", [7, 100, 40000])
def test_sort_dedup_compact_w32768_runs_across_the_pair(dev, ncols):
    # the 2-CTA kernel: few columns make runs that span the two halves;
    # many columns leave more than 16384 survivors
    rng = np.random.default_rng(ncols)
    tc, tv = _presorted_tiles(rng, 3, 32768, ncols, 64, dev)
    k, v = sort_dedup_compact(tc, tv, ncols, presorted=64)
    pk, pv = sort_dedup_compact_plain(tc, tv, ncols)
    torch.cuda.synchronize()
    assert torch.equal(k, pk)
    _assert_vals(v, pv)


def test_sort_dedup_compact_refuses_too_wide(dev):
    tc = torch.zeros((1, 65536), dtype=torch.int32, device=dev)
    tv = torch.zeros((1, 65536), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        sort_dedup_compact(tc, tv, 5)


@pytest.mark.parametrize("n,ncols", [(128, 100), (1000, 1000), (16384, 16000)])
def test_compact_nonzero_rows_kernel_matches_twin(dev, n, ncols):
    g = torch.Generator().manual_seed(n)
    x = torch.rand((37, n), generator=g)
    x = torch.where(torch.rand((37, n), generator=g) < 0.1, x, 0.0).to(dev)
    k, v = compact_nonzero_rows(x, ncols)
    pk, pv = compact_nonzero_rows_plain(x, ncols)
    torch.cuda.synchronize()
    assert torch.equal(k, pk) and torch.equal(v, pv)


def test_window_gather_kernel_matches_twin(dev):
    g = torch.Generator().manual_seed(3)
    nr, w = 40, 128
    src_c = torch.randint(-1000, 1000, (nr * w,), generator=g, dtype=torch.int32)
    src_v = torch.randint(-(2**31), 2**31 - 1, (nr * w,), generator=g, dtype=torch.int32)
    p0 = torch.randint(-500, nr * w + 500, (3001,), generator=g, dtype=torch.int32)
    args = [t.to(dev) for t in (src_c, src_v, p0)]
    k = window_gather(*args, w)
    p = window_gather_plain(*args, w)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def _k2_rows(r, n, seed, dev):
    """[r, n] f32 rows: ~10% nonzero, row 0 all zero and row 1 all
    nonzero (when r > 2), and -0.0 and NaN lanes scattered through."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((r, n), generator=g, device=dev) + 0.25
    x = torch.where(torch.rand((r, n), generator=g, device=dev) < 0.1, x, 0.0)
    special = torch.rand((r, n), generator=g, device=dev)
    x = torch.where(special < 0.02, -0.0, x)
    x = torch.where(special > 0.99, float("nan"), x)
    if r > 2:
        x[0] = 0.0
        x[1] = torch.rand(n, generator=g, device=dev) + 0.5
    return x


def _same_k2(got, want):
    # bit for bit: NaN lanes compare by their bits, -0.0 is never kept
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.parametrize("r", [1, 563])
@pytest.mark.parametrize("n", [1, 3, 127, 128, 1000, 4097, 16384, 65536, 131072])
@pytest.mark.parametrize("narrow", [False, True])
def test_compact_nonzero_rows_edge_shapes(dev, r, n, narrow):
    # one CTA a row up to 2048 lanes, clusters of 2-8 CTAs above, and
    # several 2048-lane pieces a CTA past 16384; N off the 4-lane grid
    # takes the 4-byte path
    x = _k2_rows(r, n, n + r, dev)
    ncols = max(n - n // 3 - 1, 0) if narrow else n
    before = compact_nonzero_rows.launches
    got = compact_nonzero_rows(x, ncols)
    want = compact_nonzero_rows_plain(x, ncols)
    torch.cuda.synchronize()
    assert compact_nonzero_rows.launches == before + 1
    _same_k2(got, want)
    kept = (got[0] < ncols).sum(1)
    lane = torch.arange(n, device=dev)
    assert torch.equal(kept, ((x != 0) & (lane < ncols)).sum(1))


@pytest.mark.parametrize("fill", ["zero", "nonzero", "negative_zero", "nan"])
@pytest.mark.parametrize("n", [1, 4097, 16384])
def test_compact_nonzero_rows_single_row_of_one_kind(dev, fill, n):
    value = {"zero": 0.0, "nonzero": 1.5, "negative_zero": -0.0, "nan": float("nan")}[fill]
    x = torch.full((1, n), value, device=dev)
    for ncols in (n, n // 2):
        got = compact_nonzero_rows(x, ncols)
        want = compact_nonzero_rows_plain(x, ncols)
        torch.cuda.synchronize()
        _same_k2(got, want)


def test_compact_nonzero_rows_off_the_16_byte_grid(dev):
    # a contiguous view one float past the allocation's start: the
    # kernel's 4-byte path at a width its 16-byte path would take
    r, n = 9, 16384
    base = _k2_rows(1, r * n + 1, 3, dev).reshape(-1)
    x = base[1:].view(r, n)
    assert x.data_ptr() % 16 == 4
    _same_k2(compact_nonzero_rows(x, n - 5), compact_nonzero_rows_plain(x, n - 5))


def _k3_source(nr, w, seed, dev):
    g = torch.Generator().manual_seed(seed)
    src_c = torch.randint(-(2**31), 2**31 - 1, (nr * w,), generator=g, dtype=torch.int32)
    src_v = torch.randint(-(2**31), 2**31 - 1, (nr * w,), generator=g, dtype=torch.int32)
    return src_c.to(dev), src_v.to(dev)


def _k3_positions(nr, w, q, seed, dev):
    """q positions: every offset 0..W-1 in turn, then starts clipped at
    both ends (before the source, inside its last window, past it)."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, nr, (q,), generator=g)
    p = rows * w + torch.arange(q) % w
    ends = torch.tensor([-1, -(2**31), -w - 3, (nr - 1) * w, (nr - 1) * w + w // 2,
                         nr * w - 1, nr * w, nr * w + 5 * w + 1, 2**31 - 1])
    k = min(q, ends.numel())
    p[:k] = ends[:k]
    return p.to(torch.int32).to(dev)


@pytest.mark.parametrize("w", [1, 3, 32, 64, 128, 256])
@pytest.mark.parametrize("nr,q", [(2, 1), (2, 300), (37, 3001)])
def test_window_gather_every_offset_and_clip(dev, w, nr, q):
    # W = 128 on the 16-byte grid takes the shuffle-realigning kernel,
    # every other W the 4-byte one; 3001 windows are no whole number of
    # a CTA's 16, and nr = 2 is the smallest source
    src_c, src_v = _k3_source(nr, w, w + q, dev)
    p0 = _k3_positions(nr, w, q, nr + q, dev)
    before = window_gather.launches
    got = window_gather(src_c, src_v, p0, w)
    want = window_gather_plain(src_c, src_v, p0, w)
    torch.cuda.synchronize()
    assert window_gather.launches == before + 1
    assert len(got) == 2 and all(torch.equal(a, b) for a, b in zip(got, want))


def test_window_gather_source_off_the_16_byte_grid(dev):
    nr, w = 20, 128
    src_c, src_v = _k3_source(nr + 1, w, 4, dev)
    for shift in (1, 2, 3):
        sc, sv = src_c[shift:shift + nr * w], src_v[shift:shift + nr * w]
        p0 = _k3_positions(nr, w, 700, shift, dev)
        got = window_gather(sc, sv, p0, w)
        want = window_gather_plain(sc, sv, p0, w)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("w", [128, 32])
@pytest.mark.parametrize("q0,q1", [(3001, 517), (1, 1), (0, 40), (40, 0)])
def test_window_gather_two_lists_in_one_launch(dev, w, q0, q1):
    nr = 29
    src_c, src_v = _k3_source(nr, w, 7, dev)
    p0 = _k3_positions(nr, w, q0, 8, dev)
    p1 = _k3_positions(nr, w, q1, 9, dev)
    before = window_gather.launches
    got = window_gather(src_c, src_v, p0, w, p1)
    want = window_gather_plain(src_c, src_v, p0, w, p1)
    torch.cuda.synchronize()
    assert window_gather.launches == before + 1
    assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want))
    one = window_gather(src_c, src_v, p0, w) + window_gather(src_c, src_v, p1, w)
    assert all(torch.equal(a, b) for a, b in zip(got, one))


def test_k2_and_k3_back_to_back_without_a_synchronize(dev):
    # 20 calls of each, no synchronize between them, then every result
    # held to its twin
    x = _k2_rows(563, 16384, 11, dev)
    src_c, src_v = _k3_source(700, 128, 12, dev)
    p0 = _k3_positions(700, 128, 20000, 13, dev)
    p1 = _k3_positions(700, 128, 4000, 14, dev)
    k2 = [compact_nonzero_rows(x, 16000) for _ in range(20)]
    k3 = [window_gather(src_c, src_v, p0, 128, p1) for _ in range(20)]
    torch.cuda.synchronize()
    want2 = compact_nonzero_rows_plain(x, 16000)
    want3 = window_gather_plain(src_c, src_v, p0, 128, p1)
    for got in k2:
        _same_k2(got, want2)
    for got in k3:
        assert all(torch.equal(a, b) for a, b in zip(got, want3))


def test_k2_and_k3_replay_in_a_cuda_graph_with_new_inputs(dev):
    # K2 (clusters of 8 CTAs, and a 4097-lane row on the 4-byte path) and
    # K3 (two lists) captured once, replayed on refilled inputs, each
    # replay equal to the twins and to an eager call
    g = torch.Generator(device=dev).manual_seed(15)
    rows = {n: torch.empty((37, n), device=dev) for n in (16384, 4097)}
    src_c = torch.empty(300 * 128, dtype=torch.int32, device=dev)
    src_v = torch.empty_like(src_c)
    p0 = torch.empty(5000, dtype=torch.int32, device=dev)
    p1 = torch.empty(300, dtype=torch.int32, device=dev)

    def refill():
        for n, x in rows.items():
            x.copy_(_k2_rows(37, n, int(torch.randint(0, 2**30, (1,), generator=g,
                                                      device=dev)), dev))
        for t in (src_c, src_v):
            t.copy_(torch.randint(-(2**31), 2**31 - 1, t.shape, generator=g, device=dev,
                                  dtype=torch.int32))
        for t in (p0, p1):
            t.copy_(torch.randint(-500, 300 * 128 + 500, t.shape, generator=g, device=dev,
                                  dtype=torch.int32))

    def calls():
        out = [compact_nonzero_rows(x, n - 7) for n, x in rows.items()]
        return out + [window_gather(src_c, src_v, p0, 128, p1)]

    refill()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # build, size the grids, warm the allocator
        calls()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (compact_nonzero_rows.launches, window_gather.launches)
    with torch.cuda.graph(graph):
        captured = calls()
    assert (compact_nonzero_rows.launches, window_gather.launches) == (
        before[0] + 2, before[1] + 1)
    for _ in range(3):
        refill()
        graph.replay()
        eager = calls()
        torch.cuda.synchronize()
        for (n, x), got, again in zip(rows.items(), captured, eager):
            _same_k2(got, compact_nonzero_rows_plain(x, n - 7))
            _same_k2(again, got)
        want = window_gather_plain(src_c, src_v, p0, 128, p1)
        assert all(torch.equal(a, b) for a, b in zip(captured[2], want))
        assert all(torch.equal(a, b) for a, b in zip(eager[2], want))


@pytest.mark.parametrize(
    "n",
    [
        1,
        TILE - 1,
        TILE,
        TILE + 1,
        2 * TILE + 3,
        3_000_001,
        20_000_003,  # 2442 tiles: more than the card holds resident CTAs
    ],
)
def test_cumsum_i32_kernel_matches_twin(dev, n):
    g = torch.Generator().manual_seed(n)
    x = torch.randint(-(2**30), 2**30, (n,), generator=g, dtype=torch.int32).to(dev)
    got, want = cumsum_i32(x), cumsum_i32_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)  # int32 wrap-around on both


@pytest.mark.parametrize("shift", [1, 2, 3])
@pytest.mark.parametrize("n", [5, TILE + 7, 1_000_003])
def test_cumsum_i32_kernel_on_an_unaligned_view(dev, shift, n):
    g = torch.Generator().manual_seed(shift * n)
    base = torch.randint(-(2**30), 2**30, (n + shift,), generator=g, dtype=torch.int32)
    x = base.to(dev)[shift:]  # contiguous, 4 * shift bytes off the 16-byte grid
    got = cumsum_i32(x)
    assert got.data_ptr() % 16 == x.data_ptr() % 16
    # an output off the input's alignment takes the scalar path
    other = torch.empty(n, dtype=torch.int32, device=dev)
    stream = _build.current_stream(dev)
    scratch, _ = _build.stream_scratch("cumsum_i32", dev, stream, scratch_words(n))
    _build.launch("smf_cumsum_i32", dev, x.data_ptr(), other.data_ptr(), n,
                  scratch.data_ptr(), stream=stream)
    want = cumsum_i32_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(other, want)


def test_kernels_back_to_back_without_a_synchronize(dev):
    # no synchronize between calls: a stale flag or status word of an
    # earlier launch on the stream would show as a wrong result
    g = torch.Generator().manual_seed(5)
    scans, gathers = [], []
    for i, n in enumerate([TILE * 300 + 1, 17, TILE * 40, 5_000_000, 3, TILE * 300 + 1]):
        x = torch.randint(-(2**30), 2**30, (n,), generator=g, dtype=torch.int32).to(dev)
        scans.append((x, cumsum_i32(x)))
        d = (2, 8, 4, 3, 1, 4)[i]
        xc = torch.randint(0, 2**30, (d, 4096 // d + i, 128), generator=g,
                           dtype=torch.int32).to(dev)
        xv = torch.rand((d, 4096 // d + i, 128), generator=g).to(dev)
        gathers.append((xc, xv, ring_all_gather(xc, xv)))
    for _ in range(20):
        scans.append((scans[0][0], cumsum_i32(scans[0][0])))
        gathers.append((*gathers[0][:2], ring_all_gather(*gathers[0][:2])))
    torch.cuda.synchronize()
    for x, got in scans:
        assert torch.equal(got, cumsum_i32_plain(x))
    for xc, xv, (gc, gv) in gathers:
        assert torch.equal(gc, ring_all_gather_plain(xc))
        assert torch.equal(gv, ring_all_gather_plain(xv))


def test_kernels_replay_in_a_cuda_graph_with_new_inputs(dev):
    # a captured launch reuses its captured arguments at every replay: K4
    # and K6 must not carry a status word or flag of one replay into the
    # next, nor read the scratch of the eager calls around the graph
    g = torch.Generator().manual_seed(9)
    x = torch.empty(TILE * 40 + 5, dtype=torch.int32, device=dev)
    xc = torch.empty((4, 1000, 128), dtype=torch.int32, device=dev)
    xv = torch.empty((4, 1000, 128), dtype=torch.float32, device=dev)

    def refill():
        x.copy_(torch.randint(-(2**30), 2**30, x.shape, generator=g, dtype=torch.int32))
        xc.copy_(torch.randint(-(2**30), 2**30, xc.shape, generator=g, dtype=torch.int32))
        xv.copy_(torch.randn(xv.shape, generator=g))

    refill()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # build, size the grids, warm the allocator
        cumsum_i32(x), ring_all_gather(xc, xv)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (cumsum_i32.launches, ring_all_gather.launches)
    with torch.cuda.graph(graph):
        scan = cumsum_i32(x)
        gc, gv = ring_all_gather(xc, xv)
    assert (cumsum_i32.launches, ring_all_gather.launches) == (before[0] + 1, before[1] + 1)
    for _ in range(3):
        refill()
        graph.replay()
        eager = (cumsum_i32(x), ring_all_gather(xc, xv))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(scan, cumsum_i32_plain(x)) and torch.equal(eager[0], scan)
        assert torch.equal(gc, ring_all_gather_plain(xc))
        assert torch.equal(gv, ring_all_gather_plain(xv))
        assert torch.equal(eager[1][0], gc) and torch.equal(eager[1][1], gv)


def test_k1_and_k5_replay_in_a_cuda_graph_with_new_inputs(dev):
    # K1 (one-CTA rows and the W = 32768 cluster) and K5 (a split hub row:
    # its second kernel and the scratch slots) captured once, replayed on
    # refilled inputs, each replay equal to an eager call bit for bit
    g = torch.Generator().manual_seed(10)
    tiles = {w: (torch.empty((r, w), dtype=torch.int32, device=dev),
                 torch.empty((r, w), dtype=torch.float32, device=dev))
             for w, r in ((64, 37), (8192, 5), (32768, 2))}
    rng = np.random.default_rng(10)
    d = np.where(rng.random((40, 3000)) < 0.02, 1.0, 0.0)
    d[5, ::3] = 1.0  # 125 blocks of 8 columns: four pieces
    a = BCSR.from_csr(CSR.from_dense(d.astype(np.float32), device="cpu"), 8, 8).to(dev)
    assert a.schedule.splits.shape[0] >= 1
    b = torch.empty((3000, 70), device=dev)

    def refill():
        for w, (tc, tv) in tiles.items():
            tc.copy_(torch.randint(0, w // 4 + 1, tc.shape, generator=g, dtype=torch.int32))
            tv.copy_(torch.randn(tv.shape, generator=g))
        a.blocks.copy_(torch.randn(a.blocks.shape, generator=g).to(dev) * (a.blocks != 0))
        b.copy_(torch.randn(b.shape, generator=g))

    def calls():
        out = [sort_dedup_compact(tc, tv, w // 4) for w, (tc, tv) in tiles.items()]
        return out + [bcsr_spmm(a, b)]

    refill()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # build, size the grids, warm the allocator
        calls()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (sort_dedup_compact.launches, bcsr_spmm.launches)
    with torch.cuda.graph(graph):
        captured = calls()
    assert (sort_dedup_compact.launches, bcsr_spmm.launches) == (before[0] + 3, before[1] + 1)
    for _ in range(3):
        refill()
        graph.replay()
        eager = calls()
        torch.cuda.synchronize()
        for (w, (tc, tv)), got, again in zip(tiles.items(), captured, eager):
            pk, _ = sort_dedup_compact_plain(tc, tv, w // 4)
            assert torch.equal(got[0], pk) and torch.equal(again[0], got[0])
            _assert_run_sums(got[1], tc, tv, w // 4)
            assert torch.equal(again[1], got[1])
        bound = 1e-7 + 1e-4 * (a.to_dense().abs() @ b.abs())
        assert bool(((captured[3] - bcsr_spmm_plain(a, b)).abs() <= bound).all())
        assert torch.equal(eager[3], captured[3])


def test_constructors_default_to_the_card(dev):
    a = rmat_csr(8, edge_factor=4, seed=1)
    assert a.device == dev and a.col_ind.device == dev and a.values.device == dev
    c = COO.from_numpy([0, 1], [1, 0], [1.0, 2.0], 2, 2)
    assert c.device == dev and c.nnz.device == dev
    assert banded_csr(64, bandwidth=2).device == dev
    assert CSR.from_dense(np.eye(3, dtype=np.float32)).device == dev
    _same_csr(a, rmat_csr(8, edge_factor=4, seed=1, device="cpu"))


def test_wrappers_refuse_mixed_devices(dev):
    with pytest.raises(ValueError):
        sort_dedup_compact(
            torch.zeros((1, 64), dtype=torch.int32, device=dev),
            torch.zeros((1, 64), dtype=torch.float32),
            5,
        )


def _same_csr(got, want):
    assert torch.equal(got.row_ptr.cpu(), want.row_ptr.cpu())
    nnz = int(want.row_ptr[-1])
    assert torch.equal(got.col_ind[:nnz].cpu(), want.col_ind[:nnz].cpu())
    _assert_vals(got.values[:nnz].cpu(), want.values[:nnz].cpu())


def test_spgemm_ell_on_card_matches_cpu_path(dev):
    a = rmat_csr(10, edge_factor=8, seed=7, weights="random", device="cpu")
    plan = plan_ell(a, a, max_w=512)
    assert plan.hub_groups and plan.vstart is not None
    want = E.spgemm_ell(a, a, plan)
    ad = a.to(dev)
    dplan = plan_ell(ad, ad, max_w=512)
    _same_csr(E.spgemm_ell(ad, ad, dplan), want)
    _same_csr(E.spgemm_ell(ad, ad, dplan), want)  # fused second call


def test_spgemm_auto_band_on_card_matches_cpu_path(dev):
    # positive values: no entry cancels, so a relative bound holds
    # whatever the summation order
    band = banded_csr(3000, bandwidth=32, device="cpu")
    a = CSR(band.row_ptr, band.col_ind, band.values.abs(), band.ncols)
    _same_csr(spgemm_auto(a.to(dev), a.to(dev)), block_spgemm(a, a))


def test_spgemm_ell_w32768_bin_on_card_matches_cpu_path(dev):
    a = rmat_csr(10, edge_factor=16, seed=7, weights="random", device="cpu")
    plan = plan_ell(a, a, max_w=32768)
    assert 32768 in [w for w, _, _, _ in plan.bins]
    want = E.spgemm_ell(a, a, plan)
    ad = a.to(dev)
    before = sort_dedup_compact.launches
    got = E.spgemm_ell(ad, ad, plan_ell(ad, ad, max_w=32768))
    assert sort_dedup_compact.launches > before
    _same_csr(got, want)


# ---- K5 bcsr_spmm ------------------------------------------------------------
@pytest.mark.parametrize(
    "rows,cols,density,br,bc,n",
    [
        (64, 64, 0.1, 8, 8, 1),
        (64, 64, 0.1, 8, 16, 300),
        (37, 45, 0.2, 8, 16, 129),
        (37, 45, 0.2, 3, 5, 100),
        (50, 70, 0.3, 1, 128, 128),
        (50, 70, 0.3, 2, 7, 64),
        (60, 300, 0.05, 12, 200, 257),  # two row passes, two column stages
        (200, 500, 0.02, 8, 128, 513),
    ],
)
def test_bcsr_spmm_kernel_matches_twin(dev, rows, cols, density, br, bc, n):
    rng = np.random.default_rng(rows + n)
    d = np.where(rng.random((rows, cols)) < density, rng.standard_normal((rows, cols)), 0.0)
    d[rows // 4 : rows // 2] = 0.0  # empty block rows in the middle
    a = BCSR.from_csr(CSR.from_dense(d.astype(np.float32), device="cpu"), br, bc).to(dev)
    b = torch.from_numpy(rng.standard_normal((cols, n)).astype(np.float32)).to(dev)
    junk = torch.full((rows, n), float("nan"), device=dev)
    del junk  # the caching allocator hands this block to the output
    before = bcsr_spmm.launches
    got = bcsr_spmm(a, b)
    want = bcsr_spmm_plain(a, b)
    torch.cuda.synchronize()
    assert bcsr_spmm.launches == before + 1
    bound = 1e-7 + 1e-5 * (torch.from_numpy(np.abs(d)).to(dev).float() @ b.abs())
    assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())
    assert not got[rows // 4 : rows // 2].any()  # NaN junk never leaks


# every power-of-two width, every presorted hint below it, and the tiles
# that stress K1's design: one column (the longest run), all sentinel,
# runs of 33 lanes (across threads, warps and the cluster's halves), and
# a row count that leaves a partial CTA of rows
K1_WIDTHS = [2 ** p for p in range(1, 16)]


def _k1_edge_tiles(rng, case, w, presorted, dev):
    ncols = max(w // 3, 4)
    r = 37 if case == "ragged_rows" else 3
    if case == "one_column":
        tc = np.full((r, w), 2, np.int32)
    elif case == "all_sentinel":
        tc = np.full((r, w), ncols, np.int32)
    elif case == "runs_of_33":
        tc = np.minimum(np.arange(w) // 33, ncols).astype(np.int32)[None].repeat(r, 0)
        tc = np.take_along_axis(tc, rng.permuted(np.tile(np.arange(w), (r, 1)), axis=1), 1)
    else:
        tc = rng.integers(0, ncols + 1, size=(r, w)).astype(np.int32)
    tv = np.where(tc < ncols, rng.standard_normal((r, w)), 0.0).astype(np.float32)
    tv[:, ::5] = 1.0  # exact duplicates of values inside runs
    if presorted > 1:
        sh = (r, -1, presorted)
        order = np.argsort(tc.reshape(sh), axis=2, kind="stable")
        tc = np.take_along_axis(tc.reshape(sh), order, axis=2)
        tv = np.take_along_axis(tv.reshape(sh), order, axis=2)
        tc[:, 1::2] = tc[:, 1::2, ::-1]
        tv[:, 1::2] = tv[:, 1::2, ::-1]
    return (ncols, torch.from_numpy(np.ascontiguousarray(tc.reshape(r, w))).to(dev),
            torch.from_numpy(np.ascontiguousarray(tv.reshape(r, w))).to(dev))


@pytest.mark.parametrize("case", ["one_column", "all_sentinel", "runs_of_33", "ragged_rows"])
@pytest.mark.parametrize("w", K1_WIDTHS)
def test_sort_dedup_compact_edge_tiles_at_every_width(dev, w, case):
    rng = np.random.default_rng(w)
    presorted = 1
    while presorted <= max(w // 2, 1):
        ncols, tc, tv = _k1_edge_tiles(rng, case, w, presorted, dev)
        k, v = sort_dedup_compact(tc, tv, ncols, presorted=presorted)
        k2, v2 = sort_dedup_compact(tc, tv, ncols, presorted=presorted)
        pk, _ = sort_dedup_compact_plain(tc, tv, ncols)
        torch.cuda.synchronize()
        assert torch.equal(k, pk), (presorted, case)
        _assert_run_sums(v, tc, tv, ncols)
        assert torch.equal(k2, k) and torch.equal(v2, v)  # bit for bit
        presorted *= 2


@pytest.mark.parametrize("br", [1, 2, 4, 8])
@pytest.mark.parametrize("bc,n", [(13, 70), (100, 130), (128, 1)])
def test_bcsr_spmm_hub_and_edge_shapes(dev, br, bc, n):
    # a hub block row of several 32-block pieces, empty block rows, and B
    # rows past cols (cols not a multiple of bc)
    rng = np.random.default_rng(br * 1000 + bc)
    rows, cols = 70, 40 * bc + bc // 2
    d = np.where(rng.random((rows, cols)) < 0.01, rng.standard_normal((rows, cols)), 0.0)
    d[3, ::max(bc // 2, 1)] = rng.standard_normal(d[3, ::max(bc // 2, 1)].shape)  # ~80 blocks
    d[20:40] = 0.0
    a = BCSR.from_csr(CSR.from_dense(d.astype(np.float32), device="cpu"), br, bc).to(dev)
    assert a.schedule.splits.shape[0] >= 1 and int(a.schedule.splits[:, 2].max()) >= 2
    b = torch.from_numpy(rng.standard_normal((cols, n)).astype(np.float32)).to(dev)
    got = bcsr_spmm(a, b)
    again = bcsr_spmm(a, b)
    want = bcsr_spmm_plain(a, b)
    torch.cuda.synchronize()
    bound = 1e-7 + 1e-4 * (torch.from_numpy(np.abs(d)).to(dev).float() @ b.abs())
    assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())
    assert torch.equal(again, got)  # no atomics
    assert not got[20:40].any()


@pytest.mark.parametrize("kind,group", [("band", 4), ("rmat", 1)])
def test_bcsr_spmm_both_stage_widths(dev, kind, group):
    # K5's instances of four blocks a stage (a band: its block rows share
    # block columns) and of one (a power law)
    x = (banded_csr(3000, bandwidth=20, seed=4, device="cpu") if kind == "band"
         else rmat_csr(12, edge_factor=8, seed=4, weights="random", device="cpu"))
    a = BCSR.from_csr(x, 8, 128).to(dev)
    assert a.schedule.group == group
    b = torch.randn((x.rows, 200), generator=torch.Generator().manual_seed(4)).to(dev)
    got = bcsr_spmm(a, b)
    again = bcsr_spmm(a, b)
    want = bcsr_spmm_plain(a, b)
    torch.cuda.synchronize()
    bound = 1e-7 + 1e-4 * (a.to_dense().abs() @ b.abs())
    assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())
    assert torch.equal(again, got)


def test_bcsr_spmm_all_empty_launches_nothing(dev):
    zeros = CSR.from_dense(np.zeros((20, 30), np.float32), device="cpu")
    a = BCSR.from_csr(zeros, 8, 16).to(dev)
    before = bcsr_spmm.launches
    got = bcsr_spmm(a, torch.ones((30, 5), device=dev), kernel="pallas")
    assert bcsr_spmm.launches == before
    assert got.shape == (20, 5) and not got.any()


# ---- K6-K8: the ring kernels, and the R-MCL paths that launch them ----------------
def _ring_operands(d, m, lr, n, seed, dev):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((d, m, d * lr), generator=g).to(dev)
    b = torch.randn((d, lr, n), generator=g).to(dev)
    return a, b


@pytest.mark.parametrize(
    "d,lr,w,dtype",
    [
        (1, 7, 3, torch.int32),  # no hop: the kernel copies block 0
        (2, 4096, 128, torch.float32),
        (3, 1001, 1, torch.int32),  # 1001 words: not a multiple of a CTA's 256-lane slice
        (4, 5, 3, torch.float32),  # 15 words: no 16-byte vector path
        (8, 2048, 128, torch.int32),
        (17, 64, 5, torch.float32),  # 17 rank pointers an operand list
    ],
)
def test_ring_all_gather_kernel_matches_twin(dev, d, lr, w, dtype):
    g = torch.Generator().manual_seed(d * lr)
    x = torch.randint(-(2**20), 2**20, (d, lr, w), generator=g, dtype=torch.int32)
    x = (x if dtype == torch.int32 else x.float() / 7).to(dev)
    before = ring_all_gather.launches
    got, want = ring_all_gather(x), ring_all_gather_plain(x)
    torch.cuda.synchronize()
    assert ring_all_gather.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(unrotate(got), x.reshape(1, d * lr, w).expand(d, -1, -1))


@pytest.mark.parametrize(
    "d,lr,w",
    [(1, 7, 3), (2, 4096, 128), (3, 1001, 1), (4, 5, 3), (8, 2048, 128), (8, 3, 5),
     (9, 100, 3)],  # 18 rank pointers an operand list
)
def test_ring_all_gather_kernel_two_operands_in_one_launch(dev, d, lr, w):
    g = torch.Generator().manual_seed(d + lr)
    xc = torch.randint(-(2**30), 2**30, (d, lr, w), generator=g, dtype=torch.int32).to(dev)
    xv = torch.randn((d, lr, w), generator=g).to(dev)
    before = ring_all_gather.launches
    gc, gv = ring_all_gather(xc, xv)
    torch.cuda.synchronize()
    assert ring_all_gather.launches == before + 1
    assert torch.equal(gc, ring_all_gather_plain(xc))
    assert torch.equal(gv, ring_all_gather_plain(xv))


@pytest.mark.parametrize(
    "d,m,lr,n,nt",
    [
        (2, 1, 64, 256, 128),  # M = 1
        (4, 1, 100, 300, 300),  # M = 1, N = nt, odd widths
        (8, 5, 64, 256, 128),  # d = 8
        (8, 33, 17, 96, 96),  # d = 8, N = nt
        (1, 70, 200, 512, 256),  # d = 1: no hop
        (4, 297, 512, 4096, 2048),
        (3, 37, 50, 200, 100),  # odd d; lr not a multiple of 4: A loaded without TMA
        (2, 400, 64, 256, 128),  # M above one CTA's 384 rows: two row chunks
        (2, 200, 48, 384, 384),  # 193-256 rows: four warpgroups of one m64 tile
        (2, 10, 12, 90, 90),  # N not a multiple of 4: B staged by 4-byte loads
        (4, 400, 96, 768, 128),  # two row chunks, six N tiles over two buffer slots
        (3, 8, 40, 640, 64),  # lr not a multiple of the 16-deep stage; ten N tiles
        (2, 20, 36, 200, 100),  # N tile not a multiple of the 64-column strip
        (2, 64, 4096, 4096, 4096),  # K7's strips without N tiles at full depth
        (4, 297, 4096, 4096, 2048),  # the D = 4 main path's M, lr and nt
    ],
)
def test_ring_matmul_kernels_match_twins(dev, d, m, lr, n, nt):
    a, b = _ring_operands(d, m, lr, n, d + m + n, dev)
    # |A||B| bounds the f32 rounding of any summation order
    bound = 1e-7 + 1e-4 * torch.matmul(a.abs(), b.abs().reshape(d * lr, n))
    for fn, twin, counter in (
        (lambda: ring_matmul(a, b), lambda: ring_matmul_plain(a, b), ring_matmul),
        (lambda: ring_matmul_tiled(a, b, nt), lambda: ring_matmul_tiled_plain(a, b, nt),
         ring_matmul_tiled),
    ):
        before = counter.launches
        got, want = fn(), twin()
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert bool(torch.isfinite(got).all())
        assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())


@pytest.mark.parametrize("d,lr", [(2, 16), (4, 8), (1, 32)])
def test_ring_matmul_kernels_keep_the_bits_below_tf32(dev, d, lr):
    # every entry 1 + 2^-12: its low part lies below TF32's 10-bit mantissa,
    # so one TF32 pass gives K instead of K (1 + 2^-11 + 2^-24), an error of
    # 4.9e-4 of |A||B|, and a dropped cross term (hi.lo or lo.hi) one of
    # 2.4e-4; three passes leave the lo.lo term, 6e-8.  K = d * lr = 32.
    m, n, nt = 5, 192, 64
    x = 1.0 + 2.0**-12
    a = torch.full((d, m, d * lr), x, device=dev)
    b = torch.full((d, lr, n), x, device=dev)
    exact = torch.full((d, m, n), d * lr * x * x, dtype=torch.float64, device=dev)
    bound = 1e-5 * d * lr * x * x  # |A||B|
    for fn in (lambda: ring_matmul(a, b), lambda: ring_matmul_tiled(a, b, nt)):
        err = (fn().double() - exact).abs()
        torch.cuda.synchronize()
        assert bool((err <= bound).all()), float(err.max())


def test_default_mesh_runs_sharded_rmcl_on_the_card(dev):
    # make_mesh() with no device is the card, so a host graph runs there
    t = _rmcl_graph(256, 0.03, (5, 130), 1)
    mesh = make_mesh(4)
    assert mesh.device.type == "cuda"
    before = ring_matmul_tiled.launches
    got, _ = sharded_rmcl_ell(t, mesh, max_iters=2, S=128, max_tile=1024,
                              exchange="fused_ring")
    assert ring_matmul_tiled.launches > before
    assert got.row_ptr.device.type == "cuda"
    want, _ = sharded_rmcl_ell(t, make_mesh(4, "cpu"), max_iters=2, S=128,
                               max_tile=1024, exchange="fused_ring")
    _ell_same(got, want)


def test_ring_matmul_tiled_refuses_n_not_a_multiple_of_nt(dev):
    a, b = _ring_operands(2, 4, 8, 300, 0, dev)
    with pytest.raises(ValueError):
        ring_matmul_tiled(a, b, nt=256)


@pytest.mark.parametrize("which", ["all_gather", "matmul", "tiled"])
def test_ring_grid_too_large_for_co_residency_raises(dev, which):
    # every CTA must be resident at once: with more ranks than the card
    # holds CTAs (at most 2048 threads on each SM, 256 a CTA), not even
    # one CTA a rank fits, the launch is refused, the wrapper raises and
    # nothing hangs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    d = 8 * sms + 1
    with pytest.raises(RuntimeError):
        if which == "all_gather":
            ring_all_gather(torch.zeros((d, 1, 1), dtype=torch.int32, device=dev))
        else:
            a, b = _ring_operands(d, 1, 1, 1, 1, dev)
            if which == "matmul":
                ring_matmul(a, b)
            else:
                ring_matmul_tiled(a, b, nt=1)
    torch.cuda.synchronize()  # the device is still usable


def _rmcl_graph(n, p, hubs, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < p
    np.fill_diagonal(mask, True)
    for r in hubs:
        mask[r, :] = True
    dense = np.where(mask, 1.0, 0.0).astype(np.float32)
    return CSR.from_dense(dense, device="cpu").aver_and_norm_rows()


def _ell_same(got, want):
    g, w = got.make_ordered()._drop_explicit_zeros(), want.make_ordered()._drop_explicit_zeros()
    assert g.to("cpu").is_raw_equal(w.to("cpu"), tol=1e-5)


def test_rmcl_ell_on_card_matches_cpu_path(dev):
    # W = 128 ... 1024 bins take K1; the hub row takes the dense product
    t = _rmcl_graph(300, 0.02, (7,), 0)
    want, wh = RMCL.rmcl_ell(t, max_iters=3, S=128, max_tile=1024)
    before = sort_dedup_compact.launches
    got, gh = RMCL.rmcl_ell(t.to(dev), max_iters=3, S=128, max_tile=1024)
    assert sort_dedup_compact.launches > before
    _ell_same(got, want)
    np.testing.assert_array_equal(gh["nnz"], wh["nnz"])


@pytest.mark.parametrize("exchange", ["all_gather", "pallas_ring", "ring", "fused_ring"])
def test_sharded_rmcl_on_card_matches_cpu_path(dev, exchange):
    t = _rmcl_graph(256, 0.03, (5, 130), 1)
    want, _ = sharded_rmcl_ell(t, make_mesh(4, "cpu"), max_iters=2, S=128, max_tile=1024,
                               exchange=exchange)
    counts = [w.launches for w in (ring_all_gather, ring_matmul_tiled)]
    got, _ = sharded_rmcl_ell(t.to(dev), make_mesh(4, dev), max_iters=2, S=128,
                              max_tile=1024, exchange=exchange)
    assert got.row_ptr.device.type == "cuda"
    after = [w.launches for w in (ring_all_gather, ring_matmul_tiled)]
    assert (after[0] > counts[0]) == (exchange == "pallas_ring")
    assert (after[1] > counts[1]) == (exchange == "fused_ring")
    _ell_same(got, want)


def test_fused_ring_without_hub_rows_launches_no_k8(dev):
    t = _rmcl_graph(256, 0.02, (), 2)
    plan = sharded_plan(t, 4, S=128, max_tile=8192)[0]
    assert plan.hmax == 0
    before = ring_matmul_tiled.launches
    sharded_rmcl_ell(t.to(dev), make_mesh(4, dev), max_iters=2, S=128, max_tile=8192,
                     exchange="fused_ring")
    assert ring_matmul_tiled.launches == before


def test_pallas_ring_equals_all_gather_on_card(dev):
    t = _rmcl_graph(512, 0.02, (9,), 3).to(dev)
    mesh = make_mesh(4, dev)
    ag, hag = sharded_rmcl_ell(t, mesh, max_iters=3, S=128, max_tile=1024,
                               exchange="all_gather")
    pr, hpr = sharded_rmcl_ell(t, mesh, max_iters=3, S=128, max_tile=1024,
                               exchange="pallas_ring")
    assert torch.equal(ag.row_ptr, pr.row_ptr) and torch.equal(ag.col_ind, pr.col_ind)
    assert torch.equal(ag.values, pr.values)
    for k in hag:
        np.testing.assert_array_equal(hpr[k], hag[k])


# ---- general R-MCL and ingestion on the card ----------------------------------
def _rmcl_init_s12(dev):
    from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl_init

    g = rmat_csr(12, edge_factor=8, seed=3, device="cpu")
    rp, ci, v = g.to_numpy()
    coo = COO.from_numpy(np.repeat(np.arange(g.rows), np.diff(rp)), ci, v, g.rows, g.rows,
                         capacity=ci.size + g.rows, device=dev)
    return rmcl_init(coo)


def test_rmcl_scan_makes_no_host_read(dev):
    from sparse_matrix_with_flops_tpu_torch.models.rmcl import plan_capacities, rmcl_scan

    mt0 = _rmcl_init_s12(dev)
    pc, cc = plan_capacities(mt0, mt0, 2.5)
    mt = mt0.with_capacity(cc)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, hist = rmcl_scan(mt0, mt, pc, cc, 4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.device.type == "cuda" and hist["nnz"].device.type == "cuda"
    assert not bool(hist["overflow"].any())


def test_rmcl_scan_equals_loop_on_the_card(dev):
    from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl

    mt0 = _rmcl_init_s12(dev)
    scan = rmcl(mt0, max_iters=5, mode="scan", margin=2.5)
    loop = rmcl(mt0, max_iters=5, mode="loop", margin=2.5)
    assert scan.mt.device.type == "cuda" and not scan.overflow
    for x, y in zip(scan.mt.to_numpy(), loop.mt.to_numpy()):
        np.testing.assert_array_equal(x, y)  # the steps are deterministic
    np.testing.assert_array_equal(scan.nnz_history, loop.nnz_history)
    # and equal to the CPU path's within the comparators
    cpu = rmcl(mt0.to("cpu"), max_iters=5, mode="loop", margin=2.5)
    np.testing.assert_array_equal(cpu.nnz_history, loop.nnz_history)
    rg, cg, vg = loop.mt.to_numpy()
    rc, cc_, vc = cpu.mt.to_numpy()
    np.testing.assert_array_equal(rg, rc)
    np.testing.assert_array_equal(cg, cc_)
    _assert_vals(torch.from_numpy(vg), torch.from_numpy(vc))


def test_run_sums_are_deterministic_on_the_card(dev):
    from sparse_matrix_with_flops_tpu_torch.ops.segments import run_sums

    g = torch.Generator().manual_seed(0)
    lens = torch.randint(0, 300, (20000,), generator=g)
    vals = torch.rand(int(lens.sum()), generator=g)
    off = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(lens, 0)])
    got = run_sums(vals.to(dev), off.to(dev))
    assert torch.equal(got, run_sums(vals.to(dev), off.to(dev)))
    want = torch.zeros(lens.numel(), dtype=torch.float64).index_add_(
        0, torch.repeat_interleave(torch.arange(lens.numel()), lens), vals.double())
    _assert_vals(got.cpu(), want.float())


def test_load_coo_lands_on_the_card_by_default(dev):
    from sparse_matrix_with_flops_tpu_torch.io import load_coo

    coo = load_coo("tests/tdatas/tdata.snap")
    assert coo.device == dev and coo.row.device == dev and coo.nnz.device == dev
    cpu = load_coo("tests/tdatas/tdata.snap", device="cpu")
    for k in ("row", "col", "val", "nnz"):
        assert torch.equal(getattr(coo, k).cpu(), getattr(cpu, k))
