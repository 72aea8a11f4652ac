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
    MAX_MATMUL_RANKS,
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

from torch_port_util import same_bits

RMCL = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl_ell")
PS = importlib.import_module("sparse_matrix_with_flops_tpu_torch.parallel.rmcl_ell")

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


def _unbounded_ring_library(tmp_path):
    """``csrc/ring.cu`` built with its flag waits unbounded (the trap
    after ``kWaitNs`` cut out), as a library of its own."""
    import ctypes
    import os
    import subprocess

    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    with open(os.path.join(csrc, "ring.cu")) as f:
        src = f.read()
    bound = "    if (global_ns() - t0 > kWaitNs) __trap();\n"
    assert src.count(bound) == 1
    cu, so = tmp_path / "ring_unbounded.cu", tmp_path / "ring_unbounded.so"
    cu.write_text(src.replace(bound, ""))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-shared", "-o", str(so),
                    str(cu), os.path.join(csrc, "errors.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for table, extra in ((_build._SIGNATURES, (ctypes.c_void_p,)), (_build._QUERIES, ())):
        for fn, argtypes in table.items():
            if fn.startswith("smf_ring"):
                getattr(lib, fn).argtypes = (*argtypes, *extra)
                getattr(lib, fn).restype = ctypes.c_int
    lib.smf_error_string.argtypes = (ctypes.c_int,)
    lib.smf_error_string.restype = ctypes.c_char_p
    return lib


def test_bounded_flag_waits_keep_the_stacked_bits(dev, tmp_path, monkeypatch):
    """The stacked K6 and K8 give the same bits with the bounded flag
    waits as with the waits unbounded, at the D = 4 main path's widths."""
    g = torch.Generator().manual_seed(12)
    xc = torch.randint(-(2**30), 2**30, (4, 4096, 128), generator=g, dtype=torch.int32).to(dev)
    xv = torch.randn((4, 4096, 128), generator=g).to(dev)
    a, b = _ring_operands(4, 297, 512, 4096, 12, dev)

    def run():
        gc, gv = ring_all_gather(xc, xv)
        c = ring_matmul_tiled(a, b, 2048)
        torch.cuda.synchronize()
        return gc, gv, c

    bounded = run()
    lib = _unbounded_ring_library(tmp_path)
    monkeypatch.setattr(_build, "library", lambda: lib)
    unbounded = run()
    for x, y in zip(bounded, unbounded):
        assert torch.equal(x, y)
    assert torch.equal(bounded[0], ring_all_gather_plain(xc))


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
    # holds CTAs, not even one CTA a rank fits, the launch is refused, the
    # wrapper raises and nothing hangs.  K6: at most 2048 threads on each
    # SM, 256 a CTA; K7 / K8 at M = 300: one CTA of 221 KB of shared
    # memory an SM, so one rank more than the SMs (within the ranks their
    # launch parameters hold)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    d = 8 * sms + 1 if which == "all_gather" else sms + 1
    assert which == "all_gather" or d <= MAX_MATMUL_RANKS
    with pytest.raises(RuntimeError):
        if which == "all_gather":
            ring_all_gather(torch.zeros((d, 1, 1), dtype=torch.int32, device=dev))
        else:
            a, b = _ring_operands(d, 300, 1, 1, 1, dev)
            if which == "matmul":
                ring_matmul(a, b)
            else:
                ring_matmul_tiled(a, b, nt=1)
    torch.cuda.synchronize()  # the device is still usable


def test_ring_matmul_at_the_most_ranks_the_launch_parameters_hold(dev):
    # every rank's pointers and TMA map travel in the launch's parameters:
    # MAX_MATMUL_RANKS ranks run (at M = 1, two CTAs an SM), one more is
    # refused by the wrapper before any launch
    for d in (MAX_MATMUL_RANKS, MAX_MATMUL_RANKS + 1):
        a, b = _ring_operands(d, 1, 4, 64, d, dev)
        calls = ((ring_matmul, lambda: ring_matmul(a, b), lambda: ring_matmul_plain(a, b)),
                 (ring_matmul_tiled, lambda: ring_matmul_tiled(a, b, 64),
                  lambda: ring_matmul_tiled_plain(a, b, 64)))
        for counter, fn, twin in calls:
            before = counter.launches
            if d > MAX_MATMUL_RANKS:
                with pytest.raises(ValueError, match="launch parameters hold"):
                    fn()
                assert counter.launches == before
                continue
            got = fn()
            bound = 1e-7 + 1e-4 * torch.matmul(a.abs(), b.abs().reshape(d * 4, 64))
            want = twin()
            torch.cuda.synchronize()
            assert counter.launches == before + 1
            assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())


def test_k7_and_k8_replay_in_a_cuda_graph_with_new_inputs(dev):
    # K7 / K8 at the D = 4 main path's M and nt, captured once and replayed
    # on refilled inputs: the launches copy nothing to the card (the eager
    # run before the capture is under sync debug mode "error"), each replay
    # equals an eager call bit for bit and its twin within the bar, and
    # each replay counts one launch of each
    from sparse_matrix_with_flops_tpu_torch.utils.graphs import CapturedBody

    a, b = _ring_operands(4, 297, 512, 4096, 13, dev)
    g = CapturedBody("ring matmuls", lambda: (ring_matmul(a, b), ring_matmul_tiled(a, b, 2048)),
                     (a, b))
    gen = torch.Generator().manual_seed(14)
    first = g.run()  # eager, then captured
    assert g.graph is not None
    assert g.launches == {ring_matmul: 1, ring_matmul_tiled: 1}
    for i in range(3):
        if i:
            g.load(torch.randn(a.shape, generator=gen).to(dev),
                   torch.randn(b.shape, generator=gen).to(dev))
        before = (ring_matmul.launches, ring_matmul_tiled.launches)
        got = g.run()
        assert (ring_matmul.launches, ring_matmul_tiled.launches) == (before[0] + 1,
                                                                    before[1] + 1)
        eager = (ring_matmul(a, b), ring_matmul_tiled(a, b, 2048))
        twins = (ring_matmul_plain(a, b), ring_matmul_tiled_plain(a, b, 2048))
        torch.cuda.synchronize()
        bound = 1e-7 + 1e-4 * torch.matmul(a.abs(), b.abs().reshape(4 * 512, 4096))
        for x, y, t in zip(got, eager, twins):
            assert torch.equal(x, y)
            assert bool(((x - t).abs() <= bound).all()), float((x - t).abs().max())
        if not i:
            assert all(torch.equal(x, y) for x, y in zip(got, first))
    torch.cuda.synchronize()


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


def _k9_runs(case):
    """(values, int64 offsets, leading slots before values[0] in its
    buffer) of a K9 edge case, made from a seed."""
    rng = np.random.default_rng(sum(map(ord, case)))
    lead = 0
    if case == "empty runs":
        lens = np.where(rng.random(3000) < 0.6, 0, rng.integers(1, 40, 3000))
        lens[:64] = 0  # a whole warp of empty runs
    elif case == "an empty stream":
        lens = np.zeros(70, np.int64)
    elif case == "one value":
        lens = np.array([1])
    elif case == "2^20 values":
        lens = np.array([1 << 20])
    elif case == "around kShort":  # a lane's runs and the warp's, in the lane mode
        lens = rng.integers(28, 37, 4000)
        lens[1::2] = 0
        lens[::997] = rng.integers(300, 5000, lens[::997].size)
    elif case == "power law":
        lens = np.minimum(rng.zipf(2.2, 20000), 50000)
    else:  # "off the 16-byte grid <k>": the stream starts k slots past the grid
        lead = int(case[-1])
        lens = rng.integers(0, 40, 3000)
        lens[5] = 4099
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    vals = rng.standard_normal(int(off[-1])).astype(np.float32)
    vals[rng.random(vals.size) < 0.01] = -0.0
    return vals, off, lead


@pytest.mark.parametrize("case", ["empty runs", "an empty stream", "one value", "2^20 values",
                                  "around kShort", "power law", "off the 16-byte grid 1",
                                  "off the 16-byte grid 2", "off the 16-byte grid 3"])
@pytest.mark.parametrize("odtype", [torch.int32, torch.int64])
def test_run_sums_kernel_equals_the_cpu_bits(dev, case, odtype):
    """K9 against its plain version on the CPU, bit for bit, in both
    modes (a lane a short run, or a warp a run once the stream holds
    WARP_RUN_SLOTS slots a run), with the runs moved through the stream
    and followed by slots past offsets[-1] that must be left out."""
    from sparse_matrix_with_flops_tpu_torch.ops.segments import (
        WARP_RUN_SLOTS,
        run_sums,
        run_sums_plain,
    )

    vals, off, lead = _k9_runs(case)
    runs = off.size - 1
    want = run_sums_plain(torch.from_numpy(vals), torch.from_numpy(off))
    for shift in (0, 1, 3, 6):
        for tail in (0, 5, WARP_RUN_SLOTS * runs):  # tail 0: the last run ends the stream
            buf = torch.full((lead + shift + vals.size + tail,), 7.5)
            buf[lead + shift:lead + shift + vals.size] = torch.from_numpy(vals)
            v = buf.to(dev)[lead:]
            o = torch.from_numpy(off + shift).to(odtype).to(dev)
            before = run_sums.launches
            got = run_sums(v, o)
            torch.cuda.synchronize()
            assert run_sums.launches == before + 1
            assert got.shape == (runs,) and got.device == dev
            assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)), (
                case, shift, tail)


def test_blocked_run_sums_on_the_card_equal_the_cpu_bits(dev):
    """The prune's blocked row sums (K9 twice) on the card, bit for bit
    the CPU's, at two offsets of the stream."""
    from sparse_matrix_with_flops_tpu_torch.ops.segments import blocked_run_sums

    rng = np.random.default_rng(31)
    lens = np.minimum(rng.zipf(1.5, 16384), 20000)
    lens[rng.random(lens.size) < 0.1] = 0
    vals = rng.random(int(lens.sum()) + 3).astype(np.float32)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    want = blocked_run_sums(torch.from_numpy(vals), torch.from_numpy(off))
    for shift in (0, 3):
        v = torch.from_numpy(np.concatenate([np.zeros(shift, np.float32), vals])).to(dev)
        got = blocked_run_sums(v, torch.from_numpy(off + shift).to(dev))
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_run_sums_refuses_what_the_kernel_does_not_take(dev):
    from sparse_matrix_with_flops_tpu_torch.ops.segments import run_sums

    with pytest.raises(ValueError):
        run_sums(torch.zeros(4, device=dev), torch.tensor([0, 4]))  # mixed devices
    with pytest.raises(TypeError):
        run_sums(torch.zeros(4, device=dev, dtype=torch.float16), torch.tensor([0, 4], device=dev))
    with pytest.raises(ValueError):
        run_sums(torch.zeros((2, 2), device=dev), torch.tensor([0, 4], device=dev))


def test_run_sums_replays_in_a_cuda_graph_with_new_inputs(dev):
    """K9 in both modes captured once and replayed on refilled values
    and offsets, each replay equal to the CPU bits and to an eager call."""
    from sparse_matrix_with_flops_tpu_torch.ops.segments import run_sums, run_sums_plain

    g = torch.Generator().manual_seed(11)
    cases = {"lanes": (200_000, 50_000), "warps": (200_000, 1_000)}  # (slots, runs)
    vals = {k: torch.empty(n, device=dev) for k, (n, _) in cases.items()}
    offs = {k: torch.empty(r + 1, dtype=torch.int64, device=dev) for k, (_, r) in cases.items()}

    def refill():
        for k, (n, r) in cases.items():
            cut = torch.sort(torch.randint(0, n + 1, (r + 1,), generator=g)).values
            offs[k].copy_(cut)
            vals[k].copy_(torch.randn(n, generator=g))

    def calls():
        return [run_sums(vals[k], offs[k]) for k in cases]

    refill()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = run_sums.launches
    with torch.cuda.graph(graph):
        captured = calls()
    assert run_sums.launches == before + 2
    for _ in range(3):
        refill()
        graph.replay()
        eager = calls()
        torch.cuda.synchronize()
        for k, got, again in zip(cases, captured, eager):
            want = run_sums_plain(vals[k].cpu(), offs[k].cpu())
            assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)), k
            assert torch.equal(again, got)


def test_load_coo_lands_on_the_card_by_default(dev):
    from sparse_matrix_with_flops_tpu_torch.io import load_coo

    coo = load_coo("tests/tdatas/tdata.snap")
    assert coo.device == dev and coo.row.device == dev and coo.nnz.device == dev
    cpu = load_coo("tests/tdatas/tdata.snap", device="cpu")
    for k in ("row", "col", "val", "nnz"):
        assert torch.equal(getattr(coo, k).cpu(), getattr(cpu, k))


# ---- the binned engine and the partitioned driver (K1 per bin) ----------------------
@pytest.mark.parametrize("w,r", [(16, 2283), (4096, 2278), (4096, 13), (16, 5)])
def test_sort_dedup_compact_at_the_binned_widths(dev, w, r):
    """K1 as spgemm_binned calls it: unsorted product tiles (presorted
    1), rows ragged, R not a multiple of 8."""
    rng = np.random.default_rng(w + r)
    ncols = 3 * w
    lens = rng.integers(0, w + 1, r)
    tc = rng.integers(0, ncols, (r, w)).astype(np.int32)
    tc[np.arange(w)[None, :] >= lens[:, None]] = ncols
    tv = np.where(tc < ncols, rng.standard_normal((r, w)), 0.0).astype(np.float32)
    tc, tv = torch.from_numpy(tc).to(dev), torch.from_numpy(tv).to(dev)
    k, v = sort_dedup_compact(tc, tv, ncols)
    k2, v2 = sort_dedup_compact(tc, tv, ncols)
    pk, _ = sort_dedup_compact_plain(tc, tv, ncols)
    torch.cuda.synchronize()
    assert torch.equal(k, pk)
    _assert_run_sums(v, tc, tv, ncols)
    assert torch.equal(k2, k) and torch.equal(v2, v)


@pytest.mark.parametrize("widths", [(16, 64, 256, 1024, 4096), (16, 64)])
def test_spgemm_binned_on_card(dev, widths):
    """Bit-equal across two calls, the CPU run's structure and values
    within the comparators, one K1 launch a non-empty bin, and no host
    read in a warm call."""
    from sparse_matrix_with_flops_tpu_torch.ops.binned import plan_bins, spgemm_binned

    a = rmat_csr(12, edge_factor=8, seed=7, weights="random", device="cpu")
    want = spgemm_binned(a, a, plan_bins(a, a, widths=widths))
    ad = a.to(dev)
    plan = plan_bins(ad, ad, widths=widths)
    assert plan.huge_rows.size > 0
    got = spgemm_binned(ad, ad, plan)
    before = sort_dedup_compact.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = spgemm_binned(ad, ad, plan)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert sort_dedup_compact.launches == before + plan.num_bins
    for x, y in ((got.row_ptr, again.row_ptr), (got.col_ind, again.col_ind),
                 (got.values, again.values)):
        assert torch.equal(x, y)
    _same_csr(got, want)


def test_spgemm_ell_partitioned_on_card_matches_scipy(dev):
    """Structure equal to scipy's pattern product, values within REL_TOL
    of the f64 product relative to |A||A|."""
    import scipy.sparse as sp

    from sparse_matrix_with_flops_tpu_torch.ops.partitioned import spgemm_ell_partitioned

    def keys(m):
        return np.repeat(np.arange(m.shape[0], dtype=np.int64), np.diff(m.indptr)) \
            * m.shape[1] + m.indices

    for x in (rmat_csr(11, edge_factor=8, seed=7, weights="random", device=dev),
              banded_csr(5000, bandwidth=32, device=dev)):
        rp, ci, v = x.to_numpy()
        m = sp.csr_matrix((v.astype(np.float64), ci, rp), shape=x.shape)
        mag = (abs(m) @ abs(m)).tocsr()  # no cancellation: the pattern product
        mag.sort_indices()
        prod = (m @ m).tocsr()
        want = np.zeros(mag.nnz)
        want[np.searchsorted(keys(mag), keys(prod))] = prod.data
        c = spgemm_ell_partitioned(x, x, parts=3)
        assert c.device == dev
        grp, gci, gv = c.to_numpy()
        assert np.array_equal(grp, mag.indptr) and np.array_equal(gci, mag.indices)
        assert (np.abs(gv - want) <= REL_TOL * mag.data + ABS_TOL).all()


# ---- the distributed layer on the card (shards stacked on one card) ------------------
def _sharded_pair(dev, d=4):
    from sparse_matrix_with_flops_tpu_torch.parallel.sharded import shard_csr

    a = rmat_csr(10, edge_factor=8, seed=5, weights="random", device="cpu")
    return a, shard_csr(a, d), shard_csr(a.to(dev), d)


def test_make_mesh_2d_defaults_to_the_card(dev):
    m = make_mesh((2, 2))
    assert m.device.type == "cuda" and m.num_shards == 4 and m.shape == (2, 2)


def test_sharded_spgemm_and_ring_on_card_match_cpu_path(dev):
    """Both exchanges on the card: bit-equal over two calls, no host read
    with the plan passed in, the CPU run's structure and values within
    the comparators."""
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_upper_bounds
    from sparse_matrix_with_flops_tpu_torch.parallel.sharded import unshard_csr
    from sparse_matrix_with_flops_tpu_torch.parallel.spgemm import (
        plan_spgemm_ring,
        sharded_spgemm,
        sharded_spgemm_ring,
    )

    a, sc, sd = _sharded_pair(dev)
    flops, _ = spgemm_upper_bounds(a, a)
    cpu_mesh, mesh = make_mesh(4, "cpu"), make_mesh(4, dev)
    want = sharded_spgemm(cpu_mesh, sc, sc, flops, flops)[0]
    want_ring = sharded_spgemm_ring(cpu_mesh, sc, sc, out_cap=flops)[0]
    plan, ents = plan_spgemm_ring(sd, sd)
    runs = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            runs.append((sharded_spgemm(mesh, sd, sd, flops, flops)[0],
                         sharded_spgemm_ring(mesh, sd, sd, out_cap=flops, plan=plan,
                                             step_ents=ents)[0]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for (g1, r1), (g2, r2) in zip(runs[:1], runs[1:]):
        for x, y in ((g1, g2), (r1, r2)):
            assert x.values.device.type == "cuda"
            assert torch.equal(x.row_ptr, y.row_ptr) and torch.equal(x.values, y.values)
    for got, ref in ((runs[0][0], want), (runs[0][1], want_ring)):
        _same_csr(unshard_csr(got), unshard_csr(ref))


def test_sharded_rmcl_scan_makes_no_host_read(dev):
    from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl_scan
    from sparse_matrix_with_flops_tpu_torch.parallel.rmcl import (
        plan_shard_capacities,
        sharded_rmcl_scan,
    )
    from sparse_matrix_with_flops_tpu_torch.parallel.sharded import shard_csr, unshard_csr

    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_upper_bounds

    mt0 = _rmcl_init_s12(dev)
    flops, _ = spgemm_upper_bounds(mt0, mt0)
    smgt = shard_csr(mt0, 4)
    pc, cc = plan_shard_capacities(smgt, flops, margin=6.0)
    smt = shard_csr(mt0, 4, local_capacity=cc)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, hist = sharded_rmcl_scan(make_mesh(4, dev), smgt, smt, pc, cc, 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.values.device.type == "cuda" and hist["nnz_mt"].device.type == "cuda"
    assert not bool(hist["overflow"].any())
    # the single-card scan on the same rows, bit for bit: K9 adds a run
    # in an order fixed by the run alone, wherever it starts in a stream
    single, sh = rmcl_scan(mt0, mt0.with_capacity(4 * cc), 4 * pc, 4 * cc, 3)
    (grp, gci, gv), (wrp, wci, wv) = unshard_csr(out).to_numpy(), single.to_numpy()
    np.testing.assert_array_equal(grp, wrp)
    np.testing.assert_array_equal(gci, wci)
    np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))
    np.testing.assert_array_equal(hist["nnz_mt"].cpu().numpy(), sh["nnz"].cpu().numpy())


def test_ring_densify_equals_the_accumulating_index_put_on_card(dev):
    """The ring exchange's densifies on the card: the plain set of the
    iterate blocks and the hub operands' ``index_add_`` give the
    accumulating index_put_'s bits (one value a cell; the sentinel
    column and the pads' row cut off)."""
    from sparse_matrix_with_flops_tpu_torch.parallel.rmcl_ell import dense_blocks

    t = _rmcl_graph(512, 0.02, (9,), 3)
    plan, arrays, smgt = sharded_plan(t, 4, S=128, max_tile=1024)
    cols, vals = RMCL.mt_to_ell(t, 128)
    lc = torch.where(cols >= t.ncols, plan.n, cols).reshape(4, plan.lr, 128).to(dev)
    lv = vals.reshape(4, plan.lr, 128).to(dev)
    n = plan.n
    want = torch.zeros((4, plan.lr, n + 1), device=dev)
    rix = torch.arange(plan.lr, device=dev)[:, None]
    for me in range(4):
        want[me].index_put_((rix, lc[me].long()), lv[me], accumulate=True)
    got = dense_blocks(lc, lv, n)
    assert torch.equal(got, want[:, :, :n])
    # and the hub operands of every (shard, owner) pair
    from sparse_matrix_with_flops_tpu_torch.parallel.rmcl_ell import hub_block

    hmax = plan.hmax
    assert hmax > 0
    for me in range(4):
        for owner in range(4):
            slot, pos, val = (arrays[k][me][owner].to(dev) for k in (
                "hub_ent_slot", "hub_ent_pos", "hub_ent_val"))
            width = arrays["hub_kidx"][me][owner].shape[0]
            acc = torch.zeros((hmax + 1, width), device=dev)
            acc.index_put_((torch.where(slot >= 0, slot, hmax).long(), pos.long()), val,
                           accumulate=True)
            assert torch.equal(hub_block(slot.long(), pos.long(), val, hmax, width), acc[:hmax])


# ---- compiled programs: CUDA graphs of the warm SpGEMM and the static scan ----------
def _launch_counts():
    return {w.__name__: w.launches for w in _build.WRAPPERS}


def _counted(fn):
    """(result, launches by wrapper) of one call."""
    before = _launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in _launch_counts().items() if n != before[k]}


def _program(name, dev):
    """(graph call on inputs x, eager run on inputs x, the two inputs,
    the plan that keeps the graph) of one compiled program at an edge
    size: calls on the plan run eagerly until the policy captures
    (``_until_captured``), later calls replay."""
    if name == "sharded_spgemm_ring":  # D = 4 stacked, the plan passed
        import dataclasses

        from sparse_matrix_with_flops_tpu_torch.parallel import shard_csr
        from sparse_matrix_with_flops_tpu_torch.parallel import spgemm as PSP

        a = rmat_csr(10, edge_factor=8, seed=7, weights="random", device=dev)
        sa, mesh = shard_csr(a, 4), make_mesh(4, dev)
        plan, ents = PSP.plan_spgemm_ring(sa, sa)
        rp, ci, _ = a.to_numpy()
        elen = np.diff(rp).astype(np.int64)
        rowf = np.bincount(np.repeat(np.arange(a.rows), elen), weights=elen[ci],
                           minlength=a.rows)
        oc = int(rowf.reshape(4, -1).sum(axis=1).max())  # a shard's products bound its C

        def arrays(out):
            c, info = out
            return c.row_ptr, c.col_ind, c.values, info["flops"], info["nnz"]

        def eager(x):
            return arrays(PSP._ring_impl(mesh, plan.step_prod_caps, x, sa, ents, oc))

        def call(x):
            return arrays(PSP.sharded_spgemm_ring(mesh, x, sa, out_cap=oc, plan=plan,
                                                  step_ents=ents))

        return call, eager, (sa, dataclasses.replace(sa, values=2.0 * sa.values)), plan
    if name == "spgemm_binned":  # W = 16 ... 256 bins and huge rows (run sums)
        from sparse_matrix_with_flops_tpu_torch.ops import binned as BIN

        a = rmat_csr(10, edge_factor=8, seed=7, weights="random", device=dev)
        plan = BIN.plan_bins(a, a, widths=(16, 64, 256))
        assert plan.huge_rows.size > 0
        a2 = CSR(a.row_ptr, a.col_ind, 2.0 * a.values, a.ncols)
        return ((lambda x: BIN.spgemm_binned(x, a, plan)),
                (lambda x: BIN._binned_impl(x, a, plan)), (a, a2), plan)
    if name == "spgemm_ell":  # hub groups, split hub rows, W = 16 ... 512 bins
        a = rmat_csr(10, edge_factor=8, seed=7, weights="random", device=dev)
        plan = plan_ell(a, a, max_w=512)
        assert plan.hub_groups and plan.vstart is not None
        E.spgemm_ell(a, a, plan)  # two-phase: caches the nnz(C) bucket
        cap = plan._nnzc_cache

        def eager(x):
            c, _ = E._tiles_impl(x, a, plan, fused_out_cap=cap)
            return c

        a2 = CSR(a.row_ptr, a.col_ind, 2.0 * a.values, a.ncols)
        return (lambda x: E.spgemm_ell(x, a, plan)), eager, (a, a2), plan
    if name == "rmcl_ell_scan":  # W = 128 ... 1024 bins and a hub row
        t = _rmcl_graph(300, 0.02, (7,), 0).to(dev)
        plan = RMCL.plan_rmcl_ell(t, S=128, max_tile=1024)
        adh = RMCL._dense_huge(t, plan)
        x0 = RMCL.mt_to_ell(t, 128)
        x1 = RMCL.rmcl_ell_step(plan, t, adh, *x0)[:2]

        def eager(x):
            hist, (c, v) = [], x
            for _ in range(4):
                c, v, st = RMCL.rmcl_ell_step(plan, t, adh, c, v)
                hist.append(st)
            return c, v, {k: torch.stack([h[k] for h in hist]) for k in hist[0]}

        return (lambda x: RMCL.rmcl_ell_scan(plan, t, adh, *x, 4)), eager, (x0, x1), plan
    if name.startswith("sharded_rmcl_ell_scan"):  # D = 4 stacked, hub rows
        ex = name.split()[1]
        mesh, plan, arrays, smgt, x0 = _sharded_case(dev)
        x1 = PS._sharded_step(plan, smgt, arrays, *x0, ex, mesh)[:2]

        def eager(x):
            hist, (c, v) = [], x
            for _ in range(4):
                c, v, st = PS._sharded_step(plan, smgt, arrays, c, v, ex, mesh)
                hist.append(st)
            return c, v, {k: torch.stack([h[k] for h in hist]) for k in hist[0]}

        return ((lambda x: PS.sharded_rmcl_ell_scan(mesh, plan, smgt, arrays, *x, 4, ex)),
                eager, (x0, x1), plan)
    raise ValueError(name)


def _sharded_case(dev):
    """(mesh, plan, arrays, smgt, initial iterate) of the D = 4 stacked
    sharded scan on the card: W = 128 ... 1024 bins and two hub rows."""
    t = _rmcl_graph(256, 0.03, (5, 130), 1)
    plan, arrays, smgt = sharded_plan(t.to(dev), 4, S=128, max_tile=1024)
    assert plan.hmax > 0
    cols, vals = RMCL.mt_to_ell(t.to(dev), 128)
    x0 = (torch.where(cols >= t.ncols, plan.n, cols).reshape(4, plan.lr, 128),
          vals.reshape(4, plan.lr, 128))
    return make_mesh(4, dev), plan, arrays, smgt, x0


SHARDED = [f"sharded_rmcl_ell_scan {ex}" for ex in ("ring", "all_gather", "pallas_ring",
                                                     "fused_ring")]


def _until_captured(call, plan, name):
    """Calls on one plan until the capture policy captures (at most the
    program's break-even count of them): every call's result, in order."""
    from sparse_matrix_with_flops_tpu_torch.utils import graphs

    outs = []
    for _ in range(graphs.BREAK_EVEN[name]):
        outs.append(call())
        g = graphs.held(plan, name)
        if g is not None and g.graph is not None:
            return outs
    raise AssertionError(f"{name}: no capture in {len(outs)} calls")


@pytest.mark.parametrize("name", ["spgemm_ell", "rmcl_ell_scan", "sharded_spgemm_ring",
                                  "spgemm_binned"] + SHARDED)
def test_graph_replays_equal_the_eager_run(dev, name):
    from sparse_matrix_with_flops_tpu_torch.utils import graphs

    call, eager, (x0, x1), plan = _program(name, dev)
    prog = name.split()[0]
    want, eager_launches = _counted(lambda: eager(x0))
    # eager calls, then the one that runs eagerly and captures
    firsts, _ = _counted(lambda: _until_captured(lambda: call(x0), plan, prog))
    g = graphs.held(plan, prog)
    assert g is not None and g.graph is not None and g.pool_bytes > 0
    assert sum(g.launches.values()) > 0
    replays = g.replays
    again, launches = _counted(lambda: call(x0))  # every step replayed
    assert g.replays > replays
    # the counters count the replayed kernels as the eager run counts its own
    # (K9 too, where the body sums runs)
    assert launches == eager_launches
    if prog in ("sharded_spgemm_ring", "spgemm_binned"):
        assert eager_launches.get("run_sums", 0) > 0 and eager_launches.get("cumsum_i32", 0) > 0
    assert all(same_bits(f, want) for f in firsts) and same_bits(again, want)
    # new inputs: the replay reads them (A's values doubled: C doubles exactly)
    want1 = eager(x1)
    got1 = call(x1)
    torch.cuda.synchronize()
    assert same_bits(got1, want1)
    if name in ("spgemm_ell", "spgemm_binned"):
        assert torch.equal(got1.values, 2.0 * again.values)
    elif name == "sharded_spgemm_ring":
        assert torch.equal(got1[2], 2.0 * again[2])
    assert same_bits(again, want)  # the earlier result, untouched


def test_scan_lengths_share_one_graph_and_one_iteration_captures_nothing(dev):
    # the capture policy on the static scan: a call below the break-even
    # count B captures nothing, a call of B captures at its first
    # iteration, repeated short calls capture once their eager iterations
    # reach B, and one graph serves several lengths, rebuilt (its count
    # kept) when a call needs more room than its histories have; every
    # result bit-equal to the eager loop
    from sparse_matrix_with_flops_tpu_torch.utils import graphs

    b = graphs.BREAK_EVEN["rmcl_ell_scan"]
    room = 1 << (b - 1).bit_length()
    short = max(1, (b - 1) // 2)  # a call below B
    t = _rmcl_graph(300, 0.02, (7,), 0).to(dev)
    x0 = RMCL.mt_to_ell(t, 128)

    def fresh():
        plan = RMCL.plan_rmcl_ell(t, S=128, max_tile=1024)
        return plan, RMCL._dense_huge(t, plan)

    plan, adh = fresh()
    eager = {}
    for n in sorted({1, 2, short, b, room + 1}):  # the eager loop of the step
        hist, (c, v) = [], x0
        for _ in range(n):
            c, v, st = RMCL.rmcl_ell_step(plan, t, adh, c, v)
            hist.append(st)
        eager[n] = c, v, {k: torch.stack([h[k] for h in hist]) for k in hist[0]}

    def scan(plan, adh, n):
        got = RMCL.rmcl_ell_scan(plan, t, adh, *x0, n)
        assert same_bits(got, eager[n])
        return graphs.held(plan, "rmcl_ell_scan")

    g = scan(plan, adh, 1)  # one iteration on a fresh plan: nothing captured
    assert g.graph is None and g.spent == 1
    plan, adh = fresh()
    g = scan(plan, adh, b)  # a call of B: captured at its first iteration
    assert g.graph is not None and g.spent == 1 and g.replays == b - 1
    assert g.state["room"] == room
    assert scan(plan, adh, 2) is g  # another length, the same graph
    assert g.replays == b + 1
    g2 = scan(plan, adh, room + 1)  # more than its histories hold: rebuilt, the count kept
    assert g2 is not g and g2.graph is not None and g2.state["room"] == 2 * room
    assert g2.spent == 2
    plan, adh = fresh()
    calls = -(-b // short)
    for k in range(1, calls + 1):  # short calls: the one that reaches B captures
        g = scan(plan, adh, short)
        assert (g.graph is not None) == (k == calls)
    assert g.spent == (calls - 1) * short + 1
    torch.cuda.synchronize()


def test_graph_lives_and_dies_with_its_plan(dev):
    import gc
    import weakref

    from sparse_matrix_with_flops_tpu_torch.utils import graphs

    a = rmat_csr(10, edge_factor=8, seed=7, weights="random", device=dev)
    plan = plan_ell(a, a, max_w=512)
    # two-phase, warm calls up to the capture (the break-even count), a replay
    for _ in range(2 + graphs.BREAK_EVEN["spgemm_ell"]):
        E.spgemm_ell(a, a, plan)
    g = graphs.held(plan, "spgemm_ell")
    assert g.graph is not None and g.replays == 1
    torch.cuda.synchronize()
    gone, alive = weakref.ref(g), weakref.ref(plan)
    del plan, g
    assert alive() is None and gone() is None  # no cycle holds them: freed at once
    gc.collect()
    torch.cuda.synchronize()


def test_graph_bodies_make_no_host_read(dev):
    # the static step, the warm SpGEMM body and the sharded step of each
    # exchange under sync debug mode "error" (the general step:
    # test_rmcl_scan_makes_no_host_read)
    mesh, splan, arrays, smgt, x0s = _sharded_case(dev)
    PS._plan_tensors(splan, dev, range(4))  # the plan's uploads come first
    for ex in ("ring", "all_gather", "pallas_ring", "fused_ring"):  # builds, sizes grids
        PS._sharded_step(splan, smgt, arrays, *x0s, ex, mesh)
    t = _rmcl_graph(300, 0.02, (7,), 0).to(dev)
    plan = RMCL.plan_rmcl_ell(t, S=128, max_tile=1024)
    adh = RMCL._dense_huge(t, plan)
    x0 = RMCL.mt_to_ell(t, 128)
    RMCL._plan_tensors(plan, dev)  # the plan's uploads come first
    a = rmat_csr(10, edge_factor=8, seed=7, weights="random", device=dev)
    eplan = plan_ell(a, a, max_w=512)
    E.spgemm_ell(a, a, eplan)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        RMCL.rmcl_ell_step(plan, t, adh, *x0)
        E._tiles_impl(a, a, eplan, fused_out_cap=eplan._nnzc_cache)
        for ex in ("ring", "all_gather", "pallas_ring", "fused_ring"):
            PS._sharded_step(splan, smgt, arrays, *x0s, ex, mesh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_a_capture_out_of_memory_gives_the_cache_back_and_captures_again(dev):
    # blocks cached outside any pool cannot serve a capture's private pool,
    # and the allocator cannot free them inside a capture: the first
    # attempt runs out of memory, the second (cache emptied) captures
    from sparse_matrix_with_flops_tpu_torch.utils.graphs import CapturedBody

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n = int(torch.cuda.mem_get_info(dev)[0] * 0.6) // 4
    x = torch.ones(1, device=dev)
    big = torch.empty(n, dtype=torch.float32, device=dev)
    del big  # 60% of the card, now cached outside any pool
    g = CapturedBody("probe", lambda: torch.full((n,), 2.0, device=dev)[:1] * x, (x,))
    assert torch.equal(g.run(), 2.0 * x)  # the eager run takes the cached block
    assert g.graph is not None and g.pool_bytes >= 4 * n
    assert torch.equal(g.run(), 2.0 * x) and g.replays == 1
    del g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


@pytest.mark.parametrize("breaks", ["item", "synchronize"])
def test_a_failed_capture_raises_with_no_eager_fallback(dev, breaks):
    # a host read raises in the eager run before capture (sync debug mode
    # "error"); a device synchronize, which that mode does not flag, breaks
    # the capture itself: either way the run raises and keeps no graph
    from sparse_matrix_with_flops_tpu_torch.utils.graphs import CapturedBody

    x = torch.arange(1024.0, device=dev)

    def body():
        y = x * 2
        if breaks == "item":
            y = y * y.sum().item()
        else:
            torch.cuda.synchronize()
        return y

    g = CapturedBody("probe", body, (x,))
    with pytest.raises(RuntimeError, match="probe: .* failed"):
        g.run()
    assert g.graph is None and g.replays == 0
    torch.cuda.synchronize()  # the card is still usable
    assert float((x * 2).sum()) == 2.0 * 1023 * 1024 / 2


@pytest.mark.parametrize("n,total", [(1000, 3000), (200_000, 1_000_003), (50_000, 40_000)])
def test_last_marked_equals_the_running_max_on_card(dev, n, total):
    # the repeat_segments of the ESC callers (exclusive-cumsum starts, the
    # nonempty segments valid) and runs of equal marks (the window marks),
    # on the card with no host read, against the max-scatter and cummax
    from sparse_matrix_with_flops_tpu_torch.ops.segments import (
        last_marked,
        repeat_segments_plain,
    )

    gen = torch.Generator().manual_seed(n)
    counts = torch.randint(0, 6, (n,), generator=gen, dtype=torch.int32)
    valid = (counts > 0) & (torch.rand(n, generator=gen) < 0.9)
    starts = torch.cumsum(counts, 0).to(torch.int32) - counts
    runs = torch.sort(torch.randint(0, total // 4 + 1, (n,), generator=gen)).values
    for marks in (starts, runs.to(torch.int32)):
        m, v = marks.to(dev), valid.to(dev)
        before = cumsum_i32.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = last_marked(m, v, total)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert cumsum_i32.launches == before + 2
        assert torch.equal(got, repeat_segments_plain(m, v, total))
        assert torch.equal(got.cpu(), last_marked(marks, valid, total))


def test_drift_keeps_its_bits_on_card(dev):
    # each (row, col) segment of the union holds one or two entries, so the
    # pair sums equal the float atomics' sums of the scatter-add form
    from sparse_matrix_with_flops_tpu_torch.models.rmcl import plan_capacities, rmcl_one_step
    from sparse_matrix_with_flops_tpu_torch.ops.metrics import csr_frobenius_diff
    from sparse_matrix_with_flops_tpu_torch.ops.segments import segment_boundaries

    mt0 = _rmcl_init_s12(dev)
    pc, cc = plan_capacities(mt0, mt0, 2.5)
    new, _ = rmcl_one_step(mt0, mt0.with_capacity(cc), pc, cc)

    def scatter_add_form(a, b):
        valid = torch.cat([a.entry_valid(), b.entry_valid()])
        r = torch.where(valid, torch.cat([a.entry_rows(), b.entry_rows()]), a.rows)
        c = torch.cat([a.col_ind, b.col_ind])
        v = torch.cat([a.values, -b.values])
        order = torch.sort(r.long() * (a.ncols + 1) + c.long(), stable=True).indices
        r, c, v = r[order], c[order], v[order]
        ok = r < a.rows
        seg = torch.where(ok, torch.cumsum(segment_boundaries(r, c, ok), 0) - 1, r.shape[0])
        sums = torch.zeros(r.shape[0] + 1, device=dev).index_add_(0, seg, torch.where(ok, v, 0.0))
        sums = sums[: r.shape[0]]
        return (sums * sums).sum(), torch.where(a.entry_valid(), a.values**2, 0.0).sum()

    for a, b in ((mt0, new), (new, mt0)):
        got, want = csr_frobenius_diff(a, b), scatter_add_form(a, b)
        assert [float(x) for x in got] == [float(x) for x in want]
