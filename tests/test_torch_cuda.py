"""The port's CUDA kernels and main path on a card, held against their
plain PyTorch twins and the CPU path.  Marked ``cuda``: without a card
every test skips.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu_torch.config import ABS_TOL, REL_TOL
from sparse_matrix_with_flops_tpu_torch.formats.bcsr import BCSR
from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR
from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
from sparse_matrix_with_flops_tpu_torch.ops.block_spgemm import block_spgemm
from sparse_matrix_with_flops_tpu_torch.ops.dispatch import spgemm_auto
from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
from sparse_matrix_with_flops_tpu_torch.ops.scan_kernels import (
    cumsum_i32,
    cumsum_i32_plain,
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
from sparse_matrix_with_flops_tpu_torch.utils.generate import banded_csr, rmat_csr

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


@pytest.mark.parametrize("n", [1, 8191, 8192, 8193, 3_000_001])
def test_cumsum_i32_kernel_matches_twin(dev, n):
    g = torch.Generator().manual_seed(n)
    x = torch.randint(-(2**30), 2**30, (n,), generator=g, dtype=torch.int32).to(dev)
    got, want = cumsum_i32(x), cumsum_i32_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)  # int32 wrap-around on both


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
    a = rmat_csr(10, edge_factor=8, seed=7, weights="random")
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
    band = banded_csr(3000, bandwidth=32)
    a = CSR(band.row_ptr, band.col_ind, band.values.abs(), band.ncols)
    _same_csr(spgemm_auto(a.to(dev), a.to(dev)), block_spgemm(a, a))


def test_spgemm_ell_w32768_bin_on_card_matches_cpu_path(dev):
    a = rmat_csr(10, edge_factor=16, seed=7, weights="random")
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
    a = BCSR.from_csr(CSR.from_dense(d.astype(np.float32)), br, bc).to(dev)
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


def test_bcsr_spmm_all_empty_launches_nothing(dev):
    a = BCSR.from_csr(CSR.from_dense(np.zeros((20, 30), np.float32)), 8, 16).to(dev)
    before = bcsr_spmm.launches
    got = bcsr_spmm(a, torch.ones((30, 5), device=dev), kernel="pallas")
    assert bcsr_spmm.launches == before
    assert got.shape == (20, 5) and not got.any()
