"""The port's CUDA kernels and main path on a card, held against their
plain PyTorch twins and the CPU path.  Marked ``cuda``: without a card
every test skips.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu_torch.config import ABS_TOL, REL_TOL
from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR
from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
from sparse_matrix_with_flops_tpu_torch.ops.block_spgemm import block_spgemm
from sparse_matrix_with_flops_tpu_torch.ops.dispatch import spgemm_auto
from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
from sparse_matrix_with_flops_tpu_torch.ops.scan_kernels import (
    cumsum_i32,
    cumsum_i32_plain,
)
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
    [(32, 1, 5), (64, 64, 7), (1024, 1, 9), (1024, 64, 33), (16384, 64, 3)],
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


def test_sort_dedup_compact_refuses_too_wide(dev):
    tc = torch.zeros((1, 32768), dtype=torch.int32, device=dev)
    tv = torch.zeros((1, 32768), dtype=torch.float32, device=dev)
    with pytest.raises(NotImplementedError):
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
