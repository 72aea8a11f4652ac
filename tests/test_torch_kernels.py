"""Each port kernel's plain twin vs the reference Pallas kernel
(``interpret=True`` on the CPU), on the same host tiles.

On CPU tensors the wrappers run their twins, so these tests go through
the wrappers and also check that no kernel launch is counted."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.ops.pallas_scan import cumsum_i32 as j_cumsum
from sparse_matrix_with_flops_tpu.ops.pallas_sort import (
    align_windows,
    compact_nonzero_rows as j_compact,
    sort_dedup_compact as j_sdc,
)
from sparse_matrix_with_flops_tpu_torch.ops.scan_kernels import cumsum_i32
from sparse_matrix_with_flops_tpu_torch.ops.sort_kernels import (
    compact_nonzero_rows,
    sort_dedup_compact,
    window_gather,
)

from torch_port_util import assert_close_values

WRAPPERS = (sort_dedup_compact, compact_nonzero_rows, window_gather, cumsum_i32)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = [w.launches for w in WRAPPERS]
    yield
    assert [w.launches for w in WRAPPERS] == before == [0, 0, 0, 0]


def _tiles(rng, r, w, ncols, presorted):
    """Random (col, val) tiles; with presorted > 1, every aligned run of
    that many lanes sorted, odd runs reversed (the ELL-ESC invariant)."""
    tc = rng.integers(0, ncols + 1, size=(r, w)).astype(np.int32)
    tv = np.where(tc < ncols, rng.standard_normal((r, w)), 0.0).astype(np.float32)
    if presorted > 1:
        order = np.argsort(tc.reshape(r, -1, presorted), axis=2, kind="stable")
        tc = np.take_along_axis(tc.reshape(r, -1, presorted), order, axis=2)
        tv = np.take_along_axis(tv.reshape(r, -1, presorted), order, axis=2)
        tc[:, 1::2] = tc[:, 1::2, ::-1]
        tv[:, 1::2] = tv[:, 1::2, ::-1]
        tc, tv = tc.reshape(r, w), tv.reshape(r, w)
    return np.ascontiguousarray(tc), np.ascontiguousarray(tv)


@pytest.mark.parametrize("w", [64, 256])
@pytest.mark.parametrize("presorted", [1, 8])
def test_sort_dedup_compact_twin_matches_pallas(rng, w, presorted):
    ncols = w // 2 + 3  # duplicates in every row, sentinels mixed in
    tc, tv = _tiles(rng, 16, w, ncols, presorted)
    jk, jv = j_sdc(
        jnp.asarray(tc), jnp.asarray(tv), ncols, interpret=True,
        presorted=presorted,
    )
    tk, tvv = sort_dedup_compact(
        torch.from_numpy(tc), torch.from_numpy(tv), ncols, presorted=presorted
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert_close_values(tvv.numpy().ravel(), np.asarray(jv).ravel())


def test_sort_dedup_compact_keeps_exact_zero_sums():
    # the tile path keeps cancellations: keep depends on the column only
    tc = np.array([[3, 3, 1, 5, 5, 5, 9, 9]], np.int32)
    tv = np.array([[1.5, -1.5, 2.0, 1.0, 1.0, -2.0, 0.0, 0.0]], np.float32)
    k, v = sort_dedup_compact(torch.from_numpy(tc), torch.from_numpy(tv), 9)
    assert k.tolist() == [[1, 3, 5, 9, 9, 9, 9, 9]]
    assert v.tolist() == [[2.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]]


def test_sort_dedup_compact_rejects_bad_arguments():
    tc = torch.zeros((2, 24), dtype=torch.int32)
    tv = torch.zeros((2, 24), dtype=torch.float32)
    with pytest.raises(ValueError):
        sort_dedup_compact(tc, tv, 5)  # W not a power of two
    with pytest.raises(TypeError):
        sort_dedup_compact(tc[:, :16].long().contiguous(), tv[:, :16].contiguous(), 5)
    with pytest.raises(ValueError):
        sort_dedup_compact(tc[:, ::2], tv[:, ::2], 5)  # not contiguous


@pytest.mark.parametrize("ncols", [200, 256])
def test_compact_nonzero_rows_twin_matches_pallas(rng, ncols):
    n = 256
    v = np.where(
        rng.random((16, n)) < 0.2, rng.standard_normal((16, n)), 0.0
    ).astype(np.float32)
    jk, jv = j_compact(jnp.asarray(v), ncols, interpret=True)
    tk, tv = compact_nonzero_rows(torch.from_numpy(v), ncols)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_window_gather_twin_matches_align_windows(rng):
    # the reference's _assemble_body.win_gather on the same p0: two row
    # takes of the [cols | value bits] window source, then align_windows
    w, nr, q = 128, 6, 40
    src_c = rng.integers(-1000, 1000, size=nr * w).astype(np.int32)
    src_v = rng.integers(-(2**31), 2**31 - 1, size=nr * w).astype(np.int32)
    p0 = rng.integers(-300, nr * w + 300, size=q).astype(np.int32)
    p0[:4] = [0, w - 1, (nr - 2) * w + w - 1, nr * w - 1]
    src = np.concatenate([src_c.reshape(-1, w), src_v.reshape(-1, w)], axis=1)
    wr = np.clip(p0 // w, 0, nr - 2)
    off = np.clip(p0 - wr * w, 0, w - 1)
    g = np.concatenate([src[wr], src[wr + 1]], axis=1)
    jc, jv = align_windows(
        jnp.asarray(g), jnp.asarray(off[:, None].astype(np.int32)),
        interpret=True,
    )
    tc, tv = window_gather(
        torch.from_numpy(src_c), torch.from_numpy(src_v), torch.from_numpy(p0), w
    )
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n", [1, 7, 70_000])
def test_cumsum_i32_twin_matches_pallas(n):
    x = np.random.default_rng(n).integers(-5, 9, size=n).astype(np.int32)
    want = np.asarray(j_cumsum(jnp.asarray(x), interpret=True))
    got = cumsum_i32(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cumsum_i32_wraps_like_int32():
    x = torch.tensor([2**31 - 1, 1, 1], dtype=torch.int32)
    assert cumsum_i32(x).tolist() == [2**31 - 1, -(2**31), -(2**31) + 1]
