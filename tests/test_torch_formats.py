"""PyTorch port vs the JAX package: containers, generators, host helpers."""

import numpy as np
import pytest
import torch

import sparse_matrix_with_flops_tpu.utils.nphost as jnph
from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
from sparse_matrix_with_flops_tpu.ops.segments import (
    exclusive_cumsum as j_exclusive_cumsum,
)
from sparse_matrix_with_flops_tpu.utils import generate as jgen
from sparse_matrix_with_flops_tpu_torch import config as tconfig
from sparse_matrix_with_flops_tpu_torch.config import resolve_device
from sparse_matrix_with_flops_tpu_torch.formats.coo import COO as TCOO
from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR as TCSR
from sparse_matrix_with_flops_tpu_torch.ops.segments import exclusive_cumsum
from sparse_matrix_with_flops_tpu_torch.parallel.mesh import make_mesh
from sparse_matrix_with_flops_tpu_torch.utils import generate as tgen
from sparse_matrix_with_flops_tpu_torch.utils import nphost as tnph
from sparse_matrix_with_flops_tpu_torch.utils.timing import TRACE

from conftest import random_csr_np
from torch_port_util import trimmed


def test_config_constants_and_precision():
    from sparse_matrix_with_flops_tpu import config as jconfig

    for name in ("ABS_TOL", "REL_TOL", "MLMCL_PRUNE_A", "MLMCL_PRUNE_B",
                 "PRUNE_FLOOR", "DEFAULT_MAX_ITERS", "DEFAULT_STRIDE",
                 "FLOPS_BIN_BOUNDS"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    assert tconfig.QVALUE_DTYPE == torch.float32
    assert tconfig.INDEX_DTYPE == torch.int32
    # true f32 is pinned per call (config.true_f32), not at import
    with tconfig.true_f32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("capacity", [None, 64])
def test_from_numpy_round_trip(rng, capacity):
    rp, c, v = random_csr_np(rng, 9, 7, 0.3)
    t = TCSR.from_numpy(rp, c, v, 7, capacity=capacity, device="cpu")
    j = JCSR.from_arrays(rp, c, v, ncols=7, capacity=capacity)
    assert t.shape == j.shape and t.capacity == j.capacity
    assert t.row_ptr.dtype == torch.int32 and t.values.dtype == torch.float32
    # padding layout: sentinel col = ncols, value 0
    np.testing.assert_array_equal(t.col_ind.numpy(), np.asarray(j.col_ind))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    grp, gc, gv = t.to("cpu").to_numpy()
    np.testing.assert_array_equal(grp, rp)
    np.testing.assert_array_equal(gc, c)
    np.testing.assert_array_equal(gv, v)
    t2 = TCSR.from_arrays(rp, c, v, 7, capacity=capacity, device="cpu")  # JAX argument order
    assert t2.is_equal(t) and t2.capacity == t.capacity
    with pytest.raises(ValueError):
        TCSR.from_numpy(rp, c, v, 7, capacity=int(rp[-1]) - 1, device="cpu")


_CAPACITIES = {  # (nnz, capacity) -> the capacity asked for
    "grow": lambda nnz, cap: cap + 13,
    "same": lambda nnz, cap: cap,
    "nnz": lambda nnz, cap: nnz,
    "between": lambda nnz, cap: nnz + 5,
    "below": lambda nnz, cap: nnz - 1,
}


@pytest.mark.parametrize("padding", ["clean", "stray"])
@pytest.mark.parametrize("to", list(_CAPACITIES))
def test_with_capacity_equals_the_host_round_trip(rng, to, padding):
    rp, c, v = random_csr_np(rng, 9, 7, 0.4)
    nnz = int(rp[-1])
    a = TCSR.from_numpy(rp, c, v, 7, capacity=nnz + 12, device="cpu")
    if padding == "stray":  # padding slots that break the invariant
        col, val = a.col_ind.clone(), a.values.clone()
        col[nnz:] = torch.arange(12, dtype=torch.int32) % 7
        val[nnz:] = 2.5
        a = TCSR(a.row_ptr.clone(), col, val, 7)
    cap = _CAPACITIES[to](nnz, a.capacity)
    before = [t.clone() for t in (a.row_ptr, a.col_ind, a.values)]
    if to == "below":
        for pad in (a.with_capacity, lambda k: TCSR.from_numpy(*a.to_numpy(), 7, "cpu", k)):
            with pytest.raises(ValueError, match=f"capacity {cap} < nnz {nnz}"):
                pad(cap)
        return
    want = TCSR.from_numpy(*a.to_numpy(), a.ncols, a.device, cap)
    TRACE.clear()
    TRACE.enabled = True
    try:
        got = a.with_capacity(cap)
        records, counters = list(TRACE.records), list(TRACE.counters)
    finally:
        TRACE.enabled = False
        TRACE.clear()
    # growth touches no host; a shrink reads nnz once
    if cap >= a.capacity:
        assert records == [] and [(n, k) for n, _, k, _ in counters] == [
            ("csr.pad", cap - a.capacity)]
    else:
        assert [r.name for r in records] == ["read.csr.nnz"]
        assert [n for n, *_ in counters] == ["reads"]
    assert got.capacity == cap and got.ncols == want.ncols and got.device == want.device
    for g, w, old in zip((got.row_ptr, got.col_ind, got.values),
                         (want.row_ptr, want.col_ind, want.values),
                         (a.row_ptr, a.col_ind, a.values)):
        assert g.dtype == w.dtype and g.device == w.device
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))  # bit for bit
        assert g.untyped_storage().data_ptr() != old.untyped_storage().data_ptr()
    for t, b in zip((a.row_ptr, a.col_ind, a.values), before):
        assert torch.equal(t, b)  # the input is left as it was


def test_from_dense_and_to_dense_match_reference(rng):
    dense = np.where(
        rng.random((11, 13)) < 0.3, rng.standard_normal((11, 13)), 0.0
    ).astype(np.float32)
    t = TCSR.from_dense(dense, device="cpu")
    j = JCSR.from_dense(dense)
    for x, y in zip(trimmed(t), trimmed(j)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(t.to_dense().numpy(), np.asarray(j.to_dense()))
    np.testing.assert_array_equal(
        t.entry_rows().numpy(), np.asarray(j.entry_rows())
    )


def _pairs(rng):
    rp, c, v = random_csr_np(rng, 8, 8, 0.4)
    base = (rp, c, v)
    v_small = v + np.float32(5e-8)
    v_rel = v * np.float32(1.0 + 5e-4)
    v_far = v * np.float32(1.01)
    v_zero = v.copy()
    v_zero[::3] = 0.0
    c_shift = c.copy()
    c_shift[0] = (c_shift[0] + 1) % 8
    return [
        (base, (rp, c, v)),
        (base, (rp, c, v_small)),
        (base, (rp, c, v_rel)),
        (base, (rp, c, v_far)),
        ((rp, c, v_zero), (rp, c, v_zero)),
        (base, (rp, c, v_zero)),
        (base, (rp, c_shift, v)),
    ]


@pytest.mark.parametrize("case", range(7))
def test_comparators_agree_with_reference(rng, case):
    (ra, ca, va), (rb, cb, vb) = _pairs(rng)[case]
    ja, jb = JCSR.from_arrays(ra, ca, va, 8), JCSR.from_arrays(rb, cb, vb, 8)
    ta = TCSR.from_numpy(ra, ca, va, 8, device="cpu")
    tb = TCSR.from_numpy(rb, cb, vb, 8, capacity=40, device="cpu")
    assert ta.is_equal(tb) == bool(ja.is_equal(jb))
    assert ta.is_raw_equal(tb) == bool(ja.is_raw_equal(jb))
    assert ta.is_relative_equal(tb, 1e-3) == bool(ja.is_relative_equal(jb, 1e-3))
    for x, y in zip(trimmed(ta._drop_explicit_zeros()), trimmed(ja._drop_explicit_zeros())):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize(
    "scale,ef,seed,weights",
    [(6, 4, 0, "unit"), (8, 8, 7, "random"), (10, 8, 3, "random")],
)
def test_rmat_bit_identical(scale, ef, seed, weights):
    j = jgen.rmat_csr(scale, edge_factor=ef, seed=seed, weights=weights)
    t = tgen.rmat_csr(scale, edge_factor=ef, seed=seed, weights=weights, device="cpu")
    assert t.shape == j.shape
    for x, y in zip(trimmed(t), trimmed(j)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize(
    "n,bw,density", [(50, 4, 1.0), (300, 16, 1.0), (400, 32, 0.3)]
)
def test_banded_bit_identical(n, bw, density):
    j = jgen.banded_csr(n, bandwidth=bw, seed=2, density=density)
    t = tgen.banded_csr(n, bandwidth=bw, seed=2, density=density, device="cpu")
    for x, y in zip(trimmed(t), trimmed(j)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n", [0, 1, 17, 1000])
def test_exclusive_cumsum_int32(n):
    x = np.random.default_rng(n).integers(-50, 100, size=n).astype(np.int32)
    got = exclusive_cumsum(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (n + 1,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_exclusive_cumsum(x)))


def test_exclusive_cumsum_wraps_like_int32():
    x = torch.tensor([2**31 - 1, 1, 5], dtype=torch.int32)
    got = exclusive_cumsum(x)
    assert got.dtype == torch.int32
    assert got.tolist() == [0, 2**31 - 1, -(2**31), -(2**31) + 5]


def test_nphost_helpers_match_reference(rng):
    counts = rng.integers(0, 5, size=40)
    np.testing.assert_array_equal(tnph.repeat_idx(counts), jnph.repeat_idx(counts))
    vals = rng.integers(0, 100, size=40)
    np.testing.assert_array_equal(
        tnph.fast_repeat(vals, counts), jnph.fast_repeat(vals, counts)
    )
    starts = rng.integers(0, 50, size=20)
    ends = starts + rng.integers(0, 6, size=20)
    np.testing.assert_array_equal(
        tnph.concat_ranges(starts, ends), jnph.concat_ranges(starts, ends)
    )
    rp = np.concatenate([[0], np.cumsum(counts)])
    ent = rng.integers(0, 9, size=int(rp[-1]))
    np.testing.assert_array_equal(
        tnph.segment_sums(ent, rp), jnph.segment_sums(ent, rp)
    )
    n = np.arange(1, 3000)
    np.testing.assert_array_equal(tnph.pow2ceil_arr(n), jnph.pow2ceil_arr(n))
    np.testing.assert_array_equal(tnph.snap_chunks_arr(n), jnph.snap_chunks_arr(n))


def test_csr_host_is_cached_and_exact(rng):
    rp, c, v = random_csr_np(rng, 6, 6, 0.5)
    t = TCSR(
        torch.from_numpy(rp), torch.from_numpy(c), torch.from_numpy(v), 6
    )
    hrp, hci = tnph.csr_host(t)
    assert hrp.dtype == np.int64 and hci.dtype == np.int32
    np.testing.assert_array_equal(hrp, rp)
    np.testing.assert_array_equal(hci, c)
    assert tnph.csr_host(t)[0] is hrp


_DEFAULT_DEVICE_CALLS = {
    "CSR.from_numpy": lambda: TCSR.from_numpy([0, 1], [0], [1.0], 1),
    "CSR.from_arrays": lambda: TCSR.from_arrays([0, 1], [0], [1.0], 1),
    "CSR.from_dense": lambda: TCSR.from_dense(np.eye(2, dtype=np.float32)),
    "CSR.from_one_based": lambda: TCSR.from_one_based([1, 2], [1], [1.0], 1),
    "COO.from_numpy": lambda: TCOO.from_numpy([0], [0], [1.0], 1, 1),
    "rmat_csr": lambda: tgen.rmat_csr(4, edge_factor=2),
    "banded_csr": lambda: tgen.banded_csr(8, bandwidth=1),
}


@pytest.mark.parametrize("name", list(_DEFAULT_DEVICE_CALLS))
def test_constructors_default_to_the_card(name):
    # with no device the matrix lands on the card, as the reference's
    # arrays land on the accelerator; without a card that raises, and
    # only device="cpu" builds on the CPU
    make = _DEFAULT_DEVICE_CALLS[name]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='no CUDA device; pass device="cpu"'):
            make()


def test_make_mesh_and_the_constructors_share_the_device_rule():
    assert resolve_device("cpu", "x") == torch.device("cpu")
    assert make_mesh(2, "cpu").device == TCSR.from_numpy([0], [], [], 3, "cpu").device
    if not torch.cuda.is_available():
        for make in (lambda: make_mesh(2), lambda: resolve_device(None, "x")):
            with pytest.raises(RuntimeError, match='no CUDA device; pass device="cpu"'):
                make()
