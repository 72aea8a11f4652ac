"""PyTorch port vs the JAX package: the format zoo (BCSR, COO, dense,
ELL, MCSR, PCSR, TiledCSR), the CSR methods the zoo calls, the segment
primitives and the flops helpers.  Structure must be exact; dense
results within 1e-7 + 1e-5·(|A|·|B|); CSR values within the
comparators."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu import formats as J
from sparse_matrix_with_flops_tpu.ops import flops as jflops
from sparse_matrix_with_flops_tpu.ops import segments as jseg
from sparse_matrix_with_flops_tpu.ops.spgemm import matmul as jmatmul
from sparse_matrix_with_flops_tpu.utils import generate as jgen
from sparse_matrix_with_flops_tpu_torch import formats as T
from sparse_matrix_with_flops_tpu_torch.ops import flops as tflops
from sparse_matrix_with_flops_tpu_torch.ops import segments as tseg

from conftest import random_csr_np
from torch_port_util import (
    assert_close_dense,
    assert_same_bcsr,
    assert_same_csr,
    both_bcsr,
    jax_random_csr,
    port_csr,
    trimmed,
)


def _dense_eq(got, want, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


# ---- BCSR ------------------------------------------------------------------
BCSR_CASES = [
    ("rand50x70", 8, 16),
    ("rand50x70", 8, 128),
    ("rand50x70", 3, 7),
    ("band64", 8, 8),
    ("rmat8", 8, 128),
    ("empty", 8, 16),
]


def _zoo_matrix(rng, name):
    if name == "rand50x70":
        return jax_random_csr(rng, 50, 70, 0.2)
    if name == "band64":
        return jgen.banded_csr(64, bandwidth=5, seed=2)
    if name == "rmat8":
        return jgen.rmat_csr(8, edge_factor=8, seed=3, weights="random")
    return J.CSR.from_dense(np.zeros((20, 30), np.float32))


@pytest.mark.parametrize("name,br,bc", BCSR_CASES)
def test_bcsr_from_csr_is_bit_equal(rng, name, br, bc):
    ja = _zoo_matrix(rng, name)
    jb, tb = both_bcsr(ja, br, bc)
    assert_same_bcsr(jb, tb)
    assert (tb.nbrows, tb.nbcols, tb.block_capacity) == (jb.nbrows, jb.nbcols, jb.block_capacity)
    assert int(tb.nblocks) == int(jb.nblocks)
    _dense_eq(tb.to_dense(), jb.to_dense())
    assert tb.is_equal(port_csr(ja)) and jb.is_equal(ja)
    assert float(tb.nonzero_density()) == pytest.approx(float(jb.nonzero_density()), rel=1e-6)


def test_bcsr_duplicates_summed_and_is_equal_detects_change(rng):
    # duplicate (row, col) entries in one row are summed into the block
    rp = np.array([0, 3, 4], np.int32)
    c = np.array([1, 1, 5, 0], np.int32)
    v = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    ja = J.CSR.from_arrays(rp, c, v, ncols=6)
    jb, tb = both_bcsr(ja, 2, 4)
    assert_same_bcsr(jb, tb)
    assert float(tb.to_dense()[0, 1]) == 3.0
    other = T.CSR.from_numpy(rp, c, np.array([1.0, 2.0, 3.5, 4.0], np.float32), 6, device="cpu")
    assert not tb.is_equal(other)


# ---- COO -------------------------------------------------------------------
def _both_coo(row, col, val, nrows, ncols, capacity=None):
    return (
        J.COO.from_numpy(row, col, val, nrows, ncols, capacity=capacity),
        T.COO.from_numpy(row, col, val, nrows, ncols, capacity=capacity, device="cpu"),
    )


def _same_coo(jc, tc):
    assert int(tc.nnz) == int(jc.nnz) and (tc.nrows, tc.ncols) == (jc.nrows, jc.ncols)
    np.testing.assert_array_equal(tc.row.numpy(), np.asarray(jc.row))
    np.testing.assert_array_equal(tc.col.numpy(), np.asarray(jc.col))
    np.testing.assert_allclose(tc.val.numpy(), np.asarray(jc.val), rtol=1e-6, atol=1e-7)


COO_INPUTS = {
    "loops": ([0, 1, 2], [1, 1, 0], [5.0, 3.0, 2.0], 4, 4, 12),
    "dups": ([2, 0, 2, 1, 0, 2], [1, 3, 1, 0, 3, 0], [1.0, 2.0, 3.0, 4.0, -2.0, 6.0], 3, 4, 9),
    "empty_rows": ([3, 3], [0, 1], [1.0, 2.0], 5, 2, 4),
}


@pytest.mark.parametrize("name", sorted(COO_INPUTS))
@pytest.mark.parametrize("op", ["make_ordered", "sum_duplicates", "transpose"])
def test_coo_ops_match_reference(name, op):
    jc, tc = _both_coo(*COO_INPUTS[name])
    _same_coo(getattr(jc, op)(), getattr(tc, op)())


@pytest.mark.parametrize("name", sorted(COO_INPUTS))
def test_coo_to_csr_and_to_dense_match_reference(name):
    jc, tc = _both_coo(*COO_INPUTS[name])
    jo, to = jc.sum_duplicates(), tc.sum_duplicates()
    assert_same_csr(jo.to_csr(), to.to_csr())
    _dense_eq(tc.to_dense(), jc.to_dense())
    _dense_eq(to.to_dense(), jo.to_dense(), atol=1e-6)


@pytest.mark.parametrize("capacity", [12, 5])
def test_coo_add_self_loops_matches_reference(capacity):
    # capacity 5 drops the loops that do not fit, as the reference does
    jc, tc = _both_coo([0, 1, 2], [1, 1, 0], [5.0, 3.0, 2.0], 4, 4, capacity)
    _same_coo(jc.add_self_loops(), tc.add_self_loops())
    with pytest.raises(ValueError):
        _both_coo([0], [1], [1.0], 2, 3)[1].add_self_loops()


# ---- CSR methods and segment primitives ------------------------------------
def test_csr_methods_match_reference(rng):
    rp, c, v = random_csr_np(rng, 9, 11, 0.4)
    perm = np.concatenate([rng.permutation(np.arange(s, e)) for s, e in zip(rp[:-1], rp[1:])])
    ja = J.CSR.from_arrays(rp, c[perm], -v[perm], ncols=11, capacity=int(rp[-1]) + 5)
    ta = T.CSR.from_numpy(rp, c[perm], -v[perm], 11, capacity=int(rp[-1]) + 5, device="cpu")
    np.testing.assert_array_equal(ta.row_counts().numpy(), np.asarray(ja.row_counts()))
    assert ta.cols == ja.cols == 11
    assert_same_csr(ja.make_ordered(), ta.make_ordered())
    np.testing.assert_array_equal(ta.make_ordered().col_ind.numpy(), np.asarray(ja.make_ordered().col_ind))
    assert_same_csr(ja.to_abs(), ta.to_abs())
    wj, wt = ja.with_capacity(40), ta.with_capacity(40)
    assert wt.capacity == wj.capacity == 40
    np.testing.assert_array_equal(wt.col_ind.numpy(), np.asarray(wj.col_ind))
    d = ta.deep_copy()
    d.values[0] = 99.0
    assert float(ta.values[0]) != 99.0
    for x, y in zip(ja.to_one_based(), ta.to_one_based()):
        np.testing.assert_array_equal(np.asarray(x), y)
    back = T.CSR.from_one_based(*ta.to_one_based(), 11, device="cpu")
    assert_same_csr(J.CSR.from_one_based(*ja.to_one_based(), 11), back)


def test_segment_primitives_match_reference(rng):
    rp = np.array([0, 2, 2, 5, 9], np.int32)
    np.testing.assert_array_equal(
        tseg.entry_rows(torch.from_numpy(rp), 12).numpy(),
        np.asarray(jseg.entry_rows(jnp.asarray(rp), 12)),
    )
    ka = np.sort(rng.integers(0, 4, 30)).astype(np.int32)
    kb = rng.integers(0, 3, 30).astype(np.int32)
    valid = rng.random(30) < 0.8
    np.testing.assert_array_equal(
        tseg.segment_boundaries(*map(torch.from_numpy, (ka, kb, valid))).numpy(),
        np.asarray(jseg.segment_boundaries(jnp.asarray(ka), jnp.asarray(kb), jnp.asarray(valid))),
    )
    vals = rng.standard_normal(30).astype(np.float32)
    ids = rng.integers(-2, 9, 30).astype(np.int32)  # some out of range
    got = tseg.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), 7)
    want = jseg.segment_sum(jnp.asarray(vals), jnp.asarray(ids), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    starts = np.array([0, 3, 3, 7, 20], np.int32)
    ok = np.array([True, False, True, True, True])
    np.testing.assert_array_equal(
        tseg.repeat_segments(torch.from_numpy(starts), torch.from_numpy(ok), 12).numpy(),
        np.asarray(jseg.repeat_segments(jnp.asarray(starts), jnp.asarray(ok), 12)),
    )


def test_flops_match_reference(rng):
    ja, jb = jax_random_csr(rng, 17, 13, 0.3), jax_random_csr(rng, 13, 19, 0.3)
    ta, tb = port_csr(ja).with_capacity(int(ja.nnz) + 4), port_csr(jb)
    ja = ja.with_capacity(int(ja.nnz) + 4)
    np.testing.assert_array_equal(
        tflops.entry_flops(ta, tb).numpy(), np.asarray(jflops.entry_flops(ja, jb))
    )
    rf, tot = tflops.spgemm_flops(ta, tb)
    jrf, jtot = jflops.spgemm_flops(ja, jb)
    assert rf.dtype == torch.int32 and tot.dtype == torch.int32
    np.testing.assert_array_equal(rf.numpy(), np.asarray(jrf))
    assert int(tot) == int(jtot)


# ---- DenseMatrix -------------------------------------------------------------
def test_dense_matmul_and_to_csr_match_reference(rng):
    ja, jb = jax_random_csr(rng, 12, 14, 0.4), jax_random_csr(rng, 14, 10, 0.4)
    jd = J.DenseMatrix.from_csr(ja).matmul(J.DenseMatrix.from_csr(jb))
    td = T.DenseMatrix.from_csr(port_csr(ja)).matmul(T.DenseMatrix.from_csr(port_csr(jb)))
    assert (td.rows, td.cols) == (jd.rows, jd.cols)
    assert td.data.dtype == torch.float32
    assert_close_dense(td.data.numpy(), np.asarray(jd.data), np.asarray(ja.to_dense()), np.asarray(jb.to_dense()))
    # an exact zero in the dense matrix is dropped by to_csr
    z = np.asarray(jd.data).copy()
    z[0, :] = 0.0
    assert_same_csr(J.DenseMatrix(jnp.asarray(z)).to_csr(), T.DenseMatrix(torch.from_numpy(z)).to_csr())


# ---- ELL ---------------------------------------------------------------------
@pytest.mark.parametrize("width", [None, 2, 40])
def test_ell_matches_reference(rng, width):
    ja = jax_random_csr(rng, 26, 31, 0.2)
    je, te = J.ELL.from_csr(ja, width), T.ELL.from_csr(port_csr(ja), width)
    np.testing.assert_array_equal(te.col.numpy(), np.asarray(je.col))
    np.testing.assert_array_equal(te.val.numpy(), np.asarray(je.val))
    assert te.width == je.width and int(te.nnz) == int(je.nnz)
    _dense_eq(te.to_dense(), je.to_dense())
    ed = np.asarray(je.to_dense())  # truncated rows: the ELL's own matrix
    x = rng.standard_normal(31).astype(np.float32)
    assert_close_dense(te.spmv(torch.from_numpy(x)).numpy(), np.asarray(je.spmv(jnp.asarray(x))), ed, x)
    b = rng.standard_normal((31, 9)).astype(np.float32)
    assert_close_dense(te.spmm(torch.from_numpy(b)).numpy(), np.asarray(je.spmm(jnp.asarray(b))), ed, b)


# ---- MCSR --------------------------------------------------------------------
@pytest.mark.parametrize("block_rows,block_cols", [(8, 16), (30, 30), (0, 5)])
def test_mcsr_matches_reference(rng, block_rows, block_cols):
    ja = jax_random_csr(rng, 30, 30, 0.3)
    jm = J.MCSR.from_csr(ja, block_rows, block_cols)
    tm = T.MCSR.from_csr(port_csr(ja), block_rows, block_cols)
    np.testing.assert_array_equal(tm.dense.numpy(), np.asarray(jm.dense))
    assert_same_csr(jm.rest, tm.rest)
    ad = np.asarray(ja.to_dense())
    _dense_eq(tm.to_dense(), jm.to_dense())
    x = rng.standard_normal(30).astype(np.float32)
    assert_close_dense(tm.spmv(torch.from_numpy(x)).numpy(), np.asarray(jm.spmv(jnp.asarray(x))), ad, x)
    b = rng.standard_normal((30, 11)).astype(np.float32)
    assert_close_dense(tm.spmm(torch.from_numpy(b)).numpy(), np.asarray(jm.spmm(jnp.asarray(b))), ad, b)


# ---- TiledCSR ----------------------------------------------------------------
def test_tiled_spmv_and_row_ptr_match_reference(rng):
    # row regions out of row order, with gaps and an empty row; one
    # region ends at the last slot
    counts = np.array([3, 0, 2, 4], np.int32)
    base = np.array([9, 0, 3, 12], np.int32)
    t = 16
    col = np.full(t, 7, np.int32)
    val = np.zeros(t, np.float32)
    for b, n in zip(base, counts):
        col[b : b + n] = np.sort(rng.choice(7, n, replace=False))
        val[b : b + n] = rng.standard_normal(n)
    jt = J.TiledCSR(*(jnp.asarray(x) for x in (col, val, counts, base)), 7)
    tt = T.TiledCSR(*(torch.from_numpy(x) for x in (col, val, counts, base)), 7)
    np.testing.assert_array_equal(tt.row_ptr().numpy(), np.asarray(jt.row_ptr()))
    x = rng.standard_normal(7).astype(np.float32)
    assert_close_dense(
        tt.spmv(torch.from_numpy(x)).numpy(), np.asarray(jt.spmv(jnp.asarray(x))),
        np.asarray(jt.to_host_csr().to_dense()), x,
    )


# ---- PCSR --------------------------------------------------------------------
@pytest.mark.parametrize("stripes", [1, 3])
def test_pcsr_matches_reference(rng, stripes):
    ja, jb = jax_random_csr(rng, 16, 23, 0.25), jax_random_csr(rng, 23, 23, 0.25)
    jp, tp = J.PCSR.from_csr(jb, stripes), T.PCSR.from_csr(port_csr(jb), stripes)
    assert (tp.num_stripes, tp.stride, tp.rows) == (jp.num_stripes, jp.stride, jp.rows)
    for js, ts in zip(jp.stripes, tp.stripes):
        assert_same_csr(js, ts)
    assert_same_csr(jp.to_csr(), tp.to_csr())
    jc, tc = jp.striped_spgemm(ja), tp.striped_spgemm(port_csr(ja))
    for js, ts in zip(jc.stripes, tc.stripes):
        assert_same_csr(js, ts)  # stream ESC keeps cancellations
    assert_same_csr(jc.to_csr(), tc.to_csr())
    whole = jmatmul(ja, jb)
    np.testing.assert_array_equal(trimmed(tc.to_csr())[1], trimmed(whole._drop_explicit_zeros())[1])
