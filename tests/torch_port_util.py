"""Helpers for the tests that hold the PyTorch port against the JAX
package: the same host arrays go into both, and results come back as
numpy arrays for comparison."""

import numpy as np

from sparse_matrix_with_flops_tpu.config import ABS_TOL, REL_TOL
from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR as TCSR


def both_csr(row_ptr, col_ind, values, ncols):
    """(JAX CSR, port CSR) built from the same host arrays."""
    return (
        JCSR.from_arrays(row_ptr, col_ind, values, ncols=ncols),
        TCSR.from_numpy(row_ptr, col_ind, values, ncols),
    )


def trimmed(c):
    """Tight host ``(row_ptr, col_ind, values)`` of a CSR of either package."""
    rp = np.asarray(c.row_ptr)
    nnz = int(rp[-1])
    return rp, np.asarray(c.col_ind)[:nnz], np.asarray(c.values)[:nnz]


def assert_close_values(got, want):
    """Values within 1e-7 abs or 1e-3 rel (the reference's comparators):
    both sides sum in f32, in different orders."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    bound = np.maximum(ABS_TOL, REL_TOL * np.maximum(np.abs(got), np.abs(want)))
    bad = np.nonzero(err > bound)[0]
    assert bad.size == 0, (bad[:5], got[bad[:5]], want[bad[:5]])


def assert_same_csr(ref, port):
    """Exact structure and nnz, values within the comparators' bound."""
    rp_r, ci_r, v_r = trimmed(ref)
    rp_p, ci_p, v_p = trimmed(port)
    assert ref.shape == port.shape
    np.testing.assert_array_equal(rp_p, rp_r)
    np.testing.assert_array_equal(ci_p, ci_r)
    assert_close_values(v_p, v_r)


def jax_random_csr(rng, rows, cols, density, empty_rows=()):
    """A JAX-package CSR with ~density fill of standard-normal values
    (``conftest.random_csr_np``), the rows in ``empty_rows`` emptied."""
    from conftest import random_csr_np

    rp, c, v = random_csr_np(rng, rows, cols, density)
    dense = np.zeros((rows, cols), np.float32)
    dense[np.repeat(np.arange(rows), np.diff(rp)), c] = v
    dense[list(empty_rows)] = 0.0
    return JCSR.from_dense(dense)


def port_csr(jcsr):
    """The port's CSR of a JAX-package CSR, from its tight host arrays."""
    rp, ci, v = trimmed(jcsr)
    return TCSR.from_numpy(rp, ci, v, jcsr.ncols)


def both_bcsr(jcsr, br, bc):
    """(JAX BCSR, port BCSR) of the same matrix and block shape."""
    from sparse_matrix_with_flops_tpu.formats.bcsr import BCSR as JBCSR
    from sparse_matrix_with_flops_tpu_torch.formats.bcsr import BCSR as TBCSR

    return JBCSR.from_csr(jcsr, br, bc), TBCSR.from_csr(port_csr(jcsr), br, bc)


def assert_same_bcsr(ref, port):
    """Bit-equal block arrays and the same geometry."""
    assert (port.rows, port.cols, port.br, port.bc) == (
        ref.rows, ref.cols, ref.br, ref.bc,
    )
    np.testing.assert_array_equal(
        port.block_row_ptr.numpy(), np.asarray(ref.block_row_ptr)
    )
    np.testing.assert_array_equal(port.block_col.numpy(), np.asarray(ref.block_col))
    np.testing.assert_array_equal(port.blocks.numpy(), np.asarray(ref.blocks))


def assert_close_dense(got, want, a_dense, b):
    """Dense results of A·B within 1e-7 + 1e-5·(|A|·|B|) elementwise: a
    bound on the f32 rounding of any summation order, which holds for
    entries that cancel too."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = 1e-7 + 1e-5 * (
        np.abs(np.asarray(a_dense, np.float64)) @ np.abs(np.asarray(b, np.float64))
    )
    bad = np.argwhere(np.abs(got - want) > bound)
    assert bad.size == 0, (bad[:5], got[tuple(bad[:5].T)], want[tuple(bad[:5].T)])
