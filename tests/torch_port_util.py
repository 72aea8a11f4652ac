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
