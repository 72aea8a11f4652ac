"""Helpers for the tests that hold the PyTorch port against the JAX
package: the same host arrays go into both, and results come back as
numpy arrays for comparison."""

import numpy as np
import torch

from sparse_matrix_with_flops_tpu.config import ABS_TOL, REL_TOL
from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR as TCSR


def both_csr(row_ptr, col_ind, values, ncols):
    """(JAX CSR, port CSR) built from the same host arrays."""
    return (
        JCSR.from_arrays(row_ptr, col_ind, values, ncols=ncols),
        TCSR.from_numpy(row_ptr, col_ind, values, ncols, device="cpu"),
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
    return TCSR.from_numpy(rp, ci, v, jcsr.ncols, device="cpu")


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


def port_coo(jcoo):
    """The port's COO of a JAX-package COO, padding slots included."""
    from sparse_matrix_with_flops_tpu_torch.formats.coo import COO as TCOO

    nnz = int(jcoo.nnz)
    return TCOO.from_numpy(
        np.asarray(jcoo.row)[:nnz], np.asarray(jcoo.col)[:nnz],
        np.asarray(jcoo.val)[:nnz], jcoo.nrows, jcoo.ncols, capacity=jcoo.capacity,
        device="cpu",
    )


def _pallas_dedup_tile(tc, tv, n, run=0, _fallback=None):
    """The reference's ``_dedup_tile`` with its TPU branch taken on the
    CPU: the Pallas presorted-run kernel in interpret mode, whose run
    sums are exact where the CPU branch's cumsum difference is not
    (ROADMAP C5).  Tiles narrower than 128 lanes take it too; a tile
    that is no whole number of power-of-two runs keeps the reference's
    own code."""
    import jax.numpy as jnp

    from sparse_matrix_with_flops_tpu.ops.pallas_sort import sort_dedup_compact

    w = tc.shape[1]
    if not (run and w % run == 0 and run & (run - 1) == 0 and w & (w - 1) == 0):
        return _fallback(tc, tv, n, run)
    nseg = w // run
    if nseg > 1:  # reverse odd segments, as the reference's branch does
        flip = (jnp.arange(nseg) & 1).astype(bool)[None, :, None]
        t3 = tc.reshape(-1, nseg, run)
        tc = jnp.where(flip, t3[:, :, ::-1], t3).reshape(-1, w)
        v3 = tv.reshape(-1, nseg, run)
        tv = jnp.where(flip, v3[:, :, ::-1], v3).reshape(-1, w)
    r0 = tc.shape[0]
    rp = -(-r0 // 8) * 8
    if rp != r0:
        tc = jnp.concatenate([tc, jnp.full((rp - r0, w), n, jnp.int32)])
        tv = jnp.concatenate([tv, jnp.zeros((rp - r0, w), jnp.float32)])
    key, val = sort_dedup_compact(tc, tv, n, interpret=True, presorted=run)
    return key[:r0], val[:r0]


def use_pallas_dedup(monkeypatch):
    """Route the reference's R-MCL dedup (single-chip and sharded)
    through the Pallas kernel in interpret mode, for this test only."""
    import functools
    import importlib

    single = importlib.import_module("sparse_matrix_with_flops_tpu.models.rmcl_ell")
    sharded = importlib.import_module("sparse_matrix_with_flops_tpu.parallel.rmcl_ell")
    patched = functools.partial(_pallas_dedup_tile, _fallback=single._dedup_tile)
    monkeypatch.setattr(single, "_dedup_tile", patched)
    monkeypatch.setattr(sharded, "_dedup_tile", patched)


def assert_same_ell(ref_c, ref_v, got_c, got_v):
    """ELL iterates ``[n, S]`` equal: columns exactly, values within the
    comparators; except rows where an exact tie in value straddles the S
    cut.  The reference's top-S sort is not stable (``lax.sort`` without
    ``is_stable``), so it may keep either column of a tie; the port's
    stable sort keeps the lower one.  In such a row the kept values must
    agree as sorted lists, and every column kept by one side only must
    carry the row's smallest kept value.  Returns the number of such
    rows."""
    ref_c, got_c = np.asarray(ref_c), np.asarray(got_c)
    ref_v, got_v = np.asarray(ref_v, np.float64), np.asarray(got_v, np.float64)
    assert ref_c.shape == got_c.shape
    diff = (ref_c != got_c).any(axis=1)
    for r in np.nonzero(diff)[0]:
        assert_close_values(np.sort(got_v[r]), np.sort(ref_v[r]))
        low = ref_v[r][ref_v[r] > 0].min()
        for cols, vals, other in ((ref_c[r], ref_v[r], got_c[r]), (got_c[r], got_v[r], ref_c[r])):
            only = ~np.isin(cols, other)
            assert_close_values(vals[only], np.full(int(only.sum()), low))
    assert_close_values(got_v[~diff].ravel(), ref_v[~diff].ravel())
    return int(diff.sum())


def port_rmcl_state(jax_mt0, cols, vals):
    """The port's R-MCL state from the reference's: Mgt as the port's CSR
    and the ELL iterate ``[n, S]`` (numpy or jax arrays) as tensors, so
    that one step can run from the same state in both packages."""
    import torch

    return (
        port_csr(jax_mt0),
        torch.from_numpy(np.array(cols, np.int32)),
        torch.from_numpy(np.array(vals, np.float32)),
    )


def _assert_same_field(x, y, what):
    if x is None or y is None:
        assert x is None and y is None, what
    elif isinstance(x, (tuple, list)):
        assert isinstance(y, (tuple, list)) and len(x) == len(y), what
        for i, (a, b) in enumerate(zip(x, y)):
            _assert_same_field(a, b, f"{what}[{i}]")
    elif isinstance(x, dict):
        assert isinstance(y, dict) and sorted(x) == sorted(y), what
        for k in x:
            _assert_same_field(x[k], y[k], f"{what}.{k}")
    elif isinstance(x, (int, float, str, np.integer)):
        assert x == y, (what, x, y)
    else:  # numpy / jax array vs numpy array / tensor
        a = np.asarray(x)
        b = y.cpu().numpy() if hasattr(y, "cpu") else np.asarray(y)
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=what)


def assert_same_plan(ref_plan, ref_arrays, port_plan, port_arrays):
    """Every field of the two plans equal, value and dtype; and, for the
    sharded planner, every entry of the stacked ``arrays`` dicts (pass
    None for a planner without one)."""
    import dataclasses

    names = [f.name for f in dataclasses.fields(ref_plan)]
    assert names == [f.name for f in dataclasses.fields(port_plan)]
    for name in names:
        _assert_same_field(getattr(ref_plan, name), getattr(port_plan, name), name)
    _assert_same_field(ref_arrays, port_arrays, "arrays")


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


def same_bits(x, y) -> bool:
    """Bit for bit: tensors (f32 by their bits), port CSRs array by
    array, and dicts, tuples and lists of them."""
    if isinstance(x, TCSR):
        return all(same_bits(getattr(x, k), getattr(y, k))
                   for k in ("row_ptr", "col_ind", "values"))
    if isinstance(x, dict):
        return sorted(x) == sorted(y) and all(same_bits(x[k], y[k]) for k in x)
    if isinstance(x, (tuple, list)):
        return len(x) == len(y) and all(same_bits(a, b) for a, b in zip(x, y))
    bits = (lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t)  # noqa: E731
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(bits(x), bits(y))
