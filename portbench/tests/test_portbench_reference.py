"""The plain references against scipy and against a row-by-row NumPy
R-MCL, and the comparison's numbers on planted differences."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from portbench import compare
from portbench.reference import generate, rmcl, spgemm


def _random_csr(rng, m, n, density, law="uniform"):
    a = sp.random(m, n, density=density, format="csr", random_state=rng,
                  data_rvs=(lambda k: rng.standard_normal(k)) if law == "normal" else None)
    a.sort_indices()
    return a


def _t(x, dt=torch.int64):
    return torch.as_tensor(np.asarray(x), dtype=dt)


@pytest.mark.parametrize("block", [1 << 25, 7, 1])
@pytest.mark.parametrize("law", ["uniform", "normal"])
def test_spgemm_equals_scipys_product(block, law):
    rng = np.random.default_rng(4)
    a = _random_csr(rng, 40, 30, 0.1, law)
    b = _random_csr(rng, 30, 50, 0.15, law)
    rp, ci, v = spgemm.spgemm(_t(a.indptr), _t(a.indices), _t(a.data, torch.float32),
                              _t(b.indptr), _t(b.indices), _t(b.data, torch.float32), 50,
                              block=block)
    want = (a.astype(np.float32).astype(np.float64) @ b.astype(np.float32).astype(np.float64))
    want.sort_indices()
    # scipy drops no structural product here: no sum cancels exactly
    np.testing.assert_array_equal(rp.numpy(), want.indptr)
    np.testing.assert_array_equal(ci.numpy(), want.indices)
    np.testing.assert_allclose(v.numpy(), want.data, rtol=1e-13, atol=0)
    assert v.dtype == torch.float64


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.14159265, 0.0])
    r = spgemm.round_tf32(x)
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert float(r[0]) == 1.0 and float(r[4]) == 0.0
    assert float(r[1]) == 1.0 + 2**-10  # ties away from zero
    assert bool(((r - x).abs() <= 2**-11 * x.abs()).all())


def test_the_tf32_control_differs_where_float32_does_not():
    rng = np.random.default_rng(1)
    a = _random_csr(rng, 60, 60, 0.2)
    args = (_t(a.indptr), _t(a.indices), _t(a.data, torch.float32))
    exact = spgemm.spgemm(*args, *args, 60)
    ctl = spgemm.spgemm(*args, *args, 60, precision="tf32")
    rel = ((ctl[2].double() - exact[2]).abs() / exact[2]).max()
    assert 1e-5 < float(rel) < 2e-3


def _rmcl_numpy(rp, ci, n, iters, S):
    """R-MCL row by row in float64 (scipy product, Python loops)."""
    rows = np.repeat(np.arange(n), np.diff(rp))
    a = sp.csr_matrix((np.ones(ci.size), (rows, ci)), shape=(n, n))
    a = (a + sp.diags((a.diagonal() == 0).astype(float))).tocsr()
    a.data[:] = 1.0
    a.sort_indices()
    a = (sp.diags(1.0 / np.diff(a.indptr)) @ a).tocsr()
    a.sort_indices()
    m = a.copy()
    if S is not None:
        m = _rows_op(m, lambda c, v: (c[:S], v[:S] / v[:S].sum()))
    for _ in range(iters):
        c = (a @ m).tocsr()
        c.sort_indices()

        def prune(cols, v):
            w = v * v
            avg = w.sum() / w.size
            t = min(max(0.9 * avg * (1 - 2 * (w.max() - avg)), 1e-7), w.max())
            k = w >= t
            cols, w = cols[k], w[k]
            if S is not None and w.size > S:
                order = np.argsort(-w, kind="stable")[:S]
                order.sort()
                cols, w = cols[order], w[order]
            return cols, w / w.sum()
        m = _rows_op(c, prune)
    return m


def _rows_op(m, f):
    indptr, cols, vals = [0], [], []
    for r in range(m.shape[0]):
        c, v = f(m.indices[m.indptr[r]:m.indptr[r + 1]], m.data[m.indptr[r]:m.indptr[r + 1]])
        cols.append(c)
        vals.append(v)
        indptr.append(indptr[-1] + c.size)
    return sp.csr_matrix((np.concatenate(vals), np.concatenate(cols), indptr), shape=m.shape)


@pytest.mark.parametrize("S", [None, 6])
def test_rmcl_equals_a_row_by_row_numpy_rmcl(S):
    rp, ci, _ = generate.rmat(7, 8, seed=11)
    n = rp.size - 1
    got = rmcl.rmcl(rp, ci, n, 3, S)
    want = _rmcl_numpy(rp, ci, n, 3, S)
    np.testing.assert_array_equal(got[0].numpy(), want.indptr)
    np.testing.assert_array_equal(got[1].numpy(), want.indices)
    np.testing.assert_allclose(got[2].numpy(), want.data, rtol=1e-12)


def test_rmcl_init_adds_missing_self_loops_and_weighs_by_count():
    rp = np.array([0, 2, 3, 3])  # row 0: cols 0, 2; row 1: col 0; row 2: empty
    ci = np.array([0, 2, 0])
    out_rp, out_ci, v = rmcl.init(rp, ci, 3, "cpu")
    assert out_rp.tolist() == [0, 2, 4, 5]
    assert out_ci.tolist() == [0, 2, 0, 1, 2]
    np.testing.assert_allclose(v.numpy(), [0.5, 0.5, 0.5, 0.5, 1.0])


def _csr_t(m):
    return _t(m.indptr), _t(m.indices), torch.as_tensor(m.data, dtype=torch.float64)


@pytest.mark.parametrize("block", [1 << 26, 7, 1])
def test_spgemm_numbers_on_planted_differences(block):
    rng = np.random.default_rng(2)
    c = _random_csr(rng, 20, 20, 0.3)
    ref = _csr_t(c)
    prog = (ref[0].int(), torch.cat([ref[1].int(), torch.tensor([20, 20], dtype=torch.int32)]),
            torch.cat([ref[2].float(), torch.zeros(2)]))  # padded as the port pads

    def numbers(p):
        return compare.spgemm_numbers(p, ref, ref, 20, block=block)

    got = numbers(prog)
    assert got["pattern_diff"] == 0 and got["rel_err"] < 1e-7
    v = prog[2].clone()
    v[5] *= 1.01
    assert numbers((prog[0], prog[1], v))["rel_err"] == pytest.approx(0.01, rel=1e-5)
    col = prog[1].clone()
    col[0] = 20  # an entry out of range matches nothing
    assert numbers((prog[0], col, prog[2]))["pattern_diff"] == 2
    # row 3's last entry left out: every later row shifts against the
    # reference's, yet each row is compared with its own
    rp = prog[0].clone()
    e = int(rp[4]) - 1
    keep = torch.ones(prog[1].shape[0], dtype=torch.bool)
    keep[e] = False
    rp[4:] -= 1
    got = numbers((rp, prog[1][keep], prog[2][keep]))
    assert got["pattern_diff"] == 1 and got["rel_err"] < 1e-7


def test_rmcl_numbers_on_planted_differences():
    rp, ci, _ = generate.rmat(6, 8, seed=5)
    n = rp.size - 1
    ref = rmcl.rmcl(rp, ci, n, 2, 8)
    prog = (ref[0].int(), ref[1].int(), ref[2].float())
    got = compare.rmcl_numbers(prog, ref, n)
    assert got["bad_rows"] == 0 and got["rows_apart"] == 0.0
    assert got["err_matched"] < 1e-6 and got["rowsum_gap"] < 1e-6
    v = prog[2].clone()
    v[0] *= 2
    got = compare.rmcl_numbers((prog[0], prog[1], v), ref, n)
    assert got["err_matched"] == pytest.approx(1.0, rel=1e-6)
    assert got["rowsum_gap"] > 0.0 and got["gap_max"] > 0.0
    col = prog[1].clone()
    r0 = int(ref[0][1])  # a row with two entries or more: swap in another column
    col[0] = (int(col[0]) + n // 2) % n
    got = compare.rmcl_numbers((prog[0], col, prog[2]), ref, n)
    assert got["rows_apart"] == pytest.approx(1 / n) or got["bad_rows"] == 1
    v = prog[2].clone()
    v[: r0] = -1.0
    assert compare.rmcl_numbers((prog[0], prog[1], v), ref, n)["bad_rows"] == 1
