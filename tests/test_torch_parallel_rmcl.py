"""The port's dynamic and adaptive sharded R-MCL and its multi-shard dry
run, with the shards stacked on the CPU, vs the JAX package's on the
8-device virtual CPU mesh: the same numpy inputs, integers and the
repartition's gathers exactly, values within the comparators."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
from sparse_matrix_with_flops_tpu.ops.flops import row_flops as j_row_flops
from sparse_matrix_with_flops_tpu.ops.spgemm import spgemm_upper_bounds
from sparse_matrix_with_flops_tpu.parallel import make_mesh as j_make_mesh
from sparse_matrix_with_flops_tpu.parallel import rmcl as JRM
from sparse_matrix_with_flops_tpu.parallel import sharded as JSH
from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl as t_rmcl
from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl_scan as t_rmcl_scan
from sparse_matrix_with_flops_tpu_torch.parallel import dryrun_multichip, make_mesh
from sparse_matrix_with_flops_tpu_torch.parallel import rmcl as TRM
from sparse_matrix_with_flops_tpu_torch.parallel import sharded as TSH

from torch_port_util import assert_close_values, assert_same_csr, port_csr, use_pallas_dedup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graph(n: int = 48, density: float = 0.15, seed: int = 0) -> JCSR:
    """A row-stochastic R-MCL init with self loops."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    np.fill_diagonal(mask, True)
    return JCSR.from_dense(np.where(mask, 1.0, 0.0).astype(np.float32)).aver_and_norm_rows()


def _skewed(n: int = 128) -> JCSR:
    """The reference test's skewed graph (tests/test_parallel.py:186-198):
    a heavy first block (degree 24) and a light tail (degree 4)."""
    rng = np.random.default_rng(0)
    dense = np.zeros((n, n), np.float32)
    for i in range(n):
        cols = rng.choice(n, size=24 if i < 16 else 4, replace=False)
        dense[i, cols] = 1.0
        dense[i, i] = 1.0
    return JCSR.from_dense(dense).aver_and_norm_rows()


def _both_sharded(j, d, local_capacity=None):
    return (JSH.shard_csr(j, d, local_capacity=local_capacity),
            TSH.shard_csr(port_csr(j), d, local_capacity=local_capacity))


def _same_stack(js, ts, exact=False):
    np.testing.assert_array_equal(ts.row_ptr.numpy(), np.asarray(js.row_ptr))
    np.testing.assert_array_equal(ts.col_ind.numpy(), np.asarray(js.col_ind))
    if exact:
        np.testing.assert_array_equal(ts.values.numpy(), np.asarray(js.values))
    else:
        assert_close_values(ts.values.numpy().ravel(), np.asarray(js.values).ravel())
    assert (ts.ncols, ts.global_rows) == (js.ncols, js.global_rows)


def _same_stats(jst, tst):
    for k in ("flops", "nnz_mt", "overflow"):
        got, want = tst[k].numpy(), np.asarray(jst[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_allclose(tst["differs"].numpy(), np.asarray(jst["differs"]), rtol=1e-5)


# ---- the step and the scan ---------------------------------------------------------
@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_rmcl_step_matches_reference(d):
    j = _graph()
    js, ts = _both_sharded(j, d, local_capacity=j.capacity * 4)
    jmt, jst = JRM.sharded_rmcl_step(j_make_mesh(d), js, js, 4096, 4096)
    tmt, tst = TRM.sharded_rmcl_step(make_mesh(d, "cpu"), ts, ts, 4096, 4096)
    _same_stack(jmt, tmt)
    _same_stats(jst, tst)
    assert float(tst["differs"]) > 0.0 and int(tst["nnz_mt"]) > 0
    _, off = TRM.sharded_rmcl_step(make_mesh(d, "cpu"), ts, ts, 4096, 4096,
                                   track_differs=False)
    assert float(off["differs"]) == 0.0


@pytest.mark.parametrize("flops_scale,margin", [(1, 1.5), (4, 4.0), (1, 0.0)])
def test_plan_shard_capacities_matches_reference(flops_scale, margin):
    j = _graph()
    js, ts = _both_sharded(j, 4)
    flops, _ = spgemm_upper_bounds(j, j)
    assert TRM.plan_shard_capacities(ts, flops * flops_scale, margin) == (
        JRM.plan_shard_capacities(js, flops * flops_scale, margin))


def test_sharded_rmcl_scan_matches_reference_and_single_card():
    """Three iterations at D = 4: the reference's scan, and the port's
    single-card scan on the same graph bit for bit (each shard's product
    stream is the single card's for its rows, in the same order)."""
    d, iters = 4, 3
    j = _graph()
    flops, _ = spgemm_upper_bounds(j, j)
    js, ts = _both_sharded(j, d, local_capacity=j.capacity)
    pc, cc = JRM.plan_shard_capacities(js, flops * 4, margin=4.0)
    jmt, jh = JRM.sharded_rmcl_scan(j_make_mesh(d), js, js, pc, cc, iters)
    tmt, th = TRM.sharded_rmcl_scan(make_mesh(d, "cpu"), ts, ts, pc, cc, iters)
    _same_stack(jmt, tmt)
    _same_stats(jh, th)
    assert th["flops"].shape == (iters,) and not th["overflow"].any()
    t = port_csr(j)
    single, sh = t_rmcl_scan(t, t.with_capacity(cc), flops * 16, cc, iters)
    assert all(np.array_equal(x, y)
               for x, y in zip(TSH.unshard_csr(tmt).to_numpy(), single.to_numpy()))
    np.testing.assert_array_equal(th["nnz_mt"].numpy(), sh["nnz"].numpy())
    np.testing.assert_array_equal(th["flops"].numpy(), sh["flops"].numpy())
    np.testing.assert_allclose(th["differs"].numpy(), sh["differs"].numpy(), rtol=1e-6)


# ---- the adaptive path's pieces ----------------------------------------------------
@pytest.mark.parametrize("n,d", [(48, 4), (30, 4), (43, 8)])
def test_sharded_next_flops_matches_reference(n, d):
    j = _graph(n, seed=n)
    js, ts = _both_sharded(j, d, local_capacity=j.capacity * 4)
    jmt, _ = JRM.sharded_rmcl_step(j_make_mesh(d), js, js, 4096, 4096)
    tmt, _ = TRM.sharded_rmcl_step(make_mesh(d, "cpu"), ts, ts, 4096, 4096)
    for jb, tb in ((js, ts), (jmt, tmt)):
        jrf, jsp, jtot = JRM.sharded_next_flops(j_make_mesh(d), js, jb)
        trf, tsp, ttot = TRM.sharded_next_flops(make_mesh(d, "cpu"), ts, tb)
        assert trf.dtype == torch.int32 and trf.shape == (d, ts.local_rows)
        np.testing.assert_array_equal(trf.numpy(), np.asarray(jrf))
        np.testing.assert_allclose(float(tsp), float(jsp), rtol=1e-6)
        np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-6)


@pytest.mark.parametrize("rows,d", [(32, 4), (30, 4), (17, 8), (128, 4), (7, 1)])
def test_snake_perm_device_matches_reference(rows, d):
    lr = -(-rows // d)
    rng = np.random.default_rng(rows * d)
    rf = rng.integers(0, 50, size=d * lr).astype(np.int32)  # ties included
    want = np.asarray(JRM._snake_perm_device(np.asarray(rf), rows, d, lr))
    got = TRM._snake_perm_device(torch.from_numpy(rf), rows, d, lr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the real rows are dealt as the host's balanced permutation deals them
    real = got.numpy()[got.numpy() < rows]
    np.testing.assert_array_equal(real, TSH.flops_balanced_permutation(rf[:rows], d))


@pytest.mark.parametrize("n,d", [(48, 4), (30, 4)])
def test_device_repartition_pair_matches_reference(n, d):
    j = _graph(n, seed=7 + n)
    js, ts = _both_sharded(j, d, local_capacity=j.capacity * 2)
    jmt, _ = JRM.sharded_rmcl_step(j_make_mesh(d), js, js, 4096, 4096)
    tmt, _ = TRM.sharded_rmcl_step(make_mesh(d, "cpu"), ts, ts, 4096, 4096)
    # one rf for both: the reference's, from its own iterate
    jrf, _, _ = JRM.sharded_next_flops(j_make_mesh(d), js, jmt)
    trf = torch.from_numpy(np.array(jrf))
    # the iterates agree in structure; the values are the reference's so
    # that the gathers can be held exactly
    tmt = TSH.ShardedCSR(tmt.row_ptr, tmt.col_ind, torch.from_numpy(np.array(jmt.values)),
                         tmt.ncols, tmt.global_rows)
    jout = JRM._device_repartition_pair(j_make_mesh(d), js, jmt, jrf, n)
    tout = TRM._device_repartition_pair(make_mesh(d, "cpu"), ts, tmt, trf, n)
    _same_stack(jout[0], tout[0], exact=True)
    _same_stack(jout[1], tout[1], exact=True)
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    assert bool(tout[3]) == bool(jout[3]) is False
    np.testing.assert_allclose(float(tout[4]), float(jout[4]), rtol=1e-6)
    # a capacity the re-dealt iterate does not fit raises the flag
    small = TSH.ShardedCSR(tmt.row_ptr, tmt.col_ind[:, :1], tmt.values[:, :1], tmt.ncols,
                           tmt.global_rows)
    assert bool(TRM._device_repartition_pair(make_mesh(d, "cpu"), ts, small, trf, n)[3])


def test_sharded_rmcl_adaptive_matches_reference():
    """The reference test's skewed graph, D = 4, 5 iterations: the same
    decisions and spreads as the reference, and the single-card loop's
    result in the original labels (tests/test_parallel.py:211-216)."""
    n, d, iters = 128, 4, 5
    j = _skewed(n)
    jgot, jh = JRM.sharded_rmcl_adaptive(j, j_make_mesh(d), max_iters=iters)
    t = port_csr(j)
    tgot, th = TRM.sharded_rmcl_adaptive(t, make_mesh(d, "cpu"), max_iters=iters)
    np.testing.assert_array_equal(th["rebalanced"], jh["rebalanced"])
    np.testing.assert_array_equal(th["overflow"], jh["overflow"])
    np.testing.assert_array_equal(th["nnz"], jh["nnz"])
    for k in ("spread_before", "spread_after"):
        np.testing.assert_allclose(th[k], jh[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(th["differs"], jh["differs"], rtol=0, atol=1e-5)
    assert th["rebalanced"][0] and th["spread_before"][0] > 0.10
    assert np.all(th["spread_after"] < 0.10) and not th["overflow"].any()
    assert_same_csr(jgot.make_ordered(), tgot.make_ordered())
    ref = t_rmcl(t, max_iters=iters, mode="loop")
    a = tgot.make_ordered()._drop_explicit_zeros()
    b = ref.mt.make_ordered()._drop_explicit_zeros()
    assert a.is_raw_equal(b, tol=1e-5)
    np.testing.assert_allclose(th["differs"], ref.differs_history, rtol=1e-3, atol=1e-5)
    # the first repartition's permutation is the host's balanced one
    rf0 = np.array(j_row_flops(j, j))
    np.testing.assert_array_equal(
        TRM._snake_perm_device(torch.from_numpy(rf0), n, d, n // d).numpy(),
        TSH.flops_balanced_permutation(rf0, d))


# ---- the dry run -------------------------------------------------------------------
def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dryrun_multichip_matches_reference(monkeypatch, capsys):
    """``dryrun_multichip(4)`` on the CPU prints the line the reference's
    ``__graft_entry__.dryrun_multichip(4)`` prints, and returns its
    numbers."""
    use_pallas_dedup(monkeypatch)  # the reference's exact dedup (ROADMAP C5)
    _graft_entry().dryrun_multichip(4)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    got = dryrun_multichip(4, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == want
    m = re.search(r"static nnz=(\d+), dynamic nnz=(\d+), differs=([0-9.]+)", want)
    assert got[:2] == (int(m.group(1)), int(m.group(2)))
    assert abs(got[2] - float(m.group(3))) <= 5e-5


# ---- weak scaling ------------------------------------------------------------------
def test_weak_scaling_rows_follow_the_reference_recipe():
    """Stacked D = 1, 2, 4 on the CPU: R-MAT at scale base + log2(D), the
    reference tool's keys, the nnz of a direct ``sharded_rmcl_ell`` run
    (ring, 2 iterations, S = 64), the efficiency against D = 1, and the
    stacked caveat on every D > 1."""
    from sparse_matrix_with_flops_tpu_torch.parallel import sharded_rmcl_ell
    from sparse_matrix_with_flops_tpu_torch.parallel import weak_scaling as WS

    rows = WS.weak_scaling_rmcl_ell((1, 2, 4), base_scale=5, device="cpu")
    assert [(r["devices"], r["scale"], r["rows"]) for r in rows] == [
        (1, 5, 32), (2, 6, 64), (4, 7, 128)]
    for r in rows:
        assert {"devices", "scale", "rows", "ms_per_iter", "nnz_per_s", "nnz",
                "weak_scaling_efficiency_pct", "mesh", "card", "caveat"} <= set(r)
        _, hist = sharded_rmcl_ell(WS.prep(r["scale"], "cpu"), make_mesh(r["devices"], "cpu"),
                                   max_iters=2, S=64, exchange="ring")
        assert r["nnz"] == int(hist["nnz"][-1]) > 0
        assert (r["mesh"], r["card"]) == ("stacked", "cpu")
        assert bool(r["caveat"]) == (r["devices"] > 1)
        assert r["weak_scaling_efficiency_pct"] == pytest.approx(
            rows[0]["ms_per_iter"] / r["ms_per_iter"] * 100.0)
        assert r["nnz_per_s"] == pytest.approx(r["nnz"] / r["ms_per_iter"] * 1e3)
