"""General R-MCL on the CPU: the port's ``rmcl_one_step``, the scan and
loop modes, the overflow flags, the backend registry, the drift
metrics and CSR methods, clusters, checkpoints and the timing helpers,
each held against the JAX package on the same host arrays.

Structure (row_ptr, columns, nnz) must match exactly; values within
``ABS_TOL`` 1e-7 or ``REL_TOL`` 1e-3 (``torch_port_util``)."""

import importlib

import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
from sparse_matrix_with_flops_tpu.io import load_coo as j_load_coo
from sparse_matrix_with_flops_tpu.models import checkpoint as JCK
from sparse_matrix_with_flops_tpu.models import clusters as JCL
from sparse_matrix_with_flops_tpu.ops import metrics as JM
from sparse_matrix_with_flops_tpu.utils import perm as JP
from sparse_matrix_with_flops_tpu_torch.io import load_coo as t_load_coo
from sparse_matrix_with_flops_tpu_torch.models import checkpoint as TCK
from sparse_matrix_with_flops_tpu_torch.models import clusters as TCL
from sparse_matrix_with_flops_tpu_torch.ops import metrics as TM
from sparse_matrix_with_flops_tpu_torch.utils import perm as TP
from sparse_matrix_with_flops_tpu_torch.utils import timing as TT

from torch_port_util import assert_close_values, assert_same_csr, port_csr, trimmed

JR = importlib.import_module("sparse_matrix_with_flops_tpu.models.rmcl")
TR = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl")
TDATA = "tests/tdatas/tdata.snap"


def _stochastic(n: int, density: float, seed: int, uniform: bool = False) -> JCSR:
    """A row-stochastic R-MCL iterate with every diagonal entry: random
    positive weights normalised a row, or with ``uniform`` the
    reference's ``aver_and_norm_rows`` values (many exact ties)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    np.fill_diagonal(mask, True)
    d = np.where(mask, 1.0 if uniform else rng.random((n, n)) + 0.05, 0.0)
    return JCSR.from_dense((d / d.sum(1, keepdims=True)).astype(np.float32))


def _tdata():
    """(JAX, port) R-MCL inits of ``tdata.snap`` (rmcl_init)."""
    j = JR.rmcl_init(j_load_coo(TDATA, extra_capacity=16))
    t = TR.rmcl_init(t_load_coo(TDATA, extra_capacity=16, device="cpu"))
    assert_same_csr(j, t)
    return j, t


GRAPHS = [(12, 0.3, 0, False), (24, 0.15, 1, False), (40, 0.1, 2, False),
          (64, 0.08, 3, True), (128, 0.05, 4, False), (256, 0.02, 5, True)]


def _info_np(info):
    return {k: int(np.asarray(v)) for k, v in info.items()}


# ---- one step ------------------------------------------------------------------
@pytest.mark.parametrize("n,density,seed,uniform", GRAPHS)
def test_one_step_matches_reference(n, density, seed, uniform):
    j = _stochastic(n, density, seed, uniform)
    t = port_csr(j)
    pc, cc = JR.plan_capacities(j, j, margin=1.0)
    assert TR.plan_capacities(t, t, margin=1.0) == (pc, cc)
    jm, jinfo = JR.rmcl_one_step(j, j.with_capacity(cc), pc, cc)
    tm, tinfo = TR.rmcl_one_step(t, t.with_capacity(cc), pc, cc)
    assert tm.capacity == jm.capacity == cc
    assert_same_csr(jm, tm)
    assert _info_np(tinfo) == _info_np(jinfo)
    # rows of the result sum to one
    sums = tm.to_dense().sum(1).numpy()
    np.testing.assert_allclose(sums, 1.0, rtol=1e-5)


@pytest.mark.parametrize("n,density,seed,uniform", GRAPHS[:4])
def test_one_step_unfused_matches_reference(n, density, seed, uniform):
    j = _stochastic(n, density, seed, uniform)
    t = port_csr(j)
    jm, jo = JR.rmcl_one_step_unfused(j, j)
    tm, to = TR.rmcl_one_step_unfused(t, t)
    assert_same_csr(jm, tm)
    assert bool(to) == bool(jo) is False
    # the unfused shape equals the fused one
    pc, cc = TR.plan_capacities(t, t, margin=1.0)
    fused, _ = TR.rmcl_one_step(t, t.with_capacity(cc), pc, cc)
    assert_same_csr(fused, tm)


@pytest.mark.parametrize("which", ["products", "c", "mt"])
def test_overflow_flags_match_reference(which):
    """Capacities sized to overflow (products, C, or the iterate: Mgt
    with uniform rows keeps every entry of Mgt · I, more than I's
    capacity): the flags and exact counts equal the reference's, and so
    does the truncated iterate."""
    j = _stochastic(10, 0.5, 7, uniform=True)
    pc, cc = JR.plan_capacities(j, j, margin=1.0)
    if which == "products":
        pc = cc = max(pc // 4, 1)
    elif which == "c":
        cc = max(cc // 4, 1)
    mt = JCSR.from_dense(np.eye(10, dtype=np.float32)) if which == "mt" else j.with_capacity(cc)
    jm, jinfo = JR.rmcl_one_step(j, mt, pc, cc)
    tm, tinfo = TR.rmcl_one_step(port_csr(j), port_csr(mt).with_capacity(mt.capacity), pc, cc)
    assert _info_np(tinfo) == _info_np(jinfo)
    assert bool(tinfo[f"overflow_{which}"])
    assert_same_csr(jm, tm)


# ---- scan and loop ----------------------------------------------------------------
@pytest.mark.parametrize("mode", ["scan", "loop"])
@pytest.mark.parametrize("n,density,seed,uniform", [GRAPHS[0], GRAPHS[3], GRAPHS[5]])
def test_rmcl_matches_reference(mode, n, density, seed, uniform):
    j = _stochastic(n, density, seed, uniform)
    jr = JR.rmcl(j, max_iters=4, mode=mode, margin=2.0)
    tr = TR.rmcl(port_csr(j), max_iters=4, mode=mode, margin=2.0)
    assert_same_csr(jr.mt, tr.mt)
    assert tr.iters == jr.iters == 4
    np.testing.assert_array_equal(tr.nnz_history, jr.nnz_history)
    np.testing.assert_array_equal(tr.flops_history, jr.flops_history)
    assert_close_values(tr.differs_history, jr.differs_history)
    assert tr.overflow == jr.overflow is False


@pytest.mark.parametrize("graph", ["tdata", "rand"])
def test_scan_equals_loop(graph):
    """Deterministic steps: the scan (first plan's capacities) and the
    loop (re-planned capacities) give the same bits."""
    t = _tdata()[1] if graph == "tdata" else port_csr(_stochastic(48, 0.1, 9))
    s = TR.rmcl(t, max_iters=5, mode="scan", margin=3.0)
    lp = TR.rmcl(t, max_iters=5, mode="loop", margin=3.0)
    for x, y in zip(trimmed(s.mt), trimmed(lp.mt)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(s.nnz_history, lp.nnz_history)
    assert not s.overflow and not lp.overflow


def test_rmcl_from_coo_and_row_growth_match_reference():
    jcoo = j_load_coo(TDATA, extra_capacity=16)
    tcoo = t_load_coo(TDATA, extra_capacity=16, device="cpu")
    jr = JR.rmcl(jcoo, max_iters=3, mode="loop", track_row_growth=True, margin=4.0)
    tr = TR.rmcl(tcoo, max_iters=3, mode="loop", track_row_growth=True, margin=4.0)
    assert_same_csr(jr.mt, tr.mt)
    assert len(tr.row_growth) == 3
    for a, b in zip(jr.row_growth, tr.row_growth):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_scan_overflow_matches_reference():
    """A scan whose fixed capacities the second step outgrows reports
    overflow, as the reference's does, and grows nothing."""
    j = _stochastic(32, 0.12, 11)
    pc, _ = JR.plan_capacities(j, j, margin=1.0)
    jr = JR.rmcl(j, max_iters=3, mode="scan", product_cap=pc // 2, c_cap=pc // 2)
    tr = TR.rmcl(port_csr(j), max_iters=3, mode="scan", product_cap=pc // 2, c_cap=pc // 2)
    assert tr.overflow and jr.overflow
    assert tr.mt.capacity == jr.mt.capacity == pc // 2
    np.testing.assert_array_equal(tr.nnz_history, jr.nnz_history)
    np.testing.assert_array_equal(tr.flops_history, jr.flops_history)
    assert_same_csr(jr.mt, tr.mt)


def test_rmcl_scan_history_stays_on_the_device():
    t = port_csr(_stochastic(16, 0.2, 3))
    pc, cc = TR.plan_capacities(t, t, 2.0)
    mt, hist = TR.rmcl_scan(t, t.with_capacity(cc), pc, cc, 3, track_differs=False)
    assert sorted(hist) == ["differs", "flops", "nnz", "overflow"]
    assert all(isinstance(v, torch.Tensor) and v.shape == (3,) for v in hist.values())
    assert not bool(hist["differs"].any()) and hist["overflow"].dtype == torch.bool
    assert mt.capacity == cc


@pytest.mark.parametrize("name", sorted(JR.BACKENDS))
def test_backends(name):
    assert sorted(TR.BACKENDS) == sorted(JR.BACKENDS)
    assert TR.BACKENDS[name] is TR.rmcl_one_step
    t = port_csr(_stochastic(12, 0.3, 0))
    ref = TR.rmcl(t, max_iters=2, mode="loop", margin=2.0)
    got = TR.rmcl(t, max_iters=2, mode="loop", margin=2.0, backend=name.lower())
    for x, y in zip(trimmed(ref.mt), trimmed(got.mt)):
        np.testing.assert_array_equal(x, y)


def test_profile_prints_the_spans(capsys):
    TR.rmcl(port_csr(_stochastic(12, 0.3, 0)), max_iters=2, mode="loop", profile=True)
    out = capsys.readouterr().out
    assert "plan: n=2" in out and "one_step: n=2" in out


# ---- metrics and CSR methods ------------------------------------------------------
def _pair(seed):
    a = _stochastic(30, 0.15, seed)
    pc, cc = JR.plan_capacities(a, a, margin=1.0)
    b, _ = JR.rmcl_one_step(a, a.with_capacity(cc), pc, cc)
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_reference(seed):
    ja, jb = _pair(seed)
    ta, tb = port_csr(ja), port_csr(jb)
    jd2, jn2 = JM.csr_frobenius_diff(ja, jb)
    td2, tn2 = TM.csr_frobenius_diff(ta, tb)
    assert_close_values([float(td2), float(tn2)], [float(jd2), float(jn2)])
    assert_close_values([float(TM.differs(ta, tb))], [float(JM.differs(ja, jb))])
    assert float(TM.differs(ta, ta)) == 0.0
    np.testing.assert_array_equal(
        TM.row_growth_histogram(ta, tb).numpy(), np.asarray(JM.row_growth_histogram(ja, jb))
    )
    # the dense CSR.differs and CSR.row_growth_stats
    assert_close_values([float(ta.differs(tb))], [float(ja.differs(jb))])
    np.testing.assert_array_equal(
        ta.row_growth_stats(tb).numpy(), np.asarray(ja.row_growth_stats(jb))
    )
    bounds = (-50.0, 0.0, 50.0)
    np.testing.assert_array_equal(
        ta.row_growth_stats(tb, bounds).numpy(), np.asarray(ja.row_growth_stats(jb, bounds))
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_output_and_row_order_match_reference(tmp_path, seed):
    ja, _ = _pair(seed)
    ta = port_csr(ja)
    assert ta.output(name="m") == ja.output(name="m")
    p = tmp_path / "m.txt"
    ta.output(str(p))
    assert p.read_text() == ja.output()
    np.testing.assert_array_equal(
        ta.row_descending_order_permutation().numpy(),
        np.asarray(ja.row_descending_order_permutation()),
    )
    assert ta.row_descending_order_permutation().dtype == torch.int32


# ---- clusters and checkpoints -------------------------------------------------------
@pytest.mark.parametrize("graph", ["tdata", "rand"])
def test_clusters_match_reference(graph):
    if graph == "tdata":
        j, t = _tdata()
    else:
        j = _stochastic(64, 0.04, 13)
        t = port_csr(j)
    jr = JR.rmcl(j, max_iters=8, mode="loop", margin=4.0)
    tr = TR.rmcl(t, max_iters=8, mode="loop", margin=4.0)
    jl, tl = JCL.extract_clusters(jr.mt), TCL.extract_clusters(tr.mt)
    np.testing.assert_array_equal(tl, jl)
    assert TCL.cluster_sizes(tl) == JCL.cluster_sizes(jl)
    assert sum(TCL.cluster_sizes(tl).values()) == t.rows


def test_checkpoint_roundtrip_reads_the_reference_layout(tmp_path):
    j, t = _tdata()
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JCK.save_checkpoint(pj, j, 3, extra={"note": 42})
    TCK.save_checkpoint(pt, t, 3, extra={"note": 42})
    with np.load(pj) as a, np.load(pt) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    back, it, extra = TCK.load_checkpoint(pj, device="cpu")
    assert it == 3 and int(extra["note"]) == 42
    assert back.is_equal(t) and back.capacity == t.capacity


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, first):
    """Two iterations in one package, the rest in the other, against the
    reference's straight run."""
    j, t = _tdata()
    ref, _, _ = JCK.rmcl_resumable(j, 4, str(tmp_path / "straight.npz"))
    p = str(tmp_path / "ck.npz")
    if first == "jax":
        JCK.rmcl_resumable(j, 2, p)
        got, it, hist = TCK.rmcl_resumable(t, 4, p)
    else:
        TCK.rmcl_resumable(t, 2, p)
        got, it, hist = JCK.rmcl_resumable(j, 4, p)
    assert it == 4 and len(hist) == 2
    assert_same_csr(ref, got)


def test_resumable_raises_on_overflow(tmp_path):
    t = _tdata()[1]
    with pytest.raises(RuntimeError, match="overflow"):
        TCK.rmcl_resumable(t, 2, str(tmp_path / "ck.npz"), margin=0.25)
    got, it, _ = TCK.rmcl_resumable(
        t, 3, str(tmp_path / "ck2.npz"), margin=0.25, raise_on_overflow=False)
    assert it == 3
    with np.load(str(tmp_path / "ck2.npz")) as z:
        assert bool(z["extra_overflow"])


# ---- utils ------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 5])
def test_perm_matches_reference(seed):
    p = TP.random_permutation_vector(37, seed)
    np.testing.assert_array_equal(p, JP.random_permutation_vector(37, seed))
    np.testing.assert_array_equal(TP.permutation_transpose(p), JP.permutation_transpose(p))
    assert (p[TP.permutation_transpose(p)] == np.arange(37)).all()


def test_timing_helpers():
    prof = TT.Profiler()
    x = torch.ones(4)
    with prof.span("a", block_on={"x": [x]}):
        pass
    with prof.span("a"):
        pass
    assert len(prof.spans["a"]) == 2 and prof.report().startswith("a: n=2")
    off = TT.Profiler(enabled=False)
    with off.span("a"):
        pass
    assert off.spans == {} and off.report() == ""
    calls = []
    assert TT.bench_fn(lambda: calls.append(1) or x, warmup=1, iters=3) >= 0.0
    assert len(calls) == 4
    t0 = TT.time_in_mill_now()
    assert TT.time_in_mill_now() >= t0
    assert TT.block_until_ready(x) is x


def test_slope_bench_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.slope_bench(lambda: None)
