"""The compiled programs (``utils/graphs.py``) on the CPU, where every
run calls the body eagerly, built over the caller's tensors, and no
graph is kept: the graph-form static-ELL scan (carried buffers, a
history written at a device-side index) against the JAX package's
jitted ``rmcl_ell_scan`` and against the eager loop of its step, bit
for bit, at several lengths; the same for the stacked sharded scan
(``parallel/rmcl_ell.sharded_rmcl_ell_scan``, D = 2 and 4, each
exchange); the warm ``spgemm_ell``; a second call on one plan with other
inputs; results and inputs that a later call leaves alone; and a capture
guard, the CPU's stand-in for a capture: each body run with every host
read and upload patched to raise.  The general
``rmcl_scan`` is an eager loop (its graph was measured as no gain); it
takes the same second-call and guard cases.  The card's own checks
(replay against eager, capture failures, launch counts, a graph kept
with its plan) are in ``tests/test_torch_cuda.py``.

The JAX dedup is routed through its Pallas kernel in interpret mode
(``use_pallas_dedup``, ROADMAP C5); the iterates are then held by
``assert_same_ell``: columns exact, values within the comparators (1e-7
abs or 1e-3 rel), ties at the S cut allowed (C6)."""

import importlib
import weakref

import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
from sparse_matrix_with_flops_tpu.parallel import make_mesh as j_make_mesh
from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR
from sparse_matrix_with_flops_tpu_torch.models.rmcl import (
    plan_capacities,
    rmcl_one_step,
    rmcl_scan,
)
from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
from sparse_matrix_with_flops_tpu_torch.ops.metrics import differs as csr_differs
from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh
from sparse_matrix_with_flops_tpu_torch.utils import graphs

from torch_port_util import (
    assert_close_values,
    assert_same_ell,
    port_csr,
    same_bits,
    use_pallas_dedup,
)

JR = importlib.import_module("sparse_matrix_with_flops_tpu.models.rmcl_ell")
TR = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl_ell")
JP = importlib.import_module("sparse_matrix_with_flops_tpu.parallel.rmcl_ell")
TP = importlib.import_module("sparse_matrix_with_flops_tpu_torch.parallel.rmcl_ell")
EXCHANGES = ["ring", "all_gather", "pallas_ring", "fused_ring"]


def _graph(n, p, hubs=(), seed=0):
    """A row-stochastic R-MCL init of ``n`` rows at fill ``p`` with random
    weights (no exact ties), ``hubs`` full rows (the dense hub path)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < p
    np.fill_diagonal(mask, True)
    mask[list(hubs), :] = True
    dense = np.where(mask, rng.random((n, n)) + 0.1, 0.0)
    return JCSR.from_dense((dense / dense.sum(1, keepdims=True)).astype(np.float32))


def _ell_eager(plan, a, adh, cols, vals, iters):
    """The static scan as the eager loop of its step."""
    hist = []
    for _ in range(iters):
        cols, vals, st = TR.rmcl_ell_step(plan, a, adh, cols, vals)
        hist.append(st)
    return cols, vals, {k: torch.stack([h[k] for h in hist]) for k in hist[0]}


def _sharded_eager(mesh, plan, smgt, arrays, cols, vals, exchange, iters):
    """The sharded scan as the eager loop of its step."""
    hist = []
    for _ in range(iters):
        cols, vals, st = TP._sharded_step(plan, smgt, arrays, cols, vals, exchange, mesh)
        hist.append(st)
    return cols, vals, {k: torch.stack([h[k] for h in hist]) for k in hist[0]}


def _general_eager(mgt, mt, pc, cc, iters):
    """The general scan as the eager loop of its step."""
    hist = {"nnz": [], "flops": [], "differs": [], "overflow": []}
    for _ in range(iters):
        new, info = rmcl_one_step(mgt, mt, pc, cc)
        hist["nnz"].append(info["nnz_mt"])
        hist["flops"].append(info["flops"])
        hist["differs"].append(csr_differs(mt, new))
        hist["overflow"].append(info["overflow_products"] | info["overflow_c"]
                                | info["overflow_mt"])
        mt = new
    return mt, {k: torch.stack(v) for k, v in hist.items()}


# ---- the static scan against the JAX package ------------------------------------
@pytest.mark.parametrize("hubs,S,max_tile", [((3,), 32, 256), ((), 8, 256)])
def test_rmcl_ell_scan_matches_reference(monkeypatch, hubs, S, max_tile):
    # a hub row (dense products), or S = 8 (the top-S cut truncates)
    use_pallas_dedup(monkeypatch)
    j = _graph(48, 0.15, hubs)
    jp = JR.plan_rmcl_ell(j, S=S, max_tile=max_tile)
    c0, v0 = JR.mt_to_ell(j, S)
    jc, jv, jh = JR.rmcl_ell_scan(jp, j, JR._dense_huge(j, jp), c0, v0, 3)
    t = port_csr(j)
    tp = TR.plan_rmcl_ell(t, S=S, max_tile=max_tile)
    assert bool(tp.huge_rows.size) == bool(hubs)
    tc0, tv0 = TR.mt_to_ell(t, S)
    tc, tv, th = TR.rmcl_ell_scan(tp, t, TR._dense_huge(t, tp), tc0, tv0, 3)
    assert graphs.held(tp, "rmcl_ell_scan") is None  # the CPU keeps no graph
    assert_same_ell(jc, jv, tc.numpy(), tv.numpy())
    np.testing.assert_array_equal(th["nnz"].numpy(), np.asarray(jh["nnz"]))
    np.testing.assert_array_equal(th["truncated_rows"].numpy(), np.asarray(jh["truncated_rows"]))
    if not hubs:
        assert int(th["truncated_rows"].sum()) > 0
    assert_close_values(th["differs"].numpy(), np.asarray(jh["differs"]))


# ---- the graph form against the eager loop, bit for bit ---------------------------
def _static_case():
    t = port_csr(_graph(64, 0.12, (5,), seed=1))
    plan = TR.plan_rmcl_ell(t, S=16, max_tile=128)
    return t, plan, TR._dense_huge(t, plan), TR.mt_to_ell(t, 16)


def _general_case():
    mgt = port_csr(_graph(64, 0.12, (5,), seed=2))
    pc, cc = plan_capacities(mgt, mgt, 2.5)
    return mgt, mgt.with_capacity(cc), pc, cc


@pytest.mark.parametrize("iters", [1, 2, 4])
def test_rmcl_ell_scan_graph_form_equals_the_eager_loop(iters):
    # one iteration is the length a card run captures nothing at
    t, plan, adh, (c0, v0) = _static_case()
    gc_, gv, gh = TR.rmcl_ell_scan(plan, t, adh, c0, v0, iters)
    wc, wv, wh = _ell_eager(plan, t, adh, c0, v0, iters)
    assert same_bits(gc_, wc) and same_bits(gv, wv) and same_bits(gh, wh)
    assert all(h.shape == (iters,) for h in gh.values())


# ---- the sharded scan: against the JAX package, and against its eager loop ------
S_SH, MT_SH = 32, 256  # two hub rows (full rows of 32) above the 8-entry tiles


def _sharded_iterate(cols, vals, n, ncols, d, S):
    """An ELL iterate [rows, S] as the stacked [d, n / d, S] of a plan of n
    padded rows, the sentinel ncols turned into n (``sharded_rmcl_ell``)."""
    cols = np.where(np.asarray(cols) >= ncols, n, np.asarray(cols))
    vals = np.asarray(vals, np.float32)
    pad = n - cols.shape[0]
    cols = np.concatenate([cols, np.full((pad, S), n, cols.dtype)])
    vals = np.concatenate([vals, np.zeros((pad, S), np.float32)])
    return cols.reshape(d, n // d, S), vals.reshape(d, n // d, S)


def _sharded_case(d, seed=4):
    """(mesh, plan, arrays, smgt, the initial iterate, another iterate) on
    the CPU: 34 rows (padding rows on the last shard at D = 4), two hub
    rows."""
    t = port_csr(_graph(34, 0.12, (5, 20), seed=seed))
    plan, arrays, smgt = TP.plan_sharded_rmcl_ell(t, d, S=S_SH, max_tile=MT_SH)
    assert plan.hmax > 0 and plan.n == -(-t.rows // d) * d
    c0, v0 = (torch.from_numpy(x) for x in _sharded_iterate(
        *TR.mt_to_ell(t, S_SH), plan.n, t.ncols, d, S_SH))
    mesh = make_mesh(d, "cpu")
    x1 = TP._sharded_step(plan, smgt, arrays, c0, v0, "ring", mesh)[:2]
    return mesh, plan, arrays, smgt, (c0, v0), x1


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_sharded_rmcl_ell_scan_graph_form_matches_reference(monkeypatch, d, exchange):
    use_pallas_dedup(monkeypatch)
    j = _graph(34, 0.12, (5, 20), seed=4)
    jp, ja, js = JP.plan_sharded_rmcl_ell(j, d, S=S_SH, max_tile=MT_SH)
    jc0, jv0 = _sharded_iterate(*JR.mt_to_ell(j, S_SH), jp.n, j.ncols, d, S_SH)
    jc, jv, jh = JP.sharded_rmcl_ell_scan(j_make_mesh(d), jp, js, ja, jc0, jv0, 3,
                                          exchange=exchange)
    mesh, plan, arrays, smgt, (c0, v0), _ = _sharded_case(d)
    tc, tv, th = TP.sharded_rmcl_ell_scan(mesh, plan, smgt, arrays, c0, v0, 3, exchange)
    assert graphs.held(plan, "sharded_rmcl_ell_scan") is None  # the CPU keeps no graph
    n = plan.n
    assert_same_ell(np.asarray(jc).reshape(n, S_SH), np.asarray(jv).reshape(n, S_SH),
                    tc.reshape(n, S_SH).numpy(), tv.reshape(n, S_SH).numpy())
    np.testing.assert_array_equal(th["nnz"].numpy(), np.asarray(jh["nnz"]))
    np.testing.assert_array_equal(th["truncated_rows"].numpy(), np.asarray(jh["truncated_rows"]))
    assert_close_values(th["differs"].numpy(), np.asarray(jh["differs"]))


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("iters", [1, 2, 4])
def test_sharded_rmcl_ell_scan_graph_form_equals_the_eager_loop(exchange, iters):
    mesh, plan, arrays, smgt, (c0, v0), _ = _sharded_case(4)
    got = TP.sharded_rmcl_ell_scan(mesh, plan, smgt, arrays, c0, v0, iters, exchange)
    want = _sharded_eager(mesh, plan, smgt, arrays, c0, v0, exchange, iters)
    assert same_bits(got, want)
    assert all(h.shape == (iters,) for h in got[2].values())


# ---- a second call on one plan: its own inputs, the first result and inputs kept --
def _calls(program):
    """Two calls on one plan with different inputs: (first result, second
    result, the second inputs' result from an eager run, the first
    call's inputs, a copy of them taken before the calls)."""
    if program == "rmcl_ell_scan":
        t, plan, adh, (c0, v0) = _static_case()
        c1, v1, _ = TR.rmcl_ell_step(plan, t, adh, c0, v0)  # another iterate
        ins = (t, adh, c0, v0)
        before = _snapshot(ins)
        first = TR.rmcl_ell_scan(plan, t, adh, c0, v0, 3)
        second = TR.rmcl_ell_scan(plan, t, adh, c1, v1, 3)
        return first, second, _ell_eager(plan, t, adh, c1, v1, 3), ins, before
    if program == "sharded_rmcl_ell_scan":
        mesh, plan, arrays, smgt, (c0, v0), (c1, v1) = _sharded_case(4)
        ins = (smgt.row_ptr, smgt.col_ind, smgt.values, arrays, c0, v0)
        before = _snapshot(ins)
        first = TP.sharded_rmcl_ell_scan(mesh, plan, smgt, arrays, c0, v0, 3, "fused_ring")
        second = TP.sharded_rmcl_ell_scan(mesh, plan, smgt, arrays, c1, v1, 3, "fused_ring")
        return (first, second, _sharded_eager(mesh, plan, smgt, arrays, c1, v1, "fused_ring", 3),
                ins, before)
    if program == "rmcl_scan":
        mgt, mt, pc, cc = _general_case()
        mt1, _ = rmcl_one_step(mgt, mt, pc, cc)
        ins = (mgt, mt)
        before = _snapshot(ins)
        first = rmcl_scan(mgt, mt, pc, cc, 3)
        second = rmcl_scan(mgt, mt1, pc, cc, 3)
        return first, second, _general_eager(mgt, mt1, pc, cc, 3), ins, before
    a = port_csr(_graph(96, 0.1, (7,), seed=3))
    plan = E.plan_ell(a, a)
    E.spgemm_ell(a, a, plan)  # two-phase: caches the nnz(C) bucket
    before = _snapshot((a,))
    first = E.spgemm_ell(a, a, plan)  # the warm body
    a2 = CSR(a.row_ptr, a.col_ind, 2.0 * a.values, a.ncols)
    second = E.spgemm_ell(a2, a, plan)
    assert graphs.held(plan, "spgemm_ell") is None  # the CPU keeps no graph
    return (first,), (second,), (CSR(first.row_ptr, first.col_ind, 2.0 * first.values,
                                      first.ncols),), (a,), before


def _snapshot(x):
    if isinstance(x, CSR):
        return CSR(x.row_ptr.clone(), x.col_ind.clone(), x.values.clone(), x.ncols)
    if isinstance(x, dict):
        return {k: _snapshot(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_snapshot(v) for v in x)
    return x.clone()


@pytest.mark.parametrize("program",
                         ["rmcl_ell_scan", "rmcl_scan", "spgemm_ell", "sharded_rmcl_ell_scan"])
def test_a_second_call_on_one_plan_takes_its_own_inputs(program):
    first, second, want, ins, before = _calls(program)
    kept = _snapshot(first)
    # the second call's own result (SpGEMM: A's values doubled, C doubles
    # exactly), the first call's tensors left alone (no aliasing), and the
    # first call's inputs unwritten (the scans' carries are copies)
    assert same_bits(second, want)
    assert same_bits(first, kept)
    assert same_bits(ins, before)


# ---- the capture guard ------------------------------------------------------------
def _raiser(name):
    def f(*args, **kwargs):
        raise AssertionError(f"{name} inside a captured body")
    return f


HOST_READS = {
    torch.Tensor: ("item", "__int__", "__float__", "__bool__", "tolist", "cpu", "numpy",
                   "nonzero"),
    torch: ("from_numpy", "nonzero", "tensor", "as_tensor"),
}


@pytest.mark.parametrize("program", ["rmcl_ell_scan", "rmcl_scan", "spgemm_ell"]
                         + [f"sharded_rmcl_ell_scan {ex}" for ex in EXCHANGES])
def test_capture_guard_bodies_make_no_host_read(program, monkeypatch):
    # the body that a card captures, built (plan uploads first) before the
    # guard goes on; the general scan is eager: the whole call is guarded
    if program.startswith("sharded"):
        mesh, plan, arrays, smgt, (c0, v0), _ = _sharded_case(4)
        TP._plan_tensors(plan, c0.device, range(4))
        run = TP._scan_graph(mesh, plan, smgt, arrays, c0, v0, program.split()[1], 2).body
    elif program == "rmcl_ell_scan":
        t, plan, adh, (c0, v0) = _static_case()
        TR._plan_tensors(plan, t.device)
        run = TR._scan_graph(plan, t, adh, c0, v0, 2).body
    elif program == "rmcl_scan":
        mgt, mt, pc, cc = _general_case()

        def run():
            rmcl_scan(mgt, mt, pc, cc, 2)
    else:
        a = port_csr(_graph(96, 0.1, (7,), seed=3))
        plan = E.plan_ell(a, a)
        E.spgemm_ell(a, a, plan)
        run = E._warm_graph(a, a, plan, plan._nnzc_cache).body
    for owner, names in HOST_READS.items():
        for name in names:
            monkeypatch.setattr(owner, name, _raiser(f"{owner.__name__}.{name}"))
    with pytest.raises(AssertionError, match="Tensor.item inside a captured body"):
        torch.ones(1).item()  # the guard is on
    run()  # a step (the scan: two), or a warm call, with every read refused
    run()


# ---- the mechanism ------------------------------------------------------------------
def test_graphs_live_and_die_with_their_plan():
    # on the CPU the plan keeps no graph: the body is built over the call's
    # own tensors (no copy of Mgt), the carry cloned, and goes with the call
    t, plan, adh, (c0, v0) = _static_case()
    g = TR._scan_graph(plan, t, adh, c0, v0, 3)
    assert g.inputs[0] is t.row_ptr and g.inputs[3] is adh
    assert g.inputs[4] is not c0 and same_bits(g.inputs[4], c0)
    assert g.state["room"] == 3
    TR.rmcl_ell_scan(plan, t, adh, c0, v0, 2)
    assert graphs.held(plan, "rmcl_ell_scan") is None
    gone, alive = weakref.ref(g), weakref.ref(plan)
    del plan, g
    assert alive() is None and gone() is None  # no cycle holds them: freed at once
    # the sharded scan's body: Mgt's shards and the plan arrays in place
    mesh, plan, arrays, smgt, (c0, v0), _ = _sharded_case(2)
    g = TP._scan_graph(mesh, plan, smgt, arrays, c0, v0, "fused_ring", 3)
    assert g.inputs[0] is smgt.row_ptr and g.inputs[3] is arrays["row_ids"][0]
    assert g.inputs[-2] is not c0 and same_bits(g.inputs[-2], c0)
    TP.sharded_rmcl_ell_scan(mesh, plan, smgt, arrays, c0, v0, 2, "fused_ring")
    assert graphs.held(plan, "sharded_rmcl_ell_scan") is None
    gone, alive = weakref.ref(g), weakref.ref(plan)
    del plan, g
    assert alive() is None and gone() is None


def test_load_refuses_inputs_of_other_shapes():
    x = torch.zeros(4)
    g = graphs.CapturedBody("probe", lambda: x * 2, (x,))
    with pytest.raises(ValueError, match="input 0"):
        g.load(torch.ones(1))  # copy_ would broadcast it
    with pytest.raises(ValueError, match="input 0"):
        g.load(torch.ones(4, dtype=torch.float64))
    g.load(torch.arange(4.0))
    assert torch.equal(g.run(), torch.arange(4.0) * 2)  # the CPU runs the body
    assert g.graph is None and g.replays == 0
