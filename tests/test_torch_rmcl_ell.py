"""Static-ELL R-MCL on one device: the port's planner, host helpers,
CSR permutations, prune math, step and loop vs the JAX package's, on the
same host arrays.

The dedup rule (ROADMAP C5): the reference's CPU branch of
``_dedup_tile`` sums runs as a cumsum difference, ~1e-4 off on wide
tiles, where the port's K1 twin is exact.  Every test that runs the
reference's step therefore routes that branch through the reference's
own Pallas kernel in interpret mode (``use_pallas_dedup``), and then
holds the structure exactly equal and the values within the comparators
(1e-7 abs or 1e-3 rel)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
from sparse_matrix_with_flops_tpu.io import load_coo
from sparse_matrix_with_flops_tpu.models.rmcl import rmcl_init as j_rmcl_init
from sparse_matrix_with_flops_tpu.ops import prune as JPR
from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR as TCSR
from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl_init as t_rmcl_init
from sparse_matrix_with_flops_tpu_torch.ops import prune as TPR
from sparse_matrix_with_flops_tpu_torch.ops.select_kernels import (
    prune_select,
    prune_select_plain,
)
from sparse_matrix_with_flops_tpu_torch.ops.sort_kernels import sort_dedup_compact

from torch_port_util import (
    assert_close_values,
    assert_same_csr,
    assert_same_ell,
    assert_same_plan,
    port_coo,
    port_csr,
    port_rmcl_state,
    trimmed,
    use_pallas_dedup,
)

JR = importlib.import_module("sparse_matrix_with_flops_tpu.models.rmcl_ell")
TR = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl_ell")


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = sort_dedup_compact.launches
    yield
    assert sort_dedup_compact.launches == before == 0


def _graph(kind: str, seed: int = 0, weighted: bool = False) -> JCSR:
    """Row-stochastic R-MCL inits (the reference tests' graphs):
    ``rand`` 32 rows at 25% fill; ``hub`` 32 rows with a full row 3;
    ``gap`` 64 rows of degree ~6-14 for a planner whose largest degree
    class leaves a gap below the hub cut; ``wide`` 96 rows at 12%.
    Uniform row values (``aver_and_norm_rows``), or with ``weighted``
    random ones normalised per row, which leave no exact ties."""
    rng = np.random.default_rng(seed)
    n, p = {"rand": (32, 0.25), "hub": (32, 0.15), "gap": (64, 0.15), "wide": (96, 0.12)}[kind]
    mask = rng.random((n, n)) < p
    np.fill_diagonal(mask, True)
    if kind == "hub":
        mask[3, :] = True
    if weighted:
        dense = np.where(mask, rng.random((n, n)) + 0.1, 0.0)
        return JCSR.from_dense((dense / dense.sum(1, keepdims=True)).astype(np.float32))
    dense = np.where(mask, 1.0, 0.0).astype(np.float32)
    return JCSR.from_dense(dense).aver_and_norm_rows()


def _both(kind: str, seed: int = 0, weighted: bool = False):
    j = _graph(kind, seed, weighted)
    return j, port_csr(j)


# ---- planner and host helpers ------------------------------------------------
@pytest.mark.parametrize(
    "kind,S,max_tile,hub_precision",
    [
        ("rand", 16, 256, "f32"),
        ("hub", 32, 256, "f32"),  # dmax 8 < 32: row 3 is a hub
        ("hub", 8, 64, "bf16"),
        ("gap", 32, 224, "f32"),  # 224 // 32 = 7 -> dmax 4: degrees 5-7 go dense
        ("wide", 16, 128, "f32"),
    ],
)
def test_plan_rmcl_ell_matches_reference(kind, S, max_tile, hub_precision):
    j, t = _both(kind)
    jp = JR.plan_rmcl_ell(j, S=S, max_tile=max_tile, hub_precision=hub_precision)
    tp = TR.plan_rmcl_ell(t, S=S, max_tile=max_tile, hub_precision=hub_precision)
    assert_same_plan(jp, None, tp, None)
    if kind in ("hub", "gap"):
        assert tp.huge_rows.size and tp.hub_kh % 128 == 0
    covered = {int(r) for _, rows, _ in tp.bins for r in rows} | set(tp.huge_rows.tolist())
    assert covered == set(range(t.rows))  # every row has a self loop


@pytest.mark.parametrize("kind,S", [("rand", 8), ("rand", 32), ("hub", 8), ("wide", 16)])
def test_mt_to_ell_and_back_match_reference(kind, S):
    j, t = _both(kind)
    jc, jv = JR.mt_to_ell(j, S)
    tc, tv = TR.mt_to_ell(t, S)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert_same_csr(JR.ell_to_csr(jc, jv, j.ncols), TR.ell_to_csr(tc, tv, t.ncols))


def test_mt_to_ell_sums_duplicates_and_truncates():
    # row 0 holds column 2 twice; S = 2 keeps its first two unique columns
    rp = np.array([0, 4, 5], np.int32)
    ci = np.array([2, 0, 2, 1, 1], np.int32)
    v = np.array([0.25, 0.25, 0.25, 0.25, 1.0], np.float32)
    j = JCSR.from_arrays(rp, ci, v, ncols=3)
    t = TCSR.from_numpy(rp, ci, v, 3, device="cpu")
    jc, jv = JR.mt_to_ell(j, 2)
    tc, tv = TR.mt_to_ell(t, 2)
    assert tc.tolist() == [[0, 1], [1, 3]]
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_rmcl_init_matches_reference_tdata():
    g = load_coo("tests/tdatas/tdata.snap", extra_capacity=16)
    assert_same_csr(j_rmcl_init(g), t_rmcl_init(port_coo(g)))


@pytest.mark.parametrize("seed", [0, 1])
def test_rmcl_init_matches_reference_random_coo(seed):
    from sparse_matrix_with_flops_tpu.formats.coo import COO as JCOO

    rng = np.random.default_rng(seed)
    n, nnz = 40, 150
    row = rng.integers(0, n, nnz)
    col = rng.integers(0, n, nnz)  # duplicates and missing diagonals
    g = JCOO.from_numpy(row, col, np.ones(nnz), n, n, capacity=nnz + n)
    assert_same_csr(j_rmcl_init(g), t_rmcl_init(port_coo(g)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aver_and_norm_rows_matches_reference(seed):
    from torch_port_util import jax_random_csr

    rng = np.random.default_rng(seed)
    j = jax_random_csr(rng, 30, 25, 0.2, empty_rows=(0, 7, 29))
    assert_same_csr(j.aver_and_norm_rows(), port_csr(j).aver_and_norm_rows())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_permutations_match_reference(seed):
    from torch_port_util import jax_random_csr

    rng = np.random.default_rng(seed)
    n = 36
    j = jax_random_csr(rng, n, n, 0.15, empty_rows=(4,))
    t = port_csr(j)
    p = rng.permutation(n).astype(np.int32)
    assert_same_csr(j.permute_rows(jnp.asarray(p)), t.permute_rows(torch.from_numpy(p)))
    assert_same_csr(j.permute_cols(jnp.asarray(p)), t.permute_cols(torch.from_numpy(p)))
    jc = j.conjugate_permute(jnp.asarray(p))
    tc = t.conjugate_permute(torch.from_numpy(p))
    assert_same_csr(jc, tc)
    inv = np.argsort(p).astype(np.int32)
    assert_same_csr(t, tc.conjugate_permute(torch.from_numpy(inv)))


# ---- prune math ---------------------------------------------------------------
def test_compute_threshold_matches_reference(rng):
    avg = rng.random(500).astype(np.float32) * 0.5
    rmax = (avg + rng.random(500).astype(np.float32) * 0.5).astype(np.float32)
    avg[:5] = 0.0  # the floor
    rmax[5:10] = avg[5:10]  # max == avg
    want = np.asarray(JPR.compute_threshold(jnp.asarray(avg), jnp.asarray(rmax)))
    got = TPR.compute_threshold(torch.from_numpy(avg), torch.from_numpy(rmax)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,out_cap", [(0, None), (1, None), (2, 40)])
def test_prune_normalize_matches_reference(seed, out_cap):
    from torch_port_util import jax_random_csr

    rng = np.random.default_rng(seed)
    j = jax_random_csr(rng, 24, 30, 0.3, empty_rows=(3,))
    jc, jo = JPR.prune_normalize(j, out_cap=out_cap)
    tc, to = TPR.prune_normalize(port_csr(j), out_cap=out_cap)
    assert bool(to) == bool(jo)
    np.testing.assert_array_equal(tc.row_ptr.numpy(), np.asarray(jc.row_ptr))
    np.testing.assert_array_equal(tc.col_ind.numpy(), np.asarray(jc.col_ind))
    assert_close_values(tc.values.numpy(), np.asarray(jc.values))


@pytest.mark.parametrize("S", [2, 3, 5])
def test_prune_select_lanes_tie_at_the_cut(S):
    # inflated values 0.09, 0.04 x 3, 0.01 x 2, 0.0025 x 2: at S = 2, 3
    # the cut falls inside the run of ties, which go to the lower columns
    key = np.array([[0, 1, 2, 3, 4, 5, 6, 7], [1, 3, 4, 5, 6, 8, 8, 8]], np.int32)
    val = np.array(
        [[0.3, 0.2, 0.2, 0.2, 0.1, 0.1, 0.05, 0.05],
         [0.2, 0.3, 0.2, 0.2, 0.1, 0.0, 0.0, 0.0]],
        np.float32,
    )
    jc, jv, jt = JR._prune_select_lanes(jnp.asarray(key), jnp.asarray(val), 8, S)
    tc, tv, tt = TR._prune_select_lanes(torch.from_numpy(key), torch.from_numpy(val), 8, S)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_close_values(tv.numpy().ravel(), np.asarray(jv).ravel())
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tc[0].tolist() == [0, 1, 2, 3, 8][:S]  # 4 survive the threshold
    assert tc[1].tolist() == [1, 3, 4, 5, 8][:S]


@pytest.mark.parametrize("w,S", [(16, 8), (64, 32), (256, 16)])
def test_prune_select_lanes_matches_reference(rng, w, S):
    n = 500
    key = np.sort(rng.choice(n + 1, size=(12, w)), axis=1).astype(np.int32)
    key[:, 1:][key[:, 1:] == key[:, :-1]] = n  # unique columns, sentinels
    key = np.sort(key, axis=1)
    val = np.where(key < n, rng.random((12, w)), 0.0).astype(np.float32)
    jc, jv, jt = JR._prune_select_lanes(jnp.asarray(key), jnp.asarray(val), n, S)
    tc, tv, tt = TR._prune_select_lanes(torch.from_numpy(key), torch.from_numpy(val), n, S)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_close_values(tv.numpy().ravel(), np.asarray(jv).ravel())
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("S", [2, 3, 5])
def test_k11_plain_tie_at_the_cut(S):
    # the tie case above through K11's plain version (the static step's
    # selection): the same columns and flags as the reference's two sorts
    key = np.array([[0, 1, 2, 3, 4, 5, 6, 7], [1, 3, 4, 5, 6, 8, 8, 8]], np.int32)
    val = np.array(
        [[0.3, 0.2, 0.2, 0.2, 0.1, 0.1, 0.05, 0.05],
         [0.2, 0.3, 0.2, 0.2, 0.1, 0.0, 0.0, 0.0]],
        np.float32,
    )
    jc, jv, jt = JR._prune_select_lanes(jnp.asarray(key), jnp.asarray(val), 8, S)
    tc, tv, tt = prune_select_plain(torch.from_numpy(key), torch.from_numpy(val), 8, S)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_close_values(tv.numpy().ravel(), np.asarray(jv).ravel())
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tc[0].tolist() == [0, 1, 2, 3, 8][:S]


@pytest.mark.parametrize("w,S,pool", [(16, 8, 0), (64, 32, 0), (256, 16, 0), (2048, 128, 3)])
def test_k11_plain_matches_reference(rng, w, S, pool):
    # the reference cases above through K11's plain version, and a tile of
    # the LFR cell's narrowest width whose values come from a pool of
    # three: rows over S kept, with runs of equal values across the cut
    n = 500 if w < 2048 else 50000
    key = np.sort(rng.choice(n + 1, size=(12, w)), axis=1).astype(np.int32)
    key[:, 1:][key[:, 1:] == key[:, :-1]] = n  # unique columns, sentinels
    key = np.sort(key, axis=1)
    x = rng.choice([0.010, 0.0105, 0.011], size=(12, w)) if pool else rng.random((12, w))
    val = np.where(key < n, x, 0.0).astype(np.float32)
    jc, jv, jt = JR._prune_select_lanes(jnp.asarray(key), jnp.asarray(val), n, S)
    tc, tv, tt = prune_select_plain(torch.from_numpy(key), torch.from_numpy(val), n, S)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_close_values(tv.numpy().ravel(), np.asarray(jv).ravel())
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    if pool:
        assert tt.all()
        # the cut falls inside a run of equal values in every row
        w2 = torch.from_numpy(val) ** 2
        cut = torch.topk(torch.where(torch.from_numpy(key) < n, w2, -1.0), S + 1).values
        assert bool((cut[:, S - 1] == cut[:, S]).all())


def test_k11_wrapper_writes_its_rows_and_adds_its_counts(rng):
    # the CPU route of the wrapper: rows written at their destinations,
    # the other rows untouched, the counters added to
    n, S, w = 300, 16, 64
    key = np.sort(rng.choice(n + 1, size=(6, w)), axis=1).astype(np.int32)
    key[:, 1:][key[:, 1:] == key[:, :-1]] = n
    key = torch.from_numpy(np.sort(key, axis=1))
    val = torch.where(key < n, torch.from_numpy(rng.random((6, w)).astype(np.float32)), 0.0)
    out_c = torch.full((9, S), -1, dtype=torch.int32)
    out_v = torch.full((9, S), -1.0)
    counts = torch.tensor([4, 1])
    rows = torch.tensor([8, 0, 3, 5, 1, 7])
    prune_select(key, val, n, S, rows, out_c, out_v, counts)
    sc, sv, st = prune_select_plain(key, val, n, S)
    assert torch.equal(out_c[rows], sc) and torch.equal(out_v[rows], sv)
    assert bool((out_c[[2, 4, 6]] == -1).all())
    assert counts.tolist() == [4 + int((sc < n).sum()), 1 + int(st.sum())]
    assert prune_select.launches == 0


# ---- dedup and drift ---------------------------------------------------------
def _runs(rng, r, w, run, n):
    """Tiles of ``run``-wide sorted unique runs (gathered iterate rows)."""
    out = np.full((r, w), n, np.int32)
    for i in range(r):
        for s in range(w // run):
            k = rng.integers(0, run + 1)
            out[i, s * run : s * run + k] = np.sort(rng.choice(n, size=k, replace=False))
    val = np.where(out < n, rng.random((r, w)), 0.0).astype(np.float32)
    return out, val


@pytest.mark.parametrize("w,run", [(8, 8), (32, 8), (64, 16), (128, 32), (256, 16)])
def test_dedup_tile_matches_pallas(monkeypatch, rng, w, run):
    use_pallas_dedup(monkeypatch)
    n = 50
    tc, tv = _runs(rng, 10, w, run, n)
    jk, jv = JR._dedup_tile(jnp.asarray(tc), jnp.asarray(tv), n, run=run)
    tk, tvv = TR._dedup_tile(torch.from_numpy(tc), torch.from_numpy(tv), n, run=run)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert_close_values(tvv.numpy().ravel(), np.asarray(jv).ravel())


def test_ell_drift_sq_matches_reference(monkeypatch):
    use_pallas_dedup(monkeypatch)
    j = _graph("rand")
    c0, v0 = JR.mt_to_ell(j, 16)
    plan = JR.plan_rmcl_ell(j, S=16, max_tile=256)
    c1, v1, _ = JR.rmcl_ell_step(plan, j, JR._dense_huge(j, plan), c0, v0)
    jd = JR._ell_drift_sq(c0, v0, c1, v1, j.rows)
    args = [torch.from_numpy(np.array(x)) for x in (c0, v0, c1, v1)]
    td = TR._ell_drift_sq(*args, j.rows)
    for a, b in zip(td, jd):
        assert_close_values([float(a)], [float(b)])


# ---- one step and the loop -----------------------------------------------------
@pytest.mark.parametrize(
    "kind,S,max_tile,hub_precision",
    [
        ("rand", 32, 256, "f32"),
        ("hub", 32, 256, "f32"),
        ("hub", 32, 256, "bf16"),
        ("gap", 32, 224, "f32"),
        ("wide", 8, 64, "f32"),  # S = 8 truncates
    ],
)
def test_rmcl_ell_step_matches_reference(monkeypatch, kind, S, max_tile, hub_precision):
    use_pallas_dedup(monkeypatch)
    j = _graph(kind)
    jp = JR.plan_rmcl_ell(j, S=S, max_tile=max_tile, hub_precision=hub_precision)
    c0, v0 = JR.mt_to_ell(j, S)
    # one reference step first, so the compared step starts from a
    # pruned iterate, not from the uniform init
    c0, v0, _ = JR.rmcl_ell_step(jp, j, JR._dense_huge(j, jp), c0, v0)
    jc, jv, js = JR.rmcl_ell_step(jp, j, JR._dense_huge(j, jp), c0, v0)
    t, tc0, tv0 = port_rmcl_state(j, c0, v0)
    tp = TR.plan_rmcl_ell(t.make_ordered(), S=S, max_tile=max_tile, hub_precision=hub_precision)
    tc, tv, ts = TR.rmcl_ell_step(tp, t, TR._dense_huge(t, tp), tc0, tv0)
    ties = assert_same_ell(jc, jv, tc.numpy(), tv.numpy())
    assert int(ts["nnz"]) == int(js["nnz"])
    assert int(ts["truncated_rows"]) == int(js["truncated_rows"])
    if kind == "wide":
        assert int(ts["truncated_rows"]) > 0
    else:  # no truncation, no cut: the iterates are equal
        assert ties == 0
    if not ties:  # a tie kept on another column moves the drift
        assert_close_values([float(ts["differs"])], [float(js["differs"])])


@pytest.mark.parametrize(
    "kind,S,max_tile,hub_precision",
    [
        ("rand", 32, 256, "f32"),
        ("hub", 32, 256, "f32"),
        ("hub", 32, 256, "bf16"),
        ("gap", 16, 224, "f32"),
        ("wide", 16, 256, "f32"),  # truncates: weighted, so that no tie sits at the cut
    ],
)
def test_rmcl_ell_matches_reference(monkeypatch, kind, S, max_tile, hub_precision):
    use_pallas_dedup(monkeypatch)
    j, t = _both(kind, weighted=kind == "wide")
    want, jh = JR.rmcl_ell(j, max_iters=3, S=S, max_tile=max_tile, hub_precision=hub_precision)
    got, th = TR.rmcl_ell(t, max_iters=3, S=S, max_tile=max_tile, hub_precision=hub_precision)
    assert_same_csr(want, got)
    np.testing.assert_array_equal(th["nnz"], jh["nnz"])
    np.testing.assert_array_equal(th["truncated_rows"], jh["truncated_rows"])
    assert_close_values(th["differs"], jh["differs"])


def test_rmcl_ell_from_coo_matches_reference_tdata(monkeypatch):
    use_pallas_dedup(monkeypatch)
    g = load_coo("tests/tdatas/tdata.snap", extra_capacity=16)
    want, jh = JR.rmcl_ell(g, max_iters=3, S=8)
    got, th = TR.rmcl_ell(port_coo(g), max_iters=3, S=8)
    assert_same_csr(want, got)
    np.testing.assert_array_equal(th["nnz"], jh["nnz"])
    assert_close_values(th["differs"], jh["differs"])


def test_rmcl_ell_stays_row_stochastic():
    t = port_csr(_graph("wide", seed=3))
    got, hist = TR.rmcl_ell(t, max_iters=3, S=4, max_tile=64)
    assert int(hist["truncated_rows"].sum()) > 0
    rp, _, v = trimmed(got)
    sums = np.add.reduceat(v, rp[:-1]) if v.size else v
    np.testing.assert_allclose(sums[np.diff(rp) > 0], 1.0, atol=1e-5)


# ---- C2: the matmuls of the slice run in true f32 ----------------------------------
def test_hub_matmul_is_true_f32(monkeypatch):
    """Every ``torch.matmul`` of the slice runs with TF32 off and f32
    matmul precision "highest" (ROADMAP C2), even for a caller that
    turned TF32 on (C7: ``config.true_f32`` pins it per call and gives
    the caller's switches back): a spy checks the switches at each
    call, on the single-chip hub, every sharded exchange and the ring
    twins; and the hub product agrees with an f64 product within
    1e-5·(|A||B|), which a TF32 or bf16 rounding of f32 operands breaks."""
    from sparse_matrix_with_flops_tpu_torch.config import _f32_switches, true_f32

    with true_f32():  # the caller's switches come back after the test
        torch.backends.cuda.matmul.allow_tf32 = True  # a caller that wants TF32
        torch.set_float32_matmul_precision("high")
        caller = _f32_switches()
        _hub_matmul_checks(monkeypatch)
        assert _f32_switches() == caller


def _hub_matmul_checks(monkeypatch):
    from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh, sharded_rmcl_ell
    from sparse_matrix_with_flops_tpu_torch.parallel import ring_kernels as RK

    calls = []
    real = torch.matmul

    def spy(a, b, *rest, **kw):
        calls.append((a.dtype, b.dtype))
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
        return real(a, b, *rest, **kw)

    monkeypatch.setattr(torch, "matmul", spy)
    t = port_csr(_graph("hub"))
    plan = TR.plan_rmcl_ell(t, S=32, max_tile=256)
    c0, v0 = TR.mt_to_ell(t, 32)
    a_d = TR._dense_huge(t, plan)
    krows = TR._plan_tensors(plan, c0.device)["hub_krows"]
    c_h = TR._hub_dense_products(a_d, c0, v0, t.rows, krows=krows, khp=plan.hub_kh)
    assert calls and all(x == (torch.float32, torch.float32) for x in calls)
    # the f64 product over the same union rows
    kr = plan.hub_krows
    md = np.zeros((plan.hub_kh, t.rows))
    c0n, v0n = c0.numpy(), v0.numpy().astype(np.float64)
    for i, r in enumerate(kr):
        if r >= 0:
            ok = c0n[r] < t.rows
            md[i, c0n[r][ok]] = v0n[r][ok]
    a64 = a_d.numpy().astype(np.float64)
    bound = 1e-5 * (np.abs(a64) @ np.abs(md)) + 1e-12
    assert (np.abs(c_h.numpy() - a64 @ md) <= bound).all()
    before = len(calls)
    for ex in ("ring", "all_gather", "pallas_ring", "fused_ring"):
        sharded_rmcl_ell(t, make_mesh(2, "cpu"), max_iters=1, S=32, max_tile=256, exchange=ex)
    RK.ring_matmul(torch.ones(2, 3, 8), torch.ones(2, 4, 5))
    assert len(calls) > before + 4
