"""One rank a process: the port's distributed layer on a process mesh
(``torch.distributed``, ``gloo`` backend, on the CPU; 1-D, and 2-D for
the 2-D SpGEMM) against the stacked mesh at the same D, and once against
the JAX package on its 8-device CPU mesh.

Each world size spawns its W ranks once (``torch.multiprocessing``,
spawn start method, a file store in the test's temporary directory, so
no port is taken); every rank runs all the cases of
``torch_process_workers.cases`` and writes its results to a file, which
the tests below read.  The ranks share one deadline: a rank still alive
at it is killed and the run fails, so a stuck rank fails the tests and
never hangs the suite.  Bit-equal means bit for bit: on the CPU a kernel
wrapper on a process mesh runs its twin over the group's all-gather, and
the sums of the statistics follow the stacked path's order.
"""

import importlib
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax

from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
from sparse_matrix_with_flops_tpu.ops.spgemm import spgemm_upper_bounds as j_upper_bounds
from sparse_matrix_with_flops_tpu.parallel import make_mesh as j_make_mesh
from sparse_matrix_with_flops_tpu.parallel import rmcl as JRM
from sparse_matrix_with_flops_tpu.parallel import sharded as JSH
from sparse_matrix_with_flops_tpu.parallel import spgemm2d as J2
from sparse_matrix_with_flops_tpu_torch.formats.coo import COO
from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR as TCSR
from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl_init

import torch_process_workers as W
from torch_port_util import assert_close_values, assert_same_csr, trimmed, use_pallas_dedup

JP = importlib.import_module("sparse_matrix_with_flops_tpu.parallel.rmcl_ell")
TP = importlib.import_module("sparse_matrix_with_flops_tpu_torch.parallel.rmcl_ell")
DEADLINE_S = 240  # one world's ranks, start to finish (a run takes ~10 s)
JAX_WORLD = 4


def _jax_graph() -> JCSR:
    """The hub graph of ``tests/test_torch_sharded_rmcl.py``: 32 rows,
    two hub rows at ``max_tile`` 256 and S 32, row-stochastic."""
    rng = np.random.default_rng(0)
    n = 32
    mask = rng.random((n, n)) < 0.12
    np.fill_diagonal(mask, True)
    mask[5, :] = True
    mask[20, 4:] = True
    return JCSR.from_dense(np.where(mask, 1.0, 0.0).astype(np.float32)).aver_and_norm_rows()


def _spawn(world: int, tmp) -> list:
    """Run the W ranks to their end or the deadline; each rank's results."""
    inputs = W.make_inputs(world)
    if world == JAX_WORLD:
        rp, ci, v = trimmed(_jax_graph())
        inputs["jax_graph"] = (rp, ci, v, 32)
    path = os.path.join(tmp, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run_rank,
                         args=(r, world, os.path.join(tmp, "store"), path, str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + DEADLINE_S
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    stuck = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    for r in range(world):
        err = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    assert not stuck, f"ranks {stuck} still running after {DEADLINE_S} s: killed"
    assert not errors, "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return inputs, out


_RUNS: dict = {}


def _run(world: int, tmp_path_factory):
    """(W, inputs, every rank's results, the stacked mesh's results), once
    a world size."""
    if world not in _RUNS:
        inputs, ranks = _spawn(world, tmp_path_factory.mktemp(f"ranks{world}"))
        _RUNS[world] = (world, inputs, ranks, W.stacked_results(inputs))
    return _RUNS[world]


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def run(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory)


def _each_rank_equals_stacked(run, key):
    world, _, ranks, stacked = run
    for r in range(world):
        want = W.row_of(key, stacked[key], r)
        assert W.same(ranks[r][key], want), f"rank {r}: {key} differs from the stacked mesh"


# ---- collectives ------------------------------------------------------------------
def test_all_gather_is_every_shard_in_rank_order(run):
    world, inputs, ranks, _ = run
    for r in range(world):
        assert W.same(ranks[r]["all_gather"], inputs["shards"])
    _each_rank_equals_stacked(run, "all_gather")


@pytest.mark.parametrize("shift", [1, -1], ids=["+1", "-1"])
def test_ppermute_receives_from_rank_minus_shift(run, shift):
    world, inputs, ranks, _ = run
    for r in range(world):
        assert W.same(ranks[r][f"ppermute{shift:+d}"], inputs["shards"][[(r - shift) % world]])
    _each_rank_equals_stacked(run, f"ppermute{shift:+d}")


@pytest.mark.parametrize("key", ["psum", "psum_int"])
def test_psum_keeps_the_stacked_sum(run, key):
    world, _, ranks, stacked = run
    _each_rank_equals_stacked(run, key)
    want = torch.from_numpy(run[1]["shards"][:, 0, 0].copy()).sum().numpy() if key == "psum" \
        else run[1]["counts"].sum()
    assert W.same(stacked[key], np.asarray(want))


def test_packed_psums_give_the_bits_of_separate_psums(run):
    """Four statistics (f32 and int64) in one gather of int32 words, each
    summed in its own dtype in shard order: the bits of four ``psum``
    calls, on every rank and on the stacked mesh."""
    world, _, ranks, stacked = run
    _each_rank_equals_stacked(run, "psums")
    for r in range(world):
        assert W.same(ranks[r]["psums"], ranks[r]["psums/separate"])
    assert [x.dtype for x in stacked["psums"]] == [np.float32, np.int64] * 2


def test_axis_index_is_the_rank(run):
    world, _, ranks, _ = run
    for r in range(world):
        assert ranks[r]["axis_index"].tolist() == [r]


# ---- sharding and the SpGEMMs ------------------------------------------------------
@pytest.mark.parametrize("key", ["shard", "unshard"])
def test_shard_and_unshard_equal_the_stacked_blocks(run, key):
    _each_rank_equals_stacked(run, key)


@pytest.mark.parametrize("key", ["spgemm", "spgemm_ring"])
def test_sharded_spgemm_blocks_equal_the_stacked_path(run, key):
    world, _, ranks, stacked = run
    _each_rank_equals_stacked(run, key)
    assert int(stacked[key][4].sum()) > 0  # C has entries


# ---- R-MCL --------------------------------------------------------------------------
@pytest.mark.parametrize("exchange", W.EXCHANGES)
@pytest.mark.parametrize("case", sorted(W.RMCL_CASES))
def test_sharded_rmcl_ell_equals_the_stacked_path(run, case, exchange):
    """Iterate and statistics (differs, nnz, truncated rows) bit for bit,
    on every rank."""
    _each_rank_equals_stacked(run, f"rmcl/{case}/{exchange}")


@pytest.mark.parametrize("exchange", W.EXCHANGES)
@pytest.mark.parametrize("length", W.scan_lengths(), ids=["B-1", "B"])
def test_scan_through_scan_body_equals_the_stacked_path(run, length, exchange):
    """The process mesh's static scan, its step through
    ``graphs.scan_body`` (the CUDA graph's body), on either side of the
    emulated break-even count (``W.TEST_B``, the B of the capture
    decisions below): iterate blocks and histories bit for bit."""
    for key in (f"{W.BLOCK_PREFIX}{length}/{exchange}", f"scan_hist/{length}/{exchange}"):
        _each_rank_equals_stacked(run, key)


@pytest.mark.parametrize("exchange", W.EXCHANGES)
def test_every_rank_makes_the_scan_capture_decisions_alike(run, exchange):
    """The card's keeping emulated (B = ``W.TEST_B``): every rank takes
    the same decision at every iteration; a plan's call short of B stays eager, a call that
    reaches B on it captures at its first iteration, a fresh plan's call of
    B at its second (its first makes the peer sets), and a later call
    replays; the results are the eager scan's bits."""
    world, _, ranks, _ = run
    short, b = W.scan_lengths()
    log = ranks[0][f"decisions/scan/{exchange}"]
    for r in range(1, world):
        assert ranks[r][f"decisions/scan/{exchange}"] == log
    name = "sharded_rmcl_ell_scan_process"
    # a capture's entry holds the eager runs spent on the key, its own included
    assert [e for e in log if e[0] == "capture"] == [("capture", name, short + 1),
                                                      ("capture", name, 2)]
    assert sum(e[0] == "policy" for e in log) == short + 1 + 2  # replays ask nothing
    for r in range(world):
        got = ranks[r][f"decisions/scan/{exchange}/results"]
        for run_, length in zip(got, (short, b, b, short)):
            blocks = ranks[r][f"{W.BLOCK_PREFIX}{length}/{exchange}"]
            hist = ranks[r][f"scan_hist/{length}/{exchange}"]
            assert W.same(tuple(run_), (*blocks, *hist))


def test_every_rank_makes_the_ring_capture_decisions_alike(run):
    """The warm ring SpGEMM called B + 1 times on one plan, the card's
    keeping emulated: the same decisions on every rank, the capture at
    call B (never at a plan's first call), every call's blocks the
    stacked path's."""
    world, _, ranks, stacked = run
    b = W.TEST_B
    log = ranks[0]["decisions/ring"]
    for r in range(1, world):
        assert ranks[r]["decisions/ring"] == log
    assert [e for e in log if e[0] == "capture"] == [
        ("capture", "sharded_spgemm_ring_process", max(b, 2))]
    for r in range(world):
        want = W.row_of("spgemm_ring", stacked["spgemm_ring"], r)
        assert all(W.same(tuple(c), want) for c in ranks[r]["decisions/ring/results"])


@pytest.mark.parametrize("case,hub", [("hub", True), ("nohub", False)])
def test_rmcl_cases_with_and_without_hub_rows(case, hub):
    inputs = W.make_inputs(2)
    r, c, v, n = inputs["graph"]
    _, S, max_tile, _ = W.RMCL_CASES[case]
    mgt = rmcl_init(COO.from_numpy(r, c, v, n, n, capacity=c.size + n, device="cpu"))
    plan = TP.plan_sharded_rmcl_ell(mgt.make_ordered(), 2, S=S, max_tile=max_tile)[0]
    assert (plan.hmax > 0) == hub


def test_sharded_rmcl_ell_on_processes_matches_jax(tmp_path_factory, monkeypatch):
    """D = 4 ranks, the all_gather exchange, against the JAX package's
    ``sharded_rmcl_ell`` on 4 of its 8 virtual CPU devices (its dedup
    through the Pallas kernel in interpret mode, ROADMAP C5)."""
    world, _, ranks, _ = _run(JAX_WORLD, tmp_path_factory)
    use_pallas_dedup(monkeypatch)
    j = _jax_graph()
    want, jh = JP.sharded_rmcl_ell(j, j_make_mesh(JAX_WORLD), max_iters=2, S=32, max_tile=256,
                                   exchange="all_gather")
    for r in range(world):
        rp, ci, v, differs, nnz, trunc = ranks[r]["rmcl/jax"]
        got = TCSR(torch.from_numpy(rp), torch.from_numpy(ci), torch.from_numpy(v), 32)
        assert_same_csr(want, got)
        np.testing.assert_array_equal(nnz, jh["nnz"])
        np.testing.assert_array_equal(trunc, jh["truncated_rows"])
        assert_close_values(differs, jh["differs"])


# ---- the dynamic and adaptive sharded R-MCL -------------------------------------------
@pytest.mark.parametrize("key", ["rmcl_scan", "rmcl_scan/stats", "next_flops/rf", "next_flops",
                                 "repartition/mgt", "repartition/mt", "repartition"])
def test_dynamic_rmcl_equals_the_stacked_path(run, key):
    """The scan's blocks and statistics (3 iterations), the next
    multiply's flops, the repartition's blocks, permutation, overflow
    and spread, bit for bit on every rank."""
    world, _, ranks, stacked = run
    _each_rank_equals_stacked(run, key)
    flops, nnz, overflow = stacked["rmcl_scan/stats"][1:4]
    assert (flops > 0).all() and (nnz > 0).all() and not overflow.any()
    perm, ovf, _ = stacked["repartition"]
    assert np.array_equal(np.sort(perm), np.arange(perm.size)) and not ovf


def test_adaptive_loop_is_the_same_on_every_rank(run):
    """Every rank returns the stacked loop's CSR and history, and holds
    the same relabelling."""
    world, _, ranks, stacked = run
    _each_rank_equals_stacked(run, "adaptive")
    _each_rank_equals_stacked(run, "adaptive/perm_total")
    perm = stacked["adaptive/perm_total"]
    assert np.array_equal(np.sort(perm), np.arange(perm.size))
    assert not np.array_equal(perm, np.arange(perm.size))  # the first iteration re-deals


@pytest.mark.parametrize("key", ["spgemm_2d", "unshard_2d"])
def test_spgemm_2d_on_a_2d_process_mesh_equals_the_stacked_path(run, key):
    """Rank r holds block (x, y) = divmod(r, ny) of C; C unsharded is
    whole on every rank: (2, 1) and (1, 2) at W = 2, (2, 2) at W = 4."""
    world, _, ranks, stacked = run
    for nx, ny in W.MESHES_2D[world]:
        _each_rank_equals_stacked(run, f"{key}/{nx}x{ny}")
        assert int(stacked[f"unshard_2d/{nx}x{ny}"][0][-1]) > 0  # C has entries


def test_dryrun_on_processes_equals_the_stacked_dryrun(run):
    _each_rank_equals_stacked(run, "dryrun")
    assert int(run[3]["dryrun"][0]) > 0


def test_dynamic_scan_and_2d_spgemm_on_processes_match_jax(tmp_path_factory):
    """D = 4 ranks against the JAX package on 4 of its 8 virtual CPU
    devices: the dynamic ``sharded_rmcl_scan`` (3 iterations) of the hub
    graph and the (2, 2) ``sharded_spgemm_2d``; structure and integer
    statistics equal, values and ``differs`` within the comparators."""
    world, inputs, ranks, _ = _run(JAX_WORLD, tmp_path_factory)
    j = JCSR.from_arrays(*inputs["jax_graph"][:3], ncols=inputs["jax_graph"][3])
    flops, _ = j_upper_bounds(j, j)
    js = JSH.shard_csr(j, world)
    pc, cc = JRM.plan_shard_capacities(js, flops * 4, margin=4.0)
    jmt, jh = JRM.sharded_rmcl_scan(j_make_mesh(world), js,
                                    JSH.shard_csr(j, world, local_capacity=cc), pc, cc,
                                    W.DYN_ITERS)
    rp, ci, v, n = inputs["a"]
    ja = JCSR.from_arrays(rp, ci, v, ncols=n)
    cap = j_upper_bounds(ja, ja)[0] + 8
    want = J2.sharded_spgemm_2d(jax.make_mesh((2, 2), ("x", "y")), JSH.shard_csr(ja, 2),
                                *J2.shard_csr_2d(ja, 2, 2), cap, cap)
    want = [np.asarray(x) for x in want]
    for r in range(world):
        differs, flops_h, nnz, overflow, *caps = ranks[r]["rmcl_scan/jax/stats"]
        assert tuple(caps) == (pc, cc)
        got = ranks[r]["rmcl_scan/jax"]
        np.testing.assert_array_equal(got[0][0], np.asarray(jmt.row_ptr)[r])
        np.testing.assert_array_equal(got[1][0], np.asarray(jmt.col_ind)[r])
        assert_close_values(got[2][0], np.asarray(jmt.values)[r])
        for k, x in (("flops", flops_h), ("nnz_mt", nnz), ("overflow", overflow)):
            np.testing.assert_array_equal(x, np.asarray(jh[k]), err_msg=k)
        np.testing.assert_allclose(differs, np.asarray(jh["differs"]), rtol=1e-5)
        x, y = divmod(r, 2)
        c = ranks[r]["spgemm_2d/2x2"]
        np.testing.assert_array_equal(c[0][0, 0], want[0][x, y])
        np.testing.assert_array_equal(c[1][0, 0], want[1][x, y])
        assert_close_values(c[2][0, 0], want[2][x, y])


def test_weak_scaling_on_processes_runs_d1_and_w(run):
    """Under a group of W ranks the weak-scaling run gives D = 1 on each
    rank's device and D = W on the process mesh, each with the stacked
    run's scale, rows and nnz at the same D."""
    from sparse_matrix_with_flops_tpu_torch.parallel import weak_scaling_rmcl_ell

    world, _, ranks, _ = run
    want = W.weak_scaling_shape(weak_scaling_rmcl_ell((1, world), W.WS_BASE, device="cpu"))
    want[1] = ("process", *want[1][1:5], True)  # on the CPU the ranks' caveat says so
    for r in range(world):
        assert ranks[r]["weak_scaling"] == want


# ---- the mesh -------------------------------------------------------------------------
def test_process_mesh_and_its_errors(run):
    world, _, ranks, _ = run
    for r in range(world):
        out = ranks[r]
        assert out["mesh"] == (True, world, r, "cpu")
        assert out["make_mesh()"] is True
        assert out["2-D"] == (True, (2, world // 2), ("x", "y"), divmod(r, world // 2), 2,
                              world // 2)
        for label in ("n != W", "nx*ny != W"):
            assert out[f"raises {label}"].startswith("ValueError"), out[f"raises {label}"]
