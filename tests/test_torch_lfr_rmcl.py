"""Static R-MCL on LFR community-benchmark graphs, on the CPU, with no JAX:
the benchmark's LFR generator (``portbench/reference/lfr.py``) at the
paper's sizes, the port's ``rmcl_ell`` against the benchmark's plain
float64 R-MCL on such graphs, the tracer's spans and counters inside
``models/rmcl_ell.py``, and the single-card and sharded steps' row
chunks against one tile a degree bin."""

import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import compare  # noqa: E402
from portbench.reference import lfr  # noqa: E402
from portbench.reference import rmcl as ref_rmcl  # noqa: E402
from sparse_matrix_with_flops_tpu_torch.formats.coo import COO  # noqa: E402
from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl_init  # noqa: E402
from sparse_matrix_with_flops_tpu_torch.utils.timing import TRACE  # noqa: E402

TR = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl_ell")
TP = importlib.import_module("sparse_matrix_with_flops_tpu_torch.parallel.rmcl_ell")
SEEDS = (7, 8, 9)
CELL = "lfr-524288.rmcl-static-10it"


def _cfg() -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", "lfr-524288.json")) as f:
        return json.load(f)


def _graph(n: int, seed: int):
    return lfr.graph(dict(_cfg(), nodes=n), seed=seed)


def _coo(rp, ci):
    n = rp.shape[0] - 1
    rows = np.repeat(np.arange(n), np.diff(rp))
    return COO.from_numpy(rows, ci, np.ones(ci.shape[0], np.float32), n, n,
                          capacity=ci.shape[0] + n, device="cpu")


@pytest.mark.parametrize("n", [1000, 5000])
@pytest.mark.parametrize("seed", SEEDS)
def test_lfr_graphs_keep_the_papers_shapes(n, seed):
    cfg = _cfg()
    rp, ci, label = _graph(n, seed)
    deg = np.diff(rp)
    rows = np.repeat(np.arange(n), deg)
    key = rows * n + ci
    # undirected, each row's columns sorted, no self loop, no repeated edge
    assert np.array_equal(np.sort(key), np.sort(ci * n + rows))
    assert np.all(np.diff(key) > 0) and not np.any(rows == ci)
    k_min = lfr.min_degree(cfg["avg_degree"], cfg["max_degree"], cfg["tau1"])
    assert k_min == 10
    assert deg.min() >= k_min and deg.max() <= cfg["max_degree"]
    assert abs(deg.mean() - cfg["avg_degree"]) <= 0.05 * cfg["avg_degree"]
    sizes = np.bincount(label)
    assert sizes.min() >= cfg["min_community"] and sizes.max() <= cfg["max_community"]
    assert sizes.sum() == n
    assert abs(np.mean(label[rows] != label[ci]) - cfg["mu"]) <= 0.03
    again = _graph(n, seed)
    assert all(np.array_equal(a, b) for a, b in zip((rp, ci, label), again))


@pytest.mark.parametrize("seed", SEEDS)
def test_rmcl_ell_on_lfr_graphs_within_the_cells_limits(seed):
    with open(os.path.join(ROOT, "portbench", "limits", f"{CELL}.json")) as f:
        limits = json.load(f)
    rp, ci, _ = _graph(1000, seed)
    n = rp.shape[0] - 1
    out, hist = TR.rmcl_ell(_coo(rp, ci), max_iters=10, S=128, max_tile=8192)
    ref = ref_rmcl.rmcl(rp, ci, n, 10, 128)
    got = compare.rmcl_numbers((out.row_ptr, out.col_ind, out.values), ref, n)
    assert got["bad_rows"] == 0
    for name in ("gap_p99", "rows_apart"):
        assert got[name] <= limits[name]["limit"], (name, got[name])
    assert hist["nnz"].shape == (10,) and int(hist["nnz"][-1]) == int(out.nnz)


def test_a_traced_call_names_its_spans_and_counters():
    rp, ci, _ = _graph(1000, 7)
    TRACE.clear()
    TRACE.enabled = True
    try:
        # max_tile 2048 at S 128: one degree class, 16; the rows above are hubs
        TR.rmcl_ell(_coo(rp, ci), max_iters=2, S=128, max_tile=2048)
        records, counters = list(TRACE.records), list(TRACE.counters)
    finally:
        TRACE.enabled = False
        TRACE.clear()
    want = {"rmcl_ell", "rmcl_ell.init", "rmcl_ell.plan", "rmcl_ell.load", "rmcl_ell.scan",
            "rmcl_ell.read", "rmcl_ell.step", "rmcl_ell.step.gather", "rmcl_ell.step.tile",
            "rmcl_ell.step.select", "rmcl_ell.step.hub", "rmcl_ell.step.drift",
            "read.rmcl_ell.csr_host", "read.rmcl_ell.ordered", "read.rmcl_ell.to_csr",
            "read.rmcl_ell.history"}
    assert want <= {r.name for r in records}
    mt = rmcl_init(_coo(rp, ci)).make_ordered()
    plan = TR.plan_rmcl_ell(mt, S=128, max_tile=2048)
    lanes = [c for c in counters if c[0] == "rmcl_ell.lanes"]
    hubs = [c for c in counters if c[0] == "rmcl_ell.hub_rows"]
    select = [c for c in counters if c[0] == "rmcl_ell.select_rows"]
    assert len(lanes) == len(hubs) == len(select) == 2  # one a step
    assert all(c[2] == sum(rid.size * d * 128 for d, rid, _ in plan.bins) for c in lanes)
    # every bin row goes to K11 (W 2,048), Σ R_b a step; the hub rows do not
    assert all(c[2] == sum(rid.size for _, rid, _ in plan.bins) > 0 for c in select)
    assert all(c[2] == plan.huge_rows.size > 0 for c in hubs)
    # every read is a span and a count: csr_host 2 (row_ptr and columns, for
    # the plan), ordered 1, to_csr 1 (nnz), history 3
    assert sum(c[2] for c in counters if c[0] == "reads") == 7
    assert sum(r.name.startswith("read.") for r in records) == 7


def _sharded_step_fn(mt, exchange: str):
    """The stacked sharded step at D = 2 on ``mt``'s first iterate, as
    ``sharded_rmcl_ell`` sets it up: ``step()`` -> (cols, vals, stats)."""
    plan, arrays, smgt = TP.plan_sharded_rmcl_ell(mt, 2, S=128, max_tile=8192)
    assert [d for d, _ in plan.bin_shapes] == [16, 32, 64]
    cols, vals = TR.mt_to_ell(mt, 128)
    cols = torch.where(cols >= mt.ncols, plan.n, cols)
    lc, lv = cols.reshape(2, plan.lr, 128), vals.reshape(2, plan.lr, 128)
    return lambda: TP._sharded_step(plan, smgt, arrays, lc, lv, exchange)


@pytest.mark.parametrize("step", ["single", "ring", "all_gather"])
@pytest.mark.parametrize("seed", SEEDS)
def test_row_chunks_give_the_whole_bin_tiles_bits(seed, step, monkeypatch):
    """The single-card step and the stacked sharded step (two exchanges)
    give one whole-bin tile's bits with their degree bins cut into row
    chunks."""
    rp, ci, _ = _graph(1000, seed)
    mt = rmcl_init(_coo(rp, ci)).make_ordered()
    if step == "single":
        plan = TR.plan_rmcl_ell(mt, S=128, max_tile=8192)
        assert [d for d, _, _ in plan.bins] == [16, 32, 64]
        cols, vals = TR.mt_to_ell(mt, 128)
        a_d = TR._dense_huge(mt, plan)
        run = lambda: TR.rmcl_ell_step(plan, mt, a_d, cols, vals)  # noqa: E731
    else:
        run = _sharded_step_fn(mt, step)
    whole = run()
    # 256 KB a chunk: 16, 8 and 4 rows of the three bins, the last chunk short
    monkeypatch.setattr(TR, "_TILE_BYTES", 256 << 10)
    chunked = run()
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])
    for k in whole[2]:
        assert torch.equal(whole[2][k], chunked[2][k]), k
