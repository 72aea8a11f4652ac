"""The port's tracer (``utils.timing.TRACE``): off it records nothing
and never synchronizes; on (by hand or under a ``torch.profiler``
session) it gives the span tree of an R-MCL job, the block and warm
SpGEMM calls under one trace id each, and counts every read from the
card.  The card tests run each path under
``torch.cuda.set_sync_debug_mode("error")``:

    python -m pytest tests/test_torch_trace.py -m cuda -q
"""

import importlib

import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu_torch.formats.coo import COO
from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR
from sparse_matrix_with_flops_tpu_torch.ops import block_spgemm as B
from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
from sparse_matrix_with_flops_tpu_torch.utils import timing as TT
from sparse_matrix_with_flops_tpu_torch.utils.generate import (
    banded_csr,
    planted_partition_coo,
    rmat_csr,
)

TR = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl")
PHASES = ["rmcl.step.expand", "rmcl.step.sort", "rmcl.step.compress", "rmcl.step.prune",
          "rmcl.step.drift"]


@pytest.fixture
def trace():
    """The port's tracer, enabled by hand and emptied, then put back."""
    TT.TRACE.clear()
    TT.TRACE.enabled = True
    yield TT.TRACE
    TT.TRACE.enabled = False
    TT.TRACE.clear()


def _job(coo):
    return TR.rmcl(coo, max_iters=3, mode="scan", margin=2.0)


def _graph(device="cpu"):
    return planted_partition_coo(4, 12, seed=3, device=device)[0]


def _band(device="cpu"):
    a = banded_csr(300, 6, seed=1, device=device)
    return a, B.plan_block(a, a, bs=32)


def _paths(device="cpu"):
    """Each path as (one call, its expected reads a call), planned and
    warmed so that the call is the warm one a loop makes."""
    coo = _graph(device)
    a, bplan = _band(device)
    eplan = plan_ell(a, a)
    out = {"rmcl": (lambda: _job(coo), 5),
           "block": (lambda: B.block_spgemm(a, a, bplan), 1),
           "ell": (lambda: E.spgemm_ell(a, a, eplan), 1)}
    for call, _ in out.values():
        call()
    return out


def test_off_a_span_records_nothing_and_never_synchronizes(monkeypatch):
    def no_sync(*_a, **_k):
        raise AssertionError("a synchronize while the tracer is off")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    TT.TRACE.clear()
    assert not TT.TRACE.on()
    with TT.TRACE.span("a", block_on=lambda: torch.ones(2)):
        TT.TRACE.count("n")
    assert TT.TRACE.host_read("x", torch.arange(3)).tolist() == [0, 1, 2]
    for call, _ in _paths().values():
        call()
    assert TT.TRACE.records == [] and TT.TRACE.counters == [] and TT.TRACE.spans == {}


def test_an_rmcl_job_gives_the_span_tree_under_one_trace_id(trace):
    _job(_graph())
    recs = {r.id: r for r in trace.records}
    assert len({r.trace for r in recs.values()}) == 1
    kids: dict = {}
    for r in sorted(recs.values(), key=lambda r: r.start):
        kids.setdefault(r.parent, []).append(r)
    (top,) = kids[0]
    assert top.name == "rmcl"
    names = [r.name for r in kids[top.id]]
    assert names == ["rmcl.init", "rmcl.plan", "rmcl.pad", "rmcl.scan", "rmcl.read"]
    by = {r.name: r for r in kids[top.id]}
    assert [r.name for r in kids[by["rmcl.plan"].id]] == ["read.rmcl.flops"]
    # the pad grows the iterate on the card: no read or write inside it,
    # one count of the slots it adds
    assert kids.get(by["rmcl.pad"].id, []) == []
    pads = [(n, k, t) for n, _, k, t in trace.counters if n == "csr.pad"]
    assert pads == [("csr.pad", pads[0][1], top.trace)] and pads[0][1] > 0
    steps = kids[by["rmcl.scan"].id]
    assert [r.name for r in steps] == ["rmcl.step"] * 3
    for s in steps:
        assert [r.name for r in kids[s.id]] == PHASES
    assert [r.name for r in kids[by["rmcl.read"].id]] == ["read.rmcl.history"] * 4
    # self times: each span's duration less its children's, adding up to the job
    own = TT.self_seconds(trace.records)
    assert min(own.values()) >= 0.0
    assert sum(own.values()) == pytest.approx(top.end - top.start, rel=1e-9, abs=1e-12)
    for r in recs.values():
        if r.parent:
            assert recs[r.parent].start <= r.start <= r.end <= recs[r.parent].end


@pytest.mark.parametrize("path", ["rmcl", "block", "ell"])
def test_reads_are_counted_a_job_or_call(trace, path):
    call, want = _paths()[path]
    trace.clear()
    call()
    call()
    assert trace.counted("reads", 0.0, float("inf")) == 2 * want
    reads = [r for r in trace.records if r.name.startswith("read.")]
    assert len(reads) == 2 * want and all(r.nbytes > 0 for r in reads)
    tops = [r for r in trace.records if r.parent == 0]
    assert [r.name for r in tops] == [path] * 2
    assert len({r.trace for r in trace.records}) == 2
    # each read is counted under its own call's trace id (the ELL calls
    # also count their hub rows by route, ``ell.hub.*``; a job its pad's
    # slots, ``csr.pad``)
    counted = [t for name, *_, t in trace.counters if name == "reads"]
    assert sorted(counted) == sorted(r.trace for r in reads)
    names = [name for name, *_ in trace.counters]
    own = {"ell": ["ell.hub.sparse", "ell.hub.dense"], "rmcl": ["csr.pad"]}.get(path, [])
    assert sorted(names) == sorted(["reads"] * 2 * want + own * 2)


def test_a_profiler_session_turns_the_tracer_on():
    TT.TRACE.clear()
    a, plan = _band()
    B.block_spgemm(a, a, plan)
    assert TT.TRACE.records == []
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert TT.TRACE.on()
        B.block_spgemm(a, a, plan)
    assert not TT.TRACE.on()
    names = [r.name for r in TT.TRACE.records]
    assert sorted(names) == sorted(["block", "block.values", "block.structure",
                                    "block.extract", "block.assemble",
                                    "read.assemble.nnz"])
    ranges = {e.name for e in prof.events()}
    assert set(names) <= ranges
    TT.TRACE.clear()


def test_block_on_waits_at_exit_for_a_callable(monkeypatch):
    seen = []
    monkeypatch.setattr(TT, "block_until_ready", seen.append)
    prof = TT.Profiler()
    made = {}
    with prof.span("a", block_on=lambda: made["x"]):
        made["x"] = torch.ones(2)  # made inside the span
    assert seen == [made["x"]]
    with prof.span("b", block_on=[made["x"]]):
        pass
    assert seen[1] == [made["x"]] and list(prof.spans) == ["a", "b"]


# ---- on the card ---------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("path", ["rmcl", "block", "ell"])
def test_every_read_of_a_path_goes_through_host_read(path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    call, _ = _paths("cuda")[path]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _host_pad(csr, capacity):
    """The pad as the host made it: the matrix read back, padded in numpy
    and copied up again (the oracle of the card's pad)."""
    return CSR.from_numpy(*csr.to_numpy(), csr.ncols, csr.device, capacity)


@pytest.mark.cuda
def test_the_pad_grows_on_the_card_and_the_job_keeps_its_bits(trace, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = rmat_csr(13, edge_factor=16, seed=7, device="cpu")  # the s13 cell's shape
    rp, ci, v = g.to_numpy()
    coo = COO.from_numpy(np.repeat(np.arange(g.rows), np.diff(rp)), ci, v, g.rows, g.rows,
                         capacity=ci.size + g.rows, device="cuda")
    mt0 = TR.rmcl_init(coo)
    _, cc = TR.plan_capacities(mt0, mt0, 2.5)
    want = _host_pad(mt0, cc)
    torch.cuda.synchronize()
    trace.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = mt0.with_capacity(cc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert trace.records == []
    assert [(n, k) for n, _, k, _ in trace.counters] == [("csr.pad", cc - mt0.capacity)]
    for a, b in zip((got.row_ptr, got.col_ind, got.values),
                    (want.row_ptr, want.col_ind, want.values)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # a job, with the card's pad and then with the host's: the same bits
    jobs = [TR.rmcl(coo, max_iters=5, mode="scan", margin=2.5)]
    monkeypatch.setattr(CSR, "with_capacity", _host_pad)
    jobs.append(TR.rmcl(coo, max_iters=5, mode="scan", margin=2.5))
    (rp1, ci1, v1), (rp0, ci0, v0) = (j.mt.to_numpy() for j in jobs)
    np.testing.assert_array_equal(rp1, rp0)
    np.testing.assert_array_equal(ci1, ci0)
    np.testing.assert_array_equal(v1.view(np.int32), v0.view(np.int32))
    for k in ("nnz_history", "flops_history", "differs_history"):
        np.testing.assert_array_equal(getattr(jobs[0], k), getattr(jobs[1], k))
    assert not jobs[0].overflow and not jobs[1].overflow
