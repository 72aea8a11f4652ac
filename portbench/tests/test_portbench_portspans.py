"""The readers of the port's own spans (``portspans.py``;
``metrics/pad_ms.py``, ``sort_ms.py``, ``reads.py``): on a hand-made
trace, their None where there is nothing to read, and on the card the
mapping of the port's spans onto the profiler's clock."""

import pytest
import torch

from portbench import harness, portspans
from portbench.trace import DeviceTrace, Spans
from sparse_matrix_with_flops_tpu_torch.utils.timing import TRACE, SpanRecord

NEW = ["pad_ms.cluster", "sort_ms.cluster", "reads.cluster", "reads.band", "reads.graph500"]
T0, OFFSET = 100.0, 4900.0  # the window's host start; the profiler's clock less the host's


class _Ev:
    """A kineto event: a device operation or a CUDA-runtime call."""

    def __init__(self, name, start, dur, corr, device):
        self._v = (name, start, dur, corr, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return round(self._v[1] * 1e9)

    def duration_ns(self):
        return round(self._v[2] * 1e9)

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[4] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False

    def activity_type(self):
        return "kernel" if self._v[4] else "cuda_runtime"


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events": lambda _s: events})()


def _launched(name, launch, start, dur, corr):
    """A device operation and the runtime call that launched it, at host
    times (the profiler's clock is the host's + OFFSET)."""
    return [_Ev("cudaLaunchKernel", launch + OFFSET, 2e-6, corr, False),
            _Ev(name, start + OFFSET, dur, corr, True)]


@pytest.fixture
def job():
    """One traced R-MCL job by hand: the pad, one step whose sort launches
    a 1 ms kernel, two reads; and a span after the window."""
    TRACE.clear()
    spans = [("rmcl", 1.0, 10.0, 1, 0), ("rmcl.pad", 2.0, 4.0, 2, 1),
             ("read.csr.to_numpy", 2.1, 2.2, 3, 2), ("write.csr.from_numpy", 3.0, 3.5, 4, 2),
             ("rmcl.scan", 5.0, 8.0, 5, 1), ("rmcl.step", 5.0, 8.0, 6, 5),
             ("rmcl.step.sort", 6.0, 7.0, 7, 6), ("read.rmcl.history", 8.5, 9.0, 8, 1)]
    for name, s, e, i, parent in spans:  # ms after T0
        TRACE.records.append(SpanRecord(name, T0 + s * 1e-3, T0 + e * 1e-3, i, parent, 1,
                                        4096 if name.startswith("write") else 8))
    TRACE.records.append(SpanRecord("rmcl", T0 + 1.0, T0 + 1.1, 9, 0, 2))
    TRACE.counters += [("reads", T0 + 2.15e-3, 1, 1), ("reads", T0 + 8.6e-3, 1, 1),
                       ("reads", T0 + 1.05, 1, 2)]
    ev = (_launched("marker", T0, T0 + 5e-6, 1e-6, 1)
          + _launched("Memcpy DtoH (Device -> Pageable)", T0 + 2.12e-3, T0 + 2.13e-3, 2e-5, 2)
          + _launched("Memcpy HtoD (Pageable -> Device)", T0 + 3.1e-3, T0 + 3.2e-3, 1e-4, 5)
          + _launched("sortKernel", T0 + 6.2e-3, T0 + 6.5e-3, 1e-3, 3)
          + _launched("Memcpy DtoH (Device -> Pageable)", T0 + 8.6e-3, T0 + 8.7e-3, 2e-5, 4))
    tr = DeviceTrace.__new__(DeviceTrace)
    tr.prof, tr._t0, tr.items = _Prof(ev), T0, 1
    tr.device = sorted(((e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
                        for e in ev if e._v[4]), key=lambda d: d[1])
    tr.window = (T0 + OFFSET + 5e-6, T0 + OFFSET + 5e-6 + 20e-3)
    tr.host = []
    yield harness.Record(kind="NVIDIA H100 80GB HBM3", trace=tr, items=1)
    TRACE.clear()


def test_the_readers_on_a_hand_made_job(job):
    got = {m: harness.reader(m).read(job) for m in NEW}
    assert got["pad_ms.cluster"] == pytest.approx(2.0)
    assert got["sort_ms.cluster"] == pytest.approx(1.0)
    # the read after the window is not counted
    assert got["reads.cluster"] == got["reads.band"] == got["reads.graph500"] == 2
    notes = "\n".join(job.notes)
    assert "csr.to_numpy 1, rmcl.history 1" in notes
    assert "sort 1.000" in notes and "copying 0.0 MB back" in notes
    # the offset is the least launch of a read's copy less the read's start:
    # 20 us (the first read's) over the clocks' own
    v = portspans.view(job)
    assert v.origin == pytest.approx(OFFSET + 20e-6, abs=1e-9)
    cc = v.clock_check()
    assert cc["reads"] == 2 and cc["copy_outside_read_s"] == pytest.approx(0.0, abs=1e-9)
    assert cc["op_after_read_s"] < 0
    assert "holds to 50 us" in notes


def test_idle_time_is_named_by_the_innermost_port_span(job):
    rows, inside = portspans.view(job).idle_by_span()
    # gaps (ms after the window's host start) and the span at their middle:
    # 0.006-2.13, 3.3-6.5 and 7.5-8.7 in rmcl; 2.15-3.2 in rmcl.pad; 8.72-20.005 after the job
    want = [["outside the port's spans (1 gaps)", 11.285e-3], ["rmcl (3 gaps)", 6.524e-3],
            ["rmcl.pad (1 gaps)", 1.05e-3]]
    assert [lab for lab, _ in rows] == [lab for lab, _ in want]
    assert [t for _, t in rows] == pytest.approx([t for _, t in want], abs=1e-9)
    assert inside == pytest.approx(7.574 / 18.859)


def test_the_offset_pairs_the_reads_with_their_copies():
    # reads of 0.1-1 s (each waits for the card), on a clock 10 s ahead:
    # each read's copy launched 20-40 us after its start, a copy outside the
    # port's reads 0.5 s before the first, another inside the long read
    reads = [(1.0, 1.1), (2.0, 2.05), (3.0, 4.0)]
    copies = [10.5, 11.00003, 12.00002, 13.00004, 13.5]
    assert portspans._offset(reads, copies, 99.0) == pytest.approx(10.00002, abs=1e-9)
    assert portspans._offset([], copies, 99.0) == 99.0


@pytest.mark.parametrize("name", NEW)
def test_a_reader_finds_nothing_without_a_trace(name):
    assert harness.reader(name).read(harness.Record(kind="cpu", items=3)) is None


@pytest.mark.parametrize("name", NEW)
def test_a_reader_finds_nothing_in_a_port_without_the_tracer(job, name, monkeypatch):
    monkeypatch.setattr(portspans, "TRACE", None)
    assert harness.reader(name).read(job) is None


@pytest.mark.parametrize("name", NEW)
def test_a_reader_finds_nothing_without_port_spans_in_the_window(job, name):
    TRACE.clear()
    assert harness.reader(name).read(job) is None


# ---- on the card ---------------------------------------------------------------------
@pytest.mark.cuda
def test_the_port_spans_lie_on_the_profilers_clock():
    """The profiler's own record of each span (a range on its clock, with
    the CPU activity on) is the truth the mapped spans are held to: each
    span's edges, each operation launched inside one starts after the
    span's mapped start, and each read returns after the work launched
    before it, all to within 50 us."""
    import importlib

    from sparse_matrix_with_flops_tpu_torch.ops import block_spgemm as B
    from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
    from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
    from sparse_matrix_with_flops_tpu_torch.utils.generate import (
        banded_csr,
        planted_partition_coo,
    )

    rmcl = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl").rmcl
    coo = planted_partition_coo(8, 64, seed=1, device="cuda")[0]
    a = banded_csr(4096, 16, seed=1, device="cuda")
    bplan, eplan = B.plan_block(a, a), plan_ell(a, a)
    calls = [lambda: rmcl(coo, max_iters=3, mode="scan", margin=2.0),
             lambda: B.block_spgemm(a, a, bplan), lambda: E.spgemm_ell(a, a, eplan)]
    for c in calls:
        c()
    TRACE.clear()
    dt = DeviceTrace(Spans())
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    dt.prof = torch.profiler.profile(activities=acts)
    dt.start()
    for c in calls:
        c()
        torch.cuda.synchronize()
    dt.stop(len(calls))
    v = portspans.view(harness.Record(kind=torch.cuda.get_device_name(), trace=dt, items=3))
    cpu = torch.autograd.DeviceType.CPU
    names = {r.name for r, _, _ in v.spans}
    truth: dict = {}
    for e in dt.prof.profiler.kineto_results.events():
        if e.device_type() == cpu and e.name() in names:
            truth.setdefault(e.name(), []).append((e.start_ns() * 1e-9, e.end_ns() * 1e-9))
    tol = portspans.TOL_S
    seen: dict = {}
    for r, s, e in v.spans:
        k = seen[r.name] = seen.get(r.name, -1) + 1
        rs, re = sorted(truth[r.name])[k]
        assert abs(s - rs) <= tol and abs(e - re) <= tol, (r.name, s - rs, e - re)
        launched = [(op, start, end) for op, start, end, launch in v.ops
                    if launch is not None and rs <= launch <= re]
        assert all(start >= s - tol for _, start, _ in launched), r.name
        if r.name.startswith("read."):
            before = [end for _, _, end, launch in v.ops if launch is not None and launch <= re]
            assert max(before) <= e + tol, r.name
    assert sum(len(x) for x in truth.values()) >= len(v.spans) > 0
    cc = v.clock_check()
    assert cc["reads"] == 10
    assert max(cc["copy_outside_read_s"], cc["op_after_read_s"]) <= tol
    TRACE.clear()
