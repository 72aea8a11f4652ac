"""The readers of the static R-MCL's own spans (``ellspans.py``;
``metrics/ell_scan_ms.py``, ``ell_select_ms.py``, ``ell_plan_ms.py``,
``ell_step_roofline.py``) on a hand-made trace, their None where there is
nothing to read, the roofline's count, and a CPU run of the LFR cell at
a small size."""

import pytest

from portbench import arith, harness
from portbench.trace import DeviceTrace
from sparse_matrix_with_flops_tpu_torch.utils.timing import TRACE, SpanRecord
from test_portbench_portspans import OFFSET, T0, _launched, _Prof

NEW = ["ell_scan_ms.lfr", "ell_select_ms.lfr", "ell_plan_ms.lfr", "ell_step_roofline.lfr"]
H100 = arith.peaks("NVIDIA H100 80GB HBM3")
# products a step whose 16 bytes each take 1 ms at the card's bandwidth
PRODUCTS = H100["hbm_bytes_per_s"] * 1e-3 / 16


@pytest.fixture
def job():
    """One traced static R-MCL job of two iterations by hand: the plan
    (with a read) and the load, one eager step (gather 0.3 ms, tile 0.4,
    select 1.0, hub 0.5, drift 0.2 of device work), one graph replay of
    2 ms launched in the scan, the history read."""
    TRACE.clear()
    spans = [("rmcl_ell", 1.0, 20.0, 1, 0), ("rmcl_ell.init", 1.0, 2.0, 2, 1),
             ("rmcl_ell.plan", 2.0, 4.0, 3, 1), ("read.rmcl_ell.csr_host", 2.1, 2.2, 4, 3),
             ("rmcl_ell.load", 4.0, 5.0, 5, 1), ("rmcl_ell.scan", 5.0, 15.0, 6, 1),
             ("rmcl_ell.step", 5.0, 8.0, 7, 6), ("rmcl_ell.step.gather", 5.0, 5.5, 8, 7),
             ("rmcl_ell.step.tile", 5.5, 6.0, 9, 7), ("rmcl_ell.step.select", 6.0, 6.8, 10, 7),
             ("rmcl_ell.step.hub", 6.8, 7.0, 11, 7), ("rmcl_ell.step.drift", 7.0, 7.5, 12, 7),
             ("rmcl_ell.read", 15.0, 18.0, 13, 1), ("read.rmcl_ell.history", 16.0, 16.5, 14, 13)]
    for name, s, e, i, parent in spans:  # ms after T0
        TRACE.records.append(SpanRecord(name, T0 + s * 1e-3, T0 + e * 1e-3, i, parent, 1, 8))
    TRACE.counters += [("reads", T0 + 2.15e-3, 1, 1), ("reads", T0 + 16.1e-3, 1, 1)]
    ms = 1e-3
    ev = (_launched("marker", T0, T0 + 5e-6, 1e-6, 1)
          + _launched("Memcpy DtoH (Device -> Pageable)", T0 + 2.12 * ms, T0 + 2.13 * ms, 2e-5, 2)
          + _launched("gather", T0 + 5.2 * ms, T0 + 5.3 * ms, 0.3 * ms, 3)
          + _launched("sdc_kernel", T0 + 5.7 * ms, T0 + 5.8 * ms, 0.4 * ms, 4)
          + _launched("sort", T0 + 6.5 * ms, T0 + 6.6 * ms, 1.0 * ms, 5)
          + _launched("gemm", T0 + 6.9 * ms, T0 + 7.6 * ms, 0.5 * ms, 6)
          + _launched("drift", T0 + 7.2 * ms, T0 + 8.1 * ms, 0.2 * ms, 7)
          + _launched("replayed", T0 + 9.0 * ms, T0 + 9.1 * ms, 2.0 * ms, 8)
          + _launched("Memcpy DtoH (Device -> Pageable)", T0 + 16.1 * ms, T0 + 16.2 * ms, 2e-5, 9))
    tr = DeviceTrace.__new__(DeviceTrace)
    tr.prof, tr._t0, tr.items = _Prof(ev), T0, 1
    tr.device = sorted(((e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
                        for e in ev if e._v[4]), key=lambda d: d[1])
    tr.window = (T0 + OFFSET + 5e-6, T0 + OFFSET + 5e-6 + 25e-3)
    tr.host = []
    work = {"iters": 2, "S": 128, "products": 2 * PRODUCTS}
    yield harness.Record(kind="NVIDIA H100 80GB HBM3", trace=tr, items=1, work=work)
    TRACE.clear()


def test_the_readers_on_a_hand_made_job(job):
    got = {m: harness.reader(m).read(job) for m in NEW}
    # 4.4 ms of device work launched in the scan, over 2 iterations
    assert got["ell_scan_ms.lfr"] == pytest.approx(2.2)
    assert got["ell_select_ms.lfr"] == pytest.approx(1.0)
    assert got["ell_plan_ms.lfr"] == pytest.approx(3.0)
    assert got["ell_step_roofline.lfr"] == pytest.approx(100.0 / 2.2)
    notes = "\n".join(job.notes)
    assert "gather 0.300, tile 0.400, select 1.000, hub 0.500, drift 0.200" in notes
    assert "bound by bytes" in notes and "2.000 ms in rmcl_ell.plan" in notes


def test_the_roofline_counts_a_pair_written_and_read_and_two_flops_a_product():
    mod = harness.reader("ell_step_roofline.lfr")
    flops, nbytes = mod.step_counts({"iters": 10, "products": 10 * 1000.0})
    assert (flops, nbytes) == (2000.0, 16000.0)
    # nnz(Mgt) · S products a step at 2^19 LFR nodes: bound by bytes, 6.7 ms
    least, bound = arith.least_time(*mod.step_counts({"iters": 1, "products": 11.0e6 * 128}),
                                    H100)
    assert bound == "bytes" and least == pytest.approx(11.0e6 * 128 * 16 / 3.35e12)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_finds_nothing_without_a_trace(name):
    assert harness.reader(name).read(harness.Record(kind="cpu", items=3)) is None


@pytest.mark.parametrize("name", NEW)
def test_a_reader_finds_nothing_without_the_static_paths_spans(job, name):
    # a port whose rmcl_ell records no span of its own: only the reads
    TRACE.records[:] = [r for r in TRACE.records if r.name.startswith("read.")]
    assert harness.reader(name).read(job) is None


def test_the_select_reader_finds_nothing_in_a_step_without_a_selection(job):
    TRACE.records[:] = [r for r in TRACE.records if r.name != "rmcl_ell.step.select"]
    # the sort then lies in the step's own span, not in a phase
    assert harness.reader("ell_select_ms.lfr").read(job) is None
    assert harness.reader("ell_scan_ms.lfr").read(job) == pytest.approx(2.2)


def test_a_cpu_run_of_the_lfr_cell():
    cell = "lfr-524288.rmcl-static-10it"
    small = {"config": {"nodes": 1000}, "traffic": {"pool": 2, "sample_from": 3, "sample": 2}}
    out, lines = harness.run_cell(cell, 2**31 + 11, 0.3, False, "cpu", overrides=small)
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    w = harness.workload(harness.benchmark(), cell)
    want = {m["name"] for m in harness.cell_metrics(harness.benchmark(), w, "end_to_end")}
    assert set(out["metrics"]) == want - {"peak_gib"}  # no card allocator on the CPU
    assert list(out["checks"]) == ["bad_rows", "gap_p99", "rows_apart"]
