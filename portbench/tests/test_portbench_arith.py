"""The benchmark's arithmetic on hand-made inputs: rowFlops, roofline
bytes and least times, percentiles, busy and idle time, and
the trace's idle gaps named by the harness's spans."""

import numpy as np
import pytest

from portbench import arith
from portbench.trace import DeviceTrace


def test_row_flops_against_a_hand_count():
    # A = [[1 1 0], [0 0 1], [1 0 1]]: row lengths 2, 1, 2
    rp = np.array([0, 2, 3, 5])
    ci = np.array([0, 1, 2, 0, 2])
    # row 0 reads rows 0, 1 (2 + 1); row 1 reads row 2 (2); row 2 reads rows 0, 2 (2 + 2)
    assert arith.row_flops_total(rp, ci) == 3 + 2 + 4


def test_spgemm_bytes_and_the_cells_bounds():
    assert arith.csr_bytes(3, 5) == 4 * 4 + 8 * 5
    # A·A reads A once: it is both operands
    assert arith.square_bytes(3, 5, 7) == (16 + 40) + 16 + 56
    band = arith.square_bytes(62451, 4058259, 8052019)  # the band's A and C
    assert round(band / 1e6, 2) == 97.38
    peak = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 1.65e14}
    t, bound = arith.least_time(2 * 263741075, band, peak)
    assert bound == "bytes" and abs(t - 29.07e-6) < 0.01e-6
    t, bound = arith.least_time(1.65e14, 1.0, peak)
    assert bound == "ops" and t == pytest.approx(1.0)


def test_peaks_match_the_card_by_name():
    assert arith.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        arith.peaks("cpu")


@pytest.mark.parametrize("p", [0, 10, 50, 90, 95, 100])
def test_percentile_is_numpys(p):
    xs = list(np.random.default_rng(p).random(37))
    assert arith.percentile(xs, p) == pytest.approx(float(np.percentile(xs, p)))


def test_percentile_of_a_hand_list():
    assert arith.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 90) == pytest.approx(9.1)
    with pytest.raises(ValueError):
        arith.percentile([], 50)


def test_busy_gaps_and_idle_on_overlapping_intervals():
    iv = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (6.5, 6.8), (9.0, 12.0)]
    assert arith.union(iv) == [(1.0, 4.0), (6.0, 7.0), (9.0, 12.0)]
    assert arith.busy(iv, 0.0, 10.0) == pytest.approx(3.0 + 1.0 + 1.0)
    assert arith.gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0), (7.0, 9.0)]
    assert arith.idle_pct(5.0, 10.0) == pytest.approx(50.0)
    assert arith.busy([], 0.0, 1.0) == 0.0
    assert arith.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def _trace(device, host, window):
    tr = DeviceTrace.__new__(DeviceTrace)
    tr.device, tr.host, tr.window, tr.items = device, host, window, 2
    return tr


def test_idle_gaps_are_named_by_the_innermost_span():
    tr = _trace(
        device=[("k1", 1.0, 2.0), ("k2", 3.0, 4.0), ("k1", 4.0, 5.0), ("copy", 8.0, 9.0)],
        host=[("job", 0.0, 10.0), ("plan", 2.0, 3.0), ("read", 5.0, 7.0)],
        window=(0.0, 10.0))
    assert tr.busy_s == pytest.approx(4.0)
    assert tr.window_s == pytest.approx(10.0)
    assert tr.top_ops() == [["k1", 2.0], ["k2", 1.0], ["copy", 1.0]]
    gaps = {name: t for name, t in tr.idle_by_span()}
    # 0-1 and 9-10 inside "job" only, 2-3 inside "plan", 5-8 by its middle in "read"
    assert gaps == {"job (2 gaps)": 2.0, "plan (1 gaps)": 1.0, "read (1 gaps)": 3.0}


def test_a_gap_outside_every_span_is_named_so():
    tr = _trace(device=[("k", 1.0, 2.0)], host=[], window=(0.0, 3.0))
    assert tr.idle_by_span() == [["outside the harness's spans (2 gaps)", 2.0]]
