"""The port's "last marked position" primitive (``ops/segments.last_marked``,
behind ``repeat_segments``) and the scatters that drop writes, on the
CPU: held element for element against the JAX package's
``repeat_segments`` and against ``repeat_segments_plain`` (the
max-scatter and running max), the ELL assembly's window positions and
row-start deltas against their running-max forms on an R-MAT s8 plan,
and the drift ``csr_frobenius_diff`` bit for bit against its
scatter-add form and within ``torch_port_util``'s tolerance of the JAX
function."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
from sparse_matrix_with_flops_tpu.ops import metrics as JM
from sparse_matrix_with_flops_tpu.ops import segments as JS
from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as TE
from sparse_matrix_with_flops_tpu_torch.ops import metrics as TM
from sparse_matrix_with_flops_tpu_torch.ops import segments as TS
from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell
from sparse_matrix_with_flops_tpu_torch.ops.segments import (
    last_marked,
    repeat_segments,
    repeat_segments_plain,
    segment_boundaries,
)
from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

from torch_port_util import assert_close_values, port_csr, trimmed

TR = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl")


def _three_ways(starts, valid, total):
    """The port's primitive, its plain version and the JAX function on
    the same arrays, as numpy."""
    s = np.asarray(starts, dtype=np.int32)
    v = np.asarray(valid, dtype=bool)
    ts, tv = torch.from_numpy(s), torch.from_numpy(v)
    got = repeat_segments(ts, tv, total)
    assert got.dtype == torch.int32 and got.shape == (total,)
    plain = repeat_segments_plain(ts, tv, total).numpy()
    ref = np.asarray(JS.repeat_segments(jnp.asarray(s), jnp.asarray(v), total))
    return got.numpy(), plain, ref


def _from_counts(counts, valid=None):
    """Exclusive-cumsum starts of ``counts``; valid = nonempty (and
    ``valid`` where given), as the ESC callers build them."""
    counts = np.asarray(counts, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    ok = counts > 0
    return starts, ok if valid is None else ok & np.asarray(valid, dtype=bool)


CASES = {
    "empty segments": (*_from_counts([2, 0, 3, 0, 0, 1]), 6),
    "invalid segments": (*_from_counts([2, 1, 3, 1], [True, False, True, False]), 7),
    "coinciding starts": ([0, 0, 2, 2, 2, 5], [True, True, True, False, True, True], 8),
    "starts at or past total": (*_from_counts([3, 2, 4, 1]), 5),
    "total = 0": (*_from_counts([2, 3]), 0),
    "all invalid": ([0, 1, 4], [False, False, False], 6),
    "one segment": (*_from_counts([4]), 4),
    "one segment, past its end": (*_from_counts([4]), 9),
    "no segments": ([], [], 3),
    "first start late": ([3, 5, 5], [True, True, True], 9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_repeat_segments_equals_the_running_max_and_the_reference(case):
    starts, valid, total = CASES[case]
    got, plain, ref = _three_ways(starts, valid, total)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", range(4))
def test_repeat_segments_on_esc_sized_streams(seed):
    # an expansion's shape: thousands of entries, most with products,
    # some invalid, the cap above and below the product count
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, 3000) * (rng.random(3000) < 0.8)
    starts, valid = _from_counts(counts, rng.random(3000) < 0.9)
    total = int(counts.sum())
    for cap in (total, total + 17, total // 2):
        got, plain, ref = _three_ways(starts, valid, cap)
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, ref)
    # what the equivalence rests on: valid starts non-decreasing
    assert (np.diff(starts[valid]) > 0).all()


@settings(max_examples=40, deadline=None, database=None)
@given(counts=st.lists(st.integers(0, 4), min_size=16, max_size=16),
       mask=st.lists(st.booleans(), min_size=16, max_size=16),
       total=st.sampled_from([0, 5, 24, 64]))
def test_repeat_segments_over_random_counts(counts, mask, total):
    # fixed shapes, so the JAX function compiles once a total
    starts, valid = _from_counts(counts, mask)
    got, plain, ref = _three_ways(starts, valid, total)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", range(3))
def test_last_marked_with_runs_of_equal_marks(seed):
    # the window marks: many rows mark one window, the last wins
    rng = np.random.default_rng(seed)
    marks = np.sort(rng.integers(0, 40, 200)).astype(np.int32)
    valid = rng.random(200) < 0.6
    m, v = torch.from_numpy(marks), torch.from_numpy(valid)
    for total in (0, 1, 20, 40, 45):
        np.testing.assert_array_equal(last_marked(m, v, total).numpy(),
                                      repeat_segments_plain(m, v, total).numpy())


# ---- the ELL assembly's two running maxima ---------------------------------------
def _window_positions_cummax(counts, flat_base, starts, nwin: int):
    """``_window_positions`` as a max-scatter of row ids at each row's
    window and a running max."""
    m = counts.shape[0]
    nonempty = counts > 0
    d = torch.where(nonempty, flat_base - starts, 0)
    rid = torch.arange(m, dtype=torch.int32)
    cw = torch.where(nonempty, (starts + TE._WA - 1) // TE._WA, nwin).clamp(max=nwin)
    rmax = torch.zeros(nwin + 1, dtype=torch.int32)
    rmax.scatter_reduce_(0, cw.long(), torch.where(nonempty, rid + 1, 0), reduce="amax")
    rwin = (torch.cummax(rmax[:nwin], 0).values - 1).clamp(min=0).long()
    k = torch.arange(nwin, dtype=torch.int64)
    return (k * TE._WA + d[rwin].long()).to(torch.int32)


def _row_start_deltas_cummax(counts, starts, ocap: int):
    """``_row_start_deltas`` with its forward fill a running max and the
    empty rows added into one dump slot."""
    m = counts.shape[0]
    nonempty = counts > 0
    ds = torch.where(nonempty, starts, 0)
    last = torch.cummax(torch.where(nonempty, torch.arange(m), -1), 0).values
    filled = torch.where(last >= 0, ds[last.clamp(min=0)], 0)
    prevs = torch.cat([filled.new_zeros(1), filled[:-1]])
    dds = torch.zeros(ocap + 1, dtype=torch.int32)
    tgt = torch.where(nonempty, starts, ocap).clamp(max=ocap).long()
    dds.index_add_(0, tgt, torch.where(nonempty, ds - prevs, 0))
    return dds[:ocap]


@pytest.mark.parametrize("empty_rows", [False, True])
def test_window_positions_and_row_start_deltas_equal_their_running_max_forms(empty_rows):
    a = rmat_csr(8, edge_factor=8, seed=3, weights="random", device="cpu")
    plan = plan_ell(a, a)
    _, _, counts, flat_base = TE._tiles_impl(a, a, plan)
    if empty_rows:  # empty rows between the nonempty ones, several a window
        counts = torch.where(torch.arange(counts.shape[0]) % 3 == 1, 0, counts)
    starts = TS.exclusive_cumsum(counts)[:-1]
    assert (counts == 0).any() and (counts.diff() != 0).any()
    ocap = -(-int(counts.sum()) // TE._WA) * TE._WA + TE._WA
    for nwin in (ocap // TE._WA, ocap // TE._WA - 2):
        np.testing.assert_array_equal(
            TE._window_positions(counts, flat_base, starts, nwin).numpy(),
            _window_positions_cummax(counts, flat_base, starts, nwin).numpy())
    for cap in (ocap, ocap - 2 * TE._WA):
        np.testing.assert_array_equal(
            TE._row_start_deltas(counts, starts, cap).numpy(),
            _row_start_deltas_cummax(counts, starts, cap).numpy())


# ---- the drift ---------------------------------------------------------------------
def _stochastic(n: int, density: float, seed: int) -> JCSR:
    """A row-stochastic R-MCL iterate with every diagonal entry
    (``tests/test_torch_rmcl.py``'s, random weights)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    np.fill_diagonal(mask, True)
    d = np.where(mask, rng.random((n, n)) + 0.05, 0.0)
    return JCSR.from_dense((d / d.sum(1, keepdims=True)).astype(np.float32))


PAIR_CAP = 512  # the JAX CSRs' capacity: one compile of the JAX drift for every seed


def _pair(seed):
    """``tests/test_torch_rmcl.py``'s pair, an iterate and its next step,
    the step the port's: (JAX, port) CSRs of both."""
    ta = port_csr(_stochastic(30, 0.15, seed))
    pc, cc = TR.plan_capacities(ta, ta, margin=1.0)
    tb, _ = TR.rmcl_one_step(ta, ta.with_capacity(cc), pc, cc)
    ja, jb = (JCSR.from_arrays(*trimmed(x), ncols=x.ncols, capacity=PAIR_CAP) for x in (ta, tb))
    return ja, jb, ta, tb


def _frobenius_diff_scatter_add(a, b):
    """The drift as the port wrote it before: every entry added into its
    segment, padding into one dump slot."""
    rows = a.rows
    valid = torch.cat([a.entry_valid(), b.entry_valid()])
    r = torch.where(valid, torch.cat([a.entry_rows(), b.entry_rows()]), rows)
    c = torch.cat([a.col_ind, b.col_ind])
    v = torch.cat([a.values, -b.values])
    order = torch.sort(r.long() * (max(a.ncols, b.ncols) + 1) + c.long(), stable=True).indices
    r, c, v = r[order], c[order], v[order]
    ok = r < rows
    flags = segment_boundaries(r, c, ok)
    seg = torch.where(ok, torch.cumsum(flags, 0) - 1, r.shape[0])
    sums = torch.zeros(r.shape[0] + 1)
    sums.index_add_(0, seg, torch.where(ok, v, 0.0))
    sums = sums[: r.shape[0]]
    return (sums * sums).sum(), torch.where(a.entry_valid(), a.values**2, 0.0).sum()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_keeps_the_scatter_add_bits(seed):
    ja, jb, ta, tb = _pair(seed)
    for x, y in ((ta, tb), (tb, ta), (ta, ta)):
        got, want = TM.csr_frobenius_diff(x, y), _frobenius_diff_scatter_add(x, y)
        assert [float(t) for t in got] == [float(t) for t in want]
    jd2, jn2 = JM.csr_frobenius_diff(ja, jb)
    td2, tn2 = TM.csr_frobenius_diff(ta, tb)
    assert_close_values([float(td2), float(tn2)], [float(jd2), float(jn2)])
    # each (row, col) segment of the union holds one or two entries
    keys = torch.cat([ta.entry_rows() * 64 + ta.col_ind, tb.entry_rows() * 64 + tb.col_ind])
    keys = keys[torch.cat([ta.entry_valid(), tb.entry_valid()])]
    assert int(torch.unique(keys, return_counts=True)[1].max()) <= 2
