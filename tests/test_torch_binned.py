"""The flops machinery, the binned SpGEMM, the per-bin checker, the
row-partitioned driver and ``TiledCSR.to_host_csr`` on the CPU, each
held against the JAX package on the same host arrays.  K1 runs its plain
twin here (the tensors lie on the CPU); the card tests hold the kernel
against it."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.formats.coo import COO as JCOO
from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
from sparse_matrix_with_flops_tpu.ops import bincheck as JB
from sparse_matrix_with_flops_tpu.ops import binned as JBIN
from sparse_matrix_with_flops_tpu.ops import ell_esc as JE
from sparse_matrix_with_flops_tpu.ops import flops as JF
from sparse_matrix_with_flops_tpu.ops import partitioned as JP
from sparse_matrix_with_flops_tpu.ops.spgemm import matmul as j_matmul
from sparse_matrix_with_flops_tpu.utils.generate import banded_csr as j_banded
from sparse_matrix_with_flops_tpu.utils.generate import rmat_csr as j_rmat
from sparse_matrix_with_flops_tpu_torch import ops as TOPS
from sparse_matrix_with_flops_tpu_torch.config import FLOPS_BIN_BOUNDS
from sparse_matrix_with_flops_tpu_torch.ops import bincheck as TB
from sparse_matrix_with_flops_tpu_torch.ops import binned as TBIN
from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as TE
from sparse_matrix_with_flops_tpu_torch.ops import flops as TF
from sparse_matrix_with_flops_tpu_torch.ops import partitioned as TP
from sparse_matrix_with_flops_tpu_torch.ops import sort_kernels as TK
from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell as t_plan_ell
from sparse_matrix_with_flops_tpu_torch.ops.spgemm import matmul as t_matmul

from torch_port_util import assert_same_csr, jax_random_csr, port_csr, trimmed


def _matrices():
    """(name, JAX A, JAX B) at small sizes, one seed each."""
    rng = np.random.default_rng(0)
    a = jax_random_csr(rng, 120, 90, 0.08, empty_rows=(3, 50))
    b = jax_random_csr(rng, 90, 70, 0.12, empty_rows=(7,))
    return {
        "rmat_s9": (j_rmat(9, edge_factor=8, seed=7, weights="random"),) * 2,
        "random_rect": (a, b),
        "band_300": (j_banded(300, bandwidth=6, seed=1, density=0.5),) * 2,
    }


MATS = _matrices()


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- flops helpers -----------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(MATS))
def test_classify_flops_matches_reference(name):
    ja, jb = MATS[name]
    want = JF.classify_flops(ja, jb)
    got = TF.classify_flops(port_csr(ja), port_csr(jb))
    assert got._fields == want._fields
    for f in want._fields:
        g, w = _np(getattr(got, f)), _np(getattr(want, f))
        assert g.dtype == w.dtype == np.int32, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_flops_bin_id_matches_reference():
    bounds = np.asarray(FLOPS_BIN_BOUNDS)
    x = np.unique(np.concatenate([bounds - 1, bounds, bounds + 1, [0, 2, 3, 1000, 2**20]]))
    x = x[x >= 0].astype(np.int32)
    got = TF.flops_bin_id(torch.from_numpy(x))
    want = np.asarray(JF.flops_bin_id(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("buckets", [5, 13, 20])
def test_log2_histogram_matches_reference(buckets):
    rng = np.random.default_rng(1)
    # every power of two and its neighbours (the bucket edges), and a spread
    p2 = 1 << np.arange(22)
    x = np.concatenate([[0, 1], p2 - 1, p2, p2 + 1, rng.integers(0, 2**21, 500)])
    x = x.astype(np.int32)
    got = TF.log2_histogram(torch.from_numpy(x), buckets)
    want = np.asarray(JF.log2_histogram(x, buckets))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(MATS))
def test_flops_and_nnz_stats_match_reference(name, capsys):
    ja, jb = MATS[name]
    ta, tb = port_csr(ja), port_csr(jb)
    jh, jrf = JF.flops_stats(ja, jb)
    th, trf = TF.flops_stats(ta, tb)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(trf.numpy(), np.asarray(jrf))
    jn = JF.nnz_stats(j_matmul(ja, jb))
    tn = TF.nnz_stats(t_matmul(ta, tb))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for hist, title in ((jh, "row flops"), (jn, "C row nnz")):
        JF.print_stats(hist, title)
    want = capsys.readouterr().out
    for hist, title in ((th, "row flops"), (tn, "C row nnz")):
        TF.print_stats(hist, title)
    got = capsys.readouterr().out
    assert got == want and "=== row flops (total" in got


# ---- the binned SpGEMM ---------------------------------------------------------------
def _plan_cases():
    rng = np.random.default_rng(2)
    out = {}
    for d in (0.05, 0.3):
        out[f"random_{d}"] = (jax_random_csr(rng, 64, 64, d),) * 2
    out["rmat_s10"] = (j_rmat(10, edge_factor=8, seed=7, weights="random"),) * 2
    out["band_256"] = (j_banded(256, bandwidth=8, seed=2),) * 2
    return out


PLAN_CASES = _plan_cases()


@pytest.mark.parametrize("widths", [TBIN.DEFAULT_BIN_WIDTHS, (4, 16, 64)])
@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plan_bins_matches_reference(name, widths):
    ja, jb = PLAN_CASES[name]
    want = JBIN.plan_bins(ja, jb, widths=widths)
    got = TBIN.plan_bins(port_csr(ja), port_csr(jb), widths=widths)
    names = [f.name for f in dataclasses.fields(want)]
    assert names == [f.name for f in dataclasses.fields(got)]
    assert got.num_bins == want.num_bins
    for (gr, gw), (wr, ww) in zip(got.bins, want.bins):
        assert gw == ww and gr.dtype == wr.dtype == np.int32
        np.testing.assert_array_equal(gr, wr)
        assert gr.size % 8 == 0
    for f in ("huge_product_cap", "product_cap", "out_cap", "rows"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.huge_rows.dtype == want.huge_rows.dtype
    np.testing.assert_array_equal(got.huge_rows, want.huge_rows)


def _binned_cases():
    rng = np.random.default_rng(3)
    dense = (rng.random((48, 40)) < 0.12).astype(np.float32)
    dense[5, :] = 1.0  # a heavy row, past the widest bin
    dense[17, ::2] = 1.0
    dense *= rng.standard_normal((48, 40)).astype(np.float32)
    heavy = JCSR.from_dense(dense)
    b = jax_random_csr(rng, 40, 56, 0.2)
    return {
        # name: (A, B, widths, out_cap)
        "rmat_s8": (j_rmat(8, edge_factor=8, seed=5, weights="random"),) * 2
        + (TBIN.DEFAULT_BIN_WIDTHS, None),
        "rmat_s10_huge": (j_rmat(10, edge_factor=8, seed=7, weights="random"),) * 2
        + ((16, 64), None),
        "random_rect": (
            jax_random_csr(rng, 100, 80, 0.1, empty_rows=(0, 9)),
            jax_random_csr(rng, 80, 72, 0.15),
            (4, 16, 64),
            None,
        ),
        "heavy_rows": (heavy, b, (4, 16), None),
        "heavy_rows_truncated": (heavy, b, (4, 16), 700),
        "rmat_s8_truncated": (j_rmat(8, edge_factor=8, seed=5, weights="random"),) * 2
        + ((8, 32), 5000),
    }


BINNED = _binned_cases()


@pytest.mark.parametrize("name", sorted(BINNED))
def test_spgemm_binned_matches_reference(name):
    ja, jb, widths, out_cap = BINNED[name]
    jplan = JBIN.plan_bins(ja, jb, widths=widths, out_cap=out_cap)
    want = JBIN.spgemm_binned(ja, jb, jplan)
    ta, tb = port_csr(ja), port_csr(jb)
    tplan = TBIN.plan_bins(ta, tb, widths=widths, out_cap=out_cap)
    if name.startswith(("rmat_s10_huge", "heavy")):
        assert tplan.huge_rows.size > 0
    got = TBIN.spgemm_binned(ta, tb, tplan)
    assert got.capacity == tplan.out_cap
    if out_cap is not None:  # the cap truncates: row_ptr clipped to it
        assert int(np.asarray(want.row_ptr)[-1]) == out_cap
    assert_same_csr(want, got)
    # the same call again gives the same bits (no float atomics)
    again = TBIN.spgemm_binned(ta, tb, tplan)
    for x, y in zip(trimmed(got), trimmed(again)):
        np.testing.assert_array_equal(x, y)
    # padding past nnz is the sentinel
    nnz = int(got.row_ptr[-1])
    assert bool((got.col_ind[nnz:] == tb.ncols).all()) and bool((got.values[nnz:] == 0).all())


def test_spgemm_binned_launches_k1_once_a_bin_on_the_twin_path(monkeypatch):
    """The per-bin dedup goes through the K1 wrapper, one call a
    non-empty bin; on CPU tensors the wrapper runs the twin."""
    ja, jb, widths, _ = BINNED["rmat_s10_huge"]
    ta, tb = port_csr(ja), port_csr(jb)
    plan = TBIN.plan_bins(ta, tb, widths=widths)
    calls = []
    real = TK.sort_dedup_compact_plain

    def spy(tc, tv, ncols):
        calls.append(tuple(tc.shape))
        return real(tc, tv, ncols)

    monkeypatch.setattr(TK, "sort_dedup_compact_plain", spy)
    TBIN.spgemm_binned(ta, tb, plan)
    assert [w for _, w in calls] == [w for _, w in plan.bins]
    assert [r for r, _ in calls] == [r.size for r, _ in plan.bins]


def test_spgemm_binned_rejects_mismatched_shapes():
    ja, jb = MATS["random_rect"]
    ta = port_csr(ja)
    with pytest.raises(ValueError, match="inner dimensions"):
        TBIN.spgemm_binned(ta, ta, TBIN.plan_bins(ta, ta))


def test_bin_tile_dedup_matches_reference():
    """The per-bin dedup (K1's twin here) against the reference's sort +
    scatter-add on the same tile: cols and counts exact, values within
    the comparators."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    r, w, n = 24, 64, 40
    cols = rng.integers(0, n + 1, (r, w)).astype(np.int32)  # n = padding
    vals = np.where(cols < n, rng.standard_normal((r, w)), 0.0).astype(np.float32)
    vals[0, :2], cols[0, :2] = (1.5, -1.5), 3  # a run that sums to exactly 0.0
    jc, jv, jn = JBIN._bin_tile_dedup(jnp.asarray(cols), jnp.asarray(vals), n)
    tc, tv, tn = TBIN._bin_tile_dedup(torch.from_numpy(cols), torch.from_numpy(vals), n)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


# ---- bincheck ------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(MATS))
def test_bincheck_diagnostics_match_reference(name):
    ja, jb = MATS[name]
    ta, tb = port_csr(ja), port_csr(jb)
    for g, w in zip(TB.classify_flops_queues(ta, tb), JB.classify_flops_queues(ja, jb)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        TB.per_bin_b_row_histogram(ta, tb), JB.per_bin_b_row_histogram(ja, jb)
    )
    np.testing.assert_array_equal(TB._queue_id(np.arange(1, 5000)),
                                  JB._queue_id(np.arange(1, 5000)))
    for limit in (1, 2, 4):
        bounds = [0, 1, 2, 3, 8]
        assert TB.filter_rows(limit, ta, tb, bounds) == JB.filter_rows(limit, ja, jb, bounds)


@pytest.mark.parametrize("corrupt", [None, "value", "drop_row"])
def test_results_comparison_matches_reference(corrupt):
    """The whole verdict and every bin's entry, on an exact result and on
    results corrupted in one row's value or with one row emptied."""
    ja, jb = MATS["rmat_s9"]
    jc = j_matmul(ja, jb).make_ordered()
    rp, ci, v = (np.array(x) for x in trimmed(jc))
    if corrupt == "value":
        v[rp[40]] *= 1.5
    elif corrupt == "drop_row":
        v[rp[100] : rp[101]] = 0.0
    jh = JCSR.from_arrays(rp, ci, v, ncols=jc.ncols)
    want = JB.results_comparison(jh, jc, ja, jb)
    got = TB.results_comparison(port_csr(jh), port_csr(jc), port_csr(ja), port_csr(jb))
    assert got == want
    assert got["ok"] == (corrupt is None)
    ids = np.array([40, 100, 7])
    assert TB.is_partial_raw_equal(port_csr(jh), port_csr(jc), ids) == \
        JB.is_partial_raw_equal(jh, jc, ids)


def test_filter_rows_reference_fixture():
    """The fixture of ``tests/test_bincheck.py``: the gutted main of
    mat_dat_analysis.cc:124-140, in both packages."""
    a = JCOO.from_numpy(
        np.array([0, 0, 1, 2, 2, 3, 3], np.int32),
        np.array([1, 4, 2, 0, 5, 1, 3], np.int32),
        np.array([2.0, 6.0, 3.0, 4.0, 7.0, 1.0, 5.0], np.float32),
        nrows=4,
        ncols=6,
    ).to_csr()
    b = JCOO.from_numpy(
        np.array([1, 1, 3, 3, 3, 4, 4, 5, 5], np.int32),
        np.array([2, 4, 1, 3, 4, 2, 4, 0, 2], np.int32),
        np.array([2.0, 4.0, 5.0, 1.0, 3.0, 6.0, 7.0, 8.0, 9.0], np.float32),
        nrows=6,
        ncols=5,
    ).to_csr()
    ta, tb = port_csr(a), port_csr(b)
    assert TB.filter_rows(2, ta, tb, [0, 1, 2, 3]) == [1, 0, 4, 1, 0]
    for limit in (1, 2, 3):
        assert TB.filter_rows(limit, ta, tb, [0, 1, 2, 3]) == \
            JB.filter_rows(limit, a, b, [0, 1, 2, 3])


# ---- the row-partitioned driver ----------------------------------------------------
def test_row_slice_vstack_round_trip():
    rng = np.random.default_rng(5)
    ja = jax_random_csr(rng, 37, 19, 0.3, empty_rows=(11,))
    ta = port_csr(ja)
    cuts = [0, 11, 12, 37]
    parts = [TP.csr_row_slice(ta, r0, r1) for r0, r1 in zip(cuts[:-1], cuts[1:])]
    for (r0, r1), p, jp in zip(zip(cuts[:-1], cuts[1:]), parts,
                               [JP.csr_row_slice(ja, r0, r1) for r0, r1 in
                                zip(cuts[:-1], cuts[1:])]):
        assert p.rows == r1 - r0 and p.capacity == int(p.nnz)
        for x, y in zip(trimmed(p), trimmed(jp)):
            np.testing.assert_array_equal(x, y)
    back = TP.csr_vstack(parts, ta.ncols)
    assert back.device == ta.device
    for x, y in zip(trimmed(back), trimmed(ta)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("parts", [2, 3, 4, 7])
@pytest.mark.parametrize("name", ["rmat_s9", "band_300"])
def test_flops_prefix_partition_matches_reference(name, parts):
    ja, jb = MATS[name]
    got = TP.flops_prefix_partition(port_csr(ja), port_csr(jb), parts)
    assert got == JP.flops_prefix_partition(ja, jb, parts)
    assert got[0] == 0 and got[-1] == ja.rows


@pytest.mark.parametrize("case", ["rmat_s7_parts2", "rect_parts3"])
def test_spgemm_ell_partitioned_matches_reference(case):
    """Each group is its own JAX compile, so the cases are few."""
    if case.startswith("rmat"):
        ja = jb = j_rmat(7, edge_factor=8, seed=5, weights="random")
    else:
        rng = np.random.default_rng(6)
        ja = jax_random_csr(rng, 60, 48, 0.15)
        jb = jax_random_csr(rng, 48, 33, 0.2)
    parts = int(case[-1])
    want = JP.spgemm_ell_partitioned(ja, jb, parts=parts)
    got = TP.spgemm_ell_partitioned(port_csr(ja), port_csr(jb), parts=parts)
    assert got.device.type == "cpu"
    assert_same_csr(want, got)


# ---- TiledCSR.to_host_csr ----------------------------------------------------------
@pytest.mark.parametrize("name", ["random_rect", "band_300"])
def test_to_host_csr_matches_to_csr_and_reference(name):
    ja, jb = MATS[name]
    ta, tb = port_csr(ja), port_csr(jb)
    tiled = TE.spgemm_ell_tiled(ta, tb, t_plan_ell(ta, tb, split_hub=False))
    host = tiled.to_host_csr()
    assert host.device == tiled.flat_col.device
    flat = tiled.to_csr()
    for x, y in zip(trimmed(host), trimmed(flat)):
        np.testing.assert_array_equal(x, y)
    jt = JE.spgemm_ell_tiled(ja, jb, JE.plan_ell(ja, jb, split_hub=False))
    assert_same_csr(jt.to_host_csr(), host)


# ---- the lazy export map -------------------------------------------------------------
def test_ops_exports_resolve_and_cover_the_reference():
    ref = importlib.import_module("sparse_matrix_with_flops_tpu.ops")
    renamed = {"bcsr_spmm_xla": "bcsr_spmm_plain"}
    assert sorted(renamed.get(n, n) for n in ref.__all__) == sorted(TOPS.__all__)
    for name in TOPS.__all__:
        # through the map itself: once its submodule is imported,
        # ``ops.spgemm`` is that module, in both packages (PEP 562 asks
        # __getattr__ only for names the package does not hold)
        assert callable(TOPS.__getattr__(name)), name
    assert TOPS.spgemm_binned is TBIN.spgemm_binned
    with pytest.raises(AttributeError):
        TOPS.no_such_export  # noqa: B018
