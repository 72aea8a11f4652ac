"""ELL-ESC: the port's planner and pipeline vs the JAX package's, on the
same host arrays (the reference runs on the CPU as is)."""

import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.ops import ell_esc as J
from sparse_matrix_with_flops_tpu.utils import generate as jgen
from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR as TCSR
from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as T
from sparse_matrix_with_flops_tpu_torch.ops import ell_plan as TP
from sparse_matrix_with_flops_tpu_torch.utils import generate as tgen

from conftest import random_csr_np
from torch_port_util import assert_same_csr, both_csr, trimmed


def _random_pair(rng, rows, cols, density):
    return both_csr(*random_csr_np(rng, rows, cols, density), ncols=cols)


def _assert_same_value(x, y, what):
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=what)
    elif isinstance(x, tuple):
        assert isinstance(y, tuple) and len(x) == len(y), what
        for i, (a, b) in enumerate(zip(x, y)):
            _assert_same_value(a, b, f"{what}[{i}]")
    else:
        assert x == y, what


def _assert_same_plan(jp, tp):
    for f in ("b_classes", "class_chunk_base", "total_chunks", "bins",
              "huge_rows", "huge_flops", "rows", "ncols", "out_cap",
              "row_bin", "row_slot", "chunk", "v_rows", "vstart"):
        x, y = getattr(jp, f), getattr(tp, f)
        if x is None or y is None:
            assert x is None and y is None, f
        else:
            _assert_same_value(x, y, f)
    assert len(jp.hub_groups) == len(tp.hub_groups)
    for gj, gt in zip(jp.hub_groups, tp.hub_groups):
        for f in ("rows", "src", "srp", "kmap", "khp", "slab", "n_slabs",
                  "eorder", "lin", "sptr", "caps_rs"):
            _assert_same_value(getattr(gj, f), getattr(gt, f), f"hub.{f}")
    lj, lt = J._flat_layout(jp), TP._flat_layout(tp)
    for k in lj:
        _assert_same_value(lj[k], lt[k], f"layout.{k}")


def _plan_cases():
    """(name, jax pair, port pair, plan kwargs)."""
    rng = np.random.default_rng(5)
    cases = []
    ja, ta = _random_pair(rng, 40, 48, 0.2)
    jb, tb = _random_pair(rng, 48, 40, 0.2)
    cases.append(("random", (ja, jb), (ta, tb), dict(chunk=8, max_w=64)))
    cases.append(("random-quantize", (ja, jb), (ta, tb),
                  dict(chunk=8, max_w=64, quantize=True)))
    j = jgen.rmat_csr(9, edge_factor=8, seed=7, weights="random")
    t = tgen.rmat_csr(9, edge_factor=8, seed=7, weights="random", device="cpu")
    cases.append(("rmat-auto", (j, j), (t, t), dict()))
    cases.append(("rmat-hub", (j, j), (t, t), dict(max_w=256)))
    cases.append(("rmat-hub-unsplit", (j, j), (t, t),
                  dict(max_w=256, split_hub=False)))
    j = jgen.banded_csr(600, bandwidth=16, seed=2)
    t = tgen.banded_csr(600, bandwidth=16, seed=2, device="cpu")
    cases.append(("band-split", (j, j), (t, t), dict(chunk=16, max_w=128)))
    cases.append(("band-auto", (j, j), (t, t), dict()))
    return cases


@pytest.mark.parametrize("case", range(7))
def test_plan_ell_equals_reference(case):
    name, (ja, jb), (ta, tb), kw = _plan_cases()[case]
    jp = J.plan_ell(ja, jb, **kw)
    tp = TP.plan_ell(ta, tb, **kw)
    if name.startswith("rmat-hub"):
        assert tp.hub_groups
    if name == "band-split":
        assert tp.vstart is not None
    _assert_same_plan(jp, tp)


@pytest.mark.parametrize("chunk,max_w", [(4, 32), (8, 64)])
@pytest.mark.parametrize("density", [0.05, 0.25])
def test_spgemm_ell_matches_reference(rng, chunk, max_w, density):
    ja, ta = _random_pair(rng, 40, 48, density)
    jb, tb = _random_pair(rng, 48, 40, density)
    want = J.spgemm_ell(ja, jb, J.plan_ell(ja, jb, chunk=chunk, max_w=max_w))
    got = T.spgemm_ell(ta, tb, TP.plan_ell(ta, tb, chunk=chunk, max_w=max_w))
    assert_same_csr(want, got)


def test_spgemm_ell_rmat_hub_matches_reference():
    j = jgen.rmat_csr(9, edge_factor=8, seed=7, weights="random")
    t = tgen.rmat_csr(9, edge_factor=8, seed=7, weights="random", device="cpu")
    jp, tp = J.plan_ell(j, j, max_w=256), TP.plan_ell(t, t, max_w=256)
    assert tp.hub_groups and tp.vstart is not None
    want = J.spgemm_ell(j, j, jp)
    got = T.spgemm_ell(t, t, tp)
    assert_same_csr(want, got)
    # second call: the fused path with the cached nnz(C) bucket
    assert tp._nnzc_cache >= int(got.nnz)
    assert_same_csr(want, T.spgemm_ell(t, t, tp))


def test_spgemm_ell_band_split_matches_reference():
    j = jgen.banded_csr(300, bandwidth=8, seed=2)
    t = tgen.banded_csr(300, bandwidth=8, seed=2, device="cpu")
    jp = J.plan_ell(j, j, chunk=16, max_w=64)
    tp = TP.plan_ell(t, t, chunk=16, max_w=64)
    assert tp.vstart is not None
    assert_same_csr(J.spgemm_ell(j, j, jp), T.spgemm_ell(t, t, tp))


def test_spgemm_ell_overflowed_bucket_falls_back(rng):
    ja, ta = _random_pair(rng, 24, 24, 0.2)
    tp = TP.plan_ell(ta, ta, chunk=8, max_w=64)
    object.__setattr__(tp, "_nnzc_cache", 1)  # far too small
    with pytest.warns(RuntimeWarning, match="overflowed"):
        got = T.spgemm_ell(ta, ta, tp)
    assert_same_csr(J.spgemm_ell(ja, ja, J.plan_ell(ja, ja, chunk=8, max_w=64)), got)
    assert tp._nnzc_cache >= int(got.nnz)


def test_spgemm_ell_static_capacity_matches_reference(rng):
    ja, ta = _random_pair(rng, 30, 30, 0.15)
    want = J.spgemm_ell(ja, ja, J.plan_ell(ja, ja, chunk=8, max_w=64), exact=False)
    got = T.spgemm_ell(ta, ta, TP.plan_ell(ta, ta, chunk=8, max_w=64), exact=False)
    assert got.capacity == want.capacity
    assert_same_csr(want, got)


def test_empty_rows_and_single_entry():
    dense = np.zeros((16, 16), np.float32)
    dense[3, 5] = 2.0
    dense[5, 7] = 3.0
    dense[7, 1] = -1.5
    from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
    from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR as TCSR

    j, t = JCSR.from_dense(dense), TCSR.from_dense(dense, device="cpu")
    want = J.spgemm_ell(j, j, J.plan_ell(j, j, chunk=4, max_w=32))
    assert_same_csr(want, T.spgemm_ell(t, t, TP.plan_ell(t, t, chunk=4, max_w=32)))
    one = np.zeros((8, 8), np.float32)
    one[2, 2] = 3.0
    j, t = JCSR.from_dense(one), TCSR.from_dense(one, device="cpu")
    got = T.spgemm_ell(t, t, TP.plan_ell(t, t, chunk=4, max_w=16))
    assert_same_csr(J.spgemm_ell(j, j, J.plan_ell(j, j, chunk=4, max_w=16)), got)
    assert trimmed(got)[2].tolist() == [9.0]


def test_empty_matrix():
    ja, ta = both_csr(np.zeros(9, np.int32), [], [], ncols=8)
    got = T.spgemm_ell(ta, ta)
    assert int(got.nnz) == 0 and got.shape == (8, 8)
    assert_same_csr(J.spgemm_ell(ja, ja), got)


def test_rectangular_chain(rng):
    ja, ta = _random_pair(rng, 24, 40, 0.2)
    jb, tb = _random_pair(rng, 40, 16, 0.25)
    want = J.spgemm_ell(ja, jb, J.plan_ell(ja, jb, chunk=8, max_w=64))
    got = T.spgemm_ell(ta, tb, TP.plan_ell(ta, tb, chunk=8, max_w=64))
    assert got.shape == (24, 16)
    assert_same_csr(want, got)


def test_symbolic_and_tiled_match_reference(rng):
    ja, ta = _random_pair(rng, 32, 32, 0.2)
    jp = J.plan_ell(ja, ja, chunk=8, max_w=512, split_hub=False)
    tp = TP.plan_ell(ta, ta, chunk=8, max_w=512, split_hub=False)
    assert tp.vstart is None
    jrp, jn = J.spgemm_ell_symbolic(ja, ja, jp)
    trp, tn = T.spgemm_ell_symbolic(ta, ta, tp)
    np.testing.assert_array_equal(trp.numpy(), np.asarray(jrp))
    assert int(tn) == int(jn)
    jt, tt = J.spgemm_ell_tiled(ja, ja, jp), T.spgemm_ell_tiled(ta, ta, tp)
    np.testing.assert_array_equal(tt.counts.numpy(), np.asarray(jt.counts))
    np.testing.assert_array_equal(tt.flat_base.numpy(), np.asarray(jt.flat_base))
    assert_same_csr(jt.to_csr(), tt.to_csr())


def test_c1_unreferenced_longest_b_row():
    # A never references B's longest row (row 3); the reference's
    # default planner raises IndexError here (its table lookup is not
    # clipped), so the port is held against a dense numpy product
    ad = np.array([[1.0, 2.0, 0.0, 0.0], [0.0, 0.0, 3.0, 0.0]], np.float32)
    bd = np.array(
        [
            [1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 2.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 3.0, 0.0, 0.0, 0.0],
            [1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
        ],
        np.float32,
    )
    from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR as TCSR

    a, b = TCSR.from_dense(ad, device="cpu"), TCSR.from_dense(bd, device="cpu")
    got = T.spgemm_ell(a, b, TP.plan_ell(a, b))
    np.testing.assert_array_equal(got.to_dense().numpy(), ad @ bd)
    assert int(got.nnz) == int(np.count_nonzero(ad @ bd))


def test_tile_path_keeps_exact_zero_cancellation():
    # C[0, 0] = 1*1 + 1*(-1) = 0 exactly: the tile path keeps the entry,
    # as the reference does
    ad = np.array([[1.0, 1.0], [0.0, 1.0]], np.float32)
    bd = np.array([[1.0, 2.0], [-1.0, 1.0]], np.float32)
    from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
    from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR as TCSR

    ja, jb = JCSR.from_dense(ad), JCSR.from_dense(bd)
    ta, tb = TCSR.from_dense(ad, device="cpu"), TCSR.from_dense(bd, device="cpu")
    want = J.spgemm_ell(ja, jb, J.plan_ell(ja, jb, chunk=4, max_w=16))
    got = T.spgemm_ell(ta, tb, TP.plan_ell(ta, tb, chunk=4, max_w=16))
    assert_same_csr(want, got)
    assert int(got.nnz) == 4 and 0.0 in trimmed(got)[2].tolist()


def test_plan_tensors_uploaded_once(rng):
    _, ta = _random_pair(rng, 20, 20, 0.2)
    tp = TP.plan_ell(ta, ta, chunk=8, max_w=64)
    first = T._plan_tensors(tp, torch.device("cpu"))
    assert T._plan_tensors(tp, torch.device("cpu")) is first


def test_bins_wider_than_k1_take_the_plain_sort(monkeypatch):
    # R-MAT s11 (edge factor 16) planned with max_w=65536 has bins up to
    # W = 65536: K1's wrapper sorts bins up to MAX_SORT_W = 32768 (the
    # reference's PALLAS_MAX_SORT_W), the wider one takes the plain sort,
    # chosen by width as the reference chooses its XLA branch
    # (ell_esc.py:1217)
    a = tgen.rmat_csr(11, edge_factor=16, seed=7, weights="random", device="cpu")
    plan = TP.plan_ell(a, a, max_w=65536)
    widths = [w for w, _, _, _ in plan.bins]
    assert 32768 in widths and 65536 in widths
    assert T.MAX_SORT_W == J.PALLAS_MAX_SORT_W == 32768
    seen = []
    real = T.sort_dedup_compact

    def spy(tc, tv, ncols, presorted=1):
        seen.append(tc.shape[1])
        return real(tc, tv, ncols, presorted)

    monkeypatch.setattr(T, "sort_dedup_compact", spy)
    c = T.spgemm_ell(a, a, plan)
    assert sorted(seen) == sorted(w for w in widths if w <= 32768)
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_dense_oracle

    # positive weights: no product cancels, so the oracle's structure is C's
    assert_same_csr(spgemm_dense_oracle(a, a), c)


# ---------------------------------------------------------------------------
# the hub's two routes: K10 (its twin here) and the dense matmul
# ---------------------------------------------------------------------------
def _graph500(scale: int, seed: int = 7):
    """Graph500's graph on the CPU: R-MAT edges, labels permuted, each
    edge stored both ways, duplicates merged; uniform (0, 1] values."""
    import scipy.sparse as sps

    rp, ci, _ = tgen.rmat_csr(scale, edge_factor=16, seed=seed, device="cpu").to_numpy()
    n = rp.size - 1
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    src, dst = perm[np.repeat(np.arange(n), np.diff(rp))], perm[ci]
    m = sps.csr_matrix((np.ones(2 * src.size), (np.r_[src, dst], np.r_[dst, src])), (n, n))
    m.sum_duplicates()
    m.sort_indices()
    vals = (1.0 - rng.random(m.nnz)).astype(np.float32)
    return TCSR.from_numpy(m.indptr, m.indices, vals, n, device="cpu")


def _routed(monkeypatch, below):
    """Every hub group on K10 (``below`` inf) or on the matmul (0)."""
    monkeypatch.setattr(T, "HUB_SPARSE_BELOW", below)


def test_k10_twin_matches_the_dense_hub_on_graph500_s12(monkeypatch):
    a = _graph500(12)
    got = {}
    for below in (0.0, float("inf")):
        _routed(monkeypatch, below)
        plan = TP.plan_ell(a, a, max_w=1024)
        assert plan.hub_groups
        dev = T._plan_tensors(plan, torch.device("cpu"))["hub"]
        assert (dev["sparse"] is None) == (below == 0.0)
        got[below] = T.spgemm_ell(a, a, plan)
    # the same pattern; sums in another order (the matmul's, A-entry order)
    assert_same_csr(got[0.0], got[float("inf")])


def test_hub_route_by_density(monkeypatch):
    """A near-dense hub group takes the matmul (K2 compacts it), a sparse
    one K10, by the share of its dense volume that its products fill."""
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_dense_oracle

    calls = []
    for name in ("hub_accumulate", "compact_nonzero_rows"):
        real = getattr(T, name)
        monkeypatch.setattr(T, name, lambda *a, real=real, name=name: (
            calls.append(name), real(*a))[1])
    rng = np.random.default_rng(3)
    near_dense = (rng.random((300, 300)) < 0.9) * rng.random((300, 300))
    for a, route in ((TCSR.from_dense(near_dense.astype(np.float32), device="cpu"),
                      "compact_nonzero_rows"),
                     (_graph500(11), "hub_accumulate")):
        plan = TP.plan_ell(a, a, max_w=1024)
        fill = [g._products / (g.rows.size * g.khp * plan.ncols) for g in plan.hub_groups]
        assert fill and all((f < T.HUB_SPARSE_BELOW) == (route == "hub_accumulate")
                            for f in fill)
        calls.clear()
        c = T.spgemm_ell(a, a, plan)
        assert set(calls) == {route}
        assert_same_csr(spgemm_dense_oracle(a, a), c)  # positive: no sum cancels


@pytest.mark.parametrize("hubs", [1, 4])
def test_k10_twin_sums_in_a_entry_order(monkeypatch, hubs):
    """Every hub (row, slab) of the K10 route, bit for bit, against a
    sequential Gustavson sum in f32: one-tile and two-tile slabs, an empty
    (row, slab), a ragged last slab, a one-entry hub row, and sums that
    cancel to exactly 0.0 (dropped)."""
    import hub_cases as H

    _routed(monkeypatch, float("inf"))
    a_np, b_np, _, ncols = H.slabbed_pair(hubs)
    a, b, plan = H.slabbed_case(hubs, "cpu")
    (g,) = plan.hub_groups
    assert g.caps_rs[:, 1].max() == 0 or g.caps_rs[:, 2].max() == 0  # an empty slab
    assert ncols % g.slab and g.slab > T.HUB_TILE  # a ragged last slab, tiles of K10
    flat_c, flat_v, counts, _ = T._tiles_impl(a, b, plan)
    got = H.hub_regions(plan, flat_c, flat_v, counts)
    assert len(got) == g.rows.size * g.n_slabs
    for (r, s), (gc, gv) in got.items():
        lo, hi = s * g.slab, min((s + 1) * g.slab, ncols)
        wc, wv = H.sequential_row(a_np, b_np, r, lo, hi)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))
        assert not (gc >= H.CANCEL_LO).any()  # summed to exactly 0.0: dropped
    assert any(len(gc) == 0 for gc, _ in got.values())
