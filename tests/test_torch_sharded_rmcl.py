"""Sharded static R-MCL: the port's shard layout, planner and loop, with
the D shards stacked on one device, vs the JAX package's on the 8-device
CPU mesh (D in {1, 2, 4}).

The reference's dedup runs through its Pallas kernel in interpret mode
(``use_pallas_dedup``, ROADMAP C5), so the structure is held exactly and
the values within the comparators."""

import importlib

import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
from sparse_matrix_with_flops_tpu.ops.flops import footprint_row_costs as j_footprint
from sparse_matrix_with_flops_tpu.parallel import make_mesh as j_make_mesh
from sparse_matrix_with_flops_tpu.parallel import sharded as JSH
from sparse_matrix_with_flops_tpu_torch.ops.densify import ell_rows_to_dense, entries_to_dense
from sparse_matrix_with_flops_tpu_torch.ops.flops import footprint_row_costs as t_footprint
from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh
from sparse_matrix_with_flops_tpu_torch.parallel import sharded as TSH
from sparse_matrix_with_flops_tpu_torch.parallel.mesh import ROW_AXIS, ShardMesh

from torch_port_util import (
    assert_close_values,
    assert_same_csr,
    assert_same_plan,
    port_csr,
    trimmed,
    use_pallas_dedup,
)

JP = importlib.import_module("sparse_matrix_with_flops_tpu.parallel.rmcl_ell")
TP = importlib.import_module("sparse_matrix_with_flops_tpu_torch.parallel.rmcl_ell")
TR = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl_ell")
EXCHANGES = ["ring", "all_gather", "pallas_ring", "fused_ring"]


def _graph(kind: str, seed: int = 0) -> JCSR:
    """Row-stochastic R-MCL inits: ``hub`` 32 rows with two hub rows at
    ``max_tile`` 256, S 32; ``plain`` 32 rows, no hub; ``odd`` 30 rows
    (padding rows on the last shard) with one hub row."""
    rng = np.random.default_rng(seed)
    n = 30 if kind == "odd" else 32
    mask = rng.random((n, n)) < (0.25 if kind == "plain" else 0.12)
    np.fill_diagonal(mask, True)
    if kind != "plain":
        mask[5, :] = True
        if kind == "hub":
            mask[20, 4:] = True
    dense = np.where(mask, 1.0, 0.0).astype(np.float32)
    return JCSR.from_dense(dense).aver_and_norm_rows()


def _same_sharded(js, ts):
    for f in ("row_ptr", "col_ind", "values"):
        want = np.asarray(getattr(js, f))
        got = getattr(ts, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (ts.ncols, ts.global_rows) == (js.ncols, js.global_rows)


def _compare(a, b, tol=1e-5) -> bool:
    return a.make_ordered()._drop_explicit_zeros().is_raw_equal(
        b.make_ordered()._drop_explicit_zeros(), tol=tol
    )


# ---- layout and planner -----------------------------------------------------------
def test_make_mesh():
    m = make_mesh(4, "cpu")
    assert isinstance(m, ShardMesh) and m.num_shards == 4
    assert m.device == torch.device("cpu") and ROW_AXIS == "x"
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")
    # the default is the card, with no fallback to the CPU
    if torch.cuda.is_available():
        assert make_mesh(4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(4)


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("kind", ["hub", "odd"])
def test_shard_csr_and_unshard_match_reference(d, kind):
    j = _graph(kind)
    t = port_csr(j)
    js, ts = JSH.shard_csr(j, d), TSH.shard_csr(t, d)
    _same_sharded(js, ts)
    assert ts.padded_rows == d * -(-t.rows // d) and int(ts.nnz) == int(t.nnz)
    assert_same_csr(JSH.unshard_csr(js), TSH.unshard_csr(ts))
    assert_same_csr(j, TSH.unshard_csr(ts))
    blk = ts.local_block(d - 1)
    assert blk.rows == ts.local_rows


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_balanced_permutation_matches_reference(d):
    j = _graph("odd")
    t = port_csr(j)
    for chunk in (8, 32):
        rj = np.asarray(j_footprint(j, j, chunk=chunk))
        rt = t_footprint(t, t, chunk=chunk)
        np.testing.assert_array_equal(rt, rj)
    pj = JSH.flops_balanced_permutation(rj, d)
    pt = TSH.flops_balanced_permutation(rt, d)
    np.testing.assert_array_equal(pt, pj)
    assert sorted(pt.tolist()) == list(range(t.rows))


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("kind,S,max_tile", [("hub", 32, 256), ("plain", 16, 256),
                                             ("odd", 8, 64)])
def test_plan_sharded_rmcl_ell_matches_reference(d, kind, S, max_tile):
    j = _graph(kind)
    jplan, jarr, js = JP.plan_sharded_rmcl_ell(j, d, S=S, max_tile=max_tile)
    tplan, tarr, ts = TP.plan_sharded_rmcl_ell(port_csr(j), d, S=S, max_tile=max_tile)
    assert_same_plan(jplan, jarr, tplan, tarr)
    _same_sharded(js, ts)
    assert (tplan.hmax > 0) == (kind != "plain")


# ---- the loop against the reference -----------------------------------------------
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_sharded_rmcl_ell_matches_reference(monkeypatch, d, exchange):
    use_pallas_dedup(monkeypatch)
    j = _graph("hub")
    want, jh = JP.sharded_rmcl_ell(j, j_make_mesh(d), max_iters=2, S=32, max_tile=256,
                                   exchange=exchange)
    got, th = TP.sharded_rmcl_ell(port_csr(j), make_mesh(d, "cpu"), max_iters=2, S=32,
                                  max_tile=256, exchange=exchange)
    assert_same_csr(want, got)
    np.testing.assert_array_equal(th["nnz"], jh["nnz"])
    np.testing.assert_array_equal(th["truncated_rows"], jh["truncated_rows"])
    assert_close_values(th["differs"], jh["differs"])


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_balanced_matches_reference(monkeypatch, d):
    use_pallas_dedup(monkeypatch)
    j = _graph("odd")
    want, jh = JP.sharded_rmcl_ell(j, j_make_mesh(d), max_iters=2, S=16, max_tile=64,
                                   balance=True)
    got, th = TP.sharded_rmcl_ell(port_csr(j), make_mesh(d, "cpu"), max_iters=2, S=16,
                                  max_tile=64, balance=True)
    assert_same_csr(want, got)
    np.testing.assert_array_equal(th["nnz"], jh["nnz"])
    assert_close_values(th["differs"], jh["differs"])


# ---- the exchanges against each other and against one device ---------------------------
@pytest.mark.parametrize("d", [2, 4])
def test_pallas_ring_equals_all_gather_exactly(d):
    t = port_csr(_graph("hub"))
    mesh = make_mesh(d, "cpu")
    ag, hag = TP.sharded_rmcl_ell(t, mesh, max_iters=3, S=32, max_tile=256,
                                  exchange="all_gather")
    pr, hpr = TP.sharded_rmcl_ell(t, mesh, max_iters=3, S=32, max_tile=256,
                                  exchange="pallas_ring")
    for x, y in zip(trimmed(ag), trimmed(pr)):
        np.testing.assert_array_equal(y, x)
    for k in hag:
        np.testing.assert_array_equal(hpr[k], hag[k])


@pytest.mark.parametrize("d", [2, 4])
def test_fused_ring_matches_ring(d):
    t = port_csr(_graph("hub"))
    mesh = make_mesh(d, "cpu")
    rg, _ = TP.sharded_rmcl_ell(t, mesh, max_iters=3, S=32, max_tile=256, exchange="ring")
    fr, _ = TP.sharded_rmcl_ell(t, mesh, max_iters=3, S=32, max_tile=256,
                                exchange="fused_ring")
    assert _compare(fr, rg, tol=1e-6)


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_sharded_matches_single_device(exchange):
    t = port_csr(_graph("odd"))
    one, h1 = TR.rmcl_ell(t, max_iters=3, S=32, max_tile=256)
    got, hd = TP.sharded_rmcl_ell(t, make_mesh(4, "cpu"), max_iters=3, S=32, max_tile=256,
                                  exchange=exchange)
    assert _compare(got, one)
    np.testing.assert_allclose(hd["differs"], h1["differs"], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("kind,calls", [("plain", 0), ("hub", 2)])
def test_fused_ring_calls_k8_only_with_hub_rows(monkeypatch, kind, calls):
    seen = []
    real = TP.ring_matmul_tiled

    def counted(a, b, nt=2048, mesh=None):
        seen.append((tuple(a.shape), tuple(b.shape), nt))
        return real(a, b, nt=nt, mesh=mesh)

    monkeypatch.setattr(TP, "ring_matmul_tiled", counted)
    t = port_csr(_graph(kind))
    plan = TP.plan_sharded_rmcl_ell(t, 2, S=16, max_tile=256)[0]
    assert (plan.hmax > 0) == bool(calls)
    TP.sharded_rmcl_ell(t, make_mesh(2, "cpu"), max_iters=2, S=16, max_tile=256,
                        exchange="fused_ring")
    assert len(seen) == calls
    for a_shape, b_shape, nt in seen:
        assert a_shape[0] == b_shape[0] == 2 and b_shape[2] % nt == 0


def test_sharded_rejects_unknown_exchange():
    t = port_csr(_graph("plain"))
    with pytest.raises(ValueError):
        TP.sharded_rmcl_ell(t, make_mesh(2, "cpu"), max_iters=1, S=16, exchange="tree")


def _accumulating_densify(lc, lv, n):
    """The ring exchange's densify as it was: one accumulating
    ``index_put_`` a shard into [lr, n + 1], the sentinel column cut."""
    d, lr, _ = lc.shape
    md = torch.zeros((d, lr, n + 1), dtype=lv.dtype)
    rix = torch.arange(lr)[:, None]
    for me in range(d):
        md[me].index_put_((rix, lc[me].long()), lv[me], accumulate=True)
    return md[:, :, :n]


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("source", ["random", "iterate"])
def test_ell_rows_to_dense_equals_the_accumulating_densify(d, source):
    """The plain indexed set of ``ell_rows_to_dense`` (every held shard's
    iterate block as dense rows, the ring exchange's B operand) equals
    the accumulating densify bit for bit: each row's real columns are
    distinct (the ELL invariant) and the sentinel lanes go to the dump.
    On a random ELL iterate with padded lanes, and on the hub graph's
    iterate after one step of the ring exchange."""
    if source == "random":
        rng = np.random.default_rng(d)
        lr, S = 16, 8
        n = d * lr
        lc = np.full((d, lr, S), n, np.int32)
        lv = np.zeros((d, lr, S), np.float32)
        for me in range(d):
            for r in range(lr):
                k = int(rng.integers(0, S + 1))  # 0 to S real lanes, in any order
                lc[me, r, :k] = rng.choice(n, size=k, replace=False)
                lv[me, r, :k] = rng.random(k).astype(np.float32) + 0.01
        lc, lv = torch.from_numpy(lc), torch.from_numpy(lv)
    else:
        t = port_csr(_graph("hub"))
        plan, arrays, smgt = TP.plan_sharded_rmcl_ell(t, d, S=32, max_tile=256)
        cols, vals = TR.mt_to_ell(t, 32)
        n = plan.n
        cols = torch.where(cols >= t.ncols, n, cols).reshape(d, plan.lr, 32)
        lc, lv, _ = TP._sharded_step(plan, smgt, arrays, cols, vals.reshape(d, plan.lr, 32),
                                     "ring")
        assert bool((lc == n).any())  # padded lanes present
    got = ell_rows_to_dense(lc.reshape(-1, lc.shape[2]), lv.reshape(-1, lc.shape[2]), n, 0, n)
    assert got.shape == (d * lc.shape[1], n)
    assert torch.equal(got.view(d, lc.shape[1], n), _accumulating_densify(lc, lv, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slab", [16, 24, 64])
def test_ell_rows_to_dense_cuts_column_slabs(dtype, slab):
    """Column slabs of an ELL block (the single-card hub's operand, 16 and
    24 of 40 columns: the last slab runs past the sentinel) and one slab
    wider than the columns (the fused ring's, padded to the tile width)
    equal the dense block's columns, the columns past n zero."""
    rng = np.random.default_rng(slab)
    r, S, n = 12, 8, 40
    cols = np.full((r, S), n, np.int32)
    vals = np.zeros((r, S), np.float32)
    dense = np.zeros((r, -(-n // slab) * slab), np.float32)
    for i in range(r):
        k = int(rng.integers(0, S + 1))
        cols[i, :k] = rng.choice(n, size=k, replace=False)
        vals[i, :k] = rng.random(k).astype(np.float32) + 0.01
        dense[i, cols[i, :k]] = vals[i, :k]
    want = torch.from_numpy(dense).to(dtype)
    tc, tv = torch.from_numpy(cols), torch.from_numpy(vals)
    for s0 in range(0, n, slab):
        got = ell_rows_to_dense(tc, tv, n, s0, slab, dtype)
        assert got.dtype == dtype and got.shape == (r, slab)
        assert torch.equal(got, want[:, s0:s0 + slab])


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("kind", ["hub", "odd"])
def test_entries_to_dense_equals_the_accumulating_densify(d, kind):
    """The ring exchange's hub operand of every (shard, owner) pair as
    ``entries_to_dense`` builds it equals the accumulating ``index_put_``
    it replaced, bit for bit, -1 pads and all."""
    plan, arrays, _ = TP.plan_sharded_rmcl_ell(port_csr(_graph(kind)), d, S=32, max_tile=256)
    hmax = plan.hmax
    assert hmax > 0
    for me in range(d):
        for owner in range(d):
            slot = arrays["hub_ent_slot"][me][owner].long()
            pos = arrays["hub_ent_pos"][me][owner].long()
            val = arrays["hub_ent_val"][me][owner]
            width = arrays["hub_kidx"][me][owner].shape[0]
            want = torch.zeros((hmax + 1, width))
            want.index_put_((torch.where(slot >= 0, slot, hmax), pos), val, accumulate=True)
            assert torch.equal(entries_to_dense(slot, pos, val, hmax, width), want[:hmax])
