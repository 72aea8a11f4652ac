"""The port's distributed SpGEMM (all-gathered, ring and 2-D) and mesh
helpers, with the shards stacked on the CPU, vs the JAX package's on the
8-device virtual CPU mesh: the same numpy inputs, the structure held
exactly, the values within ABS_TOL / REL_TOL (both sum in f32, the
reference with a scatter-add, the port in a fixed order)."""

import jax
import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.ops.spgemm import spgemm_upper_bounds
from sparse_matrix_with_flops_tpu.parallel import make_mesh as j_make_mesh
from sparse_matrix_with_flops_tpu.parallel import sharded as JSH
from sparse_matrix_with_flops_tpu.parallel import spgemm as JS
from sparse_matrix_with_flops_tpu.parallel import spgemm2d as J2
from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh, replicated, row_sharding
from sparse_matrix_with_flops_tpu_torch.parallel import mesh as TM
from sparse_matrix_with_flops_tpu_torch.parallel import sharded as TSH
from sparse_matrix_with_flops_tpu_torch.parallel import spgemm as TS
from sparse_matrix_with_flops_tpu_torch.parallel import spgemm2d as T2

from torch_port_util import assert_close_values, assert_same_csr, jax_random_csr, port_csr


def _pair(seed, ra, ca, cb, da=0.15, db=0.2):
    """(A, B) as JAX-package CSRs of standard-normal values."""
    rng = np.random.default_rng(seed)
    return jax_random_csr(rng, ra, ca, da), jax_random_csr(rng, ca, cb, db)


def _same_stack(js, ts):
    """Two ShardedCSRs: row_ptr and col_ind (padding included) exactly,
    values within the comparators."""
    np.testing.assert_array_equal(ts.row_ptr.numpy(), np.asarray(js.row_ptr))
    np.testing.assert_array_equal(ts.col_ind.numpy(), np.asarray(js.col_ind))
    assert_close_values(ts.values.numpy().ravel(), np.asarray(js.values).ravel())
    assert (ts.ncols, ts.global_rows) == (js.ncols, js.global_rows)


def _same_info(ji, ti):
    for k in ("flops", "nnz"):
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)


# ---- all-gathered and ring SpGEMM ---------------------------------------------------
@pytest.mark.parametrize("nd,shape", [(2, (48, 48, 40)), (8, (48, 48, 40)), (8, (43, 43, 37))],
                         ids=["d2", "d8", "d8-uneven"])
def test_sharded_spgemm_matches_reference(nd, shape):
    ja, jb = _pair(nd, *shape)
    flops, _ = spgemm_upper_bounds(ja, jb)
    per = max(flops, 16)
    jc, ji = JS.sharded_spgemm(j_make_mesh(nd), JSH.shard_csr(ja, nd), JSH.shard_csr(jb, nd),
                               per, per)
    ta, tb = port_csr(ja), port_csr(jb)
    tc, ti = TS.sharded_spgemm(make_mesh(nd, "cpu"), TSH.shard_csr(ta, nd),
                               TSH.shard_csr(tb, nd), per, per)
    _same_stack(jc, tc)
    _same_info(ji, ti)
    assert int(ti["flops"].sum()) == flops
    assert_same_csr(JSH.unshard_csr(jc), TSH.unshard_csr(tc))
    # a second call gives the same bits
    tc2, _ = TS.sharded_spgemm(make_mesh(nd, "cpu"), TSH.shard_csr(ta, nd),
                               TSH.shard_csr(tb, nd), per, per)
    assert torch.equal(tc2.values, tc.values) and torch.equal(tc2.col_ind, tc.col_ind)


@pytest.mark.parametrize("nd", [2, 4, 8])
def test_plan_spgemm_ring_matches_reference(nd):
    ja, jb = _pair(10 + nd, 44, 52, 36)
    jplan, jents = JS.plan_spgemm_ring(JSH.shard_csr(ja, nd), JSH.shard_csr(jb, nd))
    tplan, tents = TS.plan_spgemm_ring(TSH.shard_csr(port_csr(ja), nd),
                                       TSH.shard_csr(port_csr(jb), nd))
    assert tplan.step_widths == jplan.step_widths
    assert tplan.step_prod_caps == jplan.step_prod_caps
    assert len(tents) == len(jents) == nd
    for j, t in zip(jents, tents):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("nd", [2, 4])
def test_sharded_spgemm_ring_matches_reference(nd):
    ja, jb = _pair(20 + nd, 44, 52, 36)
    flops, _ = spgemm_upper_bounds(ja, jb)
    per = max(flops, 16)
    jc, ji = JS.sharded_spgemm_ring(j_make_mesh(nd), JSH.shard_csr(ja, nd),
                                    JSH.shard_csr(jb, nd), per, per)
    sa, sb = TSH.shard_csr(port_csr(ja), nd), TSH.shard_csr(port_csr(jb), nd)
    mesh = make_mesh(nd, "cpu")
    tc, ti = TS.sharded_spgemm_ring(mesh, sa, sb, per, per)
    _same_stack(jc, tc)
    _same_info(ji, ti)
    assert int(ti["flops"].sum()) == flops
    # with the plan passed in, and against the all-gathered exchange
    plan, ents = TS.plan_spgemm_ring(sa, sb)
    tc2, _ = TS.sharded_spgemm_ring(mesh, sa, sb, out_cap=per, plan=plan, step_ents=ents)
    assert torch.equal(tc2.values, tc.values) and torch.equal(tc2.row_ptr, tc.row_ptr)
    tg, _ = TS.sharded_spgemm(mesh, sa, sb, per, per)
    assert_same_csr(TSH.unshard_csr(tg), TSH.unshard_csr(tc))


def test_sharded_spgemm_refuses_another_shard_count():
    ja, jb = _pair(3, 16, 16, 16)
    sa, sb = TSH.shard_csr(port_csr(ja), 2), TSH.shard_csr(port_csr(jb), 2)
    with pytest.raises(ValueError, match="shards on a mesh"):
        TS.sharded_spgemm(make_mesh(4, "cpu"), sa, sb, 64, 64)


# ---- 2-D SpGEMM --------------------------------------------------------------------
@pytest.mark.parametrize("nx,ny", [(2, 4), (4, 2)])
def test_shard_csr_2d_matches_reference(nx, ny):
    _, jb = _pair(30 + nx, 48, 48, 40)
    want = J2.shard_csr_2d(jb, nx, ny)
    got = T2.shard_csr_2d(port_csr(jb), nx, ny)
    for w, g in zip(want[:3], got[:3]):
        w = np.asarray(w)
        assert g.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32}[w.dtype]
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[3:] == want[3:]


@pytest.mark.parametrize("nx,ny", [(2, 4), (4, 2)])
def test_sharded_spgemm_2d_matches_reference(nx, ny):
    ja, jb = _pair(40 + nx, 48, 48, 40)
    flops, _ = spgemm_upper_bounds(ja, jb)
    per = max(flops, 16)
    b_rp, b_ci, b_v, stripe, b_rows = J2.shard_csr_2d(jb, nx, ny)
    want = J2.sharded_spgemm_2d(jax.make_mesh((nx, ny), ("x", "y")), JSH.shard_csr(ja, nx),
                                b_rp, b_ci, b_v, stripe, b_rows, per, per)
    mesh = make_mesh((nx, ny), "cpu")
    tb = T2.shard_csr_2d(port_csr(jb), nx, ny)
    got = T2.sharded_spgemm_2d(mesh, TSH.shard_csr(port_csr(ja), nx), *tb, per, per)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert_close_values(got[2].numpy().ravel(), np.asarray(want[2]).ravel())
    jfull = J2.unshard_2d(*want, stripe, ja.rows, jb.ncols)
    tfull = T2.unshard_2d(*got, stripe, ja.rows, jb.ncols)
    assert_same_csr(jfull._drop_explicit_zeros(), tfull._drop_explicit_zeros())


# ---- the mesh helpers -----------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 3)])
def test_make_mesh_2d(shape):
    m = make_mesh(shape, "cpu")
    jm = jax.make_mesh(shape, ("x", "y"))
    assert m.num_shards == jm.devices.size == shape[0] * shape[1]
    assert m.shape == shape and m.axis_names == tuple(jm.axis_names)
    assert (m.axis_size("x"), m.axis_size("y")) == shape
    assert make_mesh(5, "cpu").shape == (5,) and make_mesh(5, "cpu").axis_size("x") == 5
    with pytest.raises(ValueError):
        make_mesh((2, 0), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(shape)


def test_row_sharding_and_replicated_place_operands():
    mesh = make_mesh(4, "cpu")
    s = TSH.shard_csr(port_csr(_pair(5, 16, 16, 16)[0]), 4)
    placed = row_sharding(mesh).put(s)
    assert isinstance(placed, TSH.ShardedCSR) and placed.global_rows == s.global_rows
    assert torch.equal(placed.values, s.values) and placed.values.device == mesh.device
    assert row_sharding(mesh).axis == "x" and replicated(mesh).axis is None
    rep = replicated(mesh).put(torch.arange(3))
    assert rep.device == mesh.device
    with pytest.raises(ValueError, match="leading axis"):
        row_sharding(mesh).put(torch.zeros(3, 2))


_MARKERS = ("MASTER_ADDR", "WORLD_SIZE", "SLURM_NTASKS", "SLURM_JOB_ID")


@pytest.mark.parametrize("env,launch", [
    ({}, False),
    ({"MASTER_ADDR": "localhost", "WORLD_SIZE": "1"}, False),
    ({"MASTER_ADDR": "localhost", "WORLD_SIZE": "2"}, True),
    ({"WORLD_SIZE": "2"}, False),
    ({"SLURM_NTASKS": "4"}, False),
    ({"SLURM_NTASKS": "4", "SLURM_JOB_ID": "17"}, True),
], ids=["none", "world-1", "torchrun", "no-address", "slurm-no-job", "slurm"])
def test_init_distributed(monkeypatch, env, launch):
    """Without the markers of a multi-process launch init_distributed
    calls nothing; with them, or with keyword arguments, it calls
    torch.distributed.init_process_group (monkeypatched, as the
    reference's test patches jax.distributed.initialize)."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: calls.append(k))
    for var in _MARKERS:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    TM.init_distributed()
    assert calls == ([{}] if launch else [])
    TM.init_distributed(backend="gloo", init_method="tcp://localhost:1234", world_size=1,
                        rank=0)
    assert calls[-1] == {"backend": "gloo", "init_method": "tcp://localhost:1234",
                         "world_size": 1, "rank": 0}
