"""Dense-block engine and dispatch: the port vs the JAX package, on the
same host arrays."""

import numpy as np
import pytest

from sparse_matrix_with_flops_tpu.ops import block_spgemm as JB
from sparse_matrix_with_flops_tpu.ops import dispatch as JD
from sparse_matrix_with_flops_tpu.utils import generate as jgen
from sparse_matrix_with_flops_tpu_torch.ops import block_spgemm as TB
from sparse_matrix_with_flops_tpu_torch.ops import dispatch as TD
from sparse_matrix_with_flops_tpu_torch.ops.spgemm import (
    spgemm_dense_oracle,
    spgemm_upper_bounds,
)
from sparse_matrix_with_flops_tpu_torch.utils import generate as tgen

from torch_port_util import assert_same_csr, trimmed

_PLAN_FIELDS = (
    "bs", "m", "n", "nnz_a", "nnz_b", "a_blk", "a_r", "a_c", "n_ablk",
    "b_blk", "b_r", "b_c", "n_bblk", "pair_a", "pair_b", "pair_c", "n_cblk",
    "bob", "bob_colblk", "kmax", "fill_a", "fill_b",
)


@pytest.mark.parametrize(
    "n,bw,density,bs", [(1000, 8, 1.0, 128), (700, 24, 0.5, 64)]
)
def test_block_spgemm_matches_reference(n, bw, density, bs):
    j = jgen.banded_csr(n, bandwidth=bw, seed=2, density=density)
    t = tgen.banded_csr(n, bandwidth=bw, seed=2, density=density, device="cpu")
    jp, tp = JB.plan_block(j, j, bs=bs), TB.plan_block(t, t, bs=bs)
    for f in _PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), err_msg=f)
    assert TB.block_fill_estimate(t, t, bs) == JB.block_fill_estimate(j, j, bs)
    assert_same_csr(JB.block_spgemm(j, j, jp), TB.block_spgemm(t, t, tp))


def test_block_spgemm_rectangular_matches_reference(rng):
    from torch_port_util import both_csr
    from conftest import random_csr_np

    ja, ta = both_csr(*random_csr_np(rng, 70, 90, 0.3), ncols=90)
    jb, tb = both_csr(*random_csr_np(rng, 90, 50, 0.3), ncols=50)
    want = JB.block_spgemm(ja, jb, bs=32)
    got = TB.block_spgemm(ta, tb, bs=32)
    assert got.shape == (70, 50)
    assert_same_csr(want, got)


def test_block_path_counts_structure():
    # C[0, 0] cancels to exactly 0: the block path keeps it (structure)
    from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR

    ad = np.array([[1.0, 1.0], [0.0, 1.0]], np.float32)
    bd = np.array([[1.0, 2.0], [-1.0, 1.0]], np.float32)
    got = TB.block_spgemm(CSR.from_dense(ad, device="cpu"), CSR.from_dense(bd, device="cpu"), bs=8)
    assert int(got.nnz) == 4
    assert trimmed(got)[2].tolist()[0] == 0.0


def _dispatch_cases():
    # a cant-class band (block fill ~0.17) and a power-law R-MAT
    j = jgen.banded_csr(1000, bandwidth=32, seed=2)
    t = tgen.banded_csr(1000, bandwidth=32, seed=2, device="cpu")
    jr = jgen.rmat_csr(8, edge_factor=8, seed=7, weights="random")
    tr = tgen.rmat_csr(8, edge_factor=8, seed=7, weights="random", device="cpu")
    return [("block", j, t), ("ell", jr, tr)]


@pytest.mark.parametrize("case", [0, 1])
def test_route_and_spgemm_auto_match_reference(case):
    kind, j, t = _dispatch_cases()[case]
    jk, jf = JD.route(j, j)
    tk, tf = TD.route(t, t)
    assert tk == jk == kind
    assert tf == jf
    assert_same_csr(JD.spgemm_auto(j, j), TD.spgemm_auto(t, t))


def test_upper_bounds_and_dense_oracle():
    from sparse_matrix_with_flops_tpu.ops.spgemm import (
        spgemm_dense_oracle as j_oracle,
        spgemm_upper_bounds as j_bounds,
    )

    j = jgen.rmat_csr(7, edge_factor=6, seed=3, weights="random")
    t = tgen.rmat_csr(7, edge_factor=6, seed=3, weights="random", device="cpu")
    assert spgemm_upper_bounds(t, t) == j_bounds(j, j)
    want = j_oracle(j, j)
    got = spgemm_dense_oracle(t, t)
    for x, y in zip(trimmed(got), trimmed(want)):
        np.testing.assert_array_equal(x, y)
    assert_same_csr(want, TD.spgemm_auto(t, t))
