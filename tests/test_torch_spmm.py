"""PyTorch port vs the JAX package: blocked SpMM (K5's twin) and the CSR
SpMV / SpMM with a dense operand.

The reference's Pallas kernel runs as ``tests/test_blocked.py`` runs it:
``bcsr_spmm(..., kernel="pallas")`` on the CPU, which is interpret
mode.  Dense results are held within 1e-7 + 1e-5·(|A|·|B|)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
from sparse_matrix_with_flops_tpu.ops import spmm as jspmm
from sparse_matrix_with_flops_tpu.utils import generate as jgen
from sparse_matrix_with_flops_tpu_torch.ops.spmm import (
    bcsr_spmm,
    bcsr_spmm_plain,
    csr_spmm_dense,
    csr_spmv,
)

from torch_port_util import assert_close_dense, both_bcsr, jax_random_csr, port_csr


MATRICES = {
    "band64": lambda rng: jgen.banded_csr(64, bandwidth=5, seed=2),
    "rmat8": lambda rng: jgen.rmat_csr(8, edge_factor=8, seed=3, weights="random"),
    "ragged37x45": lambda rng: jax_random_csr(rng, 37, 45, 0.2),
    "empty_block_rows": lambda rng: jax_random_csr(rng, 40, 50, 0.3, range(8, 24)),
}
CASES = [
    ("band64", 8, 8),
    ("band64", 8, 16),
    ("rmat8", 8, 16),
    ("ragged37x45", 8, 16),
    ("ragged37x45", 3, 5),
    ("empty_block_rows", 8, 16),
]


@pytest.mark.parametrize("n", [1, 100, 128, 300])
@pytest.mark.parametrize("name,br,bc", CASES)
def test_bcsr_spmm_twin_matches_pallas_and_xla(rng, name, br, bc, n):
    ja = MATRICES[name](rng)
    jb, tb = both_bcsr(ja, br, bc)
    x = np.random.default_rng(n).random((ja.ncols, n)).astype(np.float32)
    before = bcsr_spmm.launches
    got = bcsr_spmm(tb, torch.from_numpy(x))  # CPU tensor: the twin
    assert bcsr_spmm.launches == before
    np.testing.assert_array_equal(got.numpy(), bcsr_spmm_plain(tb, torch.from_numpy(x)).numpy())
    a_dense = np.asarray(ja.to_dense())
    pallas = jspmm.bcsr_spmm(jb, jnp.asarray(x), n_tile=128, kernel="pallas")
    xla = jspmm.bcsr_spmm_xla(jb, jnp.asarray(x))
    assert got.shape == (ja.rows, n)
    assert_close_dense(got.numpy(), np.asarray(pallas), a_dense, x)
    assert_close_dense(got.numpy(), np.asarray(xla), a_dense, x)
    if name == "empty_block_rows":
        assert not got[8:24].any()


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_bcsr_spmm_all_empty(kernel):
    ja = JCSR.from_dense(np.zeros((20, 30), np.float32))
    jb, tb = both_bcsr(ja, 8, 16)
    assert tb.block_capacity == 1 and int(tb.nblocks) == 0
    assert not tb.block_row_ptr.any()
    x = np.ones((30, 7), np.float32)
    before = bcsr_spmm.launches
    got = bcsr_spmm(tb, torch.from_numpy(x), kernel=kernel)
    assert bcsr_spmm.launches == before
    want = jspmm.bcsr_spmm(jb, jnp.asarray(x), kernel=kernel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (20, 7) and not got.any()


def test_bcsr_spmm_rejects_bad_inputs(rng):
    _, tb = both_bcsr(jax_random_csr(rng, 16, 16, 0.3), 8, 8)
    with pytest.raises(ValueError):
        bcsr_spmm(tb, torch.zeros((15, 4)))
    with pytest.raises(TypeError):
        bcsr_spmm(tb, torch.zeros((16, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        bcsr_spmm(tb, torch.zeros((16, 4)), kernel="triton")
    bad = dataclasses.replace(tb, blocks=tb.blocks[:, :, :4].contiguous())
    with pytest.raises(ValueError):
        bcsr_spmm(bad, torch.zeros((16, 4)))


@pytest.mark.parametrize("shape,density", [((33, 29), 0.3), ((1, 40), 0.5), ((50, 7), 0.05)])
def test_csr_spmv_matches_reference(rng, shape, density):
    ja = jax_random_csr(rng, *shape, density, empty_rows=(0,))
    x = rng.standard_normal(shape[1]).astype(np.float32)
    got = csr_spmv(port_csr(ja), torch.from_numpy(x))
    want = jspmm.csr_spmv(ja, jnp.asarray(x))
    assert_close_dense(got.numpy(), np.asarray(want), np.asarray(ja.to_dense()), x)


@pytest.mark.parametrize("n", [1, 17, 130])
def test_csr_spmm_dense_matches_reference(rng, n):
    ja = jax_random_csr(rng, 20, 30, 0.25, empty_rows=(3, 4))
    b = rng.standard_normal((30, n)).astype(np.float32)
    # spare capacity: padding slots go to the dump row
    jpad = ja.with_capacity(int(ja.nnz) + 9)
    got = csr_spmm_dense(port_csr(ja).with_capacity(int(ja.nnz) + 9), torch.from_numpy(b))
    want = jspmm.csr_spmm_dense(jpad, jnp.asarray(b))
    assert_close_dense(got.numpy(), np.asarray(want), np.asarray(ja.to_dense()), b)
