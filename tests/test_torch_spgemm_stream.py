"""PyTorch port vs the JAX package: the stream-ESC SpGEMM (``matmul``,
``spgemm``, ``spgemm_symbolic``) and its expansion and sort streams.
Both sort stably by (row, col), so the streams are equal array for
array; summed values are within the comparators."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.formats.csr import CSR as JCSR
from sparse_matrix_with_flops_tpu.formats.tiled import TiledCSR as JTiled
from sparse_matrix_with_flops_tpu.ops import spgemm as J
from sparse_matrix_with_flops_tpu_torch.formats.tiled import TiledCSR as TTiled
from sparse_matrix_with_flops_tpu_torch.ops import spgemm as T

from conftest import random_csr_np
from torch_port_util import assert_same_csr, jax_random_csr, port_csr


def _rand(rng, rows, cols, density, empty_rows=(), cancel=False):
    a = jax_random_csr(rng, rows, cols, density, empty_rows)
    if not cancel:
        return a
    # A[0] = [1, 1, 0, ...]: against B rows 0 and 1 of opposite signs
    dense = np.asarray(a.to_dense()).copy()
    dense[0, :] = 0.0
    dense[0, :2] = 1.0
    return JCSR.from_dense(dense)


def _pairs(rng):
    """(A, B) pairs: square, a rectangular chain link, empty rows, an
    exact cancellation, spare capacity."""
    a1, b1 = _rand(rng, 20, 20, 0.2, empty_rows=(3,)), _rand(rng, 20, 20, 0.2)
    a2, b2 = _rand(rng, 13, 27, 0.15), _rand(rng, 27, 9, 0.3, empty_rows=(0, 5))
    a3 = _rand(rng, 6, 4, 0.5, cancel=True)
    b3 = np.where(rng.random((4, 5)) < 0.5, 1.0, 0.0).astype(np.float32)
    b3[0, 2], b3[1, 2] = 2.0, -2.0
    return {
        "square": (a1, b1),
        "rect": (a2, b2),
        "cancel": (a3, JCSR.from_dense(b3)),
        "capacity": (a1.with_capacity(int(a1.nnz) + 7), b1.with_capacity(int(b1.nnz) + 3)),
    }


def _port(j):
    return port_csr(j).with_capacity(j.capacity)


@pytest.mark.parametrize("case", ["square", "rect", "cancel", "capacity"])
def test_matmul_and_symbolic_match_reference(rng, case):
    ja, jb = _pairs(rng)[case]
    ta, tb = _port(ja), _port(jb)
    assert_same_csr(J.matmul(ja, jb), T.matmul(ta, tb))
    pcap, ocap = J.spgemm_upper_bounds(ja, jb)
    assert T.spgemm_upper_bounds(ta, tb) == (pcap, ocap)
    jrp, jnnz, jtot = J.spgemm_symbolic(ja, jb, pcap)
    trp, tnnz, ttot = T.spgemm_symbolic(ta, tb, pcap)
    np.testing.assert_array_equal(trp.numpy(), np.asarray(jrp))
    assert int(tnnz) == int(jnnz) and int(ttot) == int(jtot)
    # a tight and an overflowing output capacity
    for cap in (ocap + 5, max(int(jnnz) - 3, 1)):
        jc, tc = J.spgemm(ja, jb, pcap, cap), T.spgemm(ta, tb, pcap, cap)
        np.testing.assert_array_equal(tc.row_ptr.numpy(), np.asarray(jc.row_ptr))
        np.testing.assert_array_equal(tc.col_ind.numpy(), np.asarray(jc.col_ind))
        np.testing.assert_allclose(tc.values.numpy(), np.asarray(jc.values), rtol=1e-3, atol=1e-7)


def test_chain_and_cancellation_kept(rng):
    ja, jb = _pairs(rng)["rect"]
    jc = _rand(rng, 9, 11, 0.4)
    want = J.matmul(J.matmul(ja, jb), jc)
    got = T.matmul(T.matmul(_port(ja), _port(jb)), _port(jc))
    assert_same_csr(want, got)
    a3, b3 = _pairs(rng)["cancel"]
    c3 = T.matmul(_port(a3), _port(b3))
    # A[0] · B[:, 2] = 2 - 2: the stream ESC stores the exact zero
    rp, ci, v = c3.to_numpy()
    row0 = slice(rp[0], rp[1])
    assert 2 in ci[row0] and v[row0][list(ci[row0]).index(2)] == 0.0
    assert_same_csr(J.matmul(a3, b3), c3)


@pytest.mark.parametrize("spare", [0, 11])
def test_esc_expand_and_sort_arrays_equal(rng, spare):
    ja, jb = _pairs(rng)["rect"]
    pcap = J.spgemm_upper_bounds(ja, jb)[0] + spare
    jx = J.esc_expand(ja, jb, pcap)
    tx = T.esc_expand(_port(ja), _port(jb), pcap)
    for g, w in zip(tx, jx):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    js = J.esc_sort(*jx[:3], ja.rows)
    ts = T.esc_sort(*tx[:3], ja.rows)
    for g, w in zip(ts, js):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_bviews_match_reference(rng):
    # two stacked local CSR blocks (the distributed layer's gathered B)
    blocks = [random_csr_np(rng, 4, 6, 0.4) for _ in range(2)]
    lcap = max(int(rp[-1]) for rp, _, _ in blocks) + 2
    rpb = np.stack([rp for rp, _, _ in blocks]).astype(np.int32)
    colb = np.full((2, lcap), 6, np.int32)
    valb = np.zeros((2, lcap), np.float32)
    for d, (rp, c, v) in enumerate(blocks):
        colb[d, : c.size], valb[d, : v.size] = c, v
    jv = J.bview_from_blocks(*(jnp.asarray(x) for x in (rpb, colb, valb)), 6)
    tv = T.bview_from_blocks(*(torch.from_numpy(x) for x in (rpb, colb, valb)), 6)
    for g, w in zip(tv[:4], jv[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ja = _rand(rng, 5, 8, 0.5)
    jx = J.esc_expand_view(ja, jv, 64)
    tx = T.esc_expand_view(_port(ja), tv, 64)
    for g, w in zip(tx, jx):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # a TiledCSR as B, read in place
    counts = np.array([2, 0, 3], np.int32)
    base = np.array([5, 0, 0], np.int32)
    col = np.array([0, 2, 3, 4, 4, 1, 3, 4], np.int32)
    val = rng.standard_normal(8).astype(np.float32)
    jt = JTiled(*(jnp.asarray(x) for x in (col, val, counts, base)), 4)
    tt = TTiled(*(torch.from_numpy(x) for x in (col, val, counts, base)), 4)
    ja = _rand(rng, 4, 3, 0.6)
    jx = J.esc_expand_view(ja, jt.as_bview(), 24)
    tx = T.esc_expand_view(_port(ja), tt.as_bview(), 24)
    for g, w in zip(tx, jx):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
