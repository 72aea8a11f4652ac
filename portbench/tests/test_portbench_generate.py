"""The benchmark's generators against the port's, and the relabelling."""

import numpy as np
import pytest

from portbench.reference import generate


@pytest.mark.parametrize("scale,ef,seed", [(6, 8, 7), (8, 4, 123), (9, 16, 2**31 + 5)])
def test_rmat_equals_the_ports(scale, ef, seed):
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    rp, ci, v = generate.rmat(scale, ef, seed=seed)
    want = rmat_csr(scale, edge_factor=ef, seed=seed, device="cpu").to_numpy()
    np.testing.assert_array_equal(rp, want[0])
    np.testing.assert_array_equal(ci, want[1])
    np.testing.assert_array_equal(v, want[2])


@pytest.mark.parametrize("scale,ef,seed", [(6, 16, 7), (9, 16, 2**31 + 5)])
def test_graph500_is_the_rmat_edges_permuted_and_undirected(scale, ef, seed):
    import scipy.sparse as sp

    rp, ci, v = generate.graph500(scale, ef, seed=seed)
    n = rp.size - 1
    r0, c0, v0 = generate.rmat(scale, ef, seed=seed)
    perm = np.random.default_rng([seed, 500]).permutation(n)
    src = perm[np.repeat(np.arange(n), np.diff(r0))]
    a = sp.coo_matrix((v0.astype(np.float64), (src, perm[c0])), shape=(n, n)).tocsr()
    want = (a + a.T - sp.diags(a.diagonal())).tocsr()
    want.sort_indices()
    np.testing.assert_array_equal(rp, want.indptr)
    np.testing.assert_array_equal(ci, want.indices)
    np.testing.assert_array_equal(v, want.data.astype(np.float32))
    # undirected, each edge counted once (a self loop too), all drawn edges kept
    got = sp.csr_matrix((v, ci, rp), shape=(n, n))
    assert (got != got.T).nnz == 0
    assert got.sum() == 2 * v0.sum() - a.diagonal().sum()
    # vertex i of the drawn graph is vertex perm[i]: the hubs, drawn in
    # the low labels, are spread over the rows
    b = sp.coo_matrix((v0, (np.repeat(np.arange(n), np.diff(r0)), c0)), shape=(n, n)).tocsr()
    und = (b + b.T - sp.diags(b.diagonal())).tocsr()
    np.testing.assert_array_equal(np.diff(rp)[perm], np.diff(und.indptr))


def test_matrix_builds_graph500_from_a_config():
    cfg = {"generator": "graph500", "scale": 6, "edgefactor": 16, "a": 0.57, "b": 0.19,
           "c": 0.19, "seed": 4}
    for got, want in zip(generate.matrix(cfg), generate.graph500(6, 16, seed=4)):
        np.testing.assert_array_equal(got, want)
    got = generate.matrix(cfg, seed=5)[1]
    assert got.shape != generate.graph500(6, 16, seed=4)[1].shape or \
        not np.array_equal(got, generate.graph500(6, 16, seed=4)[1])


@pytest.mark.parametrize("n,bw,seed", [(50, 3, 0), (300, 32, 9)])
def test_band_equals_the_ports(n, bw, seed):
    from sparse_matrix_with_flops_tpu_torch.utils.generate import banded_csr

    rp, ci, v = generate.band(n, bw, seed)
    want = banded_csr(n, bandwidth=bw, seed=seed, device="cpu").to_numpy()
    np.testing.assert_array_equal(rp, want[0])
    np.testing.assert_array_equal(ci, want[1])
    np.testing.assert_array_equal(v, want[2])


def test_matrix_reads_the_configs():
    rp, ci, _ = generate.matrix({"generator": "band", "rows": 10, "bandwidth": 2, "seed": 0})
    assert rp[-1] == ci.size == 10 * 5 - 2 * (2 + 1)
    with pytest.raises(ValueError):
        generate.matrix({"generator": "nope", "seed": 0})


def test_relabel_keeps_the_graph():
    from portbench import arith

    rp, ci, _ = generate.rmat(8, 8, seed=3)
    n = rp.size - 1
    perm = np.random.default_rng(1).permutation(n)
    rp2, ci2 = generate.relabel(rp, ci, perm)
    # the same edges under the new names, each row's columns sorted
    src = np.repeat(np.arange(n), np.diff(rp))
    src2 = np.repeat(np.arange(n), np.diff(rp2))
    assert set(zip(perm[src].tolist(), perm[ci].tolist())) == set(zip(src2.tolist(), ci2.tolist()))
    for r in range(n):
        row = ci2[rp2[r]:rp2[r + 1]]
        assert np.all(np.diff(row) > 0)
    # so the same work: degrees and Σ rowFlops of A·A
    np.testing.assert_array_equal(np.sort(np.diff(rp)), np.sort(np.diff(rp2)))
    assert arith.row_flops_total(rp, ci) == arith.row_flops_total(rp2, ci2)
