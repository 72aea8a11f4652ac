"""The planted-partition clustering path, the segment helpers, the run
sums' order and the host heap tuning on the CPU, each held against the
JAX package on the same host arrays: ``planted_partition_coo`` and
``cluster_purity`` (``utils/generate.py``), ``equal_partition``,
``prefix_sum_to_counts`` and ``key_value_sort`` (``ops/segments.py``),
R-MCL on a planted graph through the stream and static-ELL paths, the
plain ``run_sums`` against a sequential f32 sum and ``blocked_run_sums``
against a blocked one, and ``prefault`` (``utils/nphost.py``)."""

import importlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.models.clusters import extract_clusters as j_extract
from sparse_matrix_with_flops_tpu.ops import segments as JS
from sparse_matrix_with_flops_tpu.utils import generate as JG
from sparse_matrix_with_flops_tpu_torch.models.clusters import cluster_sizes, extract_clusters
from sparse_matrix_with_flops_tpu_torch.ops import segments as TS
from sparse_matrix_with_flops_tpu_torch.utils import generate as TG
from sparse_matrix_with_flops_tpu_torch.utils import nphost as TH

JR = importlib.import_module("sparse_matrix_with_flops_tpu.models.rmcl")
TR = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl")
TRE = importlib.import_module("sparse_matrix_with_flops_tpu_torch.models.rmcl_ell")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- planted_partition_coo, cluster_purity -------------------------------------------
@pytest.mark.parametrize("args", [(6, 16, 0.5, 0.0005, 2), (8, 12, 0.3, 0.01, 0),
                                  (16, 32, 0.3, 0.002, 11)])
def test_planted_partition_equals_the_reference(args):
    kc, cs, p_in, p_out, seed = args
    jc, jl = JG.planted_partition_coo(kc, cs, p_in=p_in, p_out=p_out, seed=seed)
    tc, tl = TG.planted_partition_coo(kc, cs, p_in=p_in, p_out=p_out, seed=seed, device="cpu")
    assert tc.device.type == "cpu" and (tc.nrows, tc.ncols) == (jc.nrows, jc.ncols)
    assert tc.capacity == jc.row.shape[0] == int(jc.nnz) + kc * cs
    for k in ("row", "col", "val", "nnz"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)))
    assert tl.dtype == np.int64
    np.testing.assert_array_equal(tl, jl)


def test_cluster_purity_equals_the_reference():
    rng = np.random.default_rng(4)
    planted = np.repeat(np.arange(12), 20)
    cases = [planted.copy(), np.zeros(240, np.int64), np.arange(240),
             planted // 3, rng.integers(0, 30, 240)]
    noisy = planted.copy()
    noisy[rng.choice(240, 25, replace=False)] = rng.integers(0, 12, 25)
    cases.append(noisy)
    for found in cases:
        assert TG.cluster_purity(found, planted) == JG.cluster_purity(found, planted)
    assert TG.cluster_purity(planted, planted) == 1.0


# ---- equal_partition, prefix_sum_to_counts, key_value_sort ---------------------------
def test_equal_partition_reference_cases():
    # tests/test_reference_units.py's hand-evaluated case (util.cc:137-149)
    ps = torch.tensor([0, 2, 5, 9, 12], dtype=torch.int32)
    ends = TS.equal_partition(ps, 2)
    assert ends.dtype == torch.int32 and ends.tolist() == [0, 2, 4]
    ends3 = TS.equal_partition(ps, 3)
    assert ends3[0] == 0 and ends3[-1] == 4
    costs = ps[ends3[1:].long()] - ps[ends3[:-1].long()]
    assert int(costs.sum()) == 12


@pytest.mark.parametrize("seed", range(4))
def test_equal_partition_and_counts_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    counts = rng.integers(0, 50, n).astype(np.int32)
    counts[rng.random(n) < 0.3] = 0  # empty ranges
    ps = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    for parts in (1, 2, 3, 7, n, n + 5):
        want = np.asarray(JS.equal_partition(jnp.asarray(ps), parts))
        got = TS.equal_partition(torch.from_numpy(ps), parts)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    got = TS.prefix_sum_to_counts(torch.from_numpy(ps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JS.prefix_sum_to_counts(jnp.asarray(ps))))
    np.testing.assert_array_equal(got.numpy(), counts)


def test_key_value_sort_reference_case():
    # key_value_qsort with greaterThanFunction (test_reference_units.py)
    k = torch.tensor([3, 1, 3, 7, 1], dtype=torch.int32)
    v = torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32)
    ks, vs = TS.key_value_sort(k, v, descending=True)
    assert ks.tolist() == [7, 3, 3, 1, 1] and vs.tolist() == [3, 0, 2, 1, 4]


@pytest.mark.parametrize("descending", [False, True])
def test_key_value_sort_equals_the_reference(descending):
    rng = np.random.default_rng(7 + descending)
    imin = np.iinfo(np.int32).min
    ki = rng.integers(-5, 6, 400).astype(np.int32)
    ki[[3, 50, 51]] = imin  # -imin wraps to imin in both packages
    kf = rng.integers(-3, 4, 400).astype(np.float32)
    kf[rng.random(400) < 0.2] = -0.0  # signed zeros tie with +0.0
    kf[[7, 8]] = [np.inf, -np.inf]
    v = np.arange(400, dtype=np.int32)
    for keys in (ki, kf):
        jk, jv = JS.key_value_sort(jnp.asarray(keys), jnp.asarray(v), descending=descending)
        tk, tv = TS.key_value_sort(torch.from_numpy(keys), torch.from_numpy(v),
                                   descending=descending)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        # bit for bit, signed zeros included
        np.testing.assert_array_equal(tk.numpy().view(np.int32), np.asarray(jk).view(np.int32))


# ---- R-MCL on a planted partition, both paths ----------------------------------------
def test_planted_partition_quality_and_path_agreement():
    """tests/test_rmcl.py's planted case (6 x 16, seed 2) on the port:
    the stream and static-ELL labels are equal, purity >= 0.95, about
    the planted count, and the labels are the JAX package's stream
    loop's."""
    coo, planted = TG.planted_partition_coo(6, 16, p_in=0.5, p_out=0.0005, seed=2,
                                            device="cpu")
    mt0 = TR.rmcl_init(coo)
    res = TR.rmcl(mt0, max_iters=16, mode="loop")
    lab_stream = extract_clusters(res.mt, weight_floor=0.2)
    out_ell, _ = TRE.rmcl_ell(mt0, max_iters=16)
    lab_ell = extract_clusters(out_ell, weight_floor=0.2)
    np.testing.assert_array_equal(lab_stream, lab_ell)
    assert TG.cluster_purity(lab_stream, planted) >= 0.95
    assert 4 <= len(cluster_sizes(lab_stream)) <= 10
    jcoo, _ = JG.planted_partition_coo(6, 16, p_in=0.5, p_out=0.0005, seed=2)
    jres = JR.rmcl(JR.rmcl_init(jcoo), max_iters=16, mode="loop")
    np.testing.assert_array_equal(lab_stream, j_extract(jres.mt, weight_floor=0.2))


# ---- run_sums: the plain version adds each run left to right -------------------------
@pytest.mark.parametrize("shift", range(8))
def test_plain_run_sums_equal_a_sequential_sum_at_every_offset(shift):
    """On the CPU every run sums to a strictly sequential f32 sum (the
    last element of ``np.cumsum``) wherever the stream starts: K9's
    order, which the card check holds bit for bit."""
    rng = np.random.default_rng(20 + shift)
    lens = rng.integers(0, 700, 120)
    lens[:3] = [0, 1, 2]
    vals = rng.standard_normal(int(lens.sum()) + shift + 5).astype(np.float32)
    vals[rng.random(vals.size) < 0.01] = -0.0
    off = np.concatenate([[0], np.cumsum(lens)]) + shift
    want = np.array([np.cumsum(vals[a:b], dtype=np.float32)[-1] if b > a else 0.0
                     for a, b in zip(off[:-1], off[1:])], np.float32) + np.float32(0.0)
    for dtype in (torch.int32, torch.int64):
        got = TS.run_sums(torch.from_numpy(vals), torch.from_numpy(off).to(dtype))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert TS.run_sums.launches == 0  # no kernel on the CPU


@pytest.mark.parametrize("shift", [0, 3])
def test_blocked_run_sums_add_32_value_blocks_then_the_blocks(shift):
    """The prune's row sums: each run in 32-value blocks from its own
    start, each block and then the blocks' sums added in order, so the
    bits follow the run alone wherever it starts."""
    rng = np.random.default_rng(40 + shift)
    lens = rng.integers(0, 300, 90)
    lens[rng.random(90) < 0.3] = 0
    lens[:4] = [0, 31, 32, 33]
    vals = rng.random(int(lens.sum()) + shift + 9).astype(np.float32)
    off = np.concatenate([[0], np.cumsum(lens)]) + shift

    def seq(x):
        return np.cumsum(x, dtype=np.float32)[-1] if x.size else np.float32(0.0)

    want = np.array([seq(np.array([seq(vals[i:min(i + 32, b)]) for i in range(a, b, 32)],
                                  np.float32)) for a, b in zip(off[:-1], off[1:])], np.float32)
    for dtype in (torch.int32, torch.int64):
        got = TS.blocked_run_sums(torch.from_numpy(vals), torch.from_numpy(off).to(dtype))
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    moved = TS.blocked_run_sums(torch.from_numpy(np.concatenate([np.ones(5, np.float32), vals])),
                                torch.from_numpy(off + 5))
    np.testing.assert_array_equal(moved.numpy().view(np.int32), want.view(np.int32))


def test_run_sums_checks_its_inputs():
    with pytest.raises(TypeError):
        TS.run_sums(torch.zeros(4, dtype=torch.float64), torch.tensor([0, 4]))
    with pytest.raises(TypeError):
        TS.run_sums(torch.zeros(4), torch.tensor([0.0, 4.0]))
    with pytest.raises(ValueError):
        TS.run_sums(torch.zeros(4), torch.tensor([0, 2, 4])[::2])


# ---- prefault ------------------------------------------------------------------------
def test_prefault_builds_into_the_build_tree_and_keeps_arrays():
    """In a fresh process (the first call installs the allocator for the
    whole process): importing the port changes nothing; prefault leaves
    numpy arrays as they were, builds the THP allocator into
    build/torch_native/ and is idempotent."""
    code = """
import json, os
import numpy as np
from sparse_matrix_with_flops_tpu_torch.utils import nphost as H
before = H._HEAP
a = np.arange(3 << 18, dtype=np.int64)
H.prefault(1 << 24)
H.prefault(1 << 23)
b = np.arange(3 << 18, dtype=np.int64) * 3
big = np.ones(1 << 21)
ok = bool((a * 3 == b).all() and big.sum() == (1 << 21))
print(json.dumps({"before": before, "heap": H._HEAP, "ok": ok,
                  "built": os.path.exists(H.THP_LIB), "lib": H.THP_LIB,
                  "prefaulted": H._prefaulted}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["before"] is None and rec["ok"]
    assert rec["lib"] == os.path.join(ROOT, "build", "torch_native", "_thpalloc.so")
    kept, thp = rec["heap"]
    assert rec["built"] == thp
    # under the THP allocator prefault touches nothing; else up to its mark
    assert rec["prefaulted"] == (0 if thp or not kept else 1 << 24)
    assert TH.THP_SOURCE.startswith(os.path.join(ROOT, "sparse_matrix_with_flops_tpu_torch"))
