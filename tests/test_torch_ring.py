"""The ring kernels K6-K8 (``parallel/ring_kernels.py``): their plain
twins, which the wrappers run on CPU tensors, against the reference's
Pallas kernels in interpret mode under ``shard_map`` on the 8-device CPU
mesh (as ``tests/test_pallas_ring.py`` runs them), with the D ranks of
the port stacked on the first axis."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sparse_matrix_with_flops_tpu.parallel import make_mesh as j_make_mesh
from sparse_matrix_with_flops_tpu.parallel import pallas_ring as JRING
from sparse_matrix_with_flops_tpu_torch.parallel import ring_kernels as RK

WRAPPERS = (RK.ring_all_gather, RK.ring_matmul, RK.ring_matmul_tiled)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = [w.launches for w in WRAPPERS]
    yield
    assert [w.launches for w in WRAPPERS] == before == [0, 0, 0]


def _ref_all_gather(x: np.ndarray):
    """The reference's K6 per shard: (rotation order, unrotated), both
    stacked [d, d*lr, ...]."""
    d = x.shape[0]

    def kernel(blk):
        g = JRING.ring_all_gather(blk[0], "x", d, interpret=True)
        return g[None], JRING.unrotate(g, "x", d)[None]

    return [
        np.asarray(y)
        for y in shard_map(
            kernel, mesh=j_make_mesh(d), in_specs=P("x"),
            out_specs=(P("x"), P("x")), check_vma=False,
        )(jnp.asarray(x))
    ]


def _ref_matmul(a: np.ndarray, b: np.ndarray, nt: int = 0) -> np.ndarray:
    """The reference's K7 (``nt == 0``) or K8 per shard, stacked."""
    d = a.shape[0]

    def kernel(a_blk, b_blk):
        if nt:
            out = JRING.ring_matmul_tiled(a_blk[0], b_blk[0], "x", d, nt=nt, interpret=True)
        else:
            out = JRING.ring_matmul(a_blk[0], b_blk[0], "x", d, interpret=True)
        return out[None]

    return np.asarray(
        shard_map(
            kernel, mesh=j_make_mesh(d), in_specs=(P("x"), P("x")),
            out_specs=P("x"), check_vma=False,
        )(jnp.asarray(a), jnp.asarray(b))
    )


def _operands(d, m, lr, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, m, d * lr)).astype(np.float32)
    b = rng.standard_normal((d, lr, n)).astype(np.float32)
    return a, b


# ---- K6 -----------------------------------------------------------------------
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("lr,s", [(8, 128), (5, 3)])
def test_ring_all_gather_matches_pallas(d, lr, s):
    x = np.arange(d * lr * s, dtype=np.float32).reshape(d, lr, s) * 0.5
    rot, owner_major = _ref_all_gather(x)
    got = RK.ring_all_gather(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), rot)
    np.testing.assert_array_equal(RK.unrotate(got).numpy(), owner_major)
    # owner-major is every rank holding the concatenation of the shards
    np.testing.assert_array_equal(owner_major, np.broadcast_to(x.reshape(1, d * lr, s), owner_major.shape))


@pytest.mark.parametrize("d", [1, 3, 8])
def test_ring_all_gather_int32_rotation_order(d):
    lr = 4
    x = torch.arange(d * lr * 2, dtype=torch.int32).reshape(d, lr, 2)
    got = RK.ring_all_gather(x)
    assert got.dtype == torch.int32 and got.shape == (d, d * lr, 2)
    for me in range(d):
        for k in range(d):
            assert torch.equal(got[me, k * lr:(k + 1) * lr], x[(me - k) % d])
    assert torch.equal(RK.unrotate(got), x.reshape(1, d * lr, 2).expand(d, -1, -1))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_ring_all_gather_two_operands_match_single_calls_and_pallas(d):
    # the pallas_ring exchange's call: cols (int32) and vals (f32) at once
    lr, s = 3, 5
    rng = np.random.default_rng(d)
    xc = rng.integers(-(2**20), 2**20, (d, lr, s)).astype(np.int32)
    xv = rng.standard_normal((d, lr, s)).astype(np.float32)
    gc, gv = RK.ring_all_gather(torch.from_numpy(xc), torch.from_numpy(xv))
    assert gc.dtype == torch.int32 and gv.dtype == torch.float32
    assert torch.equal(gc, RK.ring_all_gather(torch.from_numpy(xc)))
    assert torch.equal(gv, RK.ring_all_gather(torch.from_numpy(xv)))
    rot_v, owner_v = _ref_all_gather(xv)
    np.testing.assert_array_equal(gv.numpy(), rot_v)
    np.testing.assert_array_equal(RK.unrotate(gv).numpy(), owner_v)
    # the reference gathers the cols' bits as f32 words: the copy is bitwise
    rot_c, _ = _ref_all_gather(xc.view(np.float32))
    np.testing.assert_array_equal(gc.numpy(), rot_c.view(np.int32))


def test_ring_all_gather_refuses_operands_of_other_shapes():
    with pytest.raises(ValueError):
        RK.ring_all_gather(torch.zeros((2, 4, 3), dtype=torch.int32), torch.zeros((2, 4, 2)))
    with pytest.raises(ValueError):
        RK.ring_all_gather()


def test_ring_all_gather_rejects_bad_input():
    with pytest.raises(TypeError):
        RK.ring_all_gather(torch.zeros((2, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        RK.ring_all_gather(torch.zeros(4))
    with pytest.raises(ValueError):
        RK.ring_all_gather(torch.zeros((2, 4, 6))[:, :, ::2])


# ---- K7 / K8 -----------------------------------------------------------------------
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("m,lr,n", [(16, 8, 128), (5, 3, 7)])
def test_ring_matmul_matches_pallas(d, m, lr, n):
    a, b = _operands(d, m, lr, n, seed=d + m)
    want = _ref_matmul(a, b)
    got = RK.ring_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("m,lr,n", [(16, 8, 512), (3, 5, 256)])
def test_ring_matmul_tiled_matches_pallas(d, m, lr, n):
    a, b = _operands(d, m, lr, n, seed=10 * d + m)
    want = _ref_matmul(a, b, nt=256)
    got = RK.ring_matmul_tiled(torch.from_numpy(a), torch.from_numpy(b), nt=256).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name,direction,nt", [("ring_matmul", RK.LEFT, 0),
                                               ("ring_matmul_tiled", RK.RIGHT, 256)])
def test_swapped_rotation_direction_fails(name, direction, nt):
    """Each kernel's A columns must be rotated in its own direction: K7's
    blocks flow right (block k = owner (me - k) mod d), K8's left (owner
    (me + k) mod d).  The twin with the other kernel's rotation of A
    must disagree with the reference."""
    d, m, lr, n = 4, 8, 8, 256
    a, b = _operands(d, m, lr, n, seed=3)
    want = _ref_matmul(a, b, nt=nt)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    own = -direction  # the kernel's own direction
    right = RK._ring_matmul_twin(RK._rotate_cols(at, lr, own), bt, own).numpy()
    np.testing.assert_allclose(right, want, rtol=2e-5, atol=2e-5)
    swapped = RK._ring_matmul_twin(RK._rotate_cols(at, lr, direction), bt, own).numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(swapped, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_rotation_orders(d):
    right, left = RK._owners(d, RK.RIGHT, "cpu"), RK._owners(d, RK.LEFT, "cpu")
    me, k = np.meshgrid(np.arange(d), np.arange(d), indexing="ij")
    np.testing.assert_array_equal(right.numpy(), (me - k) % d)
    np.testing.assert_array_equal(left.numpy(), (me + k) % d)
    assert (d <= 2) == torch.equal(right, left)


@pytest.mark.parametrize("nt", [0, 128])
def test_ring_matmul_d1_is_a_plain_product(nt):
    a, b = _operands(1, 6, 16, 256, seed=1)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = (RK.ring_matmul_tiled(at, bt, nt=nt) if nt else RK.ring_matmul(at, bt)).numpy()
    np.testing.assert_allclose(got[0], a[0].astype(np.float64) @ b[0], rtol=1e-5, atol=1e-5)


def test_ring_matmul_tiled_rejects_n_not_a_multiple_of_nt():
    a, b = _operands(2, 4, 4, 300, seed=0)
    with pytest.raises(ValueError):
        RK.ring_matmul_tiled(torch.from_numpy(a), torch.from_numpy(b), nt=256)
    with pytest.raises(ValueError):
        RK.ring_matmul_tiled_plain(torch.from_numpy(a), torch.from_numpy(b), nt=0)


@pytest.mark.parametrize("nt", [0, 2])
def test_ring_matmul_on_the_cpu_takes_more_ranks_than_the_card_launch(nt):
    # the card launch's rank limit is no limit of the plain version
    d = RK.MAX_MATMUL_RANKS + 1
    a, b = _operands(d, 2, 1, 4, seed=5)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = (RK.ring_matmul_tiled(at, bt, nt=nt) if nt else RK.ring_matmul(at, bt)).numpy()
    want = a.astype(np.float64) @ b.reshape(d, 4).astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---- the kernels' 3xTF32 arithmetic, emulated -------------------------------------
TERMS = {"lo_hi": (1, 0), "hi_lo": (0, 1), "hi_hi": (0, 0)}  # (a part, b part)
THREE_PASS = ("lo_hi", "hi_lo", "hi_hi")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as ``cvt.rna.tf32.f32``: to nearest, ties away from zero
    (add half a TF32 ulp to the magnitude, clear the 13 low bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _ring_matmul_tf32(a, b, direction, terms=THREE_PASS) -> np.ndarray:
    """K7 / K8 on the tensor cores, emulated: every block product as the
    sum of ``terms`` over the TF32 parts (exact in f64), blocks in the
    ring's order, rounded to f32 at the end."""
    d, m, _ = a.shape
    lr, n = b.shape[1:]
    a_rot = RK._rotate_cols(torch.from_numpy(a), lr, direction)
    own = RK._owners(d, direction, "cpu").tolist()
    out = torch.zeros((d, m, n), dtype=torch.float64)
    for me in range(d):
        for k in range(d):
            pa = _split(a_rot[me, :, k * lr:(k + 1) * lr])
            pb = _split(torch.from_numpy(b[own[me][k]]))
            for t in terms:
                i, j = TERMS[t]
                out[me] += pa[i].double() @ pb[j].double()
    return out.float().numpy()


def _abs_product(a, b) -> np.ndarray:
    """|A||B| of every rank in f64 (owner-major columns of ``a``)."""
    d, lr, n = b.shape
    return np.abs(a).astype(np.float64) @ np.abs(b).reshape(d * lr, n).astype(np.float64)


def _crafted(d: int, lr: int, m: int = 4, n: int = 256):
    """Every entry 1 + 2^-12: its low part lies below TF32's mantissa."""
    x = np.float32(1.0 + 2.0**-12)
    return np.full((d, m, d * lr), x, np.float32), np.full((d, lr, n), x, np.float32)


def test_tf32_rounding_is_to_nearest_ties_away():
    ulp = 2.0**-10  # TF32's at 1
    x = torch.tensor([1.0, 1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4, -(1 + ulp / 2),
                      2.0**-12 + 2.0**-24, 0.0], dtype=torch.float32)
    want = [1.0, 1.0, 1 + ulp, 1 + ulp, -(1 + ulp), 2.0**-12, 0.0]
    assert _tf32(x).tolist() == want
    hi, lo = _split(torch.tensor([1.0 + 2.0**-12]))
    assert (hi.item(), lo.item()) == (1.0, 2.0**-12)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("kind,m,lr,n", [("random", 16, 8, 512), ("random", 3, 5, 256),
                                         ("crafted", 4, 0, 256)])
def test_3xtf32_emulation_matches_pallas(d, kind, m, lr, n):
    """The kernels' arithmetic (three TF32 passes, emulated) against the
    reference's K8 in interpret mode, within the kernels' bound of
    1e-5 of |A||B|."""
    if kind == "crafted":
        a, b = _crafted(d, 32 // d, m, n)  # K = d * lr = 32
    else:
        a, b = _operands(d, m, lr, n, seed=7 * d + m)
    want = _ref_matmul(a, b, nt=256)
    got = _ring_matmul_tf32(a, b, RK.LEFT)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= 1e-5 * _abs_product(a, b)).all(), float(err.max())


@pytest.mark.parametrize("terms,holds", [
    (THREE_PASS, True),
    (("hi_hi",), False),  # one TF32 pass
    (("hi_lo", "hi_hi"), False),  # lo.hi dropped
    (("lo_hi", "hi_hi"), False),  # hi.lo dropped
])
def test_crafted_operands_catch_a_dropped_tf32_term(terms, holds):
    """The card test's operands (every entry 1 + 2^-12, K = 32): three
    passes hold 1e-5 of |A||B| against the exact product, one pass or a
    missing cross term do not."""
    d, lr = 2, 16
    a, b = _crafted(d, lr)
    exact = np.full((d, 4, 256), d * lr * (1.0 + 2.0**-12) ** 2)
    got = _ring_matmul_tf32(a, b, RK.RIGHT, terms).astype(np.float64)
    ok = (np.abs(got - exact) <= 1e-5 * _abs_product(a, b)).all()
    assert ok == holds


def test_ring_matmul_rejects_mismatched_shapes():
    a, b = _operands(2, 4, 4, 8, seed=0)
    with pytest.raises(ValueError):
        RK.ring_matmul(torch.from_numpy(a[:, :, :6].copy()), torch.from_numpy(b))
    with pytest.raises(ValueError):
        RK.ring_matmul(torch.from_numpy(a), torch.from_numpy(b)[:1])
    with pytest.raises((TypeError, ValueError)):
        RK.ring_matmul(torch.from_numpy(a).double(), torch.from_numpy(b))
