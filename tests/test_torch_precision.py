"""ROADMAP C7: the port pins true f32 at each matmul-class call
(``config.true_f32``) and leaves the caller's precision switches as
they were, through either of torch's two APIs (the legacy
``allow_tf32`` / ``set_float32_matmul_precision`` and, on torch >= 2.9,
``fp32_precision``).  A caller who turned TF32 on still gets true-f32
products from the port, and finds TF32 on again afterwards."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu_torch.config import _f32_switches, true_f32
from sparse_matrix_with_flops_tpu_torch.formats import BCSR, MCSR, DenseMatrix
from sparse_matrix_with_flops_tpu_torch.models import rmcl_ell
from sparse_matrix_with_flops_tpu_torch.ops import ell_esc
from sparse_matrix_with_flops_tpu_torch.ops.dispatch import route, spgemm_auto
from sparse_matrix_with_flops_tpu_torch.ops.spmm import bcsr_spmm_plain
from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh, sharded_rmcl_ell
from sparse_matrix_with_flops_tpu_torch.parallel import ring_kernels as RK
from sparse_matrix_with_flops_tpu_torch.utils import generate as tgen

from test_torch_rmcl_ell import _graph
from torch_port_util import port_csr

HAS_NEW_API = hasattr(torch.backends.cuda.matmul, "fp32_precision")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _turn_tf32_on(api: str) -> None:
    """What a caller does to get TF32 matmuls, through one API."""
    if api == "legacy":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    else:
        torch.backends.cuda.matmul.fp32_precision = "tf32"
        torch.backends.cudnn.fp32_precision = "tf32"


@pytest.fixture(params=["legacy", "fp32_precision"])
def tf32_caller(request):
    """TF32 on, as a caller set it; the switches of before the test
    come back after it (``true_f32`` saves them on entry)."""
    if request.param == "fp32_precision" and not HAS_NEW_API:
        pytest.skip("this torch has no fp32_precision API")
    with true_f32():
        _turn_tf32_on(request.param)
        yield _f32_switches()


@pytest.fixture
def matmul_spy(monkeypatch):
    """Record each ``torch.matmul`` / ``torch.bmm`` / ``torch.mv`` /
    ``Tensor.__matmul__`` call, asserting at the call that TF32 is off
    and the f32 matmul precision is "highest"."""
    calls = []

    def wrap(name, real):
        def spy(*args, **kw):
            assert not torch.backends.cuda.matmul.allow_tf32, name
            assert not torch.backends.cudnn.allow_tf32, name
            assert torch.get_float32_matmul_precision() == "highest", name
            calls.append(name)
            return real(*args, **kw)
        return spy

    for name in ("matmul", "bmm", "mv"):
        monkeypatch.setattr(torch, name, wrap(name, getattr(torch, name)))
    monkeypatch.setattr(torch.Tensor, "__matmul__", wrap("@", torch.Tensor.__matmul__))
    return calls


def _rmat10():
    return tgen.rmat_csr(10, edge_factor=8, seed=7, weights="random", device="cpu")


def _band():
    return tgen.banded_csr(300, bandwidth=16, seed=2, device="cpu")


def _spgemm(t):
    got = spgemm_auto(t, t).to_dense().numpy().astype(np.float64)
    d = t.to_dense().numpy().astype(np.float64)  # the reference in numpy, past the spy
    bound = 1e-7 + 1e-5 * (np.abs(d) @ np.abs(d))
    assert (np.abs(got - d @ d) <= bound).all()


def _dense_and_mcsr():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((24, 20)).astype(np.float32)
    y = rng.standard_normal((20, 12)).astype(np.float32)
    csr = tgen.banded_csr(24, bandwidth=3, seed=1, device="cpu")
    DenseMatrix(torch.from_numpy(x)).matmul(DenseMatrix(torch.from_numpy(y)))
    m = MCSR.from_csr(csr, 8, 8)
    m.spmm(torch.from_numpy(rng.standard_normal((24, 5)).astype(np.float32)))
    m.spmv(torch.from_numpy(rng.standard_normal(24).astype(np.float32)))


def _bcsr():
    a = BCSR.from_csr(_band(), 8, 32)
    bcsr_spmm_plain(a, torch.ones((300, 7)))


def _rmcl():
    rmcl_ell(port_csr(_graph("hub")), max_iters=2, S=32, max_tile=256)


def _sharded():
    t = port_csr(_graph("hub"))
    for ex in ("ring", "all_gather", "pallas_ring", "fused_ring"):
        sharded_rmcl_ell(t, make_mesh(2, "cpu"), max_iters=1, S=32, max_tile=256, exchange=ex)
    RK.ring_matmul(torch.ones(2, 3, 8), torch.ones(2, 4, 5))


CALLERS = {
    "spgemm_auto ell (hub products)": (_rmat10, "ell"),
    "spgemm_auto block (pair bmm)": (_band, "block"),
}


@pytest.mark.parametrize("case", list(CALLERS))
def test_spgemm_auto_runs_true_f32_under_a_tf32_caller(tf32_caller, matmul_spy, case,
                                                       monkeypatch):
    make, kind = CALLERS[case]
    if kind == "ell":  # the hub's matmul route: a sparse group takes K10, no matmul
        monkeypatch.setattr(ell_esc, "HUB_SPARSE_BELOW", 0.0)
    t = make()
    assert route(t, t)[0] == kind
    _spgemm(t)
    assert matmul_spy, "the route ran no matmul-class call"
    assert _f32_switches() == tf32_caller


@pytest.mark.parametrize("fn", [_dense_and_mcsr, _bcsr, _rmcl, _sharded],
                         ids=["dense+mcsr", "bcsr_spmm_plain", "rmcl_ell", "sharded+ring"])
def test_products_run_true_f32_under_a_tf32_caller(tf32_caller, matmul_spy, fn):
    fn()
    assert matmul_spy, "no matmul-class call ran"
    assert _f32_switches() == tf32_caller


@pytest.mark.parametrize("api", ["legacy", "fp32_precision"])
def test_true_f32_restores_the_switches_after_an_exception(api):
    if api == "fp32_precision" and not HAS_NEW_API:
        pytest.skip("this torch has no fp32_precision API")
    with true_f32():
        _turn_tf32_on(api)
        before = _f32_switches()
        with pytest.raises(ZeroDivisionError):
            with true_f32():
                assert not torch.backends.cuda.matmul.allow_tf32
                assert torch.get_float32_matmul_precision() == "highest"
                1 / 0
        assert _f32_switches() == before


@pytest.mark.parametrize("api", ["legacy", "fp32_precision"])
def test_importing_the_port_leaves_the_switches_alone(api):
    """A fresh interpreter: TF32 on through one API, then the whole
    port imported; every switch reads as before the import."""
    if api == "fp32_precision" and not HAS_NEW_API:
        pytest.skip("this torch has no fp32_precision API")
    snapshot = (
        "def snapshot():\n"
        "    out = {}\n"
        "    for k, f in (('allow', lambda: torch.backends.cuda.matmul.allow_tf32),\n"
        "                 ('cudnn', lambda: torch.backends.cudnn.allow_tf32),\n"
        "                 ('prec', torch.get_float32_matmul_precision),\n"
        "                 ('new', lambda: torch.backends.cuda.matmul.fp32_precision),\n"
        "                 ('new_cudnn', lambda: torch.backends.cudnn.fp32_precision)):\n"
        "        try:\n"
        "            out[k] = f()\n"
        "        except (AttributeError, RuntimeError):\n"
        "            pass\n"
        "    return out\n"
    )
    code = (
        "import json, sys, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        + snapshot
        + ("torch.backends.cuda.matmul.allow_tf32 = True\n"
           "torch.backends.cudnn.allow_tf32 = True\n"
           if api == "legacy" else
           "torch.backends.cuda.matmul.fp32_precision = 'tf32'\n")
        + "before = snapshot()\n"
        "import sparse_matrix_with_flops_tpu_torch\n"
        "import sparse_matrix_with_flops_tpu_torch.models\n"
        "import sparse_matrix_with_flops_tpu_torch.parallel\n"
        "import sparse_matrix_with_flops_tpu_torch.ops.dispatch\n"
        "import sparse_matrix_with_flops_tpu_torch.ops.spmm\n"
        "print(json.dumps([before, snapshot()]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300, cwd=ROOT)
    before, after = json.loads(out.stdout.strip().splitlines()[-1])
    assert before and before == after
