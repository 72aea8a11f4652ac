"""Graph ingestion and the ``nrmcl`` command line on the CPU: the port's
readers, ``load_coo``, native loader and OpenMP baseline, and its CLI,
each held against the JAX package on the in-repo fixtures; the port's
own copies of the C sources against the reference's; and the rule that
the port imports neither JAX nor the JAX package."""

import ast
import glob
import os
import re

import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.cli import nrmcl as JN
from sparse_matrix_with_flops_tpu.io import load_coo as j_load_coo
from sparse_matrix_with_flops_tpu.io import matrix_market as JMM
from sparse_matrix_with_flops_tpu.io import native as JNAT
from sparse_matrix_with_flops_tpu.io import snap as JS
from sparse_matrix_with_flops_tpu_torch.cli import nrmcl as TN
from sparse_matrix_with_flops_tpu_torch.io import load_coo as t_load_coo
from sparse_matrix_with_flops_tpu_torch.io import matrix_market as TMM
from sparse_matrix_with_flops_tpu_torch.io import native as TNAT
from sparse_matrix_with_flops_tpu_torch.io import snap as TS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "sparse_matrix_with_flops_tpu_torch")
FIXTURES = sorted(glob.glob(os.path.join(ROOT, "tests", "tdatas", "*")))
MTX = [f for f in FIXTURES if f.endswith(".mtx")]


def _same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_every_fixture_is_covered():
    assert [os.path.basename(f) for f in FIXTURES] == [
        "sym.mtx", "t2.snap", "tdata.snap", "test.mtx"]


@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_read_snap_matches_reference(path, trans):
    _same_arrays(TS.read_snap(path, is_trans=trans), JS.read_snap(path, is_trans=trans))


@pytest.mark.parametrize("expand", [True, False])
@pytest.mark.parametrize("path", MTX, ids=os.path.basename)
def test_read_matrix_market_matches_reference(path, expand):
    _same_arrays(TMM.read_matrix_market(path, expand), JMM.read_matrix_market(path, expand))


def test_read_snap_falls_back_to_the_line_parser(tmp_path):
    """Mixed token counts take the per-line parser in both packages."""
    p = tmp_path / "mixed.snap"
    p.write_text("# mixed\n4 3\n0 1\n1 2 0.5\n3 0\n")
    _same_arrays(TS.read_snap(str(p)), JS.read_snap(str(p)))
    empty = tmp_path / "empty.snap"
    empty.write_text("# only comments\n")
    _same_arrays(TS.read_snap(str(empty)), JS.read_snap(str(empty)))


def test_write_matrix_market_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    r, c = rng.integers(0, 7, 12), rng.integers(0, 5, 12)
    v = rng.standard_normal(12).astype(np.float32)
    TMM.write_matrix_market(str(tmp_path / "t.mtx"), r, c, v, 7, 5)
    JMM.write_matrix_market(str(tmp_path / "j.mtx"), r, c, v, 7, 5)
    assert (tmp_path / "t.mtx").read_text() == (tmp_path / "j.mtx").read_text()
    back = TMM.read_matrix_market(str(tmp_path / "t.mtx"))
    np.testing.assert_array_equal(back[0], r)
    np.testing.assert_array_equal(back[2], v)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_load_coo_matches_reference(path, trans, native):
    j = j_load_coo(path, is_trans=trans, extra_capacity=3, use_native=native)
    t = t_load_coo(path, is_trans=trans, extra_capacity=3, use_native=native, device="cpu")
    assert t.device == torch.device("cpu")
    assert (t.nrows, t.ncols, t.capacity) == (j.nrows, j.ncols, j.capacity)
    assert int(t.nnz) == int(j.nnz)
    for k in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)))


def test_load_coo_exits_on_a_missing_file(tmp_path):
    with pytest.raises(SystemExit, match="cannot open input file"):
        t_load_coo(str(tmp_path / "none.snap"), device="cpu")


def test_load_coo_and_the_cli_need_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tdata = os.path.join(ROOT, "tests", "tdatas", "tdata.snap")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_load_coo(tdata)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TN.main(["-i", tdata, "-m", "2"])


# ---- native loader and baseline ---------------------------------------------
@pytest.mark.parametrize("name", ["loader.cc", "spgemm_baseline.cc"])
def test_native_sources_equal_the_references(name):
    """Byte for byte, but that the port's copy cites the upstream C++
    sources by their path in the upstream tree (``nlibs/...``), where
    the reference's comment gives an absolute path."""
    with open(os.path.join(PORT, "native", "src", name), "rb") as f:
        port = f.read()
    with open(os.path.join(ROOT, "sparse_matrix_with_flops_tpu", "native", "src", name), "rb") as f:
        ref = f.read()
    assert port == re.sub(rb"(?<=[ (])/\S+/(?=nlibs/)", b"", ref)


@pytest.fixture(scope="module")
def loader():
    lib = TNAT.get_lib()
    if lib is None or JNAT.get_lib() is None:
        pytest.skip("no C++ toolchain: the native loaders cannot be built")
    return lib


def test_native_builds_only_under_build(loader):
    assert os.path.dirname(loader._name) == os.path.join(ROOT, "build", "torch_native")
    assert TNAT.get_lib() is loader  # built and loaded once a process
    assert not glob.glob(os.path.join(PORT, "**", "*.so"), recursive=True)
    assert not glob.glob(os.path.join(PORT, "**", "*.tmp"), recursive=True)


@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_native_loader_matches_reference(loader, path, trans):
    got = TNAT.read_graph_native(path, trans)
    _same_arrays(got, JNAT.read_graph_native(path, trans))
    # and the numpy reader, up to the order of the entries
    r, c, v, nr, nc = TS.read_snap(path, is_trans=trans)
    assert (got[3], got[4]) == (nr, nc)
    k1, k2 = np.lexsort((got[1], got[0])), np.lexsort((c, r))
    np.testing.assert_array_equal(got[0][k1], r[k2])
    np.testing.assert_array_equal(got[1][k1], c[k2])
    np.testing.assert_allclose(got[2][k1], v[k2])


def test_native_coo_to_csr_matches_reference(loader):
    rng = np.random.default_rng(1)
    r = rng.integers(0, 9, 40).astype(np.int32)
    c = rng.integers(0, 9, 40).astype(np.int32)
    v = rng.standard_normal(40).astype(np.float32)
    _same_arrays(TNAT.coo_to_csr_native(r, c, v, 9), JNAT.coo_to_csr_native(r, c, v, 9))


def test_native_read_of_a_missing_file_is_none(loader, tmp_path):
    assert TNAT.read_graph_native(str(tmp_path / "none.snap")) is None


def test_spgemm_mt_baseline_matches_scipy():
    import scipy.sparse as sp

    rng = np.random.default_rng(3)
    m = sp.random(512, 512, density=0.02, format="csr", random_state=rng, dtype=np.float32)
    res = TNAT.spgemm_mt_baseline(m.indptr, m.indices, m.data, 512, iters=2)
    if res is None:
        pytest.skip("no C++ toolchain with OpenMP")
    ms, nnzc = res
    assert nnzc == (m @ m).nnz and ms >= 0.0
    assert os.path.dirname(TNAT.get_baseline_lib()._name) == TNAT.BUILD_DIR


# ---- the command line ------------------------------------------------------------
def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.splitlines()
    return rc, [x for x in out if x in ("Same", "Diffs")], out


@pytest.mark.parametrize("route", [[], ["-r", "STATIC"], ["-r", "omp"], ["-r", "NOPE"]],
                         ids=["default", "static", "omp", "unknown"])
def test_nrmcl_matches_the_reference_cli(route, capsys):
    tdata = os.path.join(ROOT, "tests", "tdatas", "tdata.snap")
    argv = ["-i", tdata, "-m", "5", *route]
    jrc, jverdict, jout = _run(JN.main, argv, capsys)
    trc, tverdict, tout = _run(TN.main, argv + ["--device", "cpu"], capsys)
    assert (trc, tverdict) == (jrc, jverdict)
    assert trc == (2 if route[-1:] == ["NOPE"] else 0)
    final = [x for x in jout if x.startswith("final")]
    assert [x for x in tout if x.startswith("final")] == final
    assert "device = cpu" in tout


def test_nrmcl_stats_match_the_reference(tmp_path, monkeypatch, capsys):
    tdata = os.path.join(ROOT, "tests", "tdatas", "tdata.snap")
    argv = ["-i", tdata, "-m", "3", "--stats"]
    for sub, main, extra in (("j", JN.main, []), ("t", TN.main, ["--device", "cpu"])):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        assert main(argv + extra) == 0
    capsys.readouterr()
    j = (tmp_path / "j" / "percent.stats").read_text().splitlines()
    t = (tmp_path / "t" / "percent.stats").read_text().splitlines()
    assert len(t) == len(j) == 3
    for a, b in zip(t, j):
        ta, tb = a.split(), b.split()
        assert ta[:6] == tb[:6]  # iter, nnz, flops
        assert abs(float(ta[7]) - float(tb[7])) <= 1e-5


# ---- the port stands alone -------------------------------------------------------------
def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True))
    + [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "ring_probe.py")],
    ids=lambda p: os.path.relpath(p, ROOT),
)
def test_the_port_imports_no_jax(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "sparse_matrix_with_flops_tpu")]
    assert not bad, bad
