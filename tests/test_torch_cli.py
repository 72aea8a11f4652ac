"""The command-line programs ``perf``, ``analysis``, ``mat_dat_analysis``
and ``corpus`` on the CPU (``--device cpu``), held against the JAX
package's programs on the in-repo fixtures and on small synthetic
matrices: the same lines where the output holds no time, the same
non-timing keys of the corpus records."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from sparse_matrix_with_flops_tpu.cli import analysis as JA
from sparse_matrix_with_flops_tpu.cli import corpus as JC
from sparse_matrix_with_flops_tpu.cli import mat_dat_analysis as JM
from sparse_matrix_with_flops_tpu_torch.cli import analysis as TA
from sparse_matrix_with_flops_tpu_torch.cli import corpus as TC
from sparse_matrix_with_flops_tpu_torch.cli import mat_dat_analysis as TM
from sparse_matrix_with_flops_tpu_torch.cli import perf as TPF
from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(ROOT, "tests", "tdatas", "*")))
TDATA = os.path.join(ROOT, "tests", "tdatas", "tdata.snap")
CPU = ["--device", "cpu"]


def _lines(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize(
    "path", [f for f in FIXTURES if f.endswith(("tdata.snap", "test.mtx"))],
    ids=os.path.basename,
)
def test_analysis_prints_the_reference_lines(path, capsys):
    argv = ["-i", path, "--bins"]
    jrc, jout = _lines(JA.main, argv, capsys)
    trc, tout = _lines(TA.main, argv + CPU, capsys)
    assert trc == jrc == 0
    assert tout == jout
    assert tout[0].startswith("N= ") and any(x.startswith("Binwise") for x in tout)


@pytest.mark.parametrize("limit", [1, 2])
@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_mat_dat_analysis_prints_the_reference_lines(path, limit, capsys):
    argv = ["-i", path, "--limit", str(limit)]
    jrc, jout = _lines(JM.main, argv, capsys)
    trc, tout = _lines(TM.main, argv + CPU, capsys)
    assert trc == jrc == 0
    assert tout == jout and len(tout) == 2


@pytest.mark.parametrize(
    "kernel", ["esc", "binned", "ell", "ell-tiled", "ell-partitioned", "rmcl", "rmcl-static"]
)
def test_perf_runs_every_kernel(kernel, capsys):
    rc, out = _lines(TPF.main, ["-i", TDATA, "--kernel", kernel, "--iters", "2", "-m", "2",
                                "--parts", "2"] + CPU, capsys)
    assert rc == 0
    if kernel.startswith("rmcl"):
        assert out[-1].startswith(f"{kernel}: 2 iters") and "final nnz" in out[-1]
    else:
        assert out[-1].startswith(f"{kernel} spgemm: ") and "GFLOPS = " in out[-1]


def test_perf_writes_a_profile_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SMF_PROFILE_DIR", str(tmp_path / "prof"))
    rc, out = _lines(TPF.main, ["-i", TDATA, "--kernel", "binned", "--iters", "2"] + CPU, capsys)
    assert rc == 0 and out[-2] == f"profile trace written to {tmp_path / 'prof'}"
    with open(tmp_path / "prof" / "perf_binned.json") as f:
        assert json.load(f)["traceEvents"]


def test_the_programs_need_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((TPF.main, ["-i", TDATA]), (TA.main, ["-i", TDATA]),
                       (TM.main, ["-i", TDATA]), (TC.main, ["--synthetic", "--scales", "4"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


# ---- corpus --------------------------------------------------------------------------
KEYS = ("matrix", "kernel", "rows", "annz", "oflops", "routed",
        "nnzc", "nnzc_scipy", "nnzc_structural", "nnzc_ok")


def _records(main, argv, capsys):
    rc = main(argv)
    assert rc == 0
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


@pytest.mark.parametrize("kernel", ["binned", "auto"])
def test_corpus_records_match_the_reference(kernel, capsys):
    argv = ["--synthetic", "--scales", "8", "--kernel", kernel, "--check"]
    want = _records(JC.main, argv, capsys)
    got = _records(TC.main, argv + CPU, capsys)
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert {k: g.get(k) for k in KEYS} == {k: w.get(k) for k in KEYS}
        assert g["nnzc_ok"] and g["platform"] == g["device"] == "cpu"
        assert g["timing"] == "host-median" and g["ms"] > 0


def test_corpus_other_engines_and_the_partitioned_driver(tmp_path, capsys):
    out = tmp_path / "rec.jsonl"
    recs = []
    for extra in (["--kernel", "esc"], ["--kernel", "ell-tiled"], ["--kernel", "block"],
                  ["--parts", "2"]):
        recs += _records(TC.main, ["--synthetic", "--scales", "7", "--check", "--out", str(out)]
                         + extra + CPU, capsys)
    assert [r["kernel"] for r in recs] == ["esc", "ell-tiled", "block", "ell"]
    assert all(r["nnzc_ok"] for r in recs)
    assert len({r["nnzc"] for r in recs}) == 1
    assert recs[-1]["parts"] == 2 and len(recs[-1]["group_ms"]) == 2
    assert recs[-1]["timing"] == "host-median-sum-of-groups"
    with open(out) as f:
        assert [json.loads(x) for x in f] == recs


def test_corpus_reads_a_directory(tmp_path, capsys):
    for f in FIXTURES:
        os.symlink(f, tmp_path / os.path.basename(f))
    recs = _records(TC.main, ["--dir", str(tmp_path), "--kernel", "binned", "--check"] + CPU,
                    capsys)
    assert [r["matrix"] for r in recs] == [os.path.basename(f) for f in FIXTURES
                                          if f.endswith((".mtx", ".snap"))]
    assert all(r["nnzc_ok"] for r in recs)


def test_duel_takes_the_reference_decisions_on_the_cpu(capsys):
    """On the CPU the ELL tile limit is the reference's 6 GB, so the duel
    skips what the JAX duel skips: each engine's fill and footprint
    estimates equal the reference's, and the duel runs the engines they
    allow."""
    from sparse_matrix_with_flops_tpu.ops.dispatch import route as j_route
    from sparse_matrix_with_flops_tpu.utils.generate import banded_csr as j_banded
    from sparse_matrix_with_flops_tpu.utils.generate import rmat_csr as j_rmat
    from sparse_matrix_with_flops_tpu_torch.ops.dispatch import route as t_route

    from torch_port_util import port_csr

    assert TC._ell_tile_limit_gb(torch.device("cpu")) == TC.ELL_TILE_GB_CPU == 6.0
    for ja in (j_rmat(7, edge_factor=8, seed=7), j_banded(8192, bandwidth=32),
               j_banded(62451, bandwidth=32)):
        ta = port_csr(ja)
        assert t_route(ta, ta) == j_route(ja, ja)
        assert TC._ell_tile_gb(ta) == JC._ell_tile_gb(ja)
    (rec,) = _records(TC.main, ["--synthetic", "--scales", "7", "--duel", "--check"] + CPU,
                      capsys)
    fill = rec["routed"]["fill"]
    assert sorted(rec["duel_ms"]) == (["block", "ell"] if fill >= 0.02 else ["ell"])
    assert rec["nnzc_ok"] and "duel_errors" not in rec
    assert rec["auto_loss"] == round(rec["ms"] / min(rec["duel_ms"].values()) - 1.0, 4)


def test_duel_with_both_engines_skipped_returns_a_record(monkeypatch, capsys):
    """C4: the reference's run_duel raises StopIteration when neither
    engine ran; the port returns a record with the reasons, no ms and no
    auto_loss, and --mt then records the baseline without ratios."""
    from sparse_matrix_with_flops_tpu_torch.ops import dispatch

    monkeypatch.setattr(dispatch, "route", lambda a, b: ("ell", 0.0))  # block skipped
    monkeypatch.setattr(TC, "_ell_tile_gb", lambda a: 1e9)  # ell skipped
    a = rmat_csr(6, edge_factor=4, seed=1, device="cpu")
    rec = TC.run_duel("rmat_s6", a)
    assert "ms" not in rec and rec["auto_loss"] is None and rec["duel_ms"] == {}
    assert rec["duel_errors"]["ell"].startswith("skipped: ~1000000000.0 GB")
    assert rec["routed"] == {"fill": 0.0, "kernel": "ell"}
    (got,) = _records(TC.main, ["--synthetic", "--scales", "6", "--duel", "--mt"] + CPU, capsys)
    assert "ms" not in got and got["auto_loss"] is None
    assert "vs_baseline_mt" not in got


def test_corpus_mt_baseline_ratios(capsys):
    (rec,) = _records(TC.main, ["--synthetic", "--scales", "7", "--kernel", "binned", "--mt"]
                      + CPU, capsys)
    assert rec["vs_baseline_mt"] == round(rec["mt_baseline_ms"] / rec["ms"], 3)
    assert np.isfinite(rec["vs_baseline_mt_cold"])
