"""The result line's schema, the run's refusals, and the check that no
run holds JAX or the JAX package (whole top-level names)."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
SMALL = {"graph500-s16.spgemm-warm": {"config": {"scale": 8}},
         "band-62451.spgemm-warm": {"config": {"rows": 1000}},
         "graph500-s13.rmcl-general": {"config": {"scale": 8},
                                       "traffic": {"pool": 2, "sample_from": 3, "sample": 2}}}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_result_line_of_a_cpu_run(cell):
    out, lines = harness.run_cell(cell, 2**31 + 11, 0.3, False, "cpu", overrides=SMALL[cell])
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    w = harness.workload(harness.benchmark(), cell)
    want = {m["name"] for m in harness.cell_metrics(harness.benchmark(), w, "end_to_end")}
    assert set(out["metrics"]) == want - {"peak_gib"}  # no card allocator on the CPU
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    limits = harness.load_cell(cell)[3]
    assert list(out["checks"]) == list(limits)
    for name, c in out["checks"].items():
        assert c == {"value": c["value"], "limit": limits[name]["limit"]}
    # the numbers compared are the last lines of standard error, in order
    tail = lines[-len(limits):]
    assert [ln.split()[1] for ln in tail] == list(limits)
    assert all(ln.startswith("check ") and " limit " in ln for ln in tail)
    json.dumps(out)


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "graph500-s16.spgemm-warm", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA card" in res.stderr


def test_a_tree_with_only_the_benchmark_cannot_run(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from portbench import harness\n"
            "harness.run_cell('graph500-s16.spgemm-warm', 1, 0.1, False, 'cpu',"
            " overrides={'config': {'scale': 6}})\n")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "sparse_matrix_with_flops_tpu_torch" in res.stderr


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("sparse_matrix_with_flops_tpu_torch", "sparse_matrix_with_flops_tpu_torch.ops",
                 "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "sparse_matrix_with_flops_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.banned_modules() == ["jax", "sparse_matrix_with_flops_tpu"]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(ROOT, "portbench", "**", "*.py"), recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in harness.BANNED, (path, n)


def test_a_cpu_run_holds_no_jax_module():
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from portbench import harness\n"
            "harness.run_cell('graph500-s13.rmcl-general', 3, 0.1, False, 'cpu', overrides="
            "{'config': {'scale': 7}, 'traffic': {'pool': 1, 'sample_from': 2, 'sample': 1}})\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code, ROOT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    mods = set(eval(res.stdout.strip().splitlines()[-1]))
    assert "sparse_matrix_with_flops_tpu_torch" in mods
    assert not mods & set(harness.BANNED)
