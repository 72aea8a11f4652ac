"""The harness finds every piece by its name, BENCHMARK.json keeps to the
benchmark's contract, and a new configuration, traffic mix and metric
need only new files and new entries."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    w, cfg, traffic, limits = harness.load_cell(cell)
    assert cfg["name"] == w["config"] and cfg["generator"] in ("graph500", "band")
    assert limits and all("limit" in v for v in limits.values())
    job = __import__(f"portbench.jobs.{traffic['job']}", fromlist=["Job"])
    assert hasattr(job, "Job")
    for m in harness.cell_metrics(BENCH, w, "end_to_end") + harness.cell_metrics(
            BENCH, w, "per_layer"):
        assert callable(harness.reader(m["name"]).read)


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_to_the_contract():
    b = BENCH
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"]: c for c in b["configs"]}
    assert len(cells) == len(b["workloads"]) and len(configs) == len(b["configs"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["why"]) and _one_line(c["source"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert not [k for k in c["reduced"] if k.endswith(("_dim", "_rank", "_size"))]
        on_disk = json.load(open(os.path.join(ROOT, c["file"])))
        assert on_disk["reduced"] == c["reduced"] and on_disk["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _one_line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert all(c in cells for c in m.get("workloads", cells))
        assert os.path.exists(harness.reader(m["name"]).__file__)
    for name, w in cells.items():
        reported = {m["name"] for m in harness.cell_metrics(b, w, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.cell_metrics(b, w, "per_layer")
        assert layer
        # a per-layer metric's cells report the end-to-end metric it moves
        assert all(m["moves"] in reported for m in layer)


@pytest.mark.parametrize("name,file", [("idle_pct.band", "idle_pct.py"),
                                       ("idle_pct.cluster", "idle_pct.py"),
                                       ("spgemm_roofline.graph500", "spgemm_roofline.py"),
                                       ("plan_ms.cluster", "plan_ms.cluster.py"),
                                       ("gflops", "gflops.py")])
def test_a_split_metric_without_a_file_of_its_own_takes_its_base_reader(name, file):
    assert os.path.basename(harness.reader(name).__file__) == file
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.gflops")


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_a_new_config_traffic_and_metric_need_only_new_files(tmp_path):
    """A dummy configuration, traffic mix, metric and cell, added as new
    files and new entries to a copy of the benchmark, run on the CPU
    with no file of the copy edited."""
    dst = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digest(dst)
    cfg = json.load(open(dst / "configs" / "graph500-s16.json"))
    cfg.update(name="rmat-s8", scale=8)
    (dst / "configs" / "rmat-s8.json").write_text(json.dumps(cfg))
    traffic = json.load(open(dst / "traffic" / "spgemm-warm.json"))
    traffic.update(value_sets=2, sample=2, sample_from=3)
    (dst / "traffic" / "spgemm-few.json").write_text(json.dumps(traffic))
    (dst / "limits" / "rmat-s8.spgemm-few.json").write_text(
        json.dumps({"pattern_diff": {"limit": 0}, "rel_err": {"limit": 1e-5}}))
    (dst / "metrics" / "calls_per_s.py").write_text(
        "def read(rec):\n    return rec.items / rec.window_s\n")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"].append({"name": "rmat-s8", "source": "https://graph500.org/?page_id=12",
                             "file": "portbench/configs/rmat-s8.json",
                             "reduced": ["scale"], "why": "a dummy"})
    bench["workloads"].append({"name": "rmat-s8.spgemm-few", "config": "rmat-s8",
                               "traffic": "spgemm-few", "chips": 1, "why": "a dummy"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["rmat-s8.spgemm-few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "from portbench import harness\n"
            "assert harness.HERE.startswith(sys.argv[1])\n"
            "out, _ = harness.run_cell('rmat-s8.spgemm-few', 5, 0.3, False, 'cpu')\n"
            "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path), ROOT], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    # gflops lists its cells; peak_gib lists none but reads the card's
    # allocator, so a CPU run leaves it out
    assert set(out["metrics"]) == {"setup_s", "calls_per_s"}
    after = _digest(dst)
    assert all(after[k] == v for k, v in before.items())  # no file of the copy edited
