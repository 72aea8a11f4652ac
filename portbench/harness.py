"""One run of one cell: load what ``BENCHMARK.json`` names, set up, warm
up, measure for ``--seconds``, check the results against the plain
reference, and build the result line.

Everything that belongs to one configuration, traffic mix or metric is
a file of its own, found by the name in ``BENCHMARK.json``:

* ``configs/<config>.json``: the matrix (generator and sizes);
* ``traffic/<traffic>.json``: the mix's parameters, and in ``job`` the
  driver that runs it (``jobs/<job>.py``);
* ``limits/<workload>.json``: the numbers that decide ``correct``, each
  with its limit;
* ``metrics/<metric>.py``: the reader of one metric, ``read(record)``,
  which returns a number or None when it finds nothing to read; a
  metric named ``<base>.<part>`` without a file of its own is read by
  ``metrics/<base>.py`` (one quantity split by the end-to-end metric it
  moves).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import arith
from .trace import DeviceTrace, Spans, wrap

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules no run may hold once its window has closed (whole
# names: the port's own name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "sparse_matrix_with_flops_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: dict, section: str) -> list[dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(name: str):
    """``metrics/<name>.py``, or else ``metrics/<base>.py`` for a name
    ``<base>.<part>``, loaded by its path (names hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(HERE, "metrics", f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


@dataclasses.dataclass
class Record:
    """What one run measured; the metric readers read it."""

    kind: str = ""  # the device's name
    setup_s: float = 0.0
    window_s: float = 0.0
    items: int = 0  # jobs or calls completed in the window
    failed: int = 0
    times: list = dataclasses.field(default_factory=list)  # each item's seconds
    peak_bytes: int = 0  # device memory at its peak in the window
    work: dict = dataclasses.field(default_factory=dict)  # the job's sizes
    spans: Spans | None = None
    trace: DeviceTrace | None = None
    notes: list = dataclasses.field(default_factory=list)  # lines for standard error


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def load_cell(name: str, bench: dict | None = None, overrides: dict | None = None):
    """(cell, config, traffic, limits) of workload ``name``;
    ``overrides`` ({"config": {...}, "traffic": {...}}) replaces keys, for
    tests at small sizes."""
    bench = benchmark() if bench is None else bench
    cell = workload(bench, name)
    cfg = load_json(HERE, "configs", f"{cell['config']}.json")
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    limits = load_json(HERE, "limits", f"{name}.json")
    ov = overrides or {}
    cfg.update(ov.get("config", {}))
    traffic.update(ov.get("traffic", {}))
    return cell, cfg, traffic, limits


def make_job(cfg: dict, traffic: dict, seed: int, device):
    mod = importlib.import_module(f"portbench.jobs.{traffic['job']}")
    return mod.Job(cfg, traffic, seed, torch.device(device))


def window(job, seconds: float, dev: torch.device, rec: Record, trace_items: int = 0):
    """The measured window, into ``rec``: items in a closed loop, each
    started when the last returned, until ``seconds`` have passed; it
    closes at a synchronize after the last item.  With ``trace_items``
    the profiler covers the window's first that many items, and each item
    is a span of ``rec.spans``."""
    spans = rec.spans
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dt = DeviceTrace(spans) if trace_items else None
    if dt is not None:
        dt.start()
    t_start = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        if spans is not None:
            with spans.span("job"):
                ok = job.run(i)
        else:
            ok = job.run(i)
        b = time.perf_counter()
        rec.times.append(b - a)
        rec.failed += not ok
        i += 1
        if dt is not None and i == trace_items:
            dt.stop(i)
            rec.trace, dt = dt, None
        if b - t_start >= seconds:
            break
    _sync(dev)
    rec.window_s = time.perf_counter() - t_start
    if dt is not None:
        dt.stop(i)
        rec.trace = dt
    rec.items = i
    if dev.type == "cuda":
        rec.peak_bytes = torch.cuda.max_memory_allocated(dev)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number with a limit against it: (all within, {name: {value,
    limit}})."""
    checks, ok = {}, True
    for name, lim in limits.items():
        if name not in numbers:
            raise KeyError(f"the check computed no {name!r}")
        v = numbers[name]
        checks[name] = {"value": v, "limit": lim["limit"]}
        ok &= bool(np.isfinite(v)) and v <= lim["limit"]
    return ok, checks


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: dict | None = None, t0: float | None = None,
             bench: dict | None = None):
    """One run of workload ``name``; returns the result line's object
    (``checks`` last) and the lines for standard error."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = benchmark() if bench is None else bench
    cell, cfg, traffic, limits = load_cell(name, bench, overrides)
    dev = torch.device(device)
    rec = Record(kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    t_in = time.perf_counter()
    job = make_job(cfg, traffic, seed, dev)
    t_job = time.perf_counter()
    job.warm()
    _sync(dev)
    rec.notes.append(f"set-up: {t_in - t0:.3f} s to the harness, {t_job - t_in:.3f} s inputs "
                     f"and plans, {time.perf_counter() - t_job:.3f} s warm-up")
    undo = []
    if trace:
        rec.spans = Spans()
        undo = [wrap(rec.spans, target, label, sync)
                for target, label, sync in traffic.get("spans", [])]
    rec.setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    try:
        window(job, seconds, dev, rec, traffic["trace_items"] if trace else 0)
    finally:
        for u in undo:
            u()
    job.release()
    numbers = job.check()
    rec.work.update(job.work)
    ok, checks = judge(numbers, limits)
    correct = ok and job.compared > 0
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell, section):
        value = reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": rec.kind,
        "count": 1,
        "memory_peak_bytes": max(rec.peak_bytes, setup_peak),
    }
    if dev.type == "cuda":
        device_info["power_limit_w"] = power_limit_w()
    out = {"correct": correct, "attempted": rec.items, "failed": rec.failed,
           "metrics": metrics, "device": device_info}
    if rec.trace is not None:
        device_info["busy_s"] = rec.trace.busy_s
        device_info["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.top_ops(),
                            "idle_gaps": rec.trace.idle_by_span()}
    out["checks"] = checks
    ms = sorted(t * 1e3 for t in rec.times)
    rec.notes.append(f"items: {len(ms)} in {rec.window_s:.3f} s; ms min {ms[0]:.3f} median "
                     f"{arith.percentile(ms, 50):.3f} max {ms[-1]:.3f}")
    lines = list(job.notes) + list(rec.notes)
    lines.append(f"compared {job.compared} results; correct {correct}")
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return out, lines
