"""The readings that a cell's limits (``limits/<cell>.json``) are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 --control-seeds 4 5 6

For each ``--seeds`` seed it sets the cell up as a run does, warms up,
runs the items a run keeps for its check (through the same calls as the
window, untimed) and prints the numbers the check computes: the program's
readings.  For each ``--control-seeds`` seed it puts the control in the
program's place, the reference computed in TF32 (the nearest precision
below the configuration's float32 with TF32 off), and prints its
numbers.  One JSON line a seed; one process, so set-up is paid once a
seed.  Benchmark runs never run this.
"""

import argparse
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference import rmcl as ref_rmcl  # noqa: E402
from portbench.reference.spgemm import spgemm  # noqa: E402


def control_call(job):
    """The reference in TF32 with the program's call signature."""
    if hasattr(job, "pool"):  # a SpGEMM job: A's values are the pool's
        def call(a):
            rp, ci, v = spgemm(job.rp_t, job.ci_t, a.values, job.rp_t, job.ci_t, a.values,
                               job.n, precision="tf32")
            return types.SimpleNamespace(row_ptr=rp, col_ind=ci, values=v)
        return call
    by_id = {id(coo): (rp, ci) for rp, ci, coo in job.graphs}
    S = job.traffic.get("S") if job.entry == "static" else None

    def call(coo):
        rp, ci = by_id[id(coo)]
        out = ref_rmcl.rmcl(rp, ci, job.n, job.traffic["iters"], S, "tf32", job.device)
        return types.SimpleNamespace(row_ptr=out[0], col_ind=out[1], values=out[2]), True
    return call


def readings(name: str, seed: int, control: bool, device: str, overrides=None) -> dict:
    _, cfg, traffic, _ = harness.load_cell(name, overrides=overrides)
    t0 = time.perf_counter()
    job = harness.make_job(cfg, traffic, seed, device)
    if control:
        job.call = control_call(job)
    else:
        job.warm()
    for i in sorted(job.sample):
        job.run(i)
    job.release()
    numbers = job.check()
    return {"workload": name, "seed": seed, "side": "control" if control else "program",
            "compared": job.compared, "seconds": round(time.perf_counter() - t0, 3),
            "numbers": numbers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, False, args.device)), flush=True)
    for seed in args.control_seeds:
        print(json.dumps(readings(args.workload, seed, True, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
