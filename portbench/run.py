"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for.  Prints one JSON object as the last line of standard output
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics, the device's busy time and a breakdown), and each
number compared against the plain reference, with its limit, as the
last lines of standard error.  Exits with a code other than 0, and
prints no result, without enough CUDA cards or when JAX or the JAX
package was imported.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache of a run inside the checkout, at fixed paths, so that only
# the first run of a checkout builds (the port's kernels build into
# build/torch_kernels/ beside these)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench_cache", sub)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = harness.benchmark()
    chips = harness.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    out, lines = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  "cuda", t0=T0, bench=bench)
    banned = harness.banned_modules()
    if banned:
        print(f"portbench: the run imported {', '.join(banned)}", file=sys.stderr)
        return 3
    sys.stderr.write("".join(f"{ln}\n" for ln in lines))
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
