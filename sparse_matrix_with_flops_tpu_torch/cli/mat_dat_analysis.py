"""mat_dat_analysis CLI, tools/mat_dat_analysis.cc parity (the port of
the JAX package's ``cli/mat_dat_analysis.py``; the same lines on the same
file).

The reference prototype (mat_dat_analysis.cc:53-106, main gutted at
:124-162) bins "touches" of B rows — by A rows whose nnz >= --limit —
according to the B row's own size: it shows which B-row sizes dominate
the heavy A rows' gathers.  Loads onto the CUDA card unless ``--device``
names another.

Usage: python -m sparse_matrix_with_flops_tpu_torch.cli.mat_dat_analysis -i graph.snap
"""

from __future__ import annotations

import argparse
import sys

from ..config import resolve_device
from ..io import load_coo
from ..ops.bincheck import filter_rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="B-row-size x A-row-filter binning "
        "(tools/mat_dat_analysis.cc parity)"
    )
    p.add_argument("--input", "-i", required=True)
    p.add_argument(
        "--limit",
        type=int,
        default=2,
        help="only count touches from A rows with nnz >= limit",
    )
    p.add_argument(
        "--bounds",
        type=int,
        nargs="+",
        default=[0, 1, 2, 3],
        help="B-row-size bin upper bounds (reference fixture default)",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device, e.g. cpu or cuda:0 (default: the CUDA card)",
    )
    args = p.parse_args(argv)

    device = resolve_device(args.device, "mat_dat_analysis")
    coo = load_coo(args.input, is_trans=False, device=device)
    a = coo.sum_duplicates().to_csr()
    bins = filter_rows(args.limit, a, a, list(args.bounds))
    for bound in args.bounds:
        print(f"<={bound}", end="\t")
    print(f">{args.bounds[-1]}")
    print("\t".join(str(x) for x in bins))
    return 0


if __name__ == "__main__":
    sys.exit(main())
