"""Matrix analysis CLI, tools/analysis.cc + tools/bin_analysis.cc parity
(the port of the JAX package's ``cli/analysis.py``; the same lines on the
same file).

Prints N, Annz, Cnnz, flops (double-count), Oflops (single-count),
flops/cnnz compression ratio, sparsity, and the per-row flops + nnz log2
histograms; ``--bins`` adds each flops bin's B-row-size histogram.  Runs
on the CUDA card unless ``--device`` names another.

Usage: python -m sparse_matrix_with_flops_tpu_torch.cli.analysis -i graph.snap --bins
"""

from __future__ import annotations

import sys

from ..config import resolve_device
from ..io import load_coo
from ..ops.flops import flops_stats, nnz_stats, print_stats
from ..ops.spgemm import matmul, spgemm_upper_bounds
from .args import build_parser


def main(argv=None) -> int:
    p = build_parser("matrix stats (analysis.x / bin_analysis.x parity)")
    p.add_argument(
        "--bins",
        action="store_true",
        help="per-flops-bin B-row-size histograms "
        "(mindex2-cuda/analysis.cu:35-110 parity)",
    )
    args = p.parse_args(argv)
    device = resolve_device(args.device, "analysis")
    coo = load_coo(args.input, is_trans=False, device=device)
    a = coo.sum_duplicates().to_csr()

    n = a.rows
    annz = int(a.nnz)
    oflops, _ = spgemm_upper_bounds(a, a)
    c = matmul(a, a)
    cnnz = int(c.nnz)
    flops = 2 * oflops
    print(
        f"N= {n} Annz= {annz} Cnnz={cnnz} flops= {flops} "
        f"flops/cnnz={flops / max(cnnz, 1):.6f}"
    )
    print(f"Oflops={oflops}")
    print(f"sparsity = {annz / (n * max(a.cols, 1)):.3e}")

    hist, _ = flops_stats(a, a)
    print_stats(hist, "row flops histogram")
    print_stats(nnz_stats(c), "C row nnz histogram")

    if args.bins:
        from ..ops.bincheck import classify_flops_queues, per_bin_b_row_histogram

        _, hv = classify_flops_queues(a, a)
        per_bin = per_bin_b_row_histogram(a, a)
        for q in range(per_bin.shape[0]):
            if hv[q + 1] == hv[q]:
                continue
            print(
                f"Binwise distribution of per element for bin {q} "
                f"({hv[q + 1] - hv[q]} rows)"
            )
            for k, cnt in enumerate(per_bin[q]):
                if cnt:
                    print(f"count {k} : {cnt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
