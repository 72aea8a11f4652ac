"""Matrix ingestion: SNAP edge lists and MatrixMarket files (the port of
the JAX package's ``io/``); the parsers run on the host, ``load_coo``
puts the result on the card."""

from __future__ import annotations

import os
import sys

import torch

from .matrix_market import read_matrix_market, write_matrix_market
from .snap import read_snap

__all__ = [
    "read_matrix_market",
    "write_matrix_market",
    "read_snap",
    "load_coo",
]


def load_coo(
    path: str,
    is_trans: bool = True,
    extra_capacity: int = 0,
    use_native: bool = True,
    device: torch.device | str | None = None,
):
    """Read a SNAP or MatrixMarket file into a COO on ``device`` (by
    default the card: ``config.resolve_device``).

    ``extra_capacity`` reserves padded slots (e.g. ``nrows`` for
    add_self_loops).  Mirrors the reference ingestion entry points
    (COO.cc:43-46, COO.cc:48-158; the MM banner is honoured for .mtx, as
    in mindex2-cuda/nGpuSpMM.cc:286).  The C++ parser
    (native/src/loader.cc) is preferred; the numpy reader is the
    fallback.  A missing file exits, as the reference does.
    """
    from ..config import resolve_device
    from ..formats.coo import COO

    device = resolve_device(device, "load_coo")
    if not os.path.exists(path):
        # clean exit like the reference (COO.cc:50-53 prints + exit(-1))
        sys.exit(f"cannot open input file: {path}")
    parsed = None
    if use_native:
        from .native import read_graph_native

        parsed = read_graph_native(path, is_trans=is_trans)
    if parsed is None:
        parsed = read_snap(path, is_trans=is_trans)
    row, col, val, nrows, ncols = parsed
    cap = row.shape[0] + int(extra_capacity)
    return COO.from_numpy(row, col, val, nrows, ncols, capacity=max(cap, 1), device=device)
