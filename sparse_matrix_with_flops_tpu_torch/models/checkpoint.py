"""Checkpoint / resume for long R-MCL runs (the port of the JAX package's
``models/checkpoint.py``).

The iterate and the iteration counter go into one npz file with the
reference's layout (``row_ptr``, ``col_ind`` and ``values`` at the full
capacity, ``ncols``, ``iteration``, ``extra_*``), so a checkpoint that
either package wrote resumes in the other.  The file is written beside
its path and renamed into place, so a crash leaves the last whole one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..formats.coo import COO
from ..formats.csr import CSR


def save_checkpoint(path: str, mt: CSR, iteration: int, extra: dict | None = None):
    """Write the iterate (copied to the host) and its metadata."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "row_ptr": mt.row_ptr.cpu().numpy(),
        "col_ind": mt.col_ind.cpu().numpy(),
        "values": mt.values.cpu().numpy(),
        "ncols": np.asarray(mt.ncols),
        "iteration": np.asarray(iteration),
    }
    for k, v in (extra or {}).items():
        payload["extra_" + k] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)  # atomic publish


def load_checkpoint(
    path: str, device: torch.device | str | None = None
) -> tuple[CSR, int, dict]:
    """(iterate on ``device``, by default the card; iteration; extras)."""
    with np.load(path) as z:
        mt = CSR.from_arrays(
            z["row_ptr"], z["col_ind"], z["values"], int(z["ncols"]),
            capacity=z["col_ind"].shape[0], device=device,
        )
        it = int(z["iteration"])
        extra = {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}
    return mt, it, extra


def rmcl_resumable(
    graph,
    max_iters: int,
    checkpoint_path: str,
    checkpoint_every: int = 1,
    **kwargs,
):
    """R-MCL that checkpoints every ``checkpoint_every`` iterations
    and resumes from ``checkpoint_path`` if present, on the graph's
    device.  Returns (iterate, iterations done, nnz of this call's
    steps).  Raises on a capacity overflow unless
    ``raise_on_overflow=False``."""
    from .rmcl import plan_capacities, rmcl_init, rmcl_one_step

    mgt = rmcl_init(graph) if isinstance(graph, COO) else graph
    start = 0
    overflow = False
    if os.path.exists(checkpoint_path):
        mt, start, extra = load_checkpoint(checkpoint_path, mgt.device)
        overflow = bool(extra.get("overflow", False))
    else:
        mt = mgt.deep_copy()

    nnz_hist = []
    while start < max_iters:
        pc, cc = plan_capacities(mgt, mt, margin=kwargs.get("margin", 1.5))
        if mt.capacity < cc:
            mt = mt.with_capacity(cc)
        mt, info = rmcl_one_step(mgt, mt, pc, max(cc, mt.capacity))
        start += 1
        nnz_hist.append(int(info["nnz_mt"]))
        # undersized capacities truncate the iterate, the moral equivalent
        # of qmalloc's exit-on-OOM; persisted so a resumed run keeps it
        overflow |= bool(
            info["overflow_products"] | info["overflow_c"] | info["overflow_mt"]
        )
        if start % checkpoint_every == 0 or start == max_iters:
            save_checkpoint(checkpoint_path, mt, start, extra={"overflow": overflow})
    if overflow and kwargs.get("raise_on_overflow", True):
        raise RuntimeError(
            "rmcl_resumable: capacity overflow during iteration — the "
            "iterate was truncated; rerun with a larger margin"
        )
    return mt, start, nnz_hist
