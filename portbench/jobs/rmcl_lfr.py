"""Static R-MCL jobs on LFR graphs: the closed loop of ``jobs/rmcl.py``
(its warm-up, run, release and check) over a pool of graphs made by
``reference/lfr.py``: graph k from the generator seed ``cfg["seed"] +
k``, its nodes relabelled by a permutation drawn from ``--seed``.

``work["products"]``: the benchmark's own count of the products of a
job's iterations, nnz(init(graph)) · S a step (init adds the self loop
each node lacks) times the iterations, the mean over the pool, from the
host arrays; the first ``pool`` jobs of a window, the traced ones, run
each graph once."""

from __future__ import annotations

import importlib

import numpy as np
import torch

from ..reference import generate, lfr
from . import rmcl

PKG = rmcl.PKG


class Job(rmcl.Job):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from sparse_matrix_with_flops_tpu_torch.formats.coo import COO

        if traffic["entry"] != "static":
            raise ValueError(f"rmcl_lfr runs the static entry, not {traffic['entry']!r}")
        self.traffic, self.device, self.entry = traffic, device, "static"
        rng = np.random.default_rng(seed)
        self.graphs, mixing, init_nnz = [], [], []
        for k in range(traffic["pool"]):
            rp, ci, label = lfr.graph(cfg, seed=cfg["seed"] + k)
            n = rp.shape[0] - 1
            rows = np.repeat(np.arange(n), np.diff(rp))
            mixing.append(float(np.mean(label[rows] != label[ci])))
            init_nnz.append(ci.shape[0] + n - int(np.count_nonzero(rows == ci)))
            rp, ci = generate.relabel(rp, ci, rng.permutation(n))
            rows = np.repeat(np.arange(n), np.diff(rp))
            coo = COO.from_numpy(rows, ci, np.ones(ci.shape[0], np.float32), n, n,
                                 capacity=ci.shape[0] + n, device=device)
            self.graphs.append((rp, ci, coo))
        self.n = n
        self.sample = {0} | set(rng.choice(np.arange(1, traffic["sample_from"]),
                                           traffic["sample"] - 1, replace=False).tolist())
        self.kept: list = []
        self.compared = 0
        t = traffic
        self.work = {"iters": t["iters"], "S": t["S"],
                     "products": float(np.mean(init_nnz)) * t["S"] * t["iters"]}
        self.notes = [f"static R-MCL on LFR: pool of {len(self.graphs)} graphs, n {n}, "
                      f"nnz {[int(g[1].shape[0]) for g in self.graphs]}, realised mu "
                      f"{[round(m, 4) for m in mixing]}"]
        rmcl_ell = importlib.import_module(f"{PKG}.models.rmcl_ell").rmcl_ell
        self.call = lambda coo: (rmcl_ell(coo, max_iters=t["iters"], S=t["S"],
                                          max_tile=t["max_tile"])[0], True)
