"""R-MCL clustering jobs in a closed loop: each job is one graph, on the
card as a COO, taken to its final iterate by the port's entry point.

``entry`` "static": ``models.rmcl_ell.rmcl_ell(coo, max_iters, S,
max_tile)`` (the ``nrmcl -r STATIC`` work without the file read);
"general": ``models.rmcl.rmcl(coo, max_iters, mode="scan", margin)``,
where a job that reports ``overflow`` has failed.

The graphs are a pool of ``pool`` graphs of the configuration, made in
set-up: graph k from the generator seed ``cfg["seed"] + k``, its nodes
relabelled by a permutation drawn from ``--seed``.  So every seed gives
other inputs and the same work: the same graphs under other labels.
Jobs cycle through the pool.  The results of the jobs the seed draws
are kept (tight copies) for the check.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from .. import compare
from ..reference import generate
from ..reference import rmcl as ref_rmcl

PKG = "sparse_matrix_with_flops_tpu_torch"


class Job:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from sparse_matrix_with_flops_tpu_torch.formats.coo import COO

        self.traffic, self.device = traffic, device
        self.entry = traffic["entry"]
        rng = np.random.default_rng(seed)
        self.graphs = []
        for k in range(traffic["pool"]):
            rp, ci, _ = generate.matrix(cfg, seed=cfg["seed"] + k)
            n = rp.shape[0] - 1
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
        self.work = {"iters": traffic["iters"]}
        self.notes = [f"{self.entry} R-MCL: pool of {len(self.graphs)} graphs, n {n}, "
                      f"nnz {[int(g[1].shape[0]) for g in self.graphs]}"]
        t = traffic
        if self.entry == "static":
            rmcl_ell = importlib.import_module(f"{PKG}.models.rmcl_ell").rmcl_ell
            self.call = lambda coo: (rmcl_ell(coo, max_iters=t["iters"], S=t["S"],
                                              max_tile=t["max_tile"])[0], True)
        elif self.entry == "general":
            rmcl = importlib.import_module(f"{PKG}.models.rmcl").rmcl

            def call(coo):
                res = rmcl(coo, max_iters=t["iters"], mode="scan", margin=t["margin"])
                return res.mt, not res.overflow

            self.call = call
        else:
            raise ValueError(f"unknown R-MCL entry {self.entry!r}")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self):
        for _, _, coo in self.graphs:
            self.call(coo)
        self._sync()

    def run(self, i: int) -> bool:
        k = i % len(self.graphs)
        out, ok = self.call(self.graphs[k][2])
        self._sync()
        if i in self.sample and ok:
            rp, ci, v = compare.tight(out.row_ptr, out.col_ind, out.values)
            self.kept.append((k, (rp, ci.clone(), v.clone())))
        return ok

    def release(self):
        self.call = None

    def check(self) -> dict:
        numbers: dict = {}
        refs: dict = {}
        S = self.traffic.get("S") if self.entry == "static" else None
        for k, got in self.kept:
            if k not in refs:
                rp, ci, _ = self.graphs[k]
                refs[k] = ref_rmcl.rmcl(rp, ci, self.n, self.traffic["iters"], S,
                                        device=self.device)
            for name, val in compare.rmcl_numbers(got, refs[k], self.n).items():
                numbers[name] = max(numbers.get(name, val), val)
            self.compared += 1
        self.kept = []
        return numbers
