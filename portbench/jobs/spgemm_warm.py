"""Warm SpGEMM: C = A·A on one structure, planned once in set-up, each
call with fresh values of A.

The engine is the one the port's dispatcher routes the structure to
(``ops.dispatch.route``: the lane pipeline ``spgemm_ell`` or the block
engine ``block_spgemm``).  A's values come from a pool of
``value_sets`` made on the card from the seed, the k-th call taking set
k mod ``value_sets``.  Set-up warms up until the plan holds every graph
it will capture, so nothing is captured in the window.  Each result is
held until the next call returns; those of the calls the seed draws
(and the last) are kept for the check, as tight copies (a result's
arrays are sized to the plan's capacity) into buffers made at the end
of set-up, so that the window's memory peak does not depend on where
the seed's draws fall.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import arith, compare
from ..reference import generate
from ..reference.spgemm import spgemm


class Job:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR
        from sparse_matrix_with_flops_tpu_torch.ops import block_spgemm, dispatch, ell_esc
        from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import plan_ell

        self.traffic, self.device = traffic, device
        rp, ci, v0 = generate.matrix(cfg)
        self.n, self.nnz = rp.shape[0] - 1, ci.shape[0]
        self.rp_t = torch.from_numpy(rp).to(device)
        self.ci_t = torch.from_numpy(ci).to(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        shape = (traffic["value_sets"], self.nnz)
        if cfg["values"] == "uniform":  # (0, 1]
            self.pool = 1.0 - torch.rand(shape, generator=gen, device=device)
        elif cfg["values"] == "normal":
            self.pool = torch.randn(shape, generator=gen, device=device)
        else:
            raise ValueError(f"unknown value law {cfg['values']!r}")
        a0 = CSR.from_numpy(rp, ci, v0, self.n, device)
        self.a = [CSR(a0.row_ptr, a0.col_ind, self.pool[k], self.n)
                  for k in range(shape[0])]
        self.engine, fill = dispatch.route(a0, a0)
        if self.engine == "block":
            self.plan = block_spgemm.plan_block(a0, a0)
            self.call = lambda a: block_spgemm.block_spgemm(a, a, self.plan)
        else:
            self.plan = plan_ell(a0, a0)
            self.call = lambda a: ell_esc.spgemm_ell(a, a, self.plan)
        rng = np.random.default_rng(seed)
        self.sample = {0} | set(rng.choice(np.arange(1, traffic["sample_from"]),
                                           traffic["sample"] - 1, replace=False).tolist())
        self.kept: list = []
        self.slots: list = []  # the copies' buffers, one a drawn call
        self.last = None
        self.compared = 0
        self.work = {"flops": arith.row_flops_total(rp, ci)}
        self.notes = [f"engine {self.engine} (block fill {fill:.4f}); n {self.n} nnz "
                      f"{self.nnz}; flops {self.work['flops']}"]

    def _uncaptured(self) -> bool:
        """Whether the plan holds a program that has not captured yet."""
        from sparse_matrix_with_flops_tpu_torch.utils import graphs

        held = (graphs.held(self.plan, k) for k in graphs.BREAK_EVEN)
        return any(b is not None and b.graph is None for b in held)

    def warm(self):
        t = self.traffic
        k = 0
        while k < t["warm_calls"] or (self._uncaptured() and k < t["max_warm_calls"]):
            c = self.call(self.a[k % len(self.a)])
            k += 1
        nnz = int(c.row_ptr[-1])
        self.slots = [(torch.empty_like(c.row_ptr), c.col_ind.new_empty(nnz),
                       c.values.new_empty(nnz)) for _ in self.sample]
        del c
        self.notes.append(f"warm-up: {k} calls; a program still uncaptured: "
                          f"{self._uncaptured()}")

    @staticmethod
    def _tight(c, slot=None):
        """C's entries, into ``slot`` where they fit it (every call of one
        plan gives the same nnz, unless the program is at fault)."""
        nnz = int(c.row_ptr[-1])
        if slot is None or slot[1].shape[0] != nnz or slot[0].shape != c.row_ptr.shape:
            return c.row_ptr.clone(), c.col_ind[:nnz].clone(), c.values[:nnz].clone()
        return (slot[0].copy_(c.row_ptr), slot[1].copy_(c.col_ind[:nnz]),
                slot[2].copy_(c.values[:nnz]))

    def run(self, i: int) -> bool:
        k = i % len(self.a)
        c = self.call(self.a[k])
        self.last = (i, k, c)
        if i in self.sample:
            j = len(self.kept)
            self.kept.append((i, k, self._tight(c, self.slots[j] if j < len(self.slots)
                                                else None)))
        return True

    def release(self):
        self.plan = self.call = None
        if self.last is not None and all(i != self.last[0] for i, _, _ in self.kept):
            i, k, c = self.last
            self.kept.append((i, k, self._tight(c)))
        self.last = None

    def check(self) -> dict:
        """Each kept result against the reference of its value set, one
        reference on the card at a time."""
        numbers: dict = {}
        args = (self.rp_t, self.ci_t)
        for k in sorted({k for _, k, _ in self.kept}):
            v = self.pool[k]
            ref = spgemm(*args, v, *args, v, self.n)
            absolute = ref if bool((v > 0).all()) else spgemm(
                *args, v.abs(), *args, v.abs(), self.n)
            for _, kk, c in self.kept:
                if kk != k:
                    continue
                got = compare.spgemm_numbers(c, ref, absolute, self.n)
                for name, val in got.items():
                    numbers[name] = max(numbers.get(name, val), val)
                self.compared += 1
            nnz_c = int(ref[0][-1])
            del ref, absolute
        self.kept, self.slots = [], []
        if self.compared:
            self.work["nnz_c"] = nnz_c
            self.work["bytes"] = arith.square_bytes(self.n, self.nnz, nnz_c)
        return numbers
