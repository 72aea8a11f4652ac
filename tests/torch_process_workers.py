"""One rank a process: the port's distributed layer on a process mesh
(``torch.distributed`` with the ``gloo`` backend, on the CPU), and the
same cases on the stacked mesh, for ``tests/test_torch_process_mesh.py``.

The test spawns W processes that each run :func:`run_rank`; every rank
writes its results to a file, and the test holds them against
:func:`stacked_results`.  The module also runs alone, one rank a process
under ``torchrun``, and then checks each rank against the stacked path
itself::

    torchrun --nproc-per-node 2 tests/torch_process_workers.py

It imports torch and the port only (no JAX), so a rank starts quickly.
"""

from __future__ import annotations

import importlib
import os
import pickle
import sys
import traceback

import numpy as np
import torch

EXCHANGES = ("ring", "all_gather", "pallas_ring", "fused_ring")
# R-MCL cases: (graph, S, max_tile, iterations); max_tile 256 at S 16
# leaves degree classes up to 16, so the R-MAT's denser rows are hub rows
RMCL_CASES = {"hub": ("rmat", 16, 256, 3), "nohub": ("rmat", 16, 8192, 3)}
DYN_ITERS = 3  # the dynamic scan's and the adaptive loop's iterations
WS_BASE = 5  # the weak-scaling run's R-MAT scale at D = 1
# the shapes of the 2-D SpGEMM's process mesh, by world size
MESHES_2D = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
# results that hold one block a shard: a rank holds its own ([x, y] for
# the 2-D SpGEMM's blocks); every other result is whole on every rank
BLOCK_KEYS = ("shard", "spgemm", "spgemm_ring", "rmcl_scan", "rmcl_scan/jax", "next_flops/rf",
              "repartition/mgt", "repartition/mt")
BLOCK_PREFIX = "scan_block/"  # the static scan's iterate blocks, by length and exchange


# the break-even count B of both process-mesh programs in the emulation of
# the card's keeping (:func:`capture_decisions`): on the CPU nothing is
# captured, so the policy's arithmetic, not the card's count, is tested
TEST_B = 3


def scan_lengths() -> tuple:
    """The static scan's lengths: one iteration short of the emulated
    break-even count B and B itself."""
    return TEST_B - 1, TEST_B


def make_inputs(world: int, seed: int = 0) -> dict:
    """The inputs every rank and the stacked path share, as numpy arrays:
    per-shard values for the collectives, a small R-MAT (n = 256) for the
    SpGEMMs, and its R-MCL graph (unit weights, ``rmcl_init`` applied by
    the callee)."""
    from sparse_matrix_with_flops_tpu_torch.utils.generate import rmat_csr

    rng = np.random.default_rng(seed)
    a = rmat_csr(8, edge_factor=4, seed=3, weights="random", device="cpu")
    g = rmat_csr(8, edge_factor=8, seed=7, device="cpu")
    grp, gci, gv = g.to_numpy()
    rp, ci, v = a.to_numpy()
    return {
        "world": world,
        "shards": rng.standard_normal((world, 3, 5)).astype(np.float32),
        "counts": rng.integers(0, 1000, (world,)).astype(np.int64),
        "a": (rp, ci, v, a.ncols),
        "graph": (np.repeat(np.arange(g.rows), np.diff(grp)), gci, gv, g.rows),
    }


def _csr(arrs):
    from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR

    rp, ci, v, ncols = arrs
    return CSR.from_numpy(rp, ci, v, ncols, device="cpu")


def _coo(arrs):
    from sparse_matrix_with_flops_tpu_torch.formats import COO

    r, c, v, n = arrs
    return COO.from_numpy(r, c, v, n, n, capacity=c.size + n, device="cpu")


def _np(x):
    return x.numpy().copy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sharded(s) -> tuple:
    return _np(s.row_ptr), _np(s.col_ind), _np(s.values)


def _caps(a, world: int) -> tuple:
    """Per-shard product and output capacities of A·A: the total flops."""
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_upper_bounds

    flops, _ = spgemm_upper_bounds(a, a)
    return int(flops) + 8, int(flops) + 8


def dynamic_scan(mesh, g) -> tuple:
    """The dynamic sharded scan of ``g`` (``DYN_ITERS`` iterations, the
    products' and the iterate's capacity a shard at margin 4 on 4x the
    flops): the held blocks, then the statistics in key order, then the
    caps."""
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_upper_bounds
    from sparse_matrix_with_flops_tpu_torch.parallel import (
        plan_shard_capacities,
        shard_csr,
        sharded_rmcl_scan,
    )

    flops, _ = spgemm_upper_bounds(g, g)
    smgt = shard_csr(g, mesh)
    pc, cc = plan_shard_capacities(smgt, flops * 4, margin=4.0)
    new, hist = sharded_rmcl_scan(mesh, smgt, shard_csr(g, mesh, local_capacity=cc), pc, cc,
                                  DYN_ITERS)
    return (*_sharded(new), *(_np(hist[k]) for k in sorted(hist)), pc, cc)


def dynamic_cases(mesh, inp: dict) -> dict:
    """The dynamic and adaptive sharded R-MCL on the R-MAT's R-MCL graph:
    the scan, the next multiply's flops, the repartition of the scan's
    iterate, the adaptive loop; the dry run."""
    from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl_init
    from sparse_matrix_with_flops_tpu_torch.parallel import (
        dryrun_multichip,
        shard_csr,
        sharded_next_flops,
        sharded_rmcl_adaptive,
    )
    from sparse_matrix_with_flops_tpu_torch.parallel.rmcl import _device_repartition_pair
    from sparse_matrix_with_flops_tpu_torch.parallel.sharded import ShardedCSR

    out = {}
    g = rmcl_init(_coo(inp["graph"]))
    scan = dynamic_scan(mesh, g)
    out["rmcl_scan"], out["rmcl_scan/stats"] = scan[:3], scan[3:]
    smgt = shard_csr(g, mesh, local_capacity=g.capacity)
    smt = ShardedCSR(*(torch.from_numpy(x) for x in scan[:3]), g.ncols, g.rows, smgt.shards,
                     smgt.rank)
    rf, spread, total = sharded_next_flops(mesh, smgt, smt)
    out["next_flops/rf"], out["next_flops"] = (_np(rf),), (_np(spread), _np(total))
    na, nb, perm, ovf, after = _device_repartition_pair(mesh, smgt, smt, rf, g.rows)
    out["repartition/mgt"], out["repartition/mt"] = _sharded(na), _sharded(nb)
    out["repartition"] = (_np(perm), _np(ovf), _np(after))
    res, hist = sharded_rmcl_adaptive(g, mesh, max_iters=DYN_ITERS)
    out["adaptive"] = (*res.to_numpy(), *(hist[k] for k in sorted(hist)))
    out["adaptive/perm_total"] = hist["perm_total"]
    out["dryrun"] = tuple(np.asarray(x) for x in dryrun_multichip(mesh))
    return out


def spgemm_2d_cases(world: int, inp: dict, mesh_2d) -> dict:
    """The 2-D SpGEMM A·A of the random-weight R-MAT on each shape of
    ``MESHES_2D[world]`` (``mesh_2d(shape)`` makes the mesh): the held
    blocks of C, and C unsharded."""
    from sparse_matrix_with_flops_tpu_torch.ops.spgemm import spgemm_upper_bounds
    from sparse_matrix_with_flops_tpu_torch.parallel import (
        shard_csr,
        shard_csr_2d,
        sharded_spgemm_2d,
        unshard_2d,
    )

    out = {}
    a = _csr(inp["a"])
    flops, _ = spgemm_upper_bounds(a, a)
    for nx, ny in MESHES_2D[world]:
        m2 = mesh_2d((nx, ny))
        b_rp, b_ci, b_v, stripe, b_rows = shard_csr_2d(a, nx, ny, mesh=m2)
        c = sharded_spgemm_2d(m2, shard_csr(a, m2), b_rp, b_ci, b_v, stripe, b_rows,
                              flops + 8, flops + 8)
        out[f"spgemm_2d/{nx}x{ny}"] = tuple(_np(x) for x in c)
        out[f"unshard_2d/{nx}x{ny}"] = unshard_2d(*c, stripe, a.rows, a.ncols,
                                                   mesh=m2).to_numpy()
    return out


def scan_inputs(mesh, inp: dict):
    """The static scan's plan, arrays, Mgt shards and initial iterate (the
    held blocks) for the hub case of ``RMCL_CASES``, as
    ``sharded_rmcl_ell`` builds them."""
    from sparse_matrix_with_flops_tpu_torch.models.rmcl import rmcl_init
    from sparse_matrix_with_flops_tpu_torch.models.rmcl_ell import mt_to_ell
    from sparse_matrix_with_flops_tpu_torch.parallel import collectives as C
    from sparse_matrix_with_flops_tpu_torch.parallel import plan_sharded_rmcl_ell

    _, S, max_tile, _ = RMCL_CASES["hub"]
    d = mesh.num_shards
    mt0 = rmcl_init(_coo(inp["graph"])).make_ordered()
    plan, arrays, smgt = plan_sharded_rmcl_ell(mt0, d, S=S, max_tile=max_tile, mesh=mesh)
    cols, vals = mt_to_ell(mt0, S)
    cols = torch.where(cols >= mt0.ncols, plan.n, cols)
    held = C.local_ranks(mesh)
    cut = slice(held[0], held[-1] + 1)
    return (plan, arrays, smgt, cols.reshape(d, plan.lr, S)[cut].contiguous(),
            vals.reshape(d, plan.lr, S)[cut].contiguous())


def scan_cases(mesh, inp: dict) -> dict:
    """The static ``sharded_rmcl_ell_scan`` (its step through
    ``graphs.scan_body``) at the lengths of :func:`scan_lengths`, each
    exchange on one plan: the held iterate blocks and the histories."""
    from sparse_matrix_with_flops_tpu_torch.parallel import sharded_rmcl_ell_scan

    plan, arrays, smgt, c0, v0 = scan_inputs(mesh, inp)
    out = {}
    for length in scan_lengths():
        for ex in EXCHANGES:
            c, v, hist = sharded_rmcl_ell_scan(mesh, plan, smgt, arrays, c0, v0, length, ex)
            out[f"{BLOCK_PREFIX}{length}/{ex}"] = (_np(c), _np(v))
            out[f"scan_hist/{length}/{ex}"] = tuple(_np(hist[k]) for k in sorted(hist))
    return out


def psum_cases(mesh, x, counts) -> dict:
    """Four sums (two f32, two int64 values a shard) in one packed gather
    (``collectives.psums``) and as four ``psum`` calls."""
    from sparse_matrix_with_flops_tpu_torch.parallel import collectives as C

    xs = [x[:, 0, 0].contiguous(), counts, x[:, 2, 4].contiguous(), counts * 3 - 7]
    return {"psums": tuple(_np(p) for p in C.psums(mesh, xs)),
            "psums/separate": tuple(_np(C.psum(mesh, t)) for t in xs)}


def capture_decisions(mesh, inp: dict) -> dict:
    """The capture policy on the process mesh, with the card's keeping of
    programs emulated on the CPU (``graphs.keeps`` true, a capture
    stubbed: it logs the run it came at and replays by running the body
    again into the captured outputs), every ``graphs.captures`` call
    logged, both programs' B set to ``TEST_B``.  For each exchange of the
    static scan: a fresh plan's call one iteration short of B (all eager), then a call of B on it (a capture at
    its first iteration), and on another fresh plan a call of B (its
    first iteration eager, the capture at its second) and one of B - 1
    (all replayed); then the warm ring SpGEMM on one plan, B + 1 calls.
    Returns each log and each result."""
    import types

    from sparse_matrix_with_flops_tpu_torch.parallel import shard_csr, sharded_rmcl_ell_scan
    from sparse_matrix_with_flops_tpu_torch.parallel.spgemm import (
        plan_spgemm_ring,
        sharded_spgemm_ring,
    )
    from sparse_matrix_with_flops_tpu_torch.utils import graphs

    log: list = []
    keeps, captures, capture = graphs.keeps, graphs.captures, graphs.CapturedBody._capture

    def logged(spent, left, b):
        took = captures(spent, left, b)
        log.append(("policy", spent, left, b, took))
        return took

    def stub(self):
        log.append(("capture", self.name, self.spent))
        out = self.body()
        body, self.outputs = self.body, None if out is None else tuple(t.clone() for t in out)

        def replay():
            new = body()
            for o, n in zip(self.outputs or (), new or ()):
                o.copy_(n)

        self.graph = types.SimpleNamespace(replay=replay)
        return out

    out = {}
    table = dict(graphs.BREAK_EVEN)
    graphs.BREAK_EVEN.update({"sharded_rmcl_ell_scan_process": TEST_B,
                              "sharded_spgemm_ring_process": TEST_B})
    graphs.keeps, graphs.captures, graphs.CapturedBody._capture = (lambda dev: True), logged, stub
    try:
        short, b = scan_lengths()
        for ex in EXCHANGES:
            del log[:]
            plan, arrays, smgt, c0, v0 = scan_inputs(mesh, inp)
            runs = [sharded_rmcl_ell_scan(mesh, plan, smgt, arrays, c0, v0, n, ex)
                    for n in (short, b)]
            plan, arrays, smgt, c0, v0 = scan_inputs(mesh, inp)
            runs += [sharded_rmcl_ell_scan(mesh, plan, smgt, arrays, c0, v0, n, ex)
                     for n in (b, short)]
            out[f"decisions/scan/{ex}"] = list(log)
            out[f"decisions/scan/{ex}/results"] = [
                (_np(c), _np(v), *(_np(h[k]) for k in sorted(h))) for c, v, h in runs]
        del log[:]
        a = _csr(inp["a"])
        sa = shard_csr(a, mesh)
        plan, ents = plan_spgemm_ring(sa, sa, mesh)
        ocap = _caps(a, inp["world"])[1]
        calls = []
        for _ in range(TEST_B + 1):
            c, info = sharded_spgemm_ring(mesh, sa, sa, out_cap=ocap, plan=plan, step_ents=ents)
            calls.append((*_sharded(c), _np(info["flops"]), _np(info["nnz"])))
        out["decisions/ring"] = list(log)
        out["decisions/ring/results"] = calls
    finally:
        graphs.keeps, graphs.captures, graphs.CapturedBody._capture = keeps, captures, capture
        graphs.BREAK_EVEN.clear()
        graphs.BREAK_EVEN.update(table)
    return out


def cases(mesh, inp: dict, rows, mesh_2d) -> dict:
    """Every case on ``mesh`` (stacked or process), with ``rows`` the
    shards the mesh's process holds and ``mesh_2d(shape)`` the 2-D mesh
    of the same kind: each result as numpy arrays."""
    from sparse_matrix_with_flops_tpu_torch.parallel import collectives as C
    from sparse_matrix_with_flops_tpu_torch.parallel import (
        shard_csr,
        sharded_rmcl_ell,
        sharded_spgemm,
        sharded_spgemm_ring,
        unshard_csr,
    )

    world = inp["world"]
    out = {}
    x = torch.from_numpy(inp["shards"])[rows]
    out["all_gather"] = _np(C.all_gather(mesh, x))
    out["ppermute+1"] = _np(C.ppermute(mesh, x, 1))
    out["ppermute-1"] = _np(C.ppermute(mesh, x, -1))
    out["psum"] = _np(C.psum(mesh, x[:, 0, 0].contiguous()))
    out["psum_int"] = _np(C.psum(mesh, torch.from_numpy(inp["counts"])[rows]))
    out.update(psum_cases(mesh, x, torch.from_numpy(inp["counts"])[rows]))
    out["axis_index"] = np.array([C.axis_index(mesh, i) for i in range(x.shape[0])])
    a = _csr(inp["a"])
    sa = shard_csr(a, mesh)
    out["shard"] = _sharded(sa)
    out["unshard"] = _sharded(unshard_csr(sa, mesh))
    pcap, ocap = _caps(a, world)
    c, info = sharded_spgemm(mesh, sa, sa, pcap, ocap)
    out["spgemm"] = (*_sharded(c), _np(info["flops"]), _np(info["nnz"]))
    c, info = sharded_spgemm_ring(mesh, sa, sa, out_cap=ocap)
    out["spgemm_ring"] = (*_sharded(c), _np(info["flops"]), _np(info["nnz"]))
    coo = _coo(inp["graph"])
    for name, (_, S, max_tile, iters) in RMCL_CASES.items():
        for ex in EXCHANGES:
            res, hist = sharded_rmcl_ell(coo, mesh, max_iters=iters, S=S, max_tile=max_tile,
                                         exchange=ex)
            out[f"rmcl/{name}/{ex}"] = (*_sharded(res), *(hist[k] for k in sorted(hist)))
    out.update(scan_cases(mesh, inp))
    if "jax_graph" in inp:  # the JAX comparison's graph, already row-stochastic
        res, hist = sharded_rmcl_ell(_csr(inp["jax_graph"]), mesh, max_iters=2, S=32,
                                     max_tile=256, exchange="all_gather")
        out["rmcl/jax"] = (*_sharded(res), *(hist[k] for k in sorted(hist)))
        scan = dynamic_scan(mesh, _csr(inp["jax_graph"]))
        out["rmcl_scan/jax"], out["rmcl_scan/jax/stats"] = scan[:3], scan[3:]
    out.update(dynamic_cases(mesh, inp))
    out.update(spgemm_2d_cases(world, inp, mesh_2d))
    return out


def weak_scaling_shape(rows) -> list:
    """The weak-scaling rows without their times: (mesh, D, scale, rows,
    nnz, caveat given)."""
    return [(r["mesh"], r["devices"], r["scale"], r["rows"], r["nnz"], bool(r["caveat"]))
            for r in rows]


def process_only(mesh, inp: dict) -> dict:
    """What holds on a process mesh alone: the mesh's own fields, a 2-D
    process mesh's, and the errors ``make_mesh`` raises under a group."""
    from sparse_matrix_with_flops_tpu_torch.parallel import (
        ProcessMesh,
        make_mesh,
        weak_scaling_rmcl_ell,
    )

    world = inp["world"]
    out = {"mesh": (type(mesh) is ProcessMesh, mesh.num_shards, mesh.rank, str(mesh.device))}
    out["make_mesh()"] = type(make_mesh(device="cpu")) is ProcessMesh
    m2 = make_mesh((2, world // 2), device="cpu")
    out["2-D"] = (type(m2) is ProcessMesh, m2.shape, m2.axis_names, m2.coords(),
                  m2.axis_size("x"), m2.axis_size("y"))
    out["weak_scaling"] = weak_scaling_shape(weak_scaling_rmcl_ell(base_scale=WS_BASE,
                                                                   device="cpu"))
    out.update(capture_decisions(mesh, inp))
    for label, arg in (("n != W", world + 1), ("nx*ny != W", (2, world))):
        try:
            make_mesh(arg, device="cpu")
            out[f"raises {label}"] = "no error"
        except ValueError as e:
            out[f"raises {label}"] = type(e).__name__ + ": " + str(e)
    return out


def stacked_results(inp: dict) -> dict:
    """The cases on the stacked mesh of the same D, on the CPU (built
    directly: under a group ``make_mesh`` gives the process mesh)."""
    from sparse_matrix_with_flops_tpu_torch.parallel import ShardMesh

    world, cpu = inp["world"], torch.device("cpu")
    return cases(ShardMesh(world, cpu, (world,)), inp, slice(0, world),
                 lambda shape: ShardMesh(world, cpu, shape, ("x", "y")))


def process_mesh_2d(shape):
    """The 2-D process mesh of ``shape`` on the CPU."""
    from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh

    return make_mesh(shape, device="cpu")


def run_rank(rank: int, world: int, store: str, inputs: str, out_dir: str) -> None:
    """One rank: join the gloo group through the file store ``store``, run
    the cases on the process mesh, write ``rank<r>.pkl`` (or
    ``rank<r>.err`` with the traceback) into ``out_dir``."""
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist

        from sparse_matrix_with_flops_tpu_torch.parallel import make_mesh

        with open(inputs, "rb") as f:
            inp = pickle.load(f)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        mesh = make_mesh(device="cpu")
        out = cases(mesh, inp, slice(rank, rank + 1), process_mesh_2d)
        out.update(process_only(mesh, inp))
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except Exception:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def card_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of ``tests/test_torch_cuda.py``'s pair of processes on
    card 0 under gloo: the peer route (K6 one rank a launch: one hop for
    ``ppermute``, every hop for the all-gather, the packed sums) against
    the group's own calls; then every peer set's counter set two epochs
    short of the wrap, and eager runs and replays of one CUDA graph of
    K6 (one hop and every hop) and K8 interleaved past the wrap, each
    bit-equal to the first eager run.  Writes ``card<r>.json`` (or
    ``rank<r>.err``) into ``out_dir``."""
    import json

    try:
        import torch.distributed as dist

        from sparse_matrix_with_flops_tpu_torch import _build
        from sparse_matrix_with_flops_tpu_torch.parallel import collectives as C
        from sparse_matrix_with_flops_tpu_torch.parallel import peer, process_mesh
        from sparse_matrix_with_flops_tpu_torch.parallel import ring_kernels as RK

        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        dev = torch.device("cuda", 0)
        mesh = process_mesh(device=dev)
        g = torch.Generator().manual_seed(5)
        blocks = [torch.randint(0, 1 << 20, (world, 300, 128), generator=g, dtype=torch.int32),
                  torch.rand((world, 300, 128), generator=g),
                  torch.randint(0, 1 << 20, (world, 77), generator=g, dtype=torch.int32),
                  torch.randint(-(1 << 40), 1 << 40, (world, 5), generator=g,
                                dtype=torch.int64)]
        xs = [t[rank:rank + 1].to(dev) for t in blocks]
        out = {}
        same = lambda got, want: all(torch.equal(a, b) for a, b in zip(got, want))  # noqa: E731
        out["ppermute"] = same(RK.peer_ppermute(*xs, mesh=mesh),
                               [C.ppermute(mesh, x, 1) for x in xs])
        out["all_gather"] = same(RK.peer_all_gather(*xs, mesh=mesh),
                                 [C.all_gather(mesh, x) for x in xs])
        sums = [xs[1][:, 0, 0].contiguous(), xs[3][:, 0].contiguous()]
        out["psums"] = same(C.psums(mesh, sums), [C.psum(mesh, x) for x in sums])
        a = torch.rand((world, 100, world * 256), generator=g)[rank:rank + 1].to(dev)
        b = torch.rand((world, 256, 4096), generator=g)[rank:rank + 1].to(dev)

        def body():
            return (*RK.peer_ppermute(*xs[:3], mesh=mesh), *RK.peer_all_gather(*xs[:2],
                                                                               mesh=mesh),
                    RK.ring_matmul_tiled(a, b, 2048, mesh=mesh))

        before = set(peer._SETS)
        ref = body()  # eager: makes the body's sets
        sets = [ps for k, ps in peer._SETS.items() if k not in before]
        torch.cuda.synchronize()
        dist.barrier()
        start = _build.EPOCHS - 2
        for ps in sets:
            ps.counter.fill_(start)
        graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            graph.capture_begin()
            outs = body()
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize()
        dist.barrier()
        ok = []
        for step in ("eager", "replay", "eager", "replay", "replay", "eager"):
            if step == "replay":
                graph.replay()
                got = [o.clone() for o in outs]
            else:
                got = body()
            ok.append(same(got, ref))
        torch.cuda.synchronize()
        out["interleaved"] = ok
        out["counters"] = [int(ps.counter) for ps in sets]
        out["want_counter"] = (start - 1 + 6) % _build.EPOCHS + 1
        del graph, outs
        peer.close_all()
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"card{rank}.json"), "w") as f:
            json.dump(out, f)
    except Exception:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def row_of(key: str, value, rank: int):
    """The part of a stacked result that rank ``rank`` holds: blocks and
    per-shard arrays are cut to the rank's row (a 2-D SpGEMM's to its
    block ``[x, y]``, ``(x, y) = divmod(rank, ny)``); gathered results
    (the all-gather, unshard, the R-MCL iterates and statistics, the
    sums, the permutation, the dry run) are whole on every rank."""
    if key in BLOCK_KEYS or key.startswith(BLOCK_PREFIX):
        return tuple(x[rank:rank + 1] for x in value)
    if key.startswith("spgemm_2d/"):
        x, y = divmod(rank, int(key.split("x")[-1]))
        return tuple(b[x:x + 1, y:y + 1] for b in value)
    if key in ("ppermute+1", "ppermute-1", "axis_index"):
        return value[rank:rank + 1]
    return value


def same(a, b) -> bool:
    """Bit-equal (floats compared by their bits, so NaN equals NaN)."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def main() -> int:
    """Under torchrun: one rank a process on the CPU, each rank held to
    the stacked path at the same D."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    mesh_mod = importlib.import_module("sparse_matrix_with_flops_tpu_torch.parallel.mesh")
    torch.set_num_threads(1)
    mesh_mod.init_distributed()
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    inp = make_inputs(world)
    mesh = mesh_mod.make_mesh(device="cpu")
    got = cases(mesh, inp, slice(rank, rank + 1), process_mesh_2d)
    want = stacked_results(inp)
    bad = [k for k in want if not same(got[k], row_of(k, want[k], rank))]
    print(f"rank {rank} of {world}: {len(want) - len(bad)} of {len(want)} cases bit-equal "
          f"to the stacked mesh" + (f"; differ: {bad}" if bad else ""), flush=True)
    dist.destroy_process_group()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
