"""The check that decides ``correct`` fails a broken program: each fault a
cell can have, planted in the port underneath a whole run (the look for
a card skipped: the CPU, small sizes), and the control, the reference in
TF32 put in the program's place.  The last test runs the control at the
cells' own sizes on the card."""

import dataclasses
import importlib

import pytest
import torch

from portbench import calibrate, harness

PKG = "sparse_matrix_with_flops_tpu_torch"
FEW = {"pool": 2, "sample_from": 3, "sample": 2}
# the static mix (traffic/rmcl-static.json), which no cell runs yet, on
# the general cell's graphs and limits
STATIC = "graph500-s13.rmcl-general+static"
SMALL = {"graph500-s16.spgemm-warm": {"config": {"scale": 9}},
         "band-62451.spgemm-warm": {"config": {"rows": 2000}},
         "graph500-s13.rmcl-general": {"config": {"scale": 8}, "traffic": FEW},
         STATIC: {"config": {"scale": 8},
                  "traffic": {**harness.load_json(harness.HERE, "traffic", "rmcl-static.json"),
                              **FEW}}}
SPGEMM = ("graph500-s16.spgemm-warm", "band-62451.spgemm-warm")
RMCL = ("graph500-s13.rmcl-general", STATIC)
CARD = ("graph500-s16.spgemm-warm", "band-62451.spgemm-warm", "graph500-s13.rmcl-general")


def _run(cell):
    out, _ = harness.run_cell(cell.split("+")[0], 2**31 + 3, 0.3, False, "cpu",
                              overrides=SMALL[cell])
    return out


def _csr(x):
    return importlib.import_module(f"{PKG}.formats.csr").CSR(*x)


def _half(c):
    """The rows from the middle on left out (empty)."""
    rp = c.row_ptr.clone()
    rp[rp.shape[0] // 2:] = rp[rp.shape[0] // 2]
    return _csr((rp, c.col_ind, c.values, c.ncols))


def _altered(c, factor):
    """One value of the answer altered: its largest."""
    v = c.values.clone()
    v[int(torch.argmax(v[: int(c.row_ptr[-1])].abs()))] *= factor
    return _csr((c.row_ptr, c.col_ind, v, c.ncols))


def _skewed(c):
    """A job's answer altered as a whole: every value off by 1e-3, up
    and down in turn (a clustering is compared by the 99th percentile of
    its rows' distances from the reference: see PERF.md)."""
    v = c.values.clone()
    v[0::2] *= 1.0 + 1e-3
    v[1::2] *= 1.0 - 1e-3
    return _csr((c.row_ptr, c.col_ind, v, c.ncols))


def _patch_spgemm(monkeypatch, cell, fault):
    mod, attr = ((f"{PKG}.ops.ell_esc", "spgemm_ell") if cell.startswith("graph500")
                 else (f"{PKG}.ops.block_spgemm", "block_spgemm"))
    m = importlib.import_module(mod)
    orig = getattr(m, attr)
    prev = []

    def broken(a, b, plan):
        c = orig(a, b, plan)
        if fault == "unchanged":  # every call returns the call before's product
            prev.append(c)
            return prev[-2] if len(prev) > 1 else c
        return _half(c) if fault == "half" else _altered(c, 1.0 + 1e-3)

    monkeypatch.setattr(m, attr, broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", SPGEMM)
def test_a_broken_multiply_is_not_correct(monkeypatch, cell, fault):
    _patch_spgemm(monkeypatch, cell, fault)
    out = _run(cell)
    assert out["correct"] is False, out["checks"]


def _patch_rmcl(monkeypatch, cell, fault):
    static = cell.endswith("static")
    if fault == "unchanged":  # a step that hands back the iterate it was given
        m = importlib.import_module(f"{PKG}.models.{'rmcl_ell' if static else 'rmcl'}")
        if static:
            orig = m.rmcl_ell_step

            def step(plan, a, adh, cols, vals):
                return (cols, vals, orig(plan, a, adh, cols, vals)[2])
            monkeypatch.setattr(m, "rmcl_ell_step", step)
        else:
            orig = m.rmcl_one_step
            monkeypatch.setattr(m, "rmcl_one_step",
                                lambda mgt, mt, pc, cc: (mt, orig(mgt, mt, pc, cc)[1]))
        return
    change = _half if fault == "half" else _skewed
    if static:
        m = importlib.import_module(f"{PKG}.models.rmcl_ell")
        orig = m.rmcl_ell
        monkeypatch.setattr(m, "rmcl_ell", lambda *a, **k: (change(orig(*a, **k)[0]), {}))
    else:
        m = importlib.import_module(f"{PKG}.models.rmcl")
        orig = m.rmcl

        def broken(*a, **k):
            res = orig(*a, **k)
            return dataclasses.replace(res, mt=change(res.mt))
        monkeypatch.setattr(m, "rmcl", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", RMCL)
def test_a_broken_clustering_is_not_correct(monkeypatch, cell, fault):
    _patch_rmcl(monkeypatch, cell, fault)
    out = _run(cell)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", SPGEMM + RMCL)
def test_the_control_fails_the_limits_and_the_program_meets_them(cell):
    name = cell.split("+")[0]
    limits = harness.load_cell(name)[3]
    for seed in (1, 2):
        ctl = calibrate.readings(name, seed, True, "cpu", overrides=SMALL[cell])
        assert not harness.judge(ctl["numbers"], limits)[0], ctl
        prog = calibrate.readings(name, seed, False, "cpu", overrides=SMALL[cell])
        assert harness.judge(prog["numbers"], limits)[0], prog


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CARD)
def test_the_control_fails_at_the_cells_size_on_the_card(cell):
    limits = harness.load_cell(cell)[3]
    for seed in (11, 12, 13):
        ctl = calibrate.readings(cell, seed, True, "cuda")
        assert ctl["compared"] and not harness.judge(ctl["numbers"], limits)[0], ctl
    prog = calibrate.readings(cell, 14, False, "cuda")
    assert harness.judge(prog["numbers"], limits)[0], prog
    torch.cuda.empty_cache()
