"""The static R-MCL's own spans (``models/rmcl_ell.py``: ``rmcl_ell``,
``.plan``, ``.load``, ``.scan``, and in each step run eagerly
``rmcl_ell.step`` with its phases) in a traced window, for the
``ell_*`` metric readers.  Each returns None where the window holds no
such span: a run without ``--trace 1``, or a port whose ``rmcl_ell``
records none."""

from __future__ import annotations

import bisect

from portbench import portspans

STEP = "rmcl_ell.step"
PHASES = ("gather", "tile", "select", "hub", "drift")


def view(rec, name: str):
    """``portspans.view(rec)`` where it holds a span ``name``, else None."""
    v = portspans.view(rec)
    return v if v is not None and v.named(name) else None


def launched_in(v, name: str) -> float:
    """Device seconds of the operations launched inside a span ``name``,
    at any depth under it (a CUDA graph's kernels count where the graph
    was launched)."""
    spans = sorted((s, e) for _, s, e in v.named(name))
    starts = [s for s, _ in spans]
    total = 0.0
    for _, s, e, launch in v.ops:
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch < spans[i][1]:
            total += e - s
    return total


def scan_ms(rec):
    """Device ms an iteration launched inside ``rmcl_ell.scan`` (eager
    steps and graph replays alike): their device time ÷ the scans ×
    ``work["iters"]``."""
    v = view(rec, "rmcl_ell.scan")
    if v is None or "iters" not in rec.work:
        return None
    return launched_in(v, "rmcl_ell.scan") * 1e3 / (len(v.named("rmcl_ell.scan"))
                                                    * rec.work["iters"])


def phase_ms(rec, phase: str, label: str):
    """Device ms an eagerly run step launched inside
    ``rmcl_ell.step.<phase>`` (innermost span) ÷ the ``rmcl_ell.step``
    spans, None where that phase launched nothing; its note (``label``)
    gives every phase and the step's own launches."""
    v = view(rec, STEP)
    if v is None:
        return None
    dev = v.device_s_by_span()
    if f"{STEP}.{phase}" not in dev:
        return None
    steps = len(v.named(STEP))
    parts = ", ".join(f"{p} {dev.get(f'{STEP}.{p}', 0.0) * 1e3 / steps:.3f}"
                      for p in PHASES)
    rec.notes.append(f"{label}: device ms an eagerly run step by phase over {steps} steps: "
                     f"{parts}; the step's own {dev.get(STEP, 0.0) * 1e3 / steps:.3f}")
    return dev[f"{STEP}.{phase}"] * 1e3 / steps
