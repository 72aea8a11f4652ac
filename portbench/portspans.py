"""The port's own spans and counters in a ``--trace 1`` run, on the
device trace's clock.

The port records its spans (``utils.timing.TRACE``) while a
``torch.profiler`` session records, so a traced run holds them for the
traced window, on the host's ``time.perf_counter``.  They are put on
the profiler's clock by one offset, taken from the reads: each port
read (``read.*``) launches its copy to the host as it starts, and the
trace holds the copy's CUDA-runtime call, so the offset is bounded by
each copy's launch less its read's start (:func:`_offset`).  The copies
are first paired with the reads by the offset that puts the most
copies within ``TOL_S`` of their read's start, among those that put one
of the trace's first copies at the start of one of its first reads.
(The marker's launch less the window's host start, which the harness's
offset is near, comes out late by the profiler's cost of the first
operation after it starts: 60 us to 2 ms on an H100.)  Each device
operation is put down to the innermost port span whose host interval
holds its launch (the runtime or driver call of the same correlation
id), and each idle gap of the device to the innermost port span the host
was in at its middle, as ``DeviceTrace.idle_by_span`` does with the
harness's spans.

:func:`view` returns None where there is nothing to read: no trace (a
run without ``--trace 1``, or on the CPU), a port without the tracer, or
no port span in the window.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

try:
    from sparse_matrix_with_flops_tpu_torch.utils.timing import TRACE
except ImportError:  # a port that records no spans of its own: nothing to read
    TRACE = None

from . import arith
from .trace import _annotation

TOL_S = 50e-6  # the clock check's tolerance
OUTSIDE = "outside the port's spans"


class View:
    """The port's spans of one traced window on the profiler's clock:
    ``spans`` (SpanRecord, start, end) sorted by start; ``reads`` the
    ``reads`` counter over the window; ``ops`` the device operations
    ``(name, start, end, launch)`` (``launch`` None where the trace holds
    no launch of it); ``origin`` the offset added to host times."""

    def __init__(self, trace, records, reads: int, ops: list, origin: float):
        self.trace = trace
        self.items = trace.items
        self.spans = sorted(((r, r.start + origin, r.end + origin) for r in records),
                            key=lambda x: x[1])
        self._starts = [s for _, s, _ in self.spans]
        self._tops = {x[0].trace: x for x in self.spans if x[0].parent == 0}
        self.reads = reads
        self.ops = ops
        self.origin = origin

    def innermost(self, t: float):
        """The innermost span whose interval holds ``t`` (the one of them
        that started last), or None."""
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0:
            r, s, e = self.spans[i]
            if e > t:
                return self.spans[i]
            i -= 1
        return None

    def named(self, name: str) -> list:
        return [x for x in self.spans if x[0].name == name]

    def device_s_by_span(self) -> dict:
        """Device seconds of the operations launched in each span
        (innermost), by span name."""
        tot: dict = defaultdict(float)
        for _, s, e, launch in self.ops:
            hit = self.innermost(launch) if launch is not None else None
            tot[hit[0].name if hit else OUTSIDE] += e - s
        return dict(tot)

    def idle_by_span(self, k: int = 10) -> tuple[list, float]:
        """The device's idle time in the window, summed by the innermost
        port span the host was in at each gap's middle: the ``k`` largest
        ``[label (n gaps), seconds]``, and the share of all idle time that
        fell inside some port span."""
        tot: dict = defaultdict(float)
        cnt: dict = defaultdict(int)
        idle = inside = 0.0
        for s, e in arith.gaps([(a, b) for _, a, b in self.trace.device], *self.trace.window):
            hit = self.innermost(0.5 * (s + e))
            lab = hit[0].name if hit else OUTSIDE
            tot[lab] += e - s
            cnt[lab] += 1
            idle += e - s
            inside += (e - s) if hit else 0.0
        rows = sorted(tot.items(), key=lambda x: -x[1])[:k]
        return [[f"{lab} ({cnt[lab]} gaps)", t] for lab, t in rows], (inside / idle if idle
                                                                        else 1.0)

    def clock_check(self) -> dict:
        """The mapping's check on the reads, whose copies to the host the
        trace holds: each read's copy is launched inside the read's span
        (how far the nearest copy's launch lies outside it), and the read
        returns after that copy and every operation its request launched
        before it have ended (how far the latest of them ends after it).
        The worst of each over the reads, in seconds: within ``TOL_S``
        the mapping holds."""
        copies = sorted(launch for name, _, _, launch in self.ops
                        if launch is not None and "DtoH" in name)
        ends = sorted((launch, e, name) for name, _, e, launch in self.ops if launch is not None)
        launches = [x[0] for x in ends]
        outside = after = float("-inf")
        n = 0
        for r, s, e in self.spans:
            if not r.name.startswith("read."):
                continue
            n += 1
            i = bisect.bisect_left(copies, s)
            near = [copies[j] for j in (i - 1, i) if 0 <= j < len(copies)]
            if near:
                outside = max(outside, min(max(s - c, c - e, 0.0) for c in near))
            top = self._tops.get(r.trace, (None, s, e))
            lo, hi = bisect.bisect_left(launches, top[1]), bisect.bisect_right(launches, e)
            for launch, end, name in ends[lo:hi]:
                if launch < s or "DtoH" in name:
                    after = max(after, end - e)
        return {"reads": n, "copy_outside_read_s": outside, "op_after_read_s": after}


def _device_ops(trace):
    """The trace's device operations with their launch times, and the
    marker's launch (None where the trace holds none)."""
    cpu = torch.autograd.DeviceType.CPU
    dev, calls = [], {}
    for e in trace.prof.profiler.kineto_results.events():
        if _annotation(e):
            continue
        corr = e.correlation_id()
        s = e.start_ns() * 1e-9
        if e.device_type() != cpu:
            dev.append((e.name(), s, s + e.duration_ns() * 1e-9, corr))
        elif corr and e.name().startswith("cu"):  # a CUDA runtime or driver call
            calls.setdefault(corr, s)
    dev.sort(key=lambda d: d[1])
    ops = [(name, s, e, calls.get(corr)) for name, s, e, corr in dev]
    marker = ops[0][3] if ops else None
    return ops, marker


def _offset(reads: list, copies: list, coarse: float) -> float:
    """The offset from the reads ``(start, end)`` (host) and the copies'
    launches (profiler clock), both sorted; ``coarse`` where there are
    none.  A read's copy is launched after the read starts, so the
    offset is at most the least launch less read start over the paired
    reads: that bound, late by the few microseconds of Python and
    dispatch before the copy's launch."""
    if not reads or not copies:
        return coarse

    def held(o):  # the reads whose copy is launched within TOL_S of their start
        out = []
        for s, e in reads:
            i = bisect.bisect_left(copies, s + o)
            if i < len(copies) and copies[i] <= min(e, s + TOL_S) + o:
                out.append(copies[i] - s)
        return out

    best = max((held(c - s) for s, _ in reads[:8] for c in copies[:16]), key=len)
    return min(best) if best else coarse


def view(rec) -> View | None:
    """The port's spans of ``rec``'s traced window (cached on the
    trace), or None where there is nothing to read."""
    tr = rec.trace
    if TRACE is None or tr is None or not tr.items or not hasattr(tr, "prof"):
        return None
    cached = getattr(tr, "_port_view", None)
    if cached is not None:
        return cached
    t0 = tr._t0
    records = TRACE.between(t0, t0 + tr.window_s)
    if not records:
        return None
    ops, marker = _device_ops(tr)
    reads = sorted((r.start, r.end) for r in records if r.name.startswith("read."))
    copies = sorted(launch for name, _, _, launch in ops if launch is not None and "DtoH" in name)
    origin = _offset(reads, copies, (marker if marker is not None else tr.window[0]) - t0)
    v = View(tr, records, TRACE.counted("reads", t0, t0 + tr.window_s), ops, origin)
    tr._port_view = v
    return v
