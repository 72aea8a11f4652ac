"""Spans and the device trace of a ``--trace 1`` run.

:class:`Spans` records host-clock spans that the harness puts around
its calls into the port's layers, so that an idle stretch of the device
can be named by what the host was doing.  :func:`wrap` puts such a span
around a function of the port by its module attribute, for the traced
run only.  :class:`DeviceTrace` runs ``torch.profiler`` over a short
part of the window, recording the device's activity alone, and reduces
it to the device's intervals and the harness's spans, on the profiler's
clock.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from collections import defaultdict

import torch

from . import arith

class Spans:
    """Host-clock spans ``(label, start_s, end_s)``, in memory."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((label, t0, time.perf_counter()))

    def total(self, label: str) -> tuple[float, int]:
        """(seconds, count) of the spans labelled ``label``."""
        ds = [e - s for lab, s, e in self.spans if lab == label]
        return sum(ds), len(ds)


def wrap(spans: Spans, target: str, label: str, sync: bool):
    """Put a span ``label`` around ``module:attr`` (``target``); with
    ``sync`` the span ends at a ``torch.cuda.synchronize()``, so that it
    holds the device work the call enqueued.  Returns the function that
    undoes it."""
    mod_name, attr = target.split(":")
    mod = importlib.import_module(mod_name)
    orig = getattr(mod, attr)

    def spanned(*args, **kwargs):
        with spans.span(label):
            out = orig(*args, **kwargs)
            if sync and torch.cuda.is_available():
                torch.cuda.synchronize()
        return out

    setattr(mod, attr, spanned)
    return lambda: setattr(mod, attr, orig)


def _annotation(e) -> bool:
    """Whether a kineto event is a user annotation (a ``record_function``
    range, which the profiler may also draw on the device's timeline)."""
    kind = e.activity_type() if hasattr(e, "activity_type") else ""
    return e.is_user_annotation() or "annotation" in str(kind)


class DeviceTrace:
    """``torch.profiler`` over [start, stop], reduced to device intervals.

    Only the device's activity is recorded: recording every host
    operation as well slows a host-bound loop and breaks its device work
    at each synchronize, so that much of the idle share read would be the
    profiler's own.  The host clock is put on the profiler's by a marker
    operation that :meth:`start` enqueues on the idle device: the window
    starts at the marker and lasts as long as the host measured it, and
    the harness's host spans move by the same offset.

    After :meth:`stop`: ``window`` (start, end) on the profiler's clock in
    seconds, ``device`` the device operations ``(name, start, end)``,
    ``host`` the harness's spans ``(label, start, end)`` there."""

    def __init__(self, spans: Spans | None = None):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.spans = spans
        self.window = (0.0, 0.0)
        self.device: list[tuple[str, float, float]] = []
        self.host: list[tuple[str, float, float]] = []
        self.items = 0

    def start(self):
        torch.cuda.synchronize()
        self.prof.start()
        self._t0 = time.perf_counter()
        torch.empty(1, device="cuda").fill_(1.0)  # the marker

    def stop(self, items: int):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.prof.stop()
        self.items = items
        cpu = torch.autograd.DeviceType.CPU
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != cpu and not _annotation(e):
                s = e.start_ns() * 1e-9
                self.device.append((e.name(), s, s + e.duration_ns() * 1e-9))
        if not self.device:
            raise RuntimeError("the profiler recorded no device operation in the traced "
                               "window: no device number can be read from it")
        self.device.sort(key=lambda d: d[1])
        origin = self.device[0][1] - self._t0  # the marker's start, less the host's
        self.window = (self._t0 + origin, t1 + origin)
        spans = self.spans.spans if self.spans is not None else []
        self.host = [(lab, s + origin, e + origin) for lab, s, e in spans
                     if e > self._t0 and s < t1]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return arith.busy([(s, e) for _, s, e in self.device], *self.window)

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device operations that took the most time in the
        window, summed by name."""
        tot: dict = defaultdict(float)
        lo, hi = self.window
        for name, s, e in self.device:
            if e > lo and s < hi:
                tot[name[:160]] += min(e, hi) - max(s, lo)
        return sorted(([n, t] for n, t in tot.items()), key=lambda x: -x[1])[:k]

    def idle_by_span(self, k: int = 10) -> list:
        """The device's idle time in the window, summed by the innermost
        harness span the host was in at each gap's middle."""
        tot: dict = defaultdict(float)
        cnt: dict = defaultdict(int)
        for s, e in arith.gaps([(a, b) for _, a, b in self.device], *self.window):
            mid = 0.5 * (s + e)
            inside = [(hs, lab) for lab, hs, he in self.host if hs <= mid < he]
            lab = max(inside)[1] if inside else "outside the harness's spans"
            tot[lab] += e - s
            cnt[lab] += 1
        rows = sorted(((lab, t) for lab, t in tot.items()), key=lambda x: -x[1])[:k]
        return [[f"{lab} ({cnt[lab]} gaps)", t] for lab, t in rows]
