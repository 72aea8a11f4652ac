"""Phase-labelled timing spans and benchmark timing helpers (the port of
the JAX package's ``utils/timing.py``).

The reference's profiling toolbox: the ``-Dprofiling``
``time_in_mill_now()`` spans (nlibs/tools/ntimer.cc:3-9) and the
cudaEvent RAII timer (nlibs/gpus/timer.h:32-56).  CUDA work is
asynchronous, so a span synchronises the card of the tensors it is
given, where the reference blocks on its arrays.

:data:`TRACE` is the port's tracer: spans at the boundaries of the
R-MCL job, the block and warm SpGEMM calls and every read from the card
(``host_read``), recorded while a ``torch.profiler`` session records.
A span's device time is not taken here: the profiler's trace puts each
kernel down to the span whose host interval holds its launch.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch


def time_in_mill_now() -> float:
    """Wall-clock in milliseconds (ntimer.cc:3-9 parity)."""
    return time.monotonic() * 1e3


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif hasattr(x, "__dataclass_fields__"):
        for name in x.__dataclass_fields__:
            yield from _tensors(getattr(x, name))


def block_until_ready(x):
    """Wait for the card(s) that hold the tensors in ``x`` (a tensor, or
    a dict, list, tuple or dataclass of them); CPU tensors need no wait.
    Returns ``x``."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return x


@dataclass(slots=True)
class SpanRecord:
    """One finished span: ``start`` and ``end`` on ``time.perf_counter``
    (seconds); ``parent`` the id of the span it opened in (0 at the top);
    ``trace`` the id that every span under one top-level span shares (one
    entry call: an ``rmcl`` job, a ``block_spgemm`` or ``spgemm_ell``
    call); ``nbytes`` the bytes a ``read.*`` span copied to the host."""

    name: str
    start: float
    end: float
    id: int
    parent: int
    trace: int
    nbytes: int = 0

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e3


# a range of torch.profiler for each span, so that the spans show in a
# Chrome trace beside the kernels they launched (the fast form where
# this torch has it)
_RANGE = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
          or torch.profiler.record_function)
_OFF = contextlib.nullcontext()


def _waited(cuda: bool, copy, *args):
    """``copy(*args)``, a copy between the card and the host that waits
    for the card; on the card it runs with the CUDA sync-debug mode
    lifted, since that wait is one the caller means to make."""
    mode = torch.cuda.get_sync_debug_mode() if cuda else 0
    if not mode:
        return copy(*args)
    torch.cuda.set_sync_debug_mode(0)
    try:
        return copy(*args)
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _to_host(t: torch.Tensor):
    # a scalar through pinned memory, as int(t) reads it; else t.cpu()
    return t.item() if t.dim() == 0 else t.cpu()


class _Span:
    __slots__ = ("prof", "name", "block_on", "nbytes", "id", "parent", "trace", "rng", "t0")

    def __init__(self, prof: "Profiler", name: str, block_on):
        self.prof, self.name, self.block_on, self.nbytes = prof, name, block_on, 0

    def __enter__(self):
        p = self.prof
        p._ids += 1
        if p._open:
            self.parent, self.trace = p._open[-1]
        else:
            p._traces += 1
            self.parent, self.trace = 0, p._traces
        self.id = p._ids
        p._open.append((self.id, self.trace))
        self.rng = _RANGE(self.name)
        self.rng.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            if self.block_on is not None:
                block_until_ready(self.block_on() if callable(self.block_on) else self.block_on)
        finally:
            t1 = time.perf_counter()
            self.rng.__exit__(None, None, None)
            p = self.prof
            p._open.pop()
            p.records.append(SpanRecord(self.name, self.t0, t1, self.id, self.parent,
                                        self.trace, self.nbytes))
        return False


@dataclass
class Profiler:
    """Named spans and counters: the port's tracer.

    ``enabled`` records always (the reference's -Dprofiling builds);
    ``follow`` records while a ``torch.profiler`` session records, as an
    operator's ``SMF_PROFILE_DIR`` run or a benchmark's traced window
    does.  While it records, each span is also a ``torch.profiler``
    range.  While it does not, a span costs one check and records
    nothing: it never synchronizes and allocates nothing.

    A span times the host (``time.perf_counter``).  ``block_on`` (tensors,
    or a callable that returns them at the span's exit, so that a span
    can wait for what it produced) makes it end at a synchronize of their
    card.  The spans of one thread nest; :data:`TRACE` is the port's
    instance, which every path records into.  ``records`` and
    ``counters`` grow while it records, until :meth:`clear`."""

    enabled: bool = True
    follow: bool = False
    records: list = field(default_factory=list)  # SpanRecord, in the order they closed
    counters: list = field(default_factory=list)  # (name, perf_counter s, n, trace)
    _open: list = field(default_factory=list, repr=False)  # (id, trace) of the open spans
    _ids: int = 0
    _traces: int = 0

    def on(self) -> bool:
        return self.enabled or (self.follow and torch.autograd._profiler_enabled())

    def span(self, name: str, block_on=None):
        if not self.on():
            return _OFF
        return _Span(self, name, block_on)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``, at this time and under the
        open span's trace id (0 outside every span)."""
        if self.on():
            trace = self._open[-1][1] if self._open else 0
            self.counters.append((name, time.perf_counter(), n, trace))

    def host_read(self, site: str, t: torch.Tensor):
        """``t`` on the host: ``t.item()`` for a 0-d tensor, else
        ``t.cpu()``.  A read from the card, which waits for it as the copy
        always did and adds no other synchronize.  While recording: a span
        ``read.<site>`` that holds the wait and the bytes, and one on the
        counter ``reads``."""
        if not self.on():
            return _waited(t.is_cuda, _to_host, t)
        with self.span("read." + site) as s:
            out = _waited(t.is_cuda, _to_host, t)
            s.nbytes = t.numel() * t.element_size()
            self.count("reads")
        return out

    def host_write(self, site: str, a: np.ndarray, device) -> torch.Tensor:
        """``a`` copied to ``device`` from pageable host memory (a copy
        that waits for the card); while recording, a span
        ``write.<site>`` that holds it and its bytes."""
        device = torch.device(device)
        cuda = device.type == "cuda"
        if not self.on():
            return _waited(cuda, torch.from_numpy(a).to, device)
        with self.span("write." + site) as s:
            s.nbytes = a.nbytes
            return _waited(cuda, torch.from_numpy(a).to, device)

    def between(self, t0: float, t1: float) -> list:
        """The spans that lie inside [t0, t1] (``perf_counter`` s)."""
        return [r for r in self.records if r.start >= t0 and r.end <= t1]

    def counted(self, name: str, t0: float, t1: float) -> int:
        """The counter ``name`` summed over [t0, t1]."""
        return sum(n for c, t, n, _ in self.counters if c == name and t0 <= t <= t1)

    def clear(self) -> None:
        self.records.clear()
        self.counters.clear()

    @property
    def spans(self) -> dict:
        """Milliseconds of each span, by name."""
        out: dict = {}
        for r in self.records:
            out.setdefault(r.name, []).append(r.ms)
        return out

    def report(self) -> str:
        return "\n".join(
            f"{name}: n={len(times)} total={sum(times):.3f}ms "
            f"mean={sum(times) / len(times):.3f}ms"
            for name, times in self.spans.items()
        )


def self_seconds(records) -> dict:
    """Each span's self time (id -> seconds): its duration less that of
    its children, which lie inside it and one after another."""
    own = {r.id: r.end - r.start for r in records}
    for r in records:
        if r.parent in own:
            own[r.parent] -= r.end - r.start
    return own


# The port's tracer: off until a torch.profiler session records or it is
# enabled by hand (TRACE.enabled = True).
TRACE = Profiler(enabled=False, follow=True)


def bench_fn(fn, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median wall-clock milliseconds of ``fn(*args)``, each call waited
    for (the warm-up + timed-repeats pattern of perfTests/only-somp.cc)."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.monotonic()
        block_until_ready(fn(*args))
        times.append((time.monotonic() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def slope_bench(step, ks=(1, 4), iters: int = 3) -> float:
    """Steady-state ms per call of ``step()`` on the current card by slope
    timing: for each k in ``ks``, k calls between two CUDA events, the
    median of ``iters`` runs; returns (T(k2) - T(k1)) / (k2 - k1), in
    which the fixed cost of a run cancels.  The reference repeats its
    step inside one jitted ``lax.scan`` (``utils/timing.py:71-117``);
    here a loop enqueues the k calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("slope_bench times the CUDA card; there is none")
    times = {}
    for k in ks:
        step()  # warm
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(k):
                step()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        ts.sort()
        times[k] = ts[len(ts) // 2]
    k1, k2 = ks
    return max((times[k2] - times[k1]) / (k2 - k1), 1e-3)
