"""Phase-labelled timing spans and benchmark timing helpers (the port of
the JAX package's ``utils/timing.py``).

The reference's profiling toolbox: the ``-Dprofiling``
``time_in_mill_now()`` spans (nlibs/tools/ntimer.cc:3-9) and the
cudaEvent RAII timer (nlibs/gpus/timer.h:32-56).  CUDA work is
asynchronous, so a span synchronises the card of the tensors it is
given, where the reference blocks on its arrays.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

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


@dataclass
class Profiler:
    """Named phase spans; enable like the reference's -Dprofiling builds."""

    enabled: bool = True
    spans: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str, block_on=None):
        # block_on is evaluated at entry, so it can only synchronise on
        # tensors that exist before the span; block inside the span for
        # tensors produced by it
        if not self.enabled:
            yield
            return
        t0 = time.monotonic()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            self.spans.setdefault(name, []).append((time.monotonic() - t0) * 1e3)

    def report(self) -> str:
        return "\n".join(
            f"{name}: n={len(times)} total={sum(times):.3f}ms "
            f"mean={sum(times) / len(times):.3f}ms"
            for name, times in self.spans.items()
        )


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
