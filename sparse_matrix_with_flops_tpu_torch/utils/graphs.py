"""Compile once, dispatch once: CUDA graphs, the port's counterpart of
the JAX package's jitted programs (``jax.jit`` of a ``lax.scan``, the
jitted warm ``_tiles_impl``).

A :class:`CapturedBody` holds a body function and the static tensors it
reads.  On the card it runs the body eagerly until one policy,
:func:`captures`, says that the replays to come repay a capture; that
run is eager too and then captures the body, and every later run
replays the capture.  A graph and its memory pool belong to a plan
(:func:`bound` keeps them in the plan's
``__dict__``, as the plans' device uploads are kept) and are freed with
it: there is no global cache.  A body refers to its plan through a weak
reference, so that the plan, its graphs and their pools go as soon as
the caller drops the plan.

On the CPU nothing is captured or kept: :func:`bound` builds the body
over the caller's own tensors and every run calls it.

A program of a process mesh (one rank a process, ``parallel/peer.py``)
runs on every rank at once, its K6 / K8 launches waiting on the other
ranks' flags: every rank must capture at the same run, or a rank that
replays would wait on a neighbour that runs eagerly until the flag wait
traps.  So the policy reads only what every rank holds alike (the runs
spent on a key and the runs left in the call), never a time.  Such a
body's first run on the card is always eager (it makes the peer sets,
collectively, which a capture cannot), and :func:`drop_process_graphs`
frees every graph of such bodies before the sets are unmapped.
"""

from __future__ import annotations

import os
import time
import traceback
import weakref

import torch

from .. import _build

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# device index -> the side stream captures run on (a capture may not run
# on the legacy default stream)
_SIDE: dict = {}
# the process-mesh bodies that hold a graph (their graphs hold peer pointers)
_PROCESS = weakref.WeakSet()

# The break-even count of each program: the runs on one key after which
# its graph has paid for its capture, 1 + capture / (eager - replay)
# rounded up (``ring_probe.py capture`` at R-MAT s14 on an NVIDIA H100
# 80GB HBM3, 700.00 W power limit), the median of three runs' counts:
# one capture's host time spreads widely, from run to run too.  The
# sharded scan's count is the largest of its four exchanges'.  A program
# whose replay saves nothing keeps no graph (the general ``rmcl_scan``);
# a body not named here (a probe) captures at its first run.  The
# ``_process`` programs (the sharded scan and the warm ring SpGEMM on a
# process mesh) take their counts from a process mesh of one rank on one
# card (``ring_probe.py capture one-rank``: the layout of a rank that owns
# its card).  On two processes time-sharing one card a replay saves -10%
# to +18% of the eager step (the card, not the host, bounds both), so
# there the graph barely repays its capture.
BREAK_EVEN = {
    "spgemm_ell": 15,  # runs: 15, 17, 7
    "rmcl_ell_scan": 7,  # runs: 7, 7, 6
    "sharded_rmcl_ell_scan": 12,  # runs: 15, 5, 12
    "sharded_spgemm_ring": 5,  # runs: 5, 8, 5
    "spgemm_binned": 22,  # runs: 20, 24, 22
    "sharded_rmcl_ell_scan_process": 27,  # runs: 27, 34, 18
    "sharded_spgemm_ring_process": 25,  # runs: 25, 24, 40
}


def keeps(device) -> bool:
    """Whether programs on ``device`` are kept and captured (the card),
    or built over the caller's tensors and run eagerly (the CPU)."""
    return device.type == "cuda"


def captures(spent: int, left: int, b: int) -> bool:
    """The capture policy of a body that holds no graph: capture at this
    run when the eager runs already spent on its key (``spent``) and the
    runs its call still makes, this one included (``left``), reach the
    break-even count ``b``.  So a scan of ``b`` or more iterations
    captures at its first, a shorter one on a fresh key captures nothing,
    repeated short calls capture once their eager runs add up, and a
    one-shot program (``left`` 1) captures at its ``b``-th call on a key:
    the ski-rental rule, under which no caller pays more than about twice
    the cheaper of always eager and capturing at once."""
    return spent + left >= b


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


def _failure(name: str, stage: str, exc: BaseException) -> RuntimeError:
    """The error of a body that cannot be captured, naming the line of the
    port that broke it (the first error of the chain: a failed capture
    also fails its end)."""
    first = exc
    while first.__context__ is not None:
        first = first.__context__
    ours = [f for f in traceback.extract_tb(first.__traceback__)
            if f.filename.startswith(_PKG) and not f.filename.endswith("graphs.py")]
    at = ""
    if ours:
        f = ours[-1]
        at = f" at {os.path.relpath(f.filename, os.path.dirname(_PKG))}:{f.lineno} ({f.line})"
    return RuntimeError(f"{name}: {stage} failed{at}: {type(first).__name__}: {first}")


class CapturedBody:
    """``body()`` captured once into a CUDA graph and replayed.

    ``inputs`` are static tensors the body reads: :meth:`load` copies a
    call's arguments into them, device to device, so that any inputs of
    their shapes work, as a jitted function takes any arrays of the
    shapes it was traced at.  ``state`` holds other static tensors of the
    caller (a scan's carried iterate and history).

    On the card :meth:`run` counts the eager runs it makes (``spent``)
    and runs the body eagerly until :func:`captures` says to capture.
    The capturing run runs the body eagerly under
    ``torch.cuda.set_sync_debug_mode("error")``: that run builds the
    kernels, the cuBLAS handles and the allocator's blocks, and its
    result is the run's own.  Then the body is captured on a side
    stream into a private memory pool, by ``capture_begin`` /
    ``capture_end`` alone: no device synchronize and no emptying of the
    allocator's cache first, so a capture costs about the host time of
    one eager run; a capture that runs out of memory gives the cache back
    and is made once more.  Every later run replays the graph and
    returns clones of the captured outputs, so that the next replay
    cannot overwrite a tensor the caller holds.  A body that reads the
    card from the host, or a capture that fails, raises with the line
    that broke it: there is no eager fallback.

    ``process``: a program of a process mesh (see the module): its first
    run on the card never captures, and :func:`drop_process_graphs` can
    release its graph.

    A replay runs no Python, so every replay adds the launches that the
    capture recorded to each kernel wrapper's ``launches``
    (``_build.WRAPPERS``); the capture itself launches nothing and
    counts nothing.  ``pool_bytes`` is the memory the capture took into
    the graph's private pool, held while the graph lives; ``capture_ms``
    the host time of the capture."""

    def __init__(self, name: str, body, inputs, state=None, process: bool = False):
        self.name = name
        self.process = process  # a process-mesh program: first run eager, see the module
        self.body = body
        self.inputs = tuple(inputs)
        self.state = state
        self.device = self.inputs[0].device
        self.graph = None
        self.outputs = None
        self.launches: dict = {}  # wrapper -> launches one replay makes
        self.pool_bytes = 0
        self.capture_ms = 0.0
        self.replays = 0
        self.spent = 0  # eager runs on the card

    def load(self, *values: torch.Tensor) -> None:
        """Copy a call's inputs into the static ones (same shapes and
        dtypes; ``copy_`` would broadcast silently)."""
        if len(values) != len(self.inputs):
            raise ValueError(f"{self.name}: {len(values)} inputs for {len(self.inputs)}")
        for i, (dst, src) in enumerate(zip(self.inputs, values)):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"{self.name}: input {i} is {src.dtype} "
                                 f"{tuple(src.shape)}, the plan's {dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)

    def run(self, left: int = 1):
        """The body's outputs: replayed where a graph is held; else the
        body run eagerly, and on the card captured after that run where
        :func:`captures` says so, ``left`` the runs this call still
        makes, this one included."""
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            for w, n in self.launches.items():
                w.launches += n
            return _clone(self.outputs)
        if not keeps(self.device):
            return self.body()
        take = (captures(self.spent, left, BREAK_EVEN.get(self.name, 1))
                and not (self.process and self.spent == 0))
        self.spent += 1
        return self._capture() if take else self.body()

    def _capture(self):
        prev = torch.cuda.get_sync_debug_mode()
        side = _SIDE.get(self.device.index)
        if side is None:
            side = _SIDE[self.device.index] = torch.cuda.Stream(self.device)
        try:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = self.body()
            except RuntimeError as e:
                raise _failure(self.name, "the eager run before capture", e) from e
            torch.cuda.set_sync_debug_mode(0)  # a read under capture fails the capture
            t0 = time.perf_counter()
            for attempt in range(2):
                try:
                    self._record(side)
                    break
                except torch.OutOfMemoryError as e:
                    if attempt:
                        raise _failure(self.name, "CUDA graph capture", e) from e
                except RuntimeError as e:
                    raise _failure(self.name, "CUDA graph capture", e) from e
                # Out of memory inside a capture, where the allocator cannot
                # give its cached blocks back (outside one it would, and try
                # again): the failed attempt is gone with its exception, so
                # give them back here and capture once more.
                torch.cuda.empty_cache()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        return out

    def _record(self, side) -> None:
        """One capture of the body on ``side`` into a new private pool;
        the wrappers' counts are put back as they were."""
        wrappers = tuple(_build.WRAPPERS)
        here = torch.cuda.current_stream(self.device)
        graph = torch.cuda.CUDAGraph()
        before = [w.launches for w in wrappers]
        reserved = torch.cuda.memory_reserved(self.device)
        side.wait_stream(here)
        try:
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    outputs = self.body()
                finally:
                    graph.capture_end()
        finally:
            after = [w.launches for w in wrappers]
            for w, n in zip(wrappers, before):
                w.launches = n
        here.wait_stream(side)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.launches = {w: a - b for w, a, b in zip(wrappers, after, before) if a != b}
        self.graph, self.outputs = graph, outputs
        if self.process:
            _PROCESS.add(self)

    def release(self) -> None:
        """Free the graph and its pool; the next run is eager, as a fresh
        body's first."""
        self.graph = self.outputs = None
        self.launches = {}
        self.spent = 0


def signature(*tensors: torch.Tensor) -> tuple:
    """Shapes and dtypes of ``tensors``: part of a graph's key."""
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def bound(owner, name: str, static, inputs, build, carried: int = 0,
          fits=None) -> CapturedBody:
    """The body ``name`` for ``inputs``, ready to run: ``build(buffers)``
    makes the :class:`CapturedBody` that reads ``buffers`` in place of
    the inputs.

    On the card ``owner`` (a plan) keeps one such body a name, under a
    key of the device, the inputs' shapes and dtypes and ``static`` (the
    static arguments, as a jitted function's cache key): it is built over
    static copies of the inputs when the owner holds none for this key
    (replacing one made for another key, whose count of eager runs goes
    with it) or when the one it holds does not ``fits`` this call (the
    new one keeps the key's count), and each call's inputs are copied
    into them.  On the CPU it is built over the caller's tensors, the
    last ``carried`` of them cloned (the body writes those), and nothing
    is kept."""
    dev = inputs[0].device
    if not keeps(dev):
        cut = len(inputs) - carried
        return build(list(inputs[:cut]) + [t.clone() for t in inputs[cut:]])
    key = (str(dev), signature(*inputs), static)
    slot = owner.__dict__.setdefault("_graphs", {})
    hit = slot.get(name)
    if hit is None or hit[0] != key or (fits is not None and not fits(hit[1])):
        spent = hit[1].spent if hit is not None and hit[0] == key else 0
        slot.pop(name, None)  # the old graph and its pool go first
        slot[name] = hit = (key, build([torch.empty_like(t) for t in inputs]))
        hit[1].spent = spent
    hit[1].load(*inputs)
    return hit[1]


def held(owner, name: str) -> CapturedBody | None:
    """The graph ``name`` that ``owner`` keeps, if any."""
    hit = owner.__dict__.get("_graphs", {}).get(name)
    return None if hit is None else hit[1]


def drop(owner, name: str) -> None:
    """Free the graph ``name`` of ``owner`` with its pool."""
    owner.__dict__.get("_graphs", {}).pop(name, None)


def drop_process_graphs() -> None:
    """Free the graph of every process-mesh body (``parallel/peer.close_all``
    calls it before the peer sets that the graphs point into go)."""
    for body in list(_PROCESS):
        body.release()
    _PROCESS.clear()


def scan_body(owner, name: str, static, inputs, carried: int, hist, length: int,
              step, process: bool = False) -> CapturedBody:
    """The step of a scan (the counterpart of a jitted ``lax.scan``) for
    ``inputs``, ``static`` its static arguments, the last ``carried``
    inputs the carry.  ``step(*buffers)`` returns the carry's new values
    and a dict of 0-d statistics; the body writes each statistic into its
    history (``hist``: (name, dtype) pairs) at a device-side iteration
    index, copies the carry back and advances the index.

    ``process``: a process-mesh program (:class:`CapturedBody`).  The
    histories hold at least ``length`` iterations; the length is no
    part of the key: a graph kept for a shorter scan is dropped only
    when a call needs more room than its histories have (they grow to
    the next power of two)."""
    room = length if not keeps(inputs[0].device) else 1 << (length - 1).bit_length()

    def build(bufs):
        dev = bufs[0].device
        hists = {k: torch.zeros(room, dtype=dt, device=dev) for k, dt in hist}
        it = torch.zeros(1, dtype=torch.int64, device=dev)

        def body():
            new, stats = step(*bufs)
            for k, h in hists.items():
                h.index_copy_(0, it, stats[k].reshape(1).to(h.dtype))
            for dst, src in zip(bufs[-carried:], new):
                dst.copy_(src)
            it.add_(1)

        return CapturedBody(name, body, bufs,
                            {"hist": hists, "it": it, "carried": carried, "room": room},
                            process)

    return bound(owner, name, static, inputs, build, carried,
                 fits=lambda g: g.state["room"] >= length)


def run_scan(g: CapturedBody, length: int):
    """``length`` iterations of the scan ``g``, its inputs loaded: on the
    card a held graph replays every iteration; else the call captures at
    its first iteration or not at all (:func:`captures` sees the same
    sum at every iteration of a call), and replays the rest after a
    capture.  Returns the final carry and the histories, fresh
    tensors."""
    g.state["it"].zero_()
    for i in range(length):
        g.run(left=length - i)
    carry = g.inputs[-g.state["carried"]:]
    hist = {k: h[:length] for k, h in g.state["hist"].items()}
    if keeps(g.device):  # the graph's own buffers: the next call rewrites them
        carry, hist = _clone(carry), {k: h.clone() for k, h in hist.items()}
    return tuple(carry), hist
