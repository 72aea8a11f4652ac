"""Build, load and launch the port's CUDA kernels.

The kernels in ``csrc/*.cu`` have a plain C interface.  At first use
they are compiled with ``nvcc`` for ``sm_90a``, one compiler process per
source, all started together, and linked into one shared library under
``build/`` at the repository root, loaded with ctypes.  The library is
rebuilt when a source is newer than it.  Nothing here runs at
import: the CPU tests import every module on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
_LIB = os.path.join(BUILD_DIR, "libsmf_kernels.so")
_LOG = os.path.join(BUILD_DIR, "build.log")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argument types before the trailing stream argument;
# each returns the cudaError_t of its launches
_SIGNATURES = {
    # tc, tv, kout, vout, R, W, ncols, presorted
    "smf_sort_dedup_compact": (_P, _P, _P, _P, _I, _I, _I, _I),
    # vals, kout, vout, R, N, ncols
    "smf_compact_nonzero_rows": (_P, _P, _P, _I, _I, _I),
    # src_c, src_v, p0, Q0, p1, Q1, out, nr, W
    "smf_window_gather": (_P, _P, _P, _L, _P, _L, _P, _L, _I),
    # x, out, n, scratch
    "smf_cumsum_i32": (_P, _P, _L, _P),
    # items, n_items, stages, group, splits, n_splits, partial, blocks, b,
    # c, rows, cols, n, br, bc
    "smf_bcsr_spmm": (_P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I),
    # host array of the operands' base addresses, ops, d, words, slice,
    # ctas, flags, epoch
    "smf_ring_all_gather": (_P, _I, _I, _L, _L, _I, _P, _I),
    # host array [4, d] of the ranks' A_rot, B, buffer and C addresses,
    # flags, d, m, lr, n
    "smf_ring_matmul": (_P, _P, _I, _I, _I, _I),
    # ... as smf_ring_matmul, then nt, slots
    "smf_ring_matmul_tiled": (_P, _P, _I, _I, _I, _I, _I, _I),
    # one rank a launch: host array of the rank's operand blocks and every
    # rank's landing buffers, ops, d, rank, words, slice, ctas, flags, the
    # downstream rank's flags, the set's epoch counter, hops
    "smf_ring_all_gather_rank": (_P, _I, _I, _I, _L, _L, _I, _P, _P, _P, _I),
    # one rank a launch: host array [4, d] of addresses as smf_ring_matmul's
    # (every rank's buffer, this rank's A_rot, B and C), flags, the
    # downstream rank's flags, d, m, lr, n, nt, slots, dir, rank, ranks
    # sharing the card, the set's epoch counter
    "smf_ring_matmul_rank": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # values, offsets, offsets are int64, out, runs, warp_per_run
    "smf_run_sums": (_P, _P, _I, _P, _L, _I),
    # meta, items, krow, aval, boff, bcol, bval, out_c, out_v, counts, ncols,
    # tile, warps
    "smf_hub_accumulate": (_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I),
    # key, uval, rows, out_c, out_v, counts, R, W, n, S, vec
    "smf_prune_select": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I),
}
# C entries with no stream that write one int result through a pointer
_QUERIES = {
    "smf_ring_all_gather_ctas": (_I, _P),  # d -> CTAs a rank of K6
    "smf_peer_handle_bytes": (_P,),  # -> bytes of a CUDA IPC handle
}
# C entries with no stream (csrc/peer.cu: the peer buffers' CUDA IPC)
_CALLS = {
    "smf_peer_alloc": (_L, _P, _P),  # bytes, out pointer, out handle
    "smf_peer_open": (_P, _P),  # handle, out pointer
    "smf_peer_close": (_P,),
    "smf_peer_free": (_P,),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "port's CUDA kernels cannot be built"
        )
    return found


def build() -> str:
    """Compile ``csrc/*.cu`` into the shared library if it is missing or
    older than a source; return its path.  The compiler's output
    (``-Xptxas -v``: registers and shared memory per kernel) is kept in
    ``build.log`` beside it."""
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    deps = sources + glob.glob(os.path.join(_CSRC, "*.cuh"))
    newest = max(os.path.getmtime(p) for p in deps)
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= newest:
        return _LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs = [
        os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        for src in sources
    ]
    cmds = [
        [nvcc, *NVCC_FLAGS, "-I", _CSRC, "-c", "-o", obj, src]
        for src, obj in zip(sources, objs)
    ]
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    tmp = f"{_LIB}.{tag}.tmp"
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs]
    failed = [(c, o) for c, o, p in zip(cmds, outs, procs) if p.returncode != 0]
    if not failed:
        res = subprocess.run(link, capture_output=True, text=True)
        outs.append(res.stdout + res.stderr)
        cmds.append(link)
        if res.returncode != 0:
            failed = [(link, res.stdout + res.stderr)]
    with open(_LOG, "w") as f:
        for c, o in zip(cmds, outs):
            f.write(" ".join(c) + "\n" + o)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        cmd, out = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out[-4000:]}")
    os.replace(tmp, _LIB)
    return _LIB


def build_log() -> str:
    with open(_LOG) as f:
        return f.read()


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = (*argtypes, _P)
        fn.restype = ctypes.c_int
    for name, argtypes in (*_QUERIES.items(), *_CALLS.items()):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.smf_error_string.argtypes = (ctypes.c_int,)
    lib.smf_error_string.restype = ctypes.c_char_p
    return lib


def current_stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream (the raw handle: building
    a ``torch.cuda.Stream`` costs a launch's worth of host time)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(name: str, device: torch.device, *args, stream: int | None = None) -> None:
    """Call the C entry ``name`` on ``stream`` (by default ``device``'s
    current stream) with ``device`` current; raise if the launch reports
    an error."""
    if stream is None:
        stream = current_stream(device)
    with torch.cuda.device(device):
        err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise_error(name, err)


def query(name: str, device: torch.device, *args) -> int:
    """The int that the C entry ``name`` computes for ``device``."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = getattr(library(), name)(*args, ctypes.byref(out))
    if err != 0:
        raise_error(name, err)
    return out.value


def call(name: str, device: torch.device, *args) -> None:
    """Call the C entry ``name`` (no stream) with ``device`` current;
    raise if it reports an error."""
    with torch.cuda.device(device):
        err = getattr(library(), name)(*args)
    if err != 0:
        raise_error(name, err)


def raise_error(name: str, err: int) -> None:
    msg = library().smf_error_string(err).decode()
    raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


# every kernel wrapper of the port, in the order their modules register them
WRAPPERS: list = []


def counted(wrapper):
    """Register a kernel wrapper: ``wrapper.launches`` counts the launches
    of its kernel, one where the wrapper launches it.  A CUDA graph's
    replay runs no Python, so it adds the launches it captured to these
    counts itself (``utils/graphs.py``)."""
    wrapper.launches = 0
    WRAPPERS.append(wrapper)
    return wrapper


# (kernel, device index, stream) -> [zeroed int64 scratch, last epoch]
_SCRATCH: dict = {}
EPOCHS = (1 << 30) - 1  # epochs run 1 .. EPOCHS, then start again at 1


def stream_scratch(name: str, device: torch.device, stream: int, numel: int):
    """The scratch that kernel ``name`` keeps across its launches on one
    (device, stream), at least ``numel`` int64 words, zeroed when it is
    allocated or grown, and the epoch of the next launch.  A kernel that
    tags what it publishes there with its epoch needs nothing cleared
    between launches: consecutive launches on one stream never share an
    epoch.

    A launch being captured into a CUDA graph gets a scratch of its own,
    zeroed by a node of the graph, and epoch 1: every replay reruns the
    zeroing, so a replay never meets the tags of an earlier one (it would
    with a kept scratch, since a replay reuses the captured epoch)."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(numel, dtype=torch.int64, device=device), 1
    key = (name, device.index, stream)
    st = _SCRATCH.get(key)
    if st is None or st[0].numel() < numel:
        size = max(numel, 2 * st[0].numel()) if st else numel
        st = _SCRATCH[key] = [torch.zeros(size, dtype=torch.int64, device=device), 0]
    st[1] = st[1] % EPOCHS + 1
    return st[0], st[1]


def on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (the wrapper launches
    its kernel), False when they lie on the CPU (it runs the plain
    version).  Any other device, or a mix, raises."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def check_tensor(x: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    """A kernel wrapper's argument check: contiguous, of one dtype and
    rank (the same on the CPU, so both routes take the same inputs)."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
