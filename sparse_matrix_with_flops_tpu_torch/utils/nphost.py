"""Host-side (numpy) primitives for the SpGEMM planners.

Copied from the JAX package's ``utils/nphost.py`` so the planners make
the same plans, with its host heap tuning: ``prefault`` keeps freed
large blocks on the glibc heap and installs the transparent huge-page
numpy allocator (``native/src/thpalloc.c``, built with gcc into
``build/torch_native/``).  The reference does both when it is imported;
the port does them on the first ``prefault`` call, so importing it
changes nothing in the process.
"""

from __future__ import annotations

import ctypes
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig

import numpy as np

from .timing import TRACE

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THP_SOURCE = os.path.join(_PKG, "native", "src", "thpalloc.c")
THP_LIB = os.path.join(os.path.dirname(_PKG), "build", "torch_native", "_thpalloc.so")


def _keep_heap_pages() -> bool:
    """Keep freed large blocks on the glibc heap instead of unmapping
    them (``mallopt``: no trim, no mmap threshold), so a planner's
    temporaries reuse pages that have already faulted in; False off
    glibc."""
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        m_trim_threshold, m_mmap_threshold = -1, -3
        ok = libc.mallopt(m_trim_threshold, ctypes.c_int(2**31 - 1))
        ok &= libc.mallopt(m_mmap_threshold, ctypes.c_int(2**31 - 1))
        return bool(ok)
    except OSError:
        return False


def _install_thpalloc() -> bool:
    """Build (when missing or older than its source) and install the
    transparent huge-page numpy data allocator, so MB-scale numpy
    buffers come from MADV_HUGEPAGE mappings; False, with numpy left as
    it was, when gcc, the headers or numpy's handler API are missing."""
    try:
        if not os.path.exists(THP_LIB) or os.path.getmtime(THP_LIB) < os.path.getmtime(
            THP_SOURCE
        ):
            os.makedirs(os.path.dirname(THP_LIB), exist_ok=True)
            tmp = f"{THP_LIB}.{os.getpid()}.tmp"
            cmd = ["gcc", "-O2", "-shared", "-fPIC",
                   f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}",
                   "-o", tmp, THP_SOURCE]
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, THP_LIB)
        loader = importlib.machinery.ExtensionFileLoader("_thpalloc", THP_LIB)
        spec = importlib.util.spec_from_loader("_thpalloc", loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        return bool(mod.install())
    except (OSError, ImportError, subprocess.SubprocessError):
        return False


# (heap pages kept, THP allocator installed), set by the first prefault
_HEAP: tuple[bool, bool] | None = None
_prefaulted = 0


def prefault(nbytes: int) -> None:
    """Pre-fault ``nbytes`` of heap so later numpy temporaries reuse warm
    pages.  The first call keeps freed pages on the heap and installs the
    THP allocator; under that allocator (faults are cheap there) the
    call does nothing more.  Idempotent up to the high-water mark."""
    global _HEAP, _prefaulted
    if _HEAP is None:
        _HEAP = (_keep_heap_pages(), _install_thpalloc())
    kept, thp = _HEAP
    if thp or not kept or nbytes <= _prefaulted:
        return
    block = np.empty(nbytes // 8, dtype=np.int64)
    block[:: 4096 // 8] = 0  # touch every page
    _prefaulted = nbytes
    del block


def repeat_idx(counts: np.ndarray, total: int | None = None) -> np.ndarray:
    """``np.repeat(np.arange(len(counts)), counts)`` as int32, via the
    marker-scatter + cumsum trick (ragged np.repeat is far slower).
    Zero counts are allowed."""
    counts = np.asarray(counts)
    ends = np.cumsum(counts, dtype=np.int64)
    t = int(ends[-1]) if counts.size else 0
    if total is None:
        total = t
    if counts.size <= 1:
        return np.zeros(total, dtype=np.int32)
    inner = ends[:-1]
    inner = inner[inner < total]
    out = np.bincount(inner, minlength=total).astype(np.int32, copy=False)
    np.cumsum(out, out=out)
    return out


def fast_repeat(
    values: np.ndarray, counts: np.ndarray, total: int | None = None
) -> np.ndarray:
    """``np.repeat(values, counts)`` via one gather on ``repeat_idx``."""
    return np.asarray(values)[repeat_idx(counts, total)]


def concat_ranges(
    starts: np.ndarray, ends: np.ndarray, dtype=np.int64
) -> np.ndarray:
    """Concatenation of ``[starts[i], ends[i])`` ranges without a Python
    loop: equals ``np.concatenate([np.arange(s, e) for s, e in ...])``."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(ends, dtype=np.int64) - starts
    idx = repeat_idx(lens)
    excl = np.concatenate([[0], np.cumsum(lens)[:-1]])
    within = np.arange(idx.shape[0], dtype=np.int64) - excl[idx]
    return (starts[idx] + within).astype(dtype, copy=False)


def segment_sums(ent_vals: np.ndarray, row_ptr: np.ndarray) -> np.ndarray:
    """Per-row sums of entry values laid out row-major under ``row_ptr``
    (int64 accumulate; the cumsum-difference identity — exact for ints)."""
    cs = np.zeros(ent_vals.shape[0] + 1, dtype=np.int64)
    np.cumsum(ent_vals, dtype=np.int64, out=cs[1:])
    rp = np.asarray(row_ptr, dtype=np.int64)
    return cs[rp[1:]] - cs[rp[:-1]]


def pow2ceil_arr(n: np.ndarray) -> np.ndarray:
    """Elementwise next power of two (>=1) in pure integer ops."""
    v = np.asarray(n, dtype=np.int64) - 1
    v = np.maximum(v, 0)
    for s in (1, 2, 4, 8, 16, 32):
        v |= v >> s
    return v + 1


def snap_chunks_arr(n: np.ndarray) -> np.ndarray:
    """Snap positive counts up to the nearest {2^k, 3*2^k} value (the
    ELL width-class lattice; caps per-segment padding at 1.33x)."""
    n = np.maximum(np.asarray(n, dtype=np.int64), 1)
    p2 = pow2ceil_arr(n)
    p3 = 3 * np.maximum(p2 >> 2, 1)
    return np.where((p3 >= n) & (p3 < p2), p3, p2)


def csr_host(csr, site: str | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Host views ``(row_ptr int64, col_ind int32)`` of a CSR, cached on
    the instance (the planners read the same arrays many times, and a
    CSR on the card would otherwise pay a device-to-host copy each
    time).  With ``site`` the two reads go through the port's tracer
    (``TRACE.host_read(site, ...)``)."""
    cached = getattr(csr, "_host_rp_ci", None)
    if cached is not None:
        return cached
    if site is None:
        rp, ci = csr.row_ptr.cpu(), csr.col_ind.cpu()
    else:
        rp, ci = TRACE.host_read(site, csr.row_ptr), TRACE.host_read(site, csr.col_ind)
    rp = rp.numpy().astype(np.int64)
    ci = ci.numpy().astype(np.int32, copy=False)
    pair = (rp, ci)
    object.__setattr__(csr, "_host_rp_ci", pair)
    return pair
