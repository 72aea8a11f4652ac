"""ctypes bindings for the native C++ loader and the OpenMP Gustavson
baseline (the port of the JAX package's ``io/native.py``).

The port carries its own copies of the two C sources
(``native/src/loader.cc``, ``native/src/spgemm_baseline.cc``).  They are
built on demand with g++ into ``build/torch_native/`` at the repository
root, never into a package directory, and loaded with ctypes.  When the
toolchain or the build is missing, the loader returns None and callers
fall back to the numpy readers: the native path is a loader for big
corpora, not a correctness dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "src")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_native")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL | None] = {}

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _build_lib(src: str, out: str, extra: tuple = ()) -> bool:
    # Compile to a process-unique path and publish atomically: the lock
    # cannot stop a second process (parallel pytest) from racing g++ on
    # the same target, and a half-written .so must never be loadable.
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           *extra, "-o", tmp, src]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load(name: str, extra: tuple, declare) -> ctypes.CDLL | None:
    """Build (when missing or older than its source) and load
    ``native/src/<name>.cc`` as ``build/torch_native/<name>.so``, once a
    process; None if unavailable."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        _LIBS[name] = None
        src = os.path.join(_SRC, f"{name}.cc")
        out = os.path.join(BUILD_DIR, f"{name}.so")
        if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
            if not _build_lib(src, out, extra):
                return None
        try:
            lib = ctypes.CDLL(out)
        except OSError:
            return None
        declare(lib)
        _LIBS[name] = lib
        return lib


def _declare_loader(lib) -> None:
    lib.smf_read_graph.restype = ctypes.c_int
    lib.smf_read_graph.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(_I32P), ctypes.POINTER(_I32P), ctypes.POINTER(_F32P),
        _I64P, _I64P, _I64P,
    ]
    lib.smf_coo_to_csr.restype = ctypes.c_int
    lib.smf_coo_to_csr.argtypes = [
        _I32P, _I32P, _F32P, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(_I32P), ctypes.POINTER(_I32P), ctypes.POINTER(_F32P), _I64P,
    ]
    lib.smf_free.restype = None
    lib.smf_free.argtypes = [ctypes.c_void_p]


def _declare_baseline(lib) -> None:
    lib.smf_spgemm_mt.restype = ctypes.c_int
    lib.smf_spgemm_mt.argtypes = [
        _I32P, _I32P, _F32P,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I32P, _I32P, _F32P,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        _I64P,
    ]


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the native loader; None if unavailable."""
    return _load("loader", (), _declare_loader)


def get_baseline_lib() -> ctypes.CDLL | None:
    """Multi-threaded CPU Gustavson baseline (spgemm_baseline.cc), built
    with OpenMP on demand; None if the toolchain is unavailable."""
    return _load("spgemm_baseline", ("-fopenmp",), _declare_baseline)


def spgemm_mt_baseline(rp, ci, v, ncols: int, iters: int = 5):
    """(best ms, nnzc) of C = A·A via the OpenMP Gustavson baseline, or
    None when the native toolchain is unavailable.  ``rp/ci/v`` are host
    CSR arrays of the square matrix A."""
    lib = get_baseline_lib()
    if lib is None:
        return None
    rp = np.ascontiguousarray(rp, dtype=np.int32)
    nnz = int(rp[-1])
    ci = np.ascontiguousarray(ci[:nnz], dtype=np.int32)
    v = np.ascontiguousarray(v[:nnz], dtype=np.float32)
    m = rp.shape[0] - 1
    ms = ctypes.c_double()
    nnzc = ctypes.c_int64()
    a = (rp.ctypes.data_as(_I32P), ci.ctypes.data_as(_I32P), v.ctypes.data_as(_F32P))
    rc = lib.smf_spgemm_mt(*a, m, m, ncols, *a, iters, ctypes.byref(ms), ctypes.byref(nnzc))
    if rc != 0:
        return None
    return float(ms.value), int(nnzc.value)


def _steal(lib, ptr, n, dtype):
    """Copy a malloc'd buffer into numpy and free it."""
    ct = ctypes.c_int32 if dtype == np.int32 else ctypes.c_float
    arr = np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ct)), shape=(max(n, 1),)
    )[:n].copy()
    lib.smf_free(ptr)
    return arr.astype(dtype, copy=False)


def read_graph_native(path: str, is_trans: bool = True):
    """(row, col, val, nrows, ncols) via the C++ parser, or None."""
    lib = get_lib()
    if lib is None:
        return None
    orow, ocol, oval = _I32P(), _I32P(), _F32P()
    nnz, nr, nc = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.smf_read_graph(
        path.encode(), int(is_trans),
        ctypes.byref(orow), ctypes.byref(ocol), ctypes.byref(oval),
        ctypes.byref(nnz), ctypes.byref(nr), ctypes.byref(nc),
    )
    if rc != 0:
        return None
    n = nnz.value
    return (
        _steal(lib, orow, n, np.int32),
        _steal(lib, ocol, n, np.int32),
        _steal(lib, oval, n, np.float32),
        int(nr.value),
        int(nc.value),
    )


def coo_to_csr_native(row, col, val, nrows: int):
    """(row_ptr, col, val) sorted/dedup'd CSR via C++, or None."""
    lib = get_lib()
    if lib is None:
        return None
    row = np.ascontiguousarray(row, dtype=np.int32)
    col = np.ascontiguousarray(col, dtype=np.int32)
    val = np.ascontiguousarray(val, dtype=np.float32)
    orp, ocol, oval = _I32P(), _I32P(), _F32P()
    onnz = ctypes.c_int64()
    rc = lib.smf_coo_to_csr(
        row.ctypes.data_as(_I32P), col.ctypes.data_as(_I32P), val.ctypes.data_as(_F32P),
        row.shape[0], nrows,
        ctypes.byref(orp), ctypes.byref(ocol), ctypes.byref(oval), ctypes.byref(onnz),
    )
    if rc != 0:
        return None
    n = onnz.value
    return (
        _steal(lib, orp, nrows + 1, np.int32),
        _steal(lib, ocol, n, np.int32),
        _steal(lib, oval, n, np.float32),
    )
