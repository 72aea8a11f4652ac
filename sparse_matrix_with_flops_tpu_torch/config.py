"""Global configuration and numeric constants (PyTorch port).

The same constants as the JAX package's ``config.py``; dtypes become
torch dtypes.  Indices are int32 on the device path, values float32.

Float32 matmuls run in true float32: TF32 keeps about three decimal
digits, and bf16-class rounding of the hub products broke the 1e-3
comparison bar on the reference (docs/ROUND5_NOTES.md §4).  The
reference pins ``Precision.HIGHEST`` at each product; the port wraps
each matmul-class call in :func:`true_f32`, which forces true f32 for
the call and then restores the caller's switches.  Importing the
package changes no global setting.
"""

from __future__ import annotations

import contextlib

import torch

# Value / index dtypes (macro.h:3-6: QValue = float).
QVALUE_DTYPE = torch.float32
INDEX_DTYPE = torch.int32

# R-MCL pruning parameters (util.h:11-12, util.cc:4-9).
MLMCL_PRUNE_A = 0.90
MLMCL_PRUNE_B = 2.0
PRUNE_FLOOR = 1.0e-7

# Comparison tolerances (CSR.h:234 isEqual; nGpuSpMM.cc:111 per-bin relative).
ABS_TOL = 1.0e-7
REL_TOL = 1.0e-3

# Runtime defaults (process_args.h:28,31).
DEFAULT_MAX_ITERS = 5
DEFAULT_STRIDE = 512

# GPU-reference flops bins (mindex2-cuda/flops.cu:39-47).
FLOPS_BIN_BOUNDS = (0, 1, 4, 16, 64, 512)

# The per-backend switches of torch's newer precision API (torch >= 2.9:
# "none" inherits, "ieee" is true f32, "tf32").  Reading a legacy switch
# raises once the newer API has set a different state, so each is read
# and set on its own.
_FP32_BACKENDS = {
    "cuda.matmul.fp32_precision": lambda: torch.backends.cuda.matmul,
    "cudnn.fp32_precision": lambda: torch.backends.cudnn,
    "cudnn.conv.fp32_precision": lambda: torch.backends.cudnn.conv,
    "cudnn.rnn.fp32_precision": lambda: torch.backends.cudnn.rnn,
}


def _f32_switches() -> dict:
    """Every f32-precision switch that reads without raising."""
    state = {}
    getters = {
        "cuda.matmul.allow_tf32": lambda: torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": lambda: torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision,
    }
    for key, backend in _FP32_BACKENDS.items():
        getters[key] = lambda b=backend: b().fp32_precision
    for key, get in getters.items():
        try:
            state[key] = get()
        except (AttributeError, RuntimeError):  # absent, or a mixed legacy read
            pass
    return state


@contextlib.contextmanager
def true_f32():
    """Run the block's f32 matmuls in true f32 (TF32 off, precision
    "highest"), whatever the caller set; on leaving, also by an
    exception, restore every switch the caller had.  The legacy switches
    are restored before the newer API's, which is the order that gives
    back the same reads on torch 2.9 and later."""
    saved = _f32_switches()
    for backend in _FP32_BACKENDS.values():
        try:
            backend().fp32_precision = "ieee"
        except AttributeError:  # torch before the newer API
            break
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if "cuda.matmul.allow_tf32" in saved:
            torch.backends.cuda.matmul.allow_tf32 = saved["cuda.matmul.allow_tf32"]
        if "cudnn.allow_tf32" in saved:
            torch.backends.cudnn.allow_tf32 = saved["cudnn.allow_tf32"]
        if "float32_matmul_precision" in saved:
            torch.set_float32_matmul_precision(saved["float32_matmul_precision"])
        for key, backend in _FP32_BACKENDS.items():
            if key in saved:
                backend().fp32_precision = saved[key]


def resolve_device(device: torch.device | str | None, who: str) -> torch.device:
    """``device``, or by default the current CUDA card, as the reference's
    arrays land on the accelerator.  Without a card the default raises:
    a CPU tensor is only made when ``device="cpu"`` is asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f'{who}: no CUDA device; pass device="cpu" to work on the CPU')
    return torch.device("cuda", torch.cuda.current_device())
