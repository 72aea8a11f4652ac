"""Global configuration and numeric constants (PyTorch port).

The same constants as the JAX package's ``config.py``; dtypes become
torch dtypes.  Indices are int32 on the device path, values float32.

Float32 matmuls run in true float32: TF32 keeps about three decimal
digits, and bf16-class rounding of the hub products broke the 1e-3
comparison bar on the reference (docs/ROUND5_NOTES.md §4).  Both TF32
switches are therefore turned off when the package is imported.
"""

from __future__ import annotations

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

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: torch.device | str | None, who: str) -> torch.device:
    """``device``, or by default the current CUDA card, as the reference's
    arrays land on the accelerator.  Without a card the default raises:
    a CPU tensor is only made when ``device="cpu"`` is asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f'{who}: no CUDA device; pass device="cpu" to work on the CPU')
    return torch.device("cuda", torch.cuda.current_device())
