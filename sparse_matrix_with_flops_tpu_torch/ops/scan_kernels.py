"""K4: the long int32 prefix sum (port of the JAX package's
``ops/pallas_scan.py``).

``cumsum_i32`` launches the CUDA kernel in ``csrc/cumsum_i32.cu`` for a
tensor on the card and runs ``cumsum_i32_plain`` for a tensor on the CPU.
"""

from __future__ import annotations

import torch

from .._build import check_tensor, launch, on_card

_TILE = 8192  # elements per block of the CUDA scan (csrc/cumsum_i32.cu)


def cumsum_i32_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum, int32 wrap-around (torch widens to int64)."""
    return torch.cumsum(x, 0).to(torch.int32)


def cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D contiguous int32 tensor."""
    check_tensor(x, "cumsum_i32", torch.int32, 1)
    if not on_card("cumsum_i32", x):
        return cumsum_i32_plain(x)
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    scratch = torch.empty(-(-n // _TILE), dtype=torch.int32, device=x.device)
    launch(
        "smf_cumsum_i32", x.device,
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n,
    )
    cumsum_i32.launches += 1
    return out


cumsum_i32.launches = 0
