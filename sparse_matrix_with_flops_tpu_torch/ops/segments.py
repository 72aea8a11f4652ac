"""Segment / scan primitives shared by the sparse kernels (torch)."""

from __future__ import annotations

import torch


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum with the total appended: len(out) == len(x) + 1.

    ``out[i] = sum(x[:i])``, ``out[-1] = sum(x)``, in x's dtype:
    ``torch.cumsum`` widens int32 to int64, so the result is cast back
    (int32 wrap-around, as the JAX version)."""
    out = torch.zeros(x.shape[0] + 1, dtype=x.dtype, device=x.device)
    out[1:] = torch.cumsum(x, 0).to(x.dtype)
    return out
