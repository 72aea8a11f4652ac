"""K4: the long int32 prefix sum (port of the JAX package's
``ops/pallas_scan.py``).

``cumsum_i32`` launches the CUDA kernel in ``csrc/cumsum_i32.cu`` for a
tensor on the card and runs ``cumsum_i32_plain`` for a tensor on the CPU.
The kernel is one decoupled look-back pass; its tile counter and status
words live in a scratch kept per (device, stream) across calls
(``_build.stream_scratch``, one of its own under CUDA graph capture),
zeroed by a memset before each launch.
"""

from __future__ import annotations

import torch

from .._build import check_tensor, counted, current_stream, launch, on_card, stream_scratch

TILE = 8192  # words a CTA of the CUDA scan takes (kTile in csrc/cumsum_i32.cu)


def cumsum_i32_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum, int32 wrap-around (torch widens to int64)."""
    return torch.cumsum(x, 0).to(torch.int32)


def scratch_words(n: int) -> int:
    """int64 words of the kernel's scratch for ``n`` elements: the tile
    counter and one status word a tile (tiles lie on the input's 16-byte
    grid, so up to 3 words before element 0 share its first tile)."""
    return 1 + -(-(n + 3) // TILE)


def like_aligned(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor of ``x``'s shape whose address agrees with ``x``'s
    modulo 16 bytes, so that the kernel's 16-byte loads and stores line
    up (a view into one allocation when ``x`` is not 16-byte aligned)."""
    o = (x.data_ptr() >> 2) & 3
    if not o:
        return torch.empty_like(x)
    return torch.empty(x.shape[0] + o, dtype=x.dtype, device=x.device)[o:]


@counted
def cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D contiguous int32 tensor."""
    check_tensor(x, "cumsum_i32", torch.int32, 1)
    if not on_card("cumsum_i32", x):
        return cumsum_i32_plain(x)
    n = x.shape[0]
    if n == 0:
        return torch.empty_like(x)
    out = like_aligned(x)
    stream = current_stream(x.device)
    scratch, _ = stream_scratch("cumsum_i32", x.device, stream, scratch_words(n))
    launch("smf_cumsum_i32", x.device, x.data_ptr(), out.data_ptr(), n, scratch.data_ptr(),
           stream=stream)
    cumsum_i32.launches += 1
    return out
