"""C = A·B, plain PyTorch: expand every product, sort by (row, col), sum
equal keys.  Rows go in blocks of at most ``block`` products, so a
product of hundreds of millions of terms fits on the card.

``precision``: "f64" is the reference (products and sums in float64);
"tf32" is the control: each operand rounded to TF32 (10 explicit
mantissa bits, as the tensor cores read float32 with TF32 on), products
and sums in float32.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 25  # products a block


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (round to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32``), kept as float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def operands(values: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f64":
        return values.to(torch.float64)
    if precision == "tf32":
        return round_tf32(values)
    raise ValueError(f"unknown precision {precision!r}")


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(x.shape[0] + 1, dtype=torch.int64, device=x.device)
    torch.cumsum(x, 0, out=out[1:])
    return out


def spgemm(rp_a, ci_a, va, rp_b, ci_b, vb, ncols: int, precision: str = "f64",
           block: int = BLOCK):
    """C = A·B of CSR operands (int64 row pointers and columns, values of
    any float type) on their device.  Returns C's ``(row_ptr, col, val)``,
    each row's columns sorted, every structural product kept (a sum that
    cancels to 0 stays an entry)."""
    dev = rp_a.device
    m = rp_a.shape[0] - 1
    va, vb = operands(va, precision), operands(vb, precision)
    lens_b = rp_b[1:] - rp_b[:-1]
    eflops = lens_b[ci_a]
    ecs = exclusive_cumsum(eflops)
    row_end = ecs[rp_a[1:]]  # products up to the end of each row
    cols, vals, counts = [], [], []
    r0 = 0
    while r0 < m:
        start = int(ecs[rp_a[r0]])
        r1 = int(torch.searchsorted(row_end, start + block, right=True))
        r1 = max(r1, r0 + 1)
        e0, e1 = int(rp_a[r0]), int(rp_a[r1])
        cnt = eflops[e0:e1]
        total = int(cnt.sum())
        if total == 0:
            counts.append(torch.zeros(r1 - r0, dtype=torch.int64, device=dev))
            r0 = r1
            continue
        src = torch.repeat_interleave(torch.arange(e0, e1, device=dev), cnt)
        first = exclusive_cumsum(cnt)[:-1]
        off = torch.arange(total, device=dev) - torch.repeat_interleave(first, cnt)
        bidx = rp_b[ci_a[src]] + off
        erow = torch.repeat_interleave(
            torch.arange(r0, r1, device=dev), rp_a[r0 + 1:r1 + 1] - rp_a[r0:r1])
        key = erow[src - e0] * ncols + ci_b[bidx]
        prod = va[src] * vb[bidx]
        del src, off, bidx
        key, order = torch.sort(key)
        prod = prod[order]
        ukey, inv = torch.unique_consecutive(key, return_inverse=True)
        sums = torch.zeros(ukey.shape[0], dtype=prod.dtype, device=dev)
        sums.index_add_(0, inv, prod)
        urow = ukey // ncols
        cols.append(ukey - urow * ncols)
        vals.append(sums)
        counts.append(torch.bincount(urow - r0, minlength=r1 - r0))
        r0 = r1
    row_ptr = exclusive_cumsum(torch.cat(counts))
    dt = torch.float64 if precision == "f64" else torch.float32
    col = torch.cat(cols) if cols else torch.zeros(0, dtype=torch.int64, device=dev)
    val = torch.cat(vals) if vals else torch.zeros(0, dtype=dt, device=dev)
    return row_ptr, col, val
