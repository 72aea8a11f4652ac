"""K11: the static R-MCL step's prune, top-S selection and
renormalisation of compacted ELL tiles (``csrc/prune_select.cu``).

``prune_select`` launches the kernel for tensors on the card and runs
``prune_select_plain`` for tensors on the CPU.  Its rule is the
reference's ``_prune_select_lanes`` (inflate, threshold, the S kept lanes
of largest value with a tie at the S cut going to the lower column,
column order, renormalise), with no sort: a tile row holds its valid
lanes first and in column order (K1's output), so the survivors taken in
lane order are already column-sorted.  The two float sums of a row are
taken in the kernel's fixed order, which the plain version repeats, so
the two give the same bits.
"""

from __future__ import annotations

import torch

from .._build import check_tensor, counted, launch, on_card
from .prune import compute_threshold

SELECT_THREADS = 256  # the kernel's threads a block (kThreads): the row sum's order
MAX_SELECT_W = 32768  # the widest tile row K11 holds in shared memory (128 KB of w)
MAX_SELECT_S = 4096


def _fold32(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis (32 wide) as the kernel's shuffle
    butterfly takes it: halves added pairwise, 16, 8, 4, 2, 1 apart."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _block_sum(w: torch.Tensor) -> torch.Tensor:
    """Each row's f32 sum in the kernel's order: thread t of the block
    adds lanes 4 (t + 256 k) + j in order of k, then j, from 0.0; each
    warp's 32 partial sums by the butterfly; the warps in index order.
    Lanes past the row add +0.0, which changes no sum of values >= 0."""
    r, width = w.shape
    rnd = 4 * SELECT_THREADS
    wp = max(-(-width // rnd), 1) * rnd
    x = torch.nn.functional.pad(w, (0, wp - width)).view(r, wp // rnd, SELECT_THREADS, 4)
    s = torch.zeros((r, SELECT_THREADS), dtype=w.dtype, device=w.device)
    for k in range(x.shape[1]):
        for j in range(4):
            s = s + x[:, k, :, j]
    part = _fold32(s.view(r, SELECT_THREADS // 32, 32))
    tot = part[:, 0]
    for i in range(1, part.shape[1]):
        tot = tot + part[:, i]
    return tot


def prune_select_plain(key: torch.Tensor, uval: torch.Tensor, n: int, S: int):
    """K11's plain version: (cols int32 [R, S], vals f32 [R, S],
    truncated bool [R]).  The kept lanes above the S-th largest kept w
    (``topk``), then the lanes equal to it in lane order up to S in all,
    compacted in lane order; the survivors' sum as one warp of the kernel
    takes it (lane l its positions l, l + 32, ..., then the butterfly)."""
    r, width = key.shape
    dev = key.device
    valid = key < n
    w = torch.where(valid, uval * uval, 0.0)  # inflation v^2
    rsum = _block_sum(w)
    rmax = torch.nn.functional.pad(w, (0, 1)).amax(dim=1)
    rcount = valid.sum(dim=1).to(w.dtype)
    thresh = compute_threshold(rsum / torch.clamp(rcount, min=1.0), rmax)
    keep = valid & (w >= thresh[:, None])
    truncated = keep.sum(dim=1) > S
    sel = keep
    if width > S:
        # the S-th largest kept w; above it all are taken, equal ones in
        # lane order while fewer than S are taken
        kw = torch.where(keep, w, -1.0)
        cut = torch.topk(kw, S, dim=1).values[:, S - 1:S]
        above = keep & (w > cut)
        equal = keep & (w == cut)
        room = S - above.sum(dim=1, keepdim=True)
        trunc_sel = above | (equal & (torch.cumsum(equal, dim=1) <= room))
        sel = torch.where(truncated[:, None], trunc_sel, keep)
    pos = torch.where(sel, torch.cumsum(sel, dim=1) - 1, S)  # slot S: the dropped
    sc = torch.full((r, S + 1), n, dtype=torch.int32, device=dev)
    sw = torch.zeros((r, S + 1), dtype=w.dtype, device=dev)
    sc.scatter_(1, pos, key.to(torch.int32))
    sw.scatter_(1, pos, w)
    sc, sw = sc[:, :S], sw[:, :S]
    s32 = -(-S // 32) * 32
    x = torch.nn.functional.pad(sw, (0, s32 - S)).view(r, s32 // 32, 32)
    acc = torch.zeros((r, 32), dtype=w.dtype, device=dev)
    for k in range(x.shape[1]):
        acc = acc + x[:, k]
    ksum = _fold32(acc)[:, None]
    sw = torch.where(sc < n, sw / torch.clamp(ksum, min=1e-30), 0.0)
    return sc, sw, truncated


@counted
def prune_select(key, uval, n: int, S: int, rows, out_c, out_v, counts) -> None:
    """Prune, select and renormalise each row of the compacted tile
    ``key`` / ``uval`` ([R, W] int32 / f32, the valid lanes first in
    column order: K1's output) into row ``rows[r]`` (int64 [R]) of
    ``out_c`` / ``out_v`` ([*, S] int32 / f32, padded with (n, 0.0)), and
    add the survivors and the rows that kept more than S lanes to
    ``counts`` (int64 [2]).  Writes in place, returns nothing; no host
    read.  Rows sharing a destination must produce the same row."""
    check_tensor(key, "prune_select key", torch.int32, 2)
    check_tensor(uval, "prune_select uval", torch.float32, 2)
    check_tensor(rows, "prune_select rows", torch.int64, 1)
    check_tensor(out_c, "prune_select out_c", torch.int32, 2)
    check_tensor(out_v, "prune_select out_v", torch.float32, 2)
    check_tensor(counts, "prune_select counts", torch.int64, 1)
    r, width = key.shape
    if uval.shape != key.shape or rows.shape[0] != r or counts.shape[0] != 2:
        raise ValueError(f"prune_select: key {tuple(key.shape)}, uval {tuple(uval.shape)}, "
                         f"rows {tuple(rows.shape)}, counts {tuple(counts.shape)}")
    if out_c.shape != out_v.shape or out_c.shape[1] != S:
        raise ValueError(f"prune_select: out {tuple(out_c.shape)} / {tuple(out_v.shape)}, S={S}")
    if not 1 <= width <= MAX_SELECT_W or not 1 <= S <= MAX_SELECT_S:
        raise ValueError(f"prune_select: W={width} (1 to {MAX_SELECT_W}) and S={S} "
                         f"(1 to {MAX_SELECT_S}) have no kernel")
    if not on_card("prune_select", key, uval, rows, out_c, out_v, counts):
        sc, sw, truncated = prune_select_plain(key, uval, n, S)
        out_c[rows] = sc
        out_v[rows] = sw
        counts[0] += (sc < n).sum()
        counts[1] += truncated.sum()
        return
    if r == 0:
        return
    vec = int(width % 4 == 0 and key.data_ptr() % 16 == 0 and uval.data_ptr() % 16 == 0)
    launch("smf_prune_select", key.device, key.data_ptr(), uval.data_ptr(), rows.data_ptr(),
           out_c.data_ptr(), out_v.data_ptr(), counts.data_ptr(), r, width, n, S, vec)
    prune_select.launches += 1
