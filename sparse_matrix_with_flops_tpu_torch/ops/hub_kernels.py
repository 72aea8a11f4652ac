"""K10: the ELL-ESC hub as a sparse accumulator (``csrc/hub_accumulate.cu``).

``hub_accumulate`` launches the kernel for tensors on the card and runs
``hub_accumulate_plain`` for tensors on the CPU.  One work item is one
(hub row, column slab) of a plan's hub group.  Its int64 fields
(``META`` of them, a row of ``meta``):

* ``a0, a1``: its row's entries in the hub-entry arrays ``krow`` (the
  entry's B row as an index into the segment table ``boff``) and
  ``aval`` (the entry's A value);
* ``slab0, kh, tile``: the slab's first table index, the table's stride
  from one tile to the next (the group's union rows) and the tile width:
  tile ``t`` of the slab reads B row ``krow[e]``'s entries
  ``boff[krow[e] + slab0 + t * kh]`` up to the next offset, each a
  tile-local column (``bcol``, int16) and a value (``bval``);
* ``out0, cap``: the item's region of the output;
* ``col0, width``: the slab's first column and its width;
* ``vrow``: the virtual row whose count the item writes.

The item adds its products in A-entry order, each product rounded
before its add, from 0.0, and writes its nonzero sums in column order at
the front of its region, padded with ``(ncols, 0.0)``.
"""

from __future__ import annotations

import torch

from .._build import check_tensor, counted, launch, on_card
from .segments import run_sums_plain

META = 10  # int64 fields of an item (the kernel's Field enum)
# columns a warp accumulates (8 KB of shared memory): K10's tables cut a
# slab into tiles of this width, each a warp of the item's block.  Wider
# tiles hold fewer warps an SM, narrower ones split B's segments into more
# rounds (Graph500 s16 on an H100: 9.8 ms at 4096, 8.0 at 2048, 9.4 at 1024)
TILE = 2048
MAX_TILES = 16  # tiles of one slab: warps of the kernel's block (kMaxWarps)
SMEM_BYTES = 232448  # shared memory a block can use on Hopper


def _ranges(starts: torch.Tensor, lengths: torch.Tensor):
    """(owner, position) of every slot of the ranges ``[starts[i],
    starts[i] + lengths[i])`` laid end to end (int64)."""
    dev = lengths.device
    owner = torch.repeat_interleave(torch.arange(lengths.shape[0], device=dev), lengths)
    first = torch.cumsum(lengths, 0) - lengths
    return owner, starts[owner] + torch.arange(owner.shape[0], device=dev) - first[owner]


def hub_accumulate_plain(meta, krow, aval, boff, bcol, bval, out_c, out_v, counts,
                         ncols: int) -> None:
    """K10's twin: every item's products expanded in A-entry order, a
    stable sort by (item, column), each run of one column summed
    (``run_sums_plain``: left to right from 0.0 on the CPU, K10's bits;
    CUB's order on a card), exact zeros dropped."""
    m = meta.long()
    a0, a1, slab0, kh, tile, out0, cap, col0, width, vrow = m.unbind(1)
    n = m.shape[0]
    # every (item, tile), then every (item, tile, A entry), then every product
    it, t = _ranges(torch.zeros_like(width), -(-width // tile))
    tr, e = _ranges(a0[it], (a1 - a0)[it])
    k = krow[e].long() + slab0[it[tr]] + t[tr] * kh[it[tr]]
    pr, q = _ranges(boff[k], boff[k + 1] - boff[k])
    item = it[tr[pr]]
    local = t[tr[pr]] * tile[item] + bcol[q].long()  # column within the slab
    prod = aval[e[pr]] * bval[q]
    span = int(width.max()) if n else 1
    key, order = torch.sort(item * span + local, stable=True)
    uniq, runs = torch.unique_consecutive(key, return_counts=True)
    offsets = torch.cat([runs.new_zeros(1), torch.cumsum(runs, 0)])
    sums = run_sums_plain(prod[order], offsets)
    keep = sums != 0
    uniq, sums = uniq[keep], sums[keep]
    owner = uniq // span
    rank = torch.arange(owner.shape[0], device=m.device) - torch.searchsorted(owner, owner)
    _, lane = _ranges(out0, cap)
    out_c[lane] = ncols
    out_v[lane] = 0.0
    fits = rank < cap[owner]
    pos = (out0[owner] + rank)[fits]
    out_c[pos] = (col0[owner] + uniq % span)[fits].to(out_c.dtype)
    out_v[pos] = sums[fits]
    counts[vrow] = torch.bincount(owner, minlength=n).to(counts.dtype)


@counted
def hub_accumulate(meta, krow, aval, boff, bcol, bval, out_c, out_v, counts,
                   ncols: int, tile: int, warps: int) -> None:
    """Fill each item's region of ``out_c`` / ``out_v`` and its count in
    ``counts`` (see the module's docstring); ``tile`` is the widest tile
    of the items and ``warps`` the most tiles of an item's slab (the
    kernel gives each a warp and ``tile`` floats of shared memory).
    Writes in place, returns nothing; no host read."""
    for x, what, dtype in ((meta, "meta", torch.int64), (krow, "krow", torch.int32),
                           (aval, "aval", torch.float32), (boff, "boff", torch.int64),
                           (bcol, "bcol", torch.int16), (bval, "bval", torch.float32),
                           (out_c, "out_c", torch.int32), (out_v, "out_v", torch.float32),
                           (counts, "counts", torch.int32)):
        check_tensor(x, f"hub_accumulate {what}", dtype, 2 if what == "meta" else 1)
    if meta.shape[1] != META:
        raise ValueError(f"hub_accumulate: meta must be [items, {META}], got {tuple(meta.shape)}")
    if tile < 128 or tile % 128 or not 1 <= warps <= MAX_TILES or 4 * tile * warps > SMEM_BYTES:
        raise ValueError(f"hub_accumulate: {warps} tiles of {tile} columns: a tile is a "
                         f"multiple of 128, at most {MAX_TILES} a block, {SMEM_BYTES} bytes in all")
    tensors = (meta, krow, aval, boff, bcol, bval, out_c, out_v, counts)
    if not on_card("hub_accumulate", *tensors):
        hub_accumulate_plain(*tensors, ncols)
        return
    if meta.shape[0] == 0:
        return
    launch("smf_hub_accumulate", meta.device, meta.data_ptr(), meta.shape[0],
           *(x.data_ptr() for x in tensors[1:]), ncols, tile, warps)
    hub_accumulate.launches += 1
