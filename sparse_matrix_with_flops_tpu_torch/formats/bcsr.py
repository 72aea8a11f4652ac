"""BCSR: block-compressed sparse rows with dense (br x bc) blocks (the
port of the JAX package's ``formats/bcsr.py``, after the reference's
nlibs/BCSR.h:6-64).

* blocks are one dense ``[capacity, br, bc]`` tensor; the default block
  is (8, 128);
* block slots in [nblocks, capacity) are zero blocks pointing at block
  column ``nbcols`` (the sentinel); ``from_csr`` always stores at least
  one slot, so an empty matrix holds one padding block;
* ``schedule``: kernel K5's work items (:func:`spmm_schedule`), built on
  the host by ``from_csr`` and kept on the matrix's device, so that a
  product reads nothing back.

``ops/spmm.bcsr_spmm`` (kernel K5) multiplies it by a dense matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from .csr import CSR

# K5's work items (csrc/bcsr_spmm.cu: kRows, and the 32-block pieces): an
# item covers up to SPMM_ROWS / ceil(br / 8) consecutive block rows (its
# accumulators hold SPMM_ROWS passes of 8 rows) holding at most
# SPMM_BLOCKS blocks in all, or one piece of SPMM_BLOCKS blocks of a
# longer block row.  Blocks of more than 8 * SPMM_ROWS rows have no kernel.
SPMM_ROWS = 8
SPMM_BLOCKS = 32
SPMM_DEPTH = 64  # block columns a stage of K5 (csrc/bcsr_spmm.cu: kKC)
SPMM_GROUP = 4  # blocks a stage of K5 that share one B slab, at most (kGroup)


@dataclasses.dataclass(frozen=True)
class SpmmSchedule:
    """Kernel K5's work items over a BCSR's blocks (int32 tensors).

    * ``items`` [n_items, 5]: (first block row, block rows, first stage,
      end stage, scratch slot or -1); an item with a slot is one piece of
      a split block row;
    * ``stages`` [n_stages, 12]: (B row of the chunk's first column, the
      chunk's first block column, (row pass << 1) | new B slab, nb, nb
      blocks, their accumulator rows; unused slots -1).  A stage
      multiplies 8 rows (pass p: rows 8p .. 8p + 7) and SPMM_DEPTH
      columns of up to SPMM_GROUP blocks of one block column; the
      accumulator row of 8 is (block row - the item's first) x passes +
      p.  An item's blocks are taken grouped by block column (stable),
      then by depth chunk, then by pass, SPMM_GROUP at a time, so that
      stages that read the same B slab follow each other; a stage
      flagged new loads its slab, the others reuse the one before;
    * ``splits`` [n_splits, 3]: (block row, first slot, pieces);
    * ``slots``: scratch slots of all pieces; ``nblocks``: stored blocks;
      ``group``: blocks a stage at most, SPMM_GROUP where stages would
      hold 1.5 blocks or more on average, else 1 (a power-law matrix,
      whose blocks rarely share a block column)."""

    items: torch.Tensor
    stages: torch.Tensor
    splits: torch.Tensor
    slots: int
    nblocks: int
    group: int

    def to(self, device) -> "SpmmSchedule":
        return dataclasses.replace(
            self, items=self.items.to(device), stages=self.stages.to(device),
            splits=self.splits.to(device),
        )


def spmm_schedule(
    brp: np.ndarray, bcol: np.ndarray, br: int, bc: int, device=None
) -> SpmmSchedule:
    """K5's schedule of a BCSR of (br x bc) blocks with host block-row
    pointers ``brp`` and block columns ``bcol``: consecutive block rows
    packed greedily into items of at most SPMM_ROWS / ceil(br / 8) rows
    and SPMM_BLOCKS blocks, each item's stages listed in order (at most
    ``SpmmSchedule.group`` blocks a stage); a block row of
    more than SPMM_BLOCKS blocks is cut into pieces of SPMM_BLOCKS, each an
    item of its own with a scratch slot, summed in piece order afterwards.
    Every block row lies in exactly one item, or in its pieces."""
    brp = np.asarray(brp, np.int64)
    passes = -(-br // 8)
    chunks = -(-bc // SPMM_DEPTH)
    rows_per_item = max(SPMM_ROWS // passes, 1)
    counts = np.diff(brp)
    nbrows = counts.size
    nblocks = int(brp[-1]) if brp.size else 0
    items, splits = [], []
    slots = 0
    r = 0
    while r < nbrows:
        c = int(counts[r])
        if c > SPMM_BLOCKS:
            pieces = -(-c // SPMM_BLOCKS)
            splits.append((r, slots, pieces))
            for q in range(pieces):
                lo = int(brp[r]) + q * SPMM_BLOCKS
                items.append((r, 1, lo, min(lo + SPMM_BLOCKS, int(brp[r + 1])), slots + q))
            slots += pieces
            r += 1
            continue
        r1, tot = r, 0
        while (r1 < nbrows and r1 - r < rows_per_item and counts[r1] <= SPMM_BLOCKS
               and tot + counts[r1] <= SPMM_BLOCKS):
            tot += int(counts[r1])
            r1 += 1
        items.append((r, r1 - r, int(brp[r]), int(brp[r1]), -1))
        r = r1
    it = np.asarray(items, np.int64).reshape(-1, 5)
    item_of = np.repeat(np.arange(it.shape[0]), it[:, 3] - it[:, 2])
    bcol = np.asarray(bcol, np.int64)[:nblocks]
    # each item's blocks grouped by block column (stable)
    order = np.lexsort((np.arange(nblocks), bcol, item_of))
    vrow = np.repeat(np.arange(nbrows), counts)[order] - it[item_of, 0]
    new_group = np.ones(nblocks, bool)
    new_group[1:] = (item_of[1:] != item_of[:-1]) | (bcol[order][1:] != bcol[order][:-1])
    gid = np.cumsum(new_group)  # the item's run of one block column
    # (visit, depth chunk, pass) triples sorted by (group, chunk, pass,
    # visit), then cut into stages of up to SPMM_GROUP visits of one
    # (group, chunk, pass) run; an item's stages stay contiguous
    per = chunks * passes
    v = np.repeat(np.arange(nblocks), per)
    kc = np.tile(np.repeat(np.arange(chunks), passes), nblocks)
    rh = np.tile(np.arange(passes), nblocks * chunks)
    srt = np.lexsort((v, rh, kc, gid[v]))
    v, kc, rh = v[srt], kc[srt], rh[srt]
    run_start = np.ones(v.size, bool)
    run_start[1:] = (gid[v][1:] != gid[v][:-1]) | (kc[1:] != kc[:-1]) | (rh[1:] != rh[:-1])
    run = np.cumsum(run_start) - 1
    pos = np.arange(v.size) - np.flatnonzero(run_start)[run]
    # SPMM_GROUP blocks a stage where that makes stages of 1.5 blocks or
    # more on average, else 1 (a power law's blocks rarely share a column)
    group = SPMM_GROUP if v.size >= 1.5 * np.count_nonzero(pos % SPMM_GROUP == 0) else 1
    stage_start = pos % group == 0
    stage = np.cumsum(stage_start) - 1
    first = np.flatnonzero(stage_start)
    ns = first.size
    nb = np.bincount(stage, minlength=ns)
    slot = pos % group
    blocks = np.full((ns, SPMM_GROUP), -1, np.int64)
    arows = np.full((ns, SPMM_GROUP), -1, np.int64)
    blocks[stage, slot] = order[v]
    arows[stage, slot] = vrow[v] * passes + rh
    fresh = np.ones(ns, bool)
    fk = gid[v[first]] * chunks + kc[first]
    fresh[1:] = fk[1:] != fk[:-1]
    k0 = kc[first] * SPMM_DEPTH
    stages = np.concatenate([
        np.stack([bcol[order[v[first]]] * bc + k0, k0, (rh[first] << 1) | fresh, nb], 1),
        blocks, arows], axis=1)
    # each item's stage range: the stages of its visits
    first_of_item = np.searchsorted(item_of[v], np.arange(it.shape[0] + 1))
    ends = np.append(stage, ns)[first_of_item]
    it[:, 2], it[:, 3] = ends[:-1], ends[1:]
    sp = np.asarray(splits, np.int64).reshape(-1, 3)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)

    return SpmmSchedule(dev(it), dev(stages.reshape(-1, 4 + 2 * SPMM_GROUP)), dev(sp),
                        slots, nblocks, group)


@dataclasses.dataclass(frozen=True)
class BCSR:
    """Block CSR; ``rows`` / ``cols`` are the unpadded matrix shape."""

    block_row_ptr: torch.Tensor  # int32[nbrows + 1]
    block_col: torch.Tensor  # int32[capacity]; sentinel nbcols for padding
    blocks: torch.Tensor  # f32[capacity, br, bc]
    rows: int
    cols: int
    br: int
    bc: int
    schedule: SpmmSchedule | None = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def nbrows(self) -> int:
        return self.block_row_ptr.shape[0] - 1

    @property
    def nbcols(self) -> int:
        return -(-self.cols // self.bc)

    @property
    def block_capacity(self) -> int:
        return self.block_col.shape[0]

    @property
    def nblocks(self) -> torch.Tensor:
        """Number of stored blocks (a 0-d tensor on the BCSR's device)."""
        return self.block_row_ptr[-1]

    @property
    def device(self) -> torch.device:
        return self.block_row_ptr.device

    def nonzero_density(self) -> torch.Tensor:
        """Fill ratio of the stored blocks (BCSR::nonzeroDensity)."""
        nz = (self.blocks.abs() > 0).sum()
        return nz / torch.clamp(self.nblocks * self.br * self.bc, min=1)

    # ---- conversion --------------------------------------------------------
    @staticmethod
    def from_csr(a: CSR, br: int = 8, bc: int = 128) -> "BCSR":
        """Two-pass CSR -> BCSR on the host (BCSR.cc:10-66): the block
        pattern from one stable sort of the block keys, then a numeric
        fill that sums duplicate entries.  The same numpy code as the
        reference, so the arrays are bit-identical."""
        rp, col, val = a.to_numpy()
        rp = rp.astype(np.int64)
        erow = np.repeat(np.arange(a.rows, dtype=np.int64), np.diff(rp))
        brow = erow // br
        bcol = col // bc
        nbrows = -(-a.rows // br)
        nbcols = -(-a.cols // bc)
        key = brow * nbcols + bcol
        order = np.argsort(key, kind="stable")
        skey = key[order]
        first = np.ones(skey.shape[0], dtype=bool)
        first[1:] = skey[1:] != skey[:-1]
        block_id = np.cumsum(first) - 1
        nblocks = int(block_id[-1]) + 1 if skey.size else 0
        ukey = skey[first]
        ubrow = (ukey // nbcols).astype(np.int64)
        ubcol = (ukey % nbcols).astype(np.int32)
        counts = np.bincount(ubrow, minlength=nbrows)
        brp = np.zeros(nbrows + 1, dtype=np.int32)
        np.cumsum(counts, out=brp[1:])
        blocks = np.zeros((max(nblocks, 1), br, bc), dtype=np.float32)
        rr = (erow[order] % br).astype(np.int64)
        cc = (col[order] % bc).astype(np.int64)
        np.add.at(blocks, (block_id, rr, cc), val[order])
        bcol_arr = np.full(max(nblocks, 1), nbcols, dtype=np.int32)
        bcol_arr[:nblocks] = ubcol[:nblocks]
        dev = a.device
        return BCSR(
            block_row_ptr=torch.from_numpy(brp).to(dev),
            block_col=torch.from_numpy(bcol_arr).to(dev),
            blocks=torch.from_numpy(blocks).to(dev),
            rows=a.rows,
            cols=a.cols,
            br=br,
            bc=bc,
            schedule=spmm_schedule(brp, bcol_arr, br, bc, dev),
        )

    def to(self, device: torch.device | str) -> "BCSR":
        return dataclasses.replace(
            self,
            block_row_ptr=self.block_row_ptr.to(device),
            block_col=self.block_col.to(device),
            blocks=self.blocks.to(device),
            schedule=None if self.schedule is None else self.schedule.to(device),
        )

    def spmm_schedule(self) -> SpmmSchedule:
        """K5's schedule: the one ``from_csr`` built, or (for a BCSR made
        another way) one built now from host copies of the block row
        pointers and columns, which reads them back from the device."""
        if self.schedule is not None:
            return self.schedule
        return spmm_schedule(self.block_row_ptr.cpu().numpy(),
                             self.block_col.cpu().numpy(), self.br, self.bc, self.device)

    def block_rows(self) -> torch.Tensor:
        """Block row of every block slot (int64); padding slots past
        ``nblocks`` land in the last block row, as the reference's
        ``searchsorted``."""
        q = torch.arange(self.block_capacity, dtype=INDEX_DTYPE, device=self.device)
        return torch.searchsorted(self.block_row_ptr, q, right=True).long() - 1

    def to_dense(self) -> torch.Tensor:
        """Scatter the blocks to a dense (padded) matrix, then crop.  A
        padding slot (sentinel column) goes to one dump block past the
        end, where the reference drops it."""
        nbc, nbr = self.nbcols, self.nbrows
        brows = self.block_rows()
        bcols = self.block_col.long()
        ok = (brows < nbr) & (bcols < nbc)
        slot = torch.where(ok, brows * nbc + bcols, nbr * nbc)
        out = torch.zeros(
            (nbr * nbc + 1, self.br, self.bc), dtype=QVALUE_DTYPE, device=self.device
        )
        out.index_add_(0, slot, self.blocks)
        dense = out[:-1].view(nbr, nbc, self.br, self.bc).transpose(1, 2)
        dense = dense.reshape(nbr * self.br, nbc * self.bc)
        return dense[: self.rows, : self.cols]

    def is_equal(self, a: CSR, tol: float = 1e-6) -> bool:
        """Differential check against the CSR it came from
        (BCSR::isEqual, BCSR.cc:67-116)."""
        return bool(((self.to_dense() - a.to_dense()).abs() <= tol).all())
