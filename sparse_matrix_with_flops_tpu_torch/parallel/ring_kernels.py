"""K6-K8: the ring exchanges of the sharded R-MCL loop (port of the JAX
package's ``parallel/pallas_ring.py``).

The reference runs one program per chip under ``shard_map`` and moves
blocks between chips with remote DMAs.  Here the D ranks of the ring are
stacked on one card: every operand carries a leading rank axis, and one
launch of the CUDA kernel (``csrc/ring.cu``) runs all ranks, each rank
writing into its neighbour's buffers through that rank's base pointer
and raising a flag per region.  Tensors on the CPU run each kernel's
plain twin instead.  ``<wrapper>.launches`` counts kernel launches.

* ``ring_all_gather`` (K6): ``[d, lr, ...] -> [d, d*lr, ...]``, block k
  of rank me being rank ``(me - k) mod d``'s (rotation order), for one
  or more operands in one launch; :func:`unrotate` reorders it to
  owner-major;
* ``ring_matmul`` (K7): ``C[me] = A[me] . concat(B)`` with B row-sharded,
  blocks flowing right (block k is owner ``(me - k) mod d``);
* ``ring_matmul_tiled`` (K8): K7 over N tiles of ``nt`` columns, blocks
  flowing left (block k is owner ``(me + k) mod d``), the owner order of
  the unfused ring chain of ``parallel/rmcl_ell._segments_ring``.

Each launch is cooperative, with as many CTAs a rank as are resident
at once; when not even one a rank fits (d above the card's resident
CTAs), the launch is refused and the wrapper raises.  K7 and K8 run on
the tensor cores in three TF32 passes (x = hi + lo, hi.hi + hi.lo +
lo.hi), each 16-deep stage's sum added into f32 with round-to-nearest,
as accurate as their twins, true-f32 ``torch.matmul`` calls
(``config.true_f32``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .._build import check_tensor, current_stream, launch, on_card, query, stream_scratch
from ..config import QVALUE_DTYPE, true_f32

RIGHT, LEFT = 1, -1  # direction the blocks flow: to rank me + 1 or me - 1
STRIP_COLS = 64  # columns a CTA of K7 / K8 owns (kBN in csrc/ring.cu): one flag set a strip
TMA_MAP_BYTES = 128  # sizeof(CUtensorMap): K7 / K8 load each rank's A through one
# N tiles K8's rotating buffer holds, in turn: a CTA waits for the
# neighbour to have read tile t - 2 before it writes tile t there
RING_SLOTS = 2


def _owners(d: int, direction: int, device) -> torch.Tensor:
    """[d, d] int64: the owner of the block rank ``me`` holds at hop k,
    ``(me - direction * k) mod d``."""
    r = torch.arange(d, device=device)
    return (r[:, None] - direction * r[None, :]) % d


def _rotate_cols(a: torch.Tensor, lr: int, direction: int) -> torch.Tensor:
    """Owner-major column blocks of ``a`` [d, M, d*lr] -> rotation order
    (block k of rank me = owner's block at hop k), an index gather as
    the reference's ``jnp.take`` (pallas_ring.py:158-163, :275-279)."""
    d, m = a.shape[:2]
    own = _owners(d, direction, a.device)
    blocks = a.view(d, m, d, lr)
    idx = own[:, None, :, None].expand(d, m, d, lr)
    return torch.gather(blocks, 2, idx).reshape(d, m, d * lr)


def _ptrs(tensors, device) -> torch.Tensor:
    """Device array of the tensors' base pointers (int64)."""
    return torch.tensor([t.data_ptr() for t in tensors], dtype=torch.int64,
                        device=device)


def _check_ranks(x: torch.Tensor, name: str) -> None:
    if x.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"{name}: expected int32 or float32, got {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous [d, lr, ...] tensor")


# ---------------------------------------------------------------------------
# K6: ring all-gather
# ---------------------------------------------------------------------------
GATHER_THREADS = 256  # threads of a K6 CTA (kGatherThreads in csrc/ring.cu)
MIN_SLICE = 4 * GATHER_THREADS  # words of a block a CTA owns at least
MAX_RANK_POINTERS = 2040  # ops * d the launch's parameters hold (kPtrsLarge)
_GRIDS: dict = {}  # (device index, d, words) -> K6's (CTAs a rank, slice, flag words)


def ring_all_gather_plain(x: torch.Tensor) -> torch.Tensor:
    """K6's twin: ``out[me, k] = x[(me - k) mod d]``, an index gather."""
    d, lr = x.shape[:2]
    return x[_owners(d, RIGHT, x.device)].reshape(d, d * lr, *x.shape[2:])


def _gather_grid(dev: torch.device, d: int, words: int) -> tuple:
    """(CTAs a rank, words of a block each owns, int64 words of flags):
    at most as many CTAs as are resident at once (the occupancy query
    runs once per device and shape), each owning a slice of at least
    MIN_SLICE words, a multiple of 4."""
    key = (dev.index, d, words)
    if key not in _GRIDS:
        ctas = query("smf_ring_all_gather_ctas", dev, d)
        slice_ = max(-(-words // ctas), MIN_SLICE)
        slice_ += -slice_ % 4
        ctas = -(-words // slice_)
        _GRIDS[key] = (ctas, slice_, max(1, -(-d * (d - 1) * ctas // 2)))
    return _GRIDS[key]


def ring_all_gather(*xs: torch.Tensor):
    """All-gather the ranks' ``[lr, ...]`` blocks around the ring:
    ``[d, lr, ...] -> [d, d*lr, ...]`` in rotation order, for one or more
    same-shaped operands of 4-byte dtypes (int32 cols, f32 vals) in one
    launch; the copy is bitwise.  Returns one output per operand (the
    output itself for one operand); on the card the outputs of one call
    are views into one allocation."""
    if not xs:
        raise ValueError("ring_all_gather: need at least one operand")
    for x in xs:
        _check_ranks(x, "ring_all_gather")
        if x.shape != xs[0].shape:
            raise ValueError(
                f"ring_all_gather: operands of shapes {tuple(xs[0].shape)} and "
                f"{tuple(x.shape)}"
            )
    if on_card("ring_all_gather", *xs):
        outs = _ring_all_gather_launch(xs)
    else:
        outs = [ring_all_gather_plain(x) for x in xs]
    return outs[0] if len(xs) == 1 else tuple(outs)


def _ring_all_gather_launch(xs) -> list:
    x = xs[0]
    dev, ops = x.device, len(xs)
    d, lr = x.shape[:2]
    if ops * d > MAX_RANK_POINTERS:
        raise ValueError(
            f"ring_all_gather: {ops} operands x {d} ranks exceed the "
            f"{MAX_RANK_POINTERS} rank pointers a launch's parameters hold"
        )
    buf = torch.empty((ops, d, d * lr, *x.shape[2:]), dtype=torch.int32, device=dev)
    outs = [buf[i] if t.dtype == torch.int32 else buf[i].view(t.dtype)
            for i, t in enumerate(xs)]
    words = math.prod(x.shape[1:])
    if not words:
        return outs
    ctas, slice_, flag_words = _gather_grid(dev, d, words)
    bases = (ctypes.c_longlong * (2 * ops))(
        *[t.data_ptr() for t in xs], *[t.data_ptr() for t in outs])
    stream = current_stream(dev)
    flags, epoch = stream_scratch("ring_all_gather", dev, stream, flag_words)
    launch(
        "smf_ring_all_gather", dev, ctypes.addressof(bases), ops, d, words, slice_,
        ctas, flags.data_ptr(), epoch, stream=stream,
    )
    ring_all_gather.launches += 1
    return outs


ring_all_gather.launches = 0


def unrotate(g: torch.Tensor) -> torch.Tensor:
    """Rotation order (block k = shard (me - k) mod d) -> owner-major
    (block j = shard j), for every rank of ``g`` [d, d*lr, ...]."""
    d = g.shape[0]
    lr = g.shape[1] // d
    blocks = g.view(d, d, lr, *g.shape[2:])
    pos = _owners(d, RIGHT, g.device)  # position of owner j: (me - j) mod d
    return blocks[torch.arange(d, device=g.device)[:, None], pos].reshape(g.shape)


# ---------------------------------------------------------------------------
# K7 / K8: ring matmul
# ---------------------------------------------------------------------------
def _check_matmul(a: torch.Tensor, b: torch.Tensor, name: str) -> tuple:
    check_tensor(a, f"{name} a", QVALUE_DTYPE, 3)
    check_tensor(b, f"{name} b", QVALUE_DTYPE, 3)
    d, m, k = a.shape
    lr, n = b.shape[1:]
    if b.shape[0] != d or k != d * lr:
        raise ValueError(
            f"{name}: a {tuple(a.shape)} and b {tuple(b.shape)} need "
            f"[d, M, d*lr] and [d, lr, N]"
        )
    return d, m, lr, n


def _ring_matmul_twin(a_rot, b, direction: int) -> torch.Tensor:
    """Rank me adds ``a_rot[me][:, block k] @ b[owner]`` over k in the
    ring's order (true f32: ``config.true_f32``)."""
    d, m, _ = a_rot.shape
    lr, n = b.shape[1:]
    own = _owners(d, direction, b.device).tolist()
    out = torch.zeros((d, m, n), dtype=QVALUE_DTYPE, device=b.device)
    for me in range(d):
        for k in range(d):
            with true_f32():
                part = torch.matmul(a_rot[me, :, k * lr:(k + 1) * lr], b[own[me][k]])
            out[me] += part
    return out


def _ring_matmul_launch(name, a_rot, b, d, m, lr, n, nt):
    c = torch.empty((d, m, n), dtype=QVALUE_DTYPE, device=b.device)
    if not (m and n):
        return c
    dev = b.device
    tiles = n // nt
    tiled = name == "smf_ring_matmul_tiled"
    slots = min(RING_SLOTS, tiles) if tiled else 1
    if d == 1:
        bufs = []
    else:  # each rank's rotating buffer is its own allocation
        bufs = [torch.empty(slots * (d - 1) * lr * nt, dtype=QVALUE_DTYPE, device=dev)
                for _ in range(d)]
    strips = tiles * -(-nt // STRIP_COLS)
    flags = torch.zeros(d * strips * (d + 1), dtype=torch.int32, device=dev)
    ptrs = [_ptrs(t, dev) for t in (a_rot, b, bufs, c)]  # alive past the launch
    a_host = _ptrs(a_rot, "cpu")  # the kernel's TMA maps of A are made from these
    maps = torch.empty((d, TMA_MAP_BYTES), dtype=torch.uint8, device=dev)
    args = [
        ptrs[0].data_ptr(), a_host.data_ptr(), ptrs[1].data_ptr(),
        ptrs[2].data_ptr() if bufs else 0, ptrs[3].data_ptr(), flags.data_ptr(),
        maps.data_ptr(), d, m, lr, n,
    ]
    if tiled:
        args += [nt, slots]
    launch(name, dev, *args)
    return c


def ring_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K7's twin: blocks in the rightward ring's order."""
    lr = b.shape[1]
    return _ring_matmul_twin(_rotate_cols(a, lr, RIGHT), b, RIGHT)


def ring_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C[me] = A[me] . B_full`` with B row-sharded: ``a`` [d, M, d*lr]
    (column block j multiplies shard j's block, owner-major), ``b``
    [d, lr, N]; returns [d, M, N].  Block k is contracted at hop k,
    blocks flowing right."""
    d, m, lr, n = _check_matmul(a, b, "ring_matmul")
    if not on_card("ring_matmul", a, b):
        return ring_matmul_plain(a, b)
    a_rot = _rotate_cols(a, lr, RIGHT)
    c = _ring_matmul_launch("smf_ring_matmul", a_rot, b, d, m, lr, n, n)
    if m and n:
        ring_matmul.launches += 1
    return c


ring_matmul.launches = 0


def _check_nt(n: int, nt: int) -> None:
    if nt <= 0 or n % nt:
        raise ValueError(f"N = {n} not a multiple of nt = {nt}")


def ring_matmul_tiled_plain(a: torch.Tensor, b: torch.Tensor, nt: int = 2048) -> torch.Tensor:
    """K8's twin: blocks in the leftward ring's order (the N tiling does
    not change any element's sum)."""
    _check_nt(b.shape[2], nt)
    lr = b.shape[1]
    return _ring_matmul_twin(_rotate_cols(a, lr, LEFT), b, LEFT)


def ring_matmul_tiled(a: torch.Tensor, b: torch.Tensor, nt: int = 2048) -> torch.Tensor:
    """:func:`ring_matmul` over ``N / nt`` column tiles, blocks flowing
    left (the production hub contraction of ``exchange="fused_ring"``);
    ``N % nt == 0`` (pad B's columns with zeros)."""
    d, m, lr, n = _check_matmul(a, b, "ring_matmul_tiled")
    _check_nt(n, nt)
    if not on_card("ring_matmul_tiled", a, b):
        return ring_matmul_tiled_plain(a, b, nt)
    a_rot = _rotate_cols(a, lr, LEFT)
    c = _ring_matmul_launch("smf_ring_matmul_tiled", a_rot, b, d, m, lr, n, nt)
    if m and n:
        ring_matmul_tiled.launches += 1
    return c


ring_matmul_tiled.launches = 0
