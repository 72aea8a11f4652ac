"""K6-K8: the ring exchanges of the sharded R-MCL loop (port of the JAX
package's ``parallel/pallas_ring.py``).

The reference runs one program per chip under ``shard_map`` and moves
blocks between chips with remote DMAs.  The port launches the CUDA
kernels (``csrc/ring.cu``) in one of two modes, after the mesh
(``parallel/mesh.py``):

* stacked (no mesh, or a stacked one): the D ranks of the ring are
  stacked on one card, every operand carries a leading rank axis of D,
  and one launch runs all ranks, each rank writing into its neighbour's
  buffers through that rank's base pointer and raising a flag per
  region;
* one rank a launch (a process mesh): every process passes its own
  rank's blocks (a leading axis of 1) and launches its part alone; the
  neighbour's landing buffer and flags are CUDA IPC peer pointers
  (``parallel/peer.py``, allocated once per kernel and shape), the flags
  carry an epoch that the card takes from the set's counter and advances
  after each launch (every rank in step), so a CUDA graph may capture
  the launch, and each launch takes the share of the card's resident
  CTAs left by the ranks that share the card.  The grid's size is agreed
  by every rank once.  K6 one rank a launch also serves the process
  mesh's collectives on card tensors where a program asks for the peer
  route (:func:`peer_all_gather`, :func:`peer_ppermute`: one hop).

Every wait on a flag is bounded (30 s of the card's clock, then a trap):
a rank that never arrives fails the launch instead of hanging the card.
Tensors on the CPU run each kernel's plain twin instead (on a process
mesh: the twin over the group's all-gather of the blocks).
``<wrapper>.launches`` counts kernel launches.

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
CTAs), the launch is refused and the wrapper raises.  A launch copies
nothing to the card first: the ranks' pointers (and K7 / K8's TMA maps
of A) travel in the kernel's parameters, so a CUDA graph can capture
every launch of a stacked call.  K7 and K8 run on
the tensor cores in three TF32 passes (x = hi + lo, hi.hi + hi.lo +
lo.hi), each 16-deep stage's sum added into f32 with round-to-nearest,
as accurate as their twins, true-f32 ``torch.matmul`` calls
(``config.true_f32``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .._build import check_tensor, counted, current_stream, launch, on_card, query, stream_scratch
from ..config import QVALUE_DTYPE, true_f32
from . import collectives, peer

RIGHT, LEFT = 1, -1  # direction the blocks flow: to rank me + 1 or me - 1
STRIP_COLS = 64  # columns a CTA of K7 / K8 owns (kBN in csrc/ring.cu): one flag set a strip
# ranks K7 / K8's launch parameters hold (kMaxRanks in csrc/ring.cu): a rank's
# TMA map and four pointers, 160 bytes, in 32,764 bytes of parameters
MAX_MATMUL_RANKS = 204
# N tiles K8's rotating buffer holds, in turn: a CTA waits for the
# neighbour to have read tile t - 2 before it writes tile t there
RING_SLOTS = 2


def _owners(d: int, direction: int, device) -> torch.Tensor:
    """[d, d] int64: the owner of the block rank ``me`` holds at hop k,
    ``(me - direction * k) mod d``."""
    r = torch.arange(d, device=device)
    return (r[:, None] - direction * r[None, :]) % d


def _rotate_cols(a: torch.Tensor, lr: int, direction: int, ranks=None) -> torch.Tensor:
    """Owner-major column blocks of ``a`` [L, M, d*lr] -> rotation order
    (block k of rank me = owner's block at hop k), an index gather as
    the reference's ``jnp.take`` (pallas_ring.py:158-163, :275-279).
    Row i of ``a`` is rank ``ranks[i]`` (by default rank i, L = d)."""
    rows, m = a.shape[:2]
    d = a.shape[2] // lr
    own = _owners(d, direction, a.device)
    if ranks is not None:  # a slice: an index list would be uploaded
        own = own[ranks[0]:ranks[-1] + 1]
    blocks = a.view(rows, m, d, lr)
    idx = own[:, None, :, None].expand(rows, m, d, lr)
    return torch.gather(blocks, 2, idx).reshape(rows, m, d * lr)


def _blocks(x: torch.Tensor) -> list:
    """The addresses of the rank blocks of a stacked [d, ...] tensor."""
    step = x.stride(0) * x.element_size()
    return [x.data_ptr() + r * step for r in range(x.shape[0])]


def _one_rank(mesh) -> bool:
    """Whether the ring kernels launch one rank at a time on ``mesh``."""
    return collectives.is_process(mesh)


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


def ring_all_gather_plain(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """K6's twin: ``out[me, k] = x[(me - k) mod d]``, an index gather; on
    a process mesh the same over the group's all-gather of the blocks,
    this rank's row."""
    if _one_rank(mesh):
        full = collectives.all_gather(mesh, x)
        d, lr = full.shape[:2]
        return full[_owners(d, RIGHT, x.device)[mesh.rank]].reshape(1, d * lr, *x.shape[2:])
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


@counted
def ring_all_gather(*xs: torch.Tensor, mesh=None):
    """All-gather the ranks' ``[lr, ...]`` blocks around the ring:
    ``[d, lr, ...] -> [d, d*lr, ...]`` in rotation order, for one or more
    same-shaped operands of 4-byte dtypes (int32 cols, f32 vals) in one
    launch; the copy is bitwise.  Returns one output per operand (the
    output itself for one operand); on the card the outputs of one
    stacked call are views into one allocation.  On a process mesh each
    rank passes its own block, ``[1, lr, ...] -> [1, d*lr, ...]``
    (collective: every rank calls it)."""
    if not xs:
        raise ValueError("ring_all_gather: need at least one operand")
    for x in xs:
        _check_ranks(x, "ring_all_gather")
        if x.shape != xs[0].shape:
            raise ValueError(
                f"ring_all_gather: operands of shapes {tuple(xs[0].shape)} and "
                f"{tuple(x.shape)}"
            )
    if _one_rank(mesh) and xs[0].shape[0] != 1:
        raise ValueError("ring_all_gather: on a process mesh each rank passes one block")
    if on_card("ring_all_gather", *xs):
        outs = (_ring_all_gather_rank_launch(mesh, xs) if _one_rank(mesh)
                else _ring_all_gather_launch(xs))
    else:
        outs = [ring_all_gather_plain(x, mesh) for x in xs]
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


_RANK_GRIDS: dict = {}  # (mesh, words) -> K6's (CTAs, slice) agreed by every rank


def _rank_gather_grid(mesh, words: int) -> tuple:
    """K6's (CTAs, words of a block each owns) one rank a launch: this
    card's resident CTAs over the ranks that share it, the least of every
    rank's (CTA i of every rank must own the same slice), agreed once."""
    key = (mesh, words)
    if key not in _RANK_GRIDS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"K6's grid for {words} words is not agreed yet: a capture "
                               "cannot agree it (it is collective); run the body eagerly first")
        share = peer.card_share(mesh)
        ctas = peer.agree_min(mesh, query("smf_ring_all_gather_ctas", mesh.device, share))
        slice_ = max(-(-words // ctas), MIN_SLICE)
        slice_ += -slice_ % 4
        _RANK_GRIDS[key] = (-(-words // slice_), slice_)
    return _RANK_GRIDS[key]


def _landing_bytes(nbytes: int) -> int:
    """``nbytes`` rounded up to 256, so that the flags after it align."""
    return nbytes + -nbytes % 256


def _ring_all_gather_rank_launch(mesh, xs) -> list:
    """K6 one rank a launch, every hop: ``[1, lr, ...] -> [1, d*lr, ...]``
    for each operand, copied out of the landing buffer (one copy for
    all), so that the next launch may overwrite it."""
    x = xs[0]
    d = mesh.num_shards
    shape = (1, d * x.shape[1], *x.shape[2:])
    words = math.prod(x.shape[1:])
    if not words:
        return [torch.empty(shape, dtype=t.dtype, device=x.device) for t in xs]
    landed = _rank_gather_launch(mesh, [t.reshape(1, words) for t in xs], words,
                                 d - 1).clone()
    return [landed[op].view(t.dtype).view(shape) for op, t in enumerate(xs)]


def _rank_gather_launch(mesh, xs, words: int, hops: int) -> torch.Tensor:
    """One K6 launch of this rank on the operands ``xs`` (each [1, words]
    of a 4-byte dtype): this rank's landing buffer, int32 [ops, hops + 1,
    words], block k from rank (me - k) mod d (a view of the peer
    allocation, valid until the next launch on the set).  The launch
    reads its epoch from the set's counter on the card and enqueues the
    counter's advance, so a CUDA graph may capture it."""
    dev, ops = xs[0].device, len(xs)
    d, me = mesh.num_shards, mesh.rank
    if ops * d > MAX_RANK_POINTERS:
        raise ValueError(
            f"ring_all_gather: {ops} operands x {d} ranks exceed the "
            f"{MAX_RANK_POINTERS} rank pointers a launch's parameters hold"
        )
    ctas, slice_ = _rank_gather_grid(mesh, words)
    block = (hops + 1) * words * 4  # one operand's landing buffer, in bytes
    land = _landing_bytes(ops * block)
    flag_ints = d * (d - 1) * ctas + d
    ps = peer.peer_buffers(mesh, ("ring_all_gather", ops, words, hops),
                           land + 4 * flag_ints)
    dst = (me + 1) % d
    bases = (ctypes.c_longlong * (ops + ops * d))(
        *[t.data_ptr() for t in xs],
        *[ps.ptr(r) + op * block for op in range(ops) for r in range(d)])
    launch(
        "smf_ring_all_gather_rank", dev, ctypes.addressof(bases), ops, d, me, words, slice_,
        ctas, ps.ptr(me) + land, ps.ptr(dst) + land, ps.counter.data_ptr(), hops,
    )
    ring_all_gather.launches += 1
    return ps.view(0, ops * (hops + 1) * words).view(ops, hops + 1, words)


def _as_words(xs) -> tuple:
    """(operands, words): the blocks ``xs`` (each [1, ...], 4- or 8-byte
    dtypes) as int32 [1, words] operands of one K6 launch: the blocks
    themselves, viewed, when they share a shape and a 4-byte dtype, else
    the rows of one zeroed [ops, 1, words] tensor holding each block's
    bytes (a copy each)."""
    flat = [x.contiguous().reshape(-1).unsqueeze(-1).view(torch.int32).reshape(1, -1)
            for x in xs]
    words = max(f.shape[1] for f in flat)
    if all(f.shape[1] == words and x.element_size() == 4 for f, x in zip(flat, xs)):
        return flat, words
    staged = torch.zeros((len(xs), 1, words), dtype=torch.int32, device=xs[0].device)
    for i, f in enumerate(flat):
        staged[i, :, :f.shape[1]] = f
    return list(staged), words


def _from_words(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Blocks ``w`` (int32 [n, words], contiguous rows) of operand ``x``'s
    dtype and block shape ``x.shape[1:]``: [n, *x.shape[1:]]."""
    n = w.shape[0]
    used = x[0].numel() * x.element_size() // 4
    return w[:, :used].contiguous().reshape(-1).view(x.dtype).reshape(n, *x.shape[1:])


def _peer_route(mesh, xs) -> bool:
    """Whether the blocks ``xs`` of a process mesh travel through K6 (on
    the card) or through ``torch.distributed`` (the plain version, on the
    CPU)."""
    return on_card("ring_all_gather", *xs) and _one_rank(mesh)


def peer_all_gather(*xs: torch.Tensor, mesh) -> list:
    """``collectives.all_gather`` of one or more blocks in one K6 launch
    on a process mesh (the peer route): each [1, ...] block of this rank
    -> [D, ...], owner-major, the bytes of every rank's block as they are
    (4- and 8-byte dtypes; blocks of other shapes travel packed).  On the
    CPU, the group's all-gather of each block."""
    if not _peer_route(mesh, xs):
        return [collectives.all_gather(mesh, x) for x in xs]
    d = mesh.num_shards
    ws, words = _as_words(xs)
    landed = _rank_gather_launch(mesh, ws, words, d - 1)  # rotation order
    pos = _owners(d, RIGHT, landed.device)[mesh.rank]  # owner j at hop (me - j) mod d
    owned = landed[:, pos]  # a copy: the landing buffer is the next launch's
    return [_from_words(owned[i], x) for i, x in enumerate(xs)]


def peer_ppermute(*xs: torch.Tensor, mesh) -> list:
    """``collectives.ppermute(i -> i + 1)`` of one or more blocks in one
    K6 launch of one hop on a process mesh (the peer route): rank me
    receives rank (me - 1) mod D's blocks.  On the CPU, the group's send
    and receive of each block."""
    if not _peer_route(mesh, xs) or mesh.num_shards == 1:
        return [collectives.ppermute(mesh, x, 1) for x in xs]
    ws, words = _as_words(xs)
    landed = _rank_gather_launch(mesh, ws, words, 1)
    got = landed[:, 1].clone()  # [ops, words]: the upstream rank's blocks
    return [_from_words(got[i:i + 1], x) for i, x in enumerate(xs)]


def unrotate(g: torch.Tensor, mesh=None) -> torch.Tensor:
    """Rotation order (block k = shard (me - k) mod d) -> owner-major
    (block j = shard j), for every rank of ``g`` [d, d*lr, ...] (on a
    process mesh, this rank's [1, d*lr, ...])."""
    ranks = collectives.local_ranks(mesh, g.shape[0])
    d = mesh.num_shards if mesh is not None else g.shape[0]
    lr = g.shape[1] // d
    blocks = g.view(g.shape[0], d, lr, *g.shape[2:])
    # position of owner j: (me - j) mod d (the held ranks are contiguous: a
    # slice, where an index list would be an upload)
    pos = _owners(d, RIGHT, g.device)[ranks[0]:ranks[-1] + 1]
    rows = torch.arange(g.shape[0], device=g.device)[:, None]
    return blocks[rows, pos].reshape(g.shape)


# ---------------------------------------------------------------------------
# K7 / K8: ring matmul
# ---------------------------------------------------------------------------
def _check_matmul(a: torch.Tensor, b: torch.Tensor, name: str, mesh=None) -> tuple:
    check_tensor(a, f"{name} a", QVALUE_DTYPE, 3)
    check_tensor(b, f"{name} b", QVALUE_DTYPE, 3)
    rows, m, k = a.shape
    lr, n = b.shape[1:]
    d = mesh.num_shards if _one_rank(mesh) else rows
    if b.shape[0] != rows or k != d * lr or (_one_rank(mesh) and rows != 1):
        raise ValueError(
            f"{name}: a {tuple(a.shape)} and b {tuple(b.shape)} need "
            f"[d, M, d*lr] and [d, lr, N] (one rank a process: [1, M, d*lr] "
            f"and [1, lr, N])"
        )
    return d, m, lr, n


def _check_matmul_ranks(d: int, name: str) -> None:
    """The card launch's limit: every rank's pointers and A's TMA map
    travel in one parameter struct of MAX_MATMUL_RANKS ranks, stacked
    and one rank a launch alike (``fill_ranks`` in csrc/ring.cu).  The
    plain version on the CPU has none."""
    if d > MAX_MATMUL_RANKS:
        raise ValueError(f"{name}: {d} ranks exceed the {MAX_MATMUL_RANKS} that the "
                         f"kernel's launch parameters hold")


def _ring_matmul_twin(a_rot, b, direction: int, ranks=None) -> torch.Tensor:
    """Rank me adds ``a_rot[me][:, block k] @ b[owner]`` over k in the
    ring's order (true f32: ``config.true_f32``); ``b`` holds every
    rank's block, row i of ``a_rot`` is rank ``ranks[i]`` (by default
    rank i)."""
    d = b.shape[0]
    rows, m, _ = a_rot.shape
    lr, n = b.shape[1:]
    own = [[(me - direction * k) % d for k in range(d)] for me in range(d)]  # _owners
    out = torch.zeros((rows, m, n), dtype=QVALUE_DTYPE, device=b.device)
    for i, me in enumerate(range(d) if ranks is None else ranks):
        for k in range(d):
            with true_f32():
                part = torch.matmul(a_rot[i, :, k * lr:(k + 1) * lr], b[own[me][k]])
            out[i] += part
    return out


def _ring_matmul_plain(a, b, direction: int, mesh) -> torch.Tensor:
    """The twin in ``direction``'s order; on a process mesh over the
    group's all-gather of B, this rank's row."""
    lr = b.shape[1]
    if _one_rank(mesh):
        ranks = [mesh.rank]
        return _ring_matmul_twin(_rotate_cols(a, lr, direction, ranks),
                                 collectives.all_gather(mesh, b), direction, ranks)
    return _ring_matmul_twin(_rotate_cols(a, lr, direction), b, direction)


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
    ptrs = (ctypes.c_longlong * (4 * d))(
        *_blocks(a_rot), *_blocks(b), *([t.data_ptr() for t in bufs] or [0]), *_blocks(c))
    args = [ctypes.addressof(ptrs), flags.data_ptr(), d, m, lr, n]
    if tiled:
        args += [nt, slots]
    launch(name, dev, *args)
    return c


def _ring_matmul_rank_launch(mesh, a, b, d, m, lr, n, nt, direction):
    """K7 (``direction`` RIGHT, nt = N) or K8 (LEFT) one rank a launch:
    this rank's rotating buffer and flags are its peer allocation, the
    downstream rank's are reached through its peer pointer; A's TMA map
    is built from this rank's A alone."""
    me, dev = mesh.rank, b.device
    a_rot = _rotate_cols(a, lr, direction, [me])
    c = torch.empty((1, m, n), dtype=QVALUE_DTYPE, device=dev)
    if not (m and n):
        return c
    tiles = n // nt
    slots = min(RING_SLOTS, tiles) if direction == LEFT else 1
    strips = tiles * -(-nt // STRIP_COLS)
    land = _landing_bytes(slots * (d - 1) * lr * nt * 4)
    flag_ints = d * strips * (d + 1) + d
    ps = peer.peer_buffers(mesh, ("ring_matmul", direction, lr, n, nt), land + 4 * flag_ints)
    dst = (me + direction) % d

    def mine(address):  # d addresses, this rank's set
        return [address if r == me else 0 for r in range(d)]

    ptrs = (ctypes.c_longlong * (4 * d))(
        *mine(a_rot.data_ptr()), *mine(b.data_ptr()), *[ps.ptr(r) for r in range(d)],
        *mine(c.data_ptr()))
    launch(
        "smf_ring_matmul_rank", dev, ctypes.addressof(ptrs), ps.ptr(me) + land,
        ps.ptr(dst) + land, d, m, lr, n, nt, slots, direction, me,
        peer.card_share(mesh), ps.counter.data_ptr(),
    )
    return c


def ring_matmul_plain(a: torch.Tensor, b: torch.Tensor, mesh=None) -> torch.Tensor:
    """K7's twin: blocks in the rightward ring's order."""
    return _ring_matmul_plain(a, b, RIGHT, mesh)


@counted
def ring_matmul(a: torch.Tensor, b: torch.Tensor, mesh=None) -> torch.Tensor:
    """``C[me] = A[me] . B_full`` with B row-sharded: ``a`` [d, M, d*lr]
    (column block j multiplies shard j's block, owner-major), ``b``
    [d, lr, N]; returns [d, M, N].  Block k is contracted at hop k,
    blocks flowing right.  On a process mesh each rank passes its own
    rows, ``a`` [1, M, d*lr] and ``b`` [1, lr, N] (collective).  On the
    card, stacked or on a process mesh, d is at most MAX_MATMUL_RANKS."""
    d, m, lr, n = _check_matmul(a, b, "ring_matmul", mesh)
    if not on_card("ring_matmul", a, b):
        return ring_matmul_plain(a, b, mesh)
    _check_matmul_ranks(d, "ring_matmul")
    if _one_rank(mesh):
        c = _ring_matmul_rank_launch(mesh, a, b, d, m, lr, n, n, RIGHT)
    else:
        a_rot = _rotate_cols(a, lr, RIGHT)
        c = _ring_matmul_launch("smf_ring_matmul", a_rot, b, d, m, lr, n, n)
    if m and n:
        ring_matmul.launches += 1
    return c


def _check_nt(n: int, nt: int) -> None:
    if nt <= 0 or n % nt:
        raise ValueError(f"N = {n} not a multiple of nt = {nt}")


def ring_matmul_tiled_plain(a: torch.Tensor, b: torch.Tensor, nt: int = 2048,
                            mesh=None) -> torch.Tensor:
    """K8's twin: blocks in the leftward ring's order (the N tiling does
    not change any element's sum)."""
    _check_nt(b.shape[2], nt)
    return _ring_matmul_plain(a, b, LEFT, mesh)


@counted
def ring_matmul_tiled(a: torch.Tensor, b: torch.Tensor, nt: int = 2048,
                      mesh=None) -> torch.Tensor:
    """:func:`ring_matmul` over ``N / nt`` column tiles, blocks flowing
    left (the production hub contraction of ``exchange="fused_ring"``);
    ``N % nt == 0`` (pad B's columns with zeros).  On a process mesh each
    rank passes its own rows, as for :func:`ring_matmul`, and on the card
    d is at most MAX_MATMUL_RANKS as there."""
    d, m, lr, n = _check_matmul(a, b, "ring_matmul_tiled", mesh)
    _check_nt(n, nt)
    if not on_card("ring_matmul_tiled", a, b):
        return ring_matmul_tiled_plain(a, b, nt, mesh)
    _check_matmul_ranks(d, "ring_matmul_tiled")
    if _one_rank(mesh):
        c = _ring_matmul_rank_launch(mesh, a, b, d, m, lr, n, nt, LEFT)
    else:
        a_rot = _rotate_cols(a, lr, LEFT)
        c = _ring_matmul_launch("smf_ring_matmul_tiled", a_rot, b, d, m, lr, n, nt)
    if m and n:
        ring_matmul_tiled.launches += 1
    return c
