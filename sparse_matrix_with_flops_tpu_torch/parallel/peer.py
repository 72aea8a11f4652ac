"""Peer buffers of the ring kernels K6-K8 launched one rank a process
(``parallel/ring_kernels.py`` on a process mesh).

A kernel launched by rank ``me`` writes its blocks into its downstream
neighbour's landing buffer and raises that neighbour's flags, so each
rank's landing buffers and flags must be reachable from the other ranks'
launches.  A :class:`PeerBuffers` is one such set, made collectively by
every rank of the group for one kernel at one shape (a plan's shapes are
fixed, so a plan makes each set once and reuses it every iteration):

* each rank allocates its bytes with ``cudaMalloc`` through the port's
  ctypes binding (``csrc/peer.cu``), not the caching allocator, whose
  blocks share a segment, and zeroes them once;
* it exports one CUDA IPC handle, the 64-byte handles are all-gathered
  over the group as a uint8 tensor, and each rank opens the others'
  handles (a process cannot open its own: it keeps its own pointer);
* ``ptr(r)`` is rank r's allocation as this process maps it: rank
  ``me`` reaches rank ``dst`` only through that pointer;
* ``counter`` is the set's epoch counter on the card (an int32 of this
  rank's own, 0 at first): a launch passes its pointer, every CTA takes
  the launch's epoch from it and the launch's entry point enqueues its
  advance right after the launch (``csrc/ring.cu``).  Every rank runs
  the same sequence of launches on a set (each launch is collective), so
  the counters advance in step, every rank of a launch tags its flags
  with the same epoch, and no flag is ever cleared.  A CUDA graph that
  captured launches on a set takes a new epoch at every replay, so
  eager launches and replays interleave on one set.

A set is made eagerly, never inside a capture (it is collective and reads
the handles back): :func:`peer_buffers` raises, naming the set, if a
capture would need a new one.  :func:`close_all` drops every CUDA graph of
a process-mesh program (``utils/graphs.py``: the graphs hold the sets'
pointers), then unmaps every opened handle and frees every allocation;
call it before ``torch.distributed.destroy_process_group``.  The sets are
kept per (mesh, kernel, shape) until then.
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np
import torch
import torch.distributed as dist

from .. import _build
from . import collectives

class _DeviceArray:
    """``__cuda_array_interface__`` of raw device memory, for a torch view."""

    def __init__(self, ptr: int, numel: int, typestr: str):
        self.__cuda_array_interface__ = {
            "shape": (numel,), "typestr": typestr, "data": (ptr, False), "version": 2,
            "strides": None,
        }


def card_digest(device: torch.device) -> np.ndarray:
    """16 bytes naming the card (its UUID's digest): ranks with equal
    digests share one card."""
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    return np.frombuffer(hashlib.md5(uuid.encode()).digest(), np.uint8)


class PeerBuffers:
    """One rank's view of a peer-buffer set: ``nbytes`` on every rank."""

    def __init__(self, mesh, nbytes: int):
        dev = mesh.device
        self.mesh, self.nbytes, self.device = mesh, int(nbytes), dev
        hb = _build.query("smf_peer_handle_bytes", dev)
        own = ctypes.c_void_p()
        handle = (ctypes.c_ubyte * hb)()
        _build.call("smf_peer_alloc", dev, self.nbytes, ctypes.addressof(own),
                    ctypes.addressof(handle))
        self._own = own.value
        mine = np.frombuffer(bytes(handle), np.uint8)
        allh = collectives.all_gather(
            mesh, torch.from_numpy(mine[None].copy()).to(dev)).cpu().numpy()
        self._ptrs, self._opened = [], []
        for r in range(mesh.num_shards):
            if r == mesh.rank:
                self._ptrs.append(self._own)
                continue
            p = ctypes.c_void_p()
            h = (ctypes.c_ubyte * hb).from_buffer_copy(allh[r, :hb].tobytes())
            _build.call("smf_peer_open", dev, ctypes.addressof(h), ctypes.addressof(p))
            self._ptrs.append(p.value)
            self._opened.append(p.value)
        self.counter = torch.zeros(1, dtype=torch.int32, device=dev)
        self._views: dict = {}

    def ptr(self, rank: int) -> int:
        """Rank ``rank``'s allocation as this process maps it."""
        return self._ptrs[rank]

    def view(self, offset: int, numel: int, dtype=torch.int32) -> torch.Tensor:
        """This rank's allocation from byte ``offset`` as a 1-D tensor (a
        view, made once: valid until :func:`close_all`)."""
        key = (offset, numel, dtype)
        if key not in self._views:
            typestr = {torch.int32: "<i4", torch.float32: "<f4"}[dtype]
            self._views[key] = torch.as_tensor(
                _DeviceArray(self._own + offset, numel, typestr), device=self.device)
        return self._views[key]

    def close(self) -> None:
        for p in self._opened:
            _build.call("smf_peer_close", self.device, ctypes.c_void_p(p))
        self._opened = []

    def free(self) -> None:
        if self._own:
            _build.call("smf_peer_free", self.device, ctypes.c_void_p(self._own))
            self._own = 0


_SETS: dict = {}  # (mesh, key) -> PeerBuffers
_SHARE: dict = {}  # mesh -> ranks on this rank's card


def card_share(mesh) -> int:
    """How many ranks of ``mesh`` run on this rank's card (collective on
    first use): a launch of one rank takes that share of the card's
    resident CTAs, so that the ranks' launches fit beside each other."""
    if mesh not in _SHARE:
        me = torch.from_numpy(card_digest(mesh.device)[None].copy()).to(mesh.device)
        every = collectives.all_gather(mesh, me).cpu().numpy()
        _SHARE[mesh] = int((every == every[mesh.rank]).all(axis=1).sum())
    return _SHARE[mesh]


def peer_buffers(mesh, key: tuple, nbytes: int) -> PeerBuffers:
    """The set for ``key`` on ``mesh``, made (collectively) on first use;
    inside a CUDA graph capture a set not yet made raises."""
    k = (mesh, key)
    if k not in _SETS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"peer set {key} of rank {mesh.rank} is not made yet: a capture cannot make "
                "it (it is collective); run the body eagerly once first")
        _SETS[k] = PeerBuffers(mesh, nbytes)
    return _SETS[k]


def agree_min(mesh, value: int) -> int:
    """The least of every rank's ``value`` (collective)."""
    x = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    return int(collectives.all_gather(mesh, x).min())


def close_all() -> None:
    """Drop every process-mesh CUDA graph, unmap every opened peer
    allocation, then free this process's own (collective: every rank of
    the group calls it; the card is synchronised and the group waits
    between the steps, so no rank frees memory that a peer still maps, a
    launch still writes or a graph could replay into)."""
    from ..utils import graphs

    _SHARE.clear()
    if not _SETS:
        return
    sets = list(_SETS.values())
    _SETS.clear()
    torch.cuda.synchronize(sets[0].device)
    graphs.drop_process_graphs()
    dist.barrier()
    for s in sets:
        s.close()
    torch.cuda.synchronize(sets[0].device)
    dist.barrier()
    for s in sets:
        s.free()
