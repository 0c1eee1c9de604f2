"""Eager `Communicator` — the port of ``dear_pytorch_tpu/comm/communicator.py``,
the API mirror of the reference's C++ ``comm_core`` class.

The reference's ``Communicator(nstreams)`` owns N CUDA streams, each with a
NCCL communicator of its own, enqueues one collective per call on a
round-robin stream and returns the stream index as a handle;
``synchronize()`` / ``syncStream(h)`` block the host on the streams. Here:

  stream and communicator  -> a CUDA stream (on the card) and a process
                              group of its own over the same ranks
                              (``dist.new_group``): a NCCL group runs its
                              collectives on a stream of its own, so N
                              streams need N groups
  enqueue on a side stream -> an async collective of `comm.collectives`
                              issued on handle h's stream and group
  cudaStreamSynchronize    -> wait on handle h's works, then synchronize
                              its stream
  cudaStreamQuery          -> ``work.is_completed()``
  destroy() / reload()     -> tear the groups down / form new ones (every
                              rank calls both, as NCCL's communicator
                              teardown and init are collective)

Every method takes this rank's tensor (the port's convention, where the JAX
mirror takes stacked ``(world, ...)`` arrays), never changes it, and
returns ``(out, handle)``: read ``out`` after `syncStream` of the handle or
`synchronize`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import collectives as C

__all__ = ["Communicator"]


class Communicator:
    """Round-robin async collective issuer over ``group``'s ranks (default:
    `comm.backend.group()`), with its streams on the device this process's
    group runs on (`comm.backend.device`)."""

    def __init__(self, nstreams: int = 1, group=None):
        self.nstreams = max(1, int(nstreams))
        self._base = backend.group() if group is None else group
        self.device = backend.device()
        self._groups: List = []
        self._streams: List = []
        # handle -> works still in flight on it. A reused handle appends
        # (a busy NCCL stream queues; it does not cancel), so synchronize()
        # fences everything issued
        self._pending: Dict[int, list] = {}
        self._next_handle = 0
        self.reload()

    # -- internals ----------------------------------------------------------

    def _issue(self, fn: Callable, *args):
        """``fn(*args, group, async_op=True)`` on the next handle's group and
        stream, after the caller's stream's work so far; returns ``(out,
        handle)``."""
        if not self._groups:
            raise RuntimeError("Communicator destroyed; call reload()")
        handle = self._next_handle % self.nstreams
        self._next_handle += 1
        grp = self._groups[handle]
        if self.device.type == "cuda":
            stream = self._streams[handle]
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                out, works = fn(*args, grp)
        else:
            out, works = fn(*args, grp)
        self._pending.setdefault(handle, []).extend(
            w for w in (works if isinstance(works, list) else [works])
            if w is not None)
        return out, handle

    # -- collectives (names follow comm_core.cpp:22-37 exports) -------------

    def reduce(self, x: torch.Tensor, root: int = 0):
        return self._issue(lambda t, g: C.reduce(t, root, g, async_op=True),
                           x)

    def bcast(self, x: torch.Tensor, root: int = 0):
        return self._issue(lambda t, g: C.broadcast(
            t, root, g, async_op=True, out=torch.empty_like(t)), x)

    def allReduce(self, x: torch.Tensor):
        return self._issue(lambda t, g: C.all_reduce(t, g, async_op=True), x)

    def allReduceRB(self, x: torch.Tensor, root: int = 0):
        return self._issue(lambda t, g: C.all_reduce_rb(
            t, root, g, async_op=True), x)

    def allReduceRSAG(self, x: torch.Tensor):
        return self._issue(lambda t, g: C.all_reduce_rsag(
            t, g, async_op=True), x)

    def reduceScatter(self, x: torch.Tensor):
        """``x`` of n elements, n % world == 0 -> n // world elements."""
        return self._issue(lambda t, g: C.reduce_scatter(
            t, g, async_op=True), x)

    def allGather(self, x: torch.Tensor):
        """``x`` of n elements -> n * world elements, in rank order."""
        return self._issue(lambda t, g: C.all_gather(t, g, async_op=True), x)

    def sendrecv(self, x: torch.Tensor, peer_of: Sequence[int]):
        peers = [int(p) for p in peer_of]
        return self._issue(lambda t, g: C.send_recv(
            t, peers, g, async_op=True), x)

    def multiBcast(self, xs: Sequence[torch.Tensor], fn: Callable,
                   min_elems: int = 512 * 512):
        """`comm.collectives.multi_bcast` of ``xs`` on one handle; returns
        ``(outs, handle)``."""
        return self._issue(lambda ts, g: C.multi_bcast(
            ts, fn, min_elems, g, async_op=True), list(xs))

    # -- synchronization (communicator.cpp:103-128) --------------------------

    def syncStream(self, handle: int) -> None:
        """Block the host on everything issued on one handle (:111-116)."""
        works = self._pending.pop(handle, [])
        if self.device.type != "cuda":
            for w in works:
                w.wait()
            return
        stream = self._streams[handle]
        with torch.cuda.stream(stream):
            for w in works:
                w.wait()          # the handle's stream waits on the work
        stream.synchronize()

    def synchronize(self) -> None:
        """Block the host until every outstanding collective has completed
        (cudaStreamSynchronize over all streams, :103-110)."""
        for handle in list(self._pending):
            self.syncStream(handle)

    def getNumOfFreeStreams(self) -> int:
        """The handles with nothing in flight (cudaStreamQuery loop,
        :118-128)."""
        busy = sum(1 for works in self._pending.values()
                   if not all(w.is_completed() for w in works))
        return self.nstreams - busy

    # -- lifecycle (communicator.cpp:68-95) ----------------------------------

    def destroy(self) -> None:
        """Finish what is in flight and tear the handles' groups down."""
        if not self._groups:
            return
        self.synchronize()
        for grp in self._groups:
            dist.destroy_process_group(grp)
        self._groups, self._streams = [], []

    def reload(self) -> None:
        """Form the handles' groups (and streams) anew."""
        self.destroy()
        ranks = dist.get_process_group_ranks(self._base)
        kind = dist.get_backend(self._base)
        self._groups = [dist.new_group(ranks, backend=kind)
                        for _ in range(self.nstreams)]
        self._streams = ([torch.cuda.Stream(self.device)
                          for _ in range(self.nstreams)]
                         if self.device.type == "cuda" else [])
        self._pending.clear()
        self._next_handle = 0
