"""Collectives over the process group on flat tensors — the port of
``dear_pytorch_tpu/comm/collectives.py``.

The JAX package's collectives run inside ``shard_map`` on per-device
shards; here each process holds its own tensor, and every function takes
an optional ``group`` (the default: `comm.backend.group()`). With
``async_op=True``, `all_reduce`, `reduce`, `broadcast`, `reduce_scatter`,
`all_gather`, `all_reduce_rsag`, `all_reduce_rb` and `send_recv` return
``(output, work)``: the caller waits on ``work`` (None when the work is
already done) before reading the output; ``out=`` names the output tensor
(``out=x`` reduces in place).

The gloo group of ranks that share one card (`comm.backend.card_shared`)
runs each collective on host copies of its CUDA tensors: the copy to the
host waits for the stream's work so far, and the copy back is on the
current stream, where ``work.wait()`` (a `StreamEvent`) makes the caller's
stream wait for it. A CUDA tensor on any other gloo group raises.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.ops.fusion import padded_length

__all__ = [
    "StreamEvent", "all_gather", "all_reduce", "all_reduce_mean",
    "all_reduce_rb", "all_reduce_rsag", "broadcast", "multi_bcast",
    "pad_to_multiple", "padded_length", "reduce", "reduce_scatter",
    "ring_shift", "send_recv",
]

# torch 2.13 renamed the single-tensor collectives; older builds have only
# the *_tensor names
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)


def _group(group):
    return backend.group() if group is None else group


def _on_host(x: torch.Tensor, group) -> bool:
    """Whether ``x`` must go through the host: a CUDA tensor on the gloo
    group of ranks that share a card. Any other CUDA tensor on gloo
    raises."""
    if not (x.is_cuda and dist.get_backend(group) == "gloo"):
        return False
    if not backend.card_shared():
        raise RuntimeError(
            "a CUDA tensor on a gloo group whose ranks do not share a card: "
            "ranks with cards of their own run NCCL (comm.backend.init)")
    return True


class StreamEvent:
    """The wait handle of work enqueued on a CUDA stream (a collective run
    on host copies, a ring kernel): `wait` makes the caller's current
    stream wait for it."""

    def __init__(self, event: torch.cuda.Event):
        self.event = event

    @staticmethod
    def after_current(device: torch.device) -> Optional["StreamEvent"]:
        """A handle for everything enqueued so far on ``device``'s current
        stream (None on the CPU, where the work is already done)."""
        if device.type != "cuda":
            return None
        return StreamEvent(torch.cuda.current_stream(device).record_event())

    def wait(self) -> bool:
        torch.cuda.current_stream().wait_event(self.event)
        return True

    def is_completed(self) -> bool:
        return self.event.query()


class _Then:
    """A work handle that runs ``then()`` once ``work`` is done (``work``
    None: already done): the copy out of a scratch buffer that an async
    collective wrote."""

    def __init__(self, work, then: Callable[[], object]):
        self.work, self.then = work, then

    def wait(self) -> bool:
        if self.work is not None:
            self.work.wait()
        self.then()
        return True

    def is_completed(self) -> bool:
        return self.work is None or self.work.is_completed()


def _finish(out, work, async_op: bool):
    """``(out, work)``, or ``out`` once ``work`` is waited on."""
    if async_op:
        return out, work
    if work is not None:
        work.wait()
    return out


def _staged(fn, out: torch.Tensor, *xs: torch.Tensor, async_op: bool):
    """``fn(host_out, *host_xs)`` on host copies, the result copied into
    ``out``; returns ``(out, work)`` or ``out``."""
    host_out = torch.empty(out.shape, dtype=out.dtype)
    fn(host_out, *(x.cpu() for x in xs))
    out.copy_(host_out)
    return (out, StreamEvent.after_current(out.device)) if async_op else out


def pad_to_multiple(x: torch.Tensor, world: int) -> torch.Tensor:
    """Zero-pad a flat vector to a multiple of ``world``."""
    n = x.shape[0]
    target = padded_length(n, world)
    if target == n:
        return x
    return torch.cat([x, x.new_zeros((target - n,))])


def all_reduce(x: torch.Tensor, group=None, *, async_op: bool = False,
               out: Optional[torch.Tensor] = None):
    """The sum over the group, into ``out`` (default: a new tensor)."""
    g = _group(group)
    if out is None:
        out = x.clone()
    elif out is not x:
        out.copy_(x)
    if _on_host(out, g):
        return _staged(lambda o, h: (o.copy_(h), dist.all_reduce(o, group=g)),
                       out, out, async_op=async_op)
    work = dist.all_reduce(out, group=g, async_op=async_op)
    return (out, work) if async_op else out


def broadcast(x: torch.Tensor, root: int = 0, group=None, *,
              async_op: bool = False, out: Optional[torch.Tensor] = None):
    """Group rank ``root``'s ``x`` on every rank, into ``out`` (default:
    ``x`` itself, overwritten in place); returns ``out``."""
    g = _group(group)
    if out is None:
        out = x
    elif out is not x:
        out.copy_(x)
    src = dist.get_global_rank(g, root)
    if _on_host(out, g):
        return _staged(lambda o, h: (o.copy_(h),
                                     dist.broadcast(o, src, group=g)),
                       out, out, async_op=async_op)
    work = dist.broadcast(out, src, group=g, async_op=async_op)
    return (out, work) if async_op else out


def reduce(x: torch.Tensor, root: int = 0, group=None, *,
           async_op: bool = False, out: Optional[torch.Tensor] = None):
    """The sum over the group on group rank ``root``, into ``out``
    (default: a copy of ``x``); on every other rank ``out`` keeps the
    input (the JAX package's `reduce`, collectives.py:97, after NCCL's
    in-place reduce, which leaves non-root buffers alone). gloo's reduce
    may use a non-root buffer as scratch, so on gloo the reduction runs in
    a copy that only the root copies out."""
    g = _group(group)
    if out is None:
        out = x.clone()
    elif out is not x:
        out.copy_(x)
    dst = dist.get_global_rank(g, root)
    is_root = dist.get_rank(g) == root

    def into_copy(o, h):
        tmp = h.clone()
        dist.reduce(tmp, dst, group=g)
        o.copy_(tmp if is_root else h)

    if _on_host(out, g):
        return _staged(into_copy, out, out, async_op=async_op)
    if dist.get_backend(g) != "gloo":
        work = dist.reduce(out, dst, group=g, async_op=async_op)
        return (out, work) if async_op else out
    tmp = out.clone()
    work = dist.reduce(tmp, dst, group=g, async_op=True)
    return _finish(out, _Then(work, lambda: is_root and out.copy_(tmp)),
                   async_op)


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    g = _group(group)
    return all_reduce(x, g) / dist.get_world_size(g)


def reduce_scatter(x: torch.Tensor, group=None, *, async_op: bool = False,
                   out: Optional[torch.Tensor] = None):
    """The sum over the group, scattered along dim 0: rank r gets elements
    ``[r * n/world, (r + 1) * n/world)``. ``x.shape[0]`` must divide by the
    world (`pad_to_multiple` first)."""
    g = _group(group)
    world = dist.get_world_size(g)
    if x.shape[0] % world:
        raise ValueError(f"reduce_scatter: length {x.shape[0]} does not "
                         f"divide by world {world}")
    if out is None:
        out = x.new_empty((x.shape[0] // world,) + tuple(x.shape[1:]))
    if _on_host(x, g):
        return _staged(lambda o, h: _reduce_scatter(o, h, group=g), out, x,
                       async_op=async_op)
    work = _reduce_scatter(out, x, group=g, async_op=async_op)
    return (out, work) if async_op else out


def all_gather(x: torch.Tensor, group=None, *, async_op: bool = False,
               out: Optional[torch.Tensor] = None):
    """Every rank's ``x`` concatenated along dim 0, in rank order."""
    g = _group(group)
    world = dist.get_world_size(g)
    if out is None:
        out = x.new_empty((x.shape[0] * world,) + tuple(x.shape[1:]))
    if _on_host(x, g):
        return _staged(lambda o, h: _all_gather(o, h, group=g), out, x,
                       async_op=async_op)
    work = _all_gather(out, x, group=g, async_op=async_op)
    return (out, work) if async_op else out


def all_reduce_rsag(x: torch.Tensor, group=None, *, async_op: bool = False,
                    out: Optional[torch.Tensor] = None):
    """All-reduce as reduce-scatter then all-gather, padding any length to
    the world and stripping the pad after (the decomposition whose halves
    DeAR schedules apart), into ``out`` (default: a new tensor; contiguous,
    of ``x``'s shape). The reduce-scatter is done when the call returns
    (on the card: the current stream waits for it); the all-gather is the
    work."""
    g = _group(group)
    world = dist.get_world_size(g)
    flat = x.reshape(-1)
    n = flat.shape[0]
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    shard = reduce_scatter(pad_to_multiple(flat, world), g)
    if padded_length(n, world) == n:
        _, work = all_gather(shard, g, async_op=True, out=out.view(-1))
        return _finish(out, work, async_op)
    full, work = all_gather(shard, g, async_op=True)
    return _finish(out, _Then(work, lambda: out.view(-1).copy_(full[:n])),
                   async_op)


def all_reduce_rb(x: torch.Tensor, root: int = 0, group=None, *,
                  async_op: bool = False,
                  out: Optional[torch.Tensor] = None):
    """All-reduce as a reduce to group rank ``root`` then its broadcast
    (the JAX package's `all_reduce_rb`, collectives.py:134), into ``out``
    (default: a new tensor). The reduce is done when the call returns; the
    broadcast is the work."""
    g = _group(group)
    out = reduce(x, root, g, out=out)
    return broadcast(out, root, g, async_op=async_op)


def multi_bcast(tensors: Sequence[torch.Tensor],
                fn: Callable[[torch.Tensor], torch.Tensor],
                min_elems: int = 512 * 512, group=None, *,
                async_op: bool = False):
    """``fn`` of every tensor, each computed once and broadcast (the JAX
    package's `multi_bcast`, collectives.py:164): a tensor of fewer than
    ``min_elems`` elements is computed by every rank itself; the others
    get owners round-robin over the group's ranks in the order they come,
    and each owner computes ``fn`` of its own tensor and broadcasts the
    result. ``fn`` returns a tensor of its input's shape and dtype (what a
    non-owner receives into). Returns the list of results (with
    ``async_op``: and the list of the broadcasts' works)."""
    g = _group(group)
    world, rank = dist.get_world_size(g), dist.get_rank(g)
    outs, works = [], []
    owner = 0
    for t in tensors:
        if t.numel() < min_elems:
            outs.append(fn(t))
            continue
        root = owner % world
        owner += 1
        res = fn(t) if rank == root else torch.empty_like(t)
        res, work = broadcast(res, root, g, async_op=True)
        outs.append(res)
        works.append(work)
    if async_op:
        return outs, works
    for work in works:
        if work is not None:
            work.wait()
    return outs


def send_recv(x: torch.Tensor, peer_of: Sequence[int], group=None, *,
              async_op: bool = False):
    """Pairwise exchange (the JAX package's `send_recv`, collectives.py:156):
    rank i sends ``x`` to ``peer_of[i]`` and receives, as a new tensor, from
    the rank that names it as its peer. ``peer_of`` is a permutation of the
    ranks."""
    g = _group(group)
    world, rank = dist.get_world_size(g), dist.get_rank(g)
    if len(peer_of) != world or len(set(peer_of)) != world:
        raise ValueError(f"send_recv: peer_of must name each of the {world} "
                         f"ranks once, got {list(peer_of)}")
    if _on_host(x, g):
        return _staged(lambda o, h: o.copy_(send_recv(h, peer_of, g)),
                       torch.empty_like(x), x, async_op=async_op)
    dst = peer_of[rank]
    src = list(peer_of).index(rank)
    if dst == rank:
        return _finish(x.clone(), None, async_op)
    out = torch.empty_like(x)
    reqs = [dist.isend(x.contiguous(), dist.get_global_rank(g, dst),
                       group=g),
            dist.irecv(out, dist.get_global_rank(g, src), group=g)]
    return _finish(out, _Then(reqs[1], reqs[0].wait), async_op)


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """One rightward hop of a ring: rank i sends ``x`` to rank i + 1 and
    returns what rank i - 1 sent (mod the world)."""
    world = dist.get_world_size(_group(group))
    return send_recv(x, [(i + 1) % world for i in range(world)], group)
