"""Collectives over the process group on flat tensors — the port of
``dear_pytorch_tpu/comm/collectives.py``.

The JAX package's collectives run inside ``shard_map`` on per-device
shards; here each process holds its own tensor, and every function takes
an optional ``group`` (the default: `comm.backend.group()`). With
``async_op=True``, `reduce_scatter` and `all_gather` return ``(output,
work)``: the caller waits on ``work`` before reading the output.

The gloo group of ranks that share one card (`comm.backend.card_shared`)
runs each collective on host copies of its CUDA tensors: the copy to the
host waits for the stream's work so far, and the copy back is on the
current stream, where ``work.wait()`` (a `StreamEvent`) makes the caller's
stream wait for it. A CUDA tensor on any other gloo group raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.ops.fusion import padded_length

__all__ = [
    "StreamEvent", "all_gather", "all_reduce", "all_reduce_mean",
    "all_reduce_rsag", "broadcast", "pad_to_multiple", "padded_length",
    "reduce_scatter", "ring_shift", "send_recv",
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


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the group, as a new tensor."""
    g = _group(group)
    if _on_host(x, g):
        return all_reduce(x.cpu(), g).to(x.device)
    out = x.clone()
    dist.all_reduce(out, group=g)
    return out


def broadcast(x: torch.Tensor, root: int = 0, group=None) -> torch.Tensor:
    """Overwrite ``x`` in place with group rank ``root``'s value; returns
    ``x``."""
    g = _group(group)
    if _on_host(x, g):
        return x.copy_(broadcast(x.cpu(), root, g))
    dist.broadcast(x, dist.get_global_rank(g, root), group=g)
    return x


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


def all_reduce_rsag(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce as reduce-scatter then all-gather, padding any length to
    the world and stripping the pad after (the decomposition whose halves
    DeAR schedules apart)."""
    g = _group(group)
    world = dist.get_world_size(g)
    flat = x.reshape(-1)
    full = all_gather(reduce_scatter(pad_to_multiple(flat, world), g), g)
    return full[:flat.shape[0]].reshape(x.shape)


def send_recv(x: torch.Tensor, peer_of: Sequence[int],
              group=None) -> torch.Tensor:
    """Pairwise exchange (the JAX package's `send_recv`, collectives.py:156):
    rank i sends ``x`` to ``peer_of[i]`` and receives, as a new tensor, from
    the rank that names it as its peer. ``peer_of`` is a permutation of the
    ranks. Over gloo ``x`` lies on the CPU (the ring's plain version)."""
    g = _group(group)
    world, rank = dist.get_world_size(g), dist.get_rank(g)
    if len(peer_of) != world or len(set(peer_of)) != world:
        raise ValueError(f"send_recv: peer_of must name each of the {world} "
                         f"ranks once, got {list(peer_of)}")
    dst = peer_of[rank]
    src = list(peer_of).index(rank)
    if dst == rank:
        return x.clone()
    out = torch.empty_like(x)
    reqs = [dist.isend(x.contiguous(), dist.get_global_rank(g, dst),
                       group=g),
            dist.irecv(out, dist.get_global_rank(g, src), group=g)]
    for req in reqs:
        req.wait()
    return out


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """One rightward hop of a ring: rank i sends ``x`` to rank i + 1 and
    returns what rank i - 1 sent (mod the world)."""
    world = dist.get_world_size(_group(group))
    return send_recv(x, [(i + 1) % world for i in range(world)], group)
