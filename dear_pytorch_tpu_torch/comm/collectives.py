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

Sequence parallelism adds `permute` (JAX's ``lax.ppermute``) and the
tiled `all_to_all` (``lax.all_to_all(..., tiled=True)``), and the
differentiable forms the ring and Ulysses attention and the sp losses
take gradients through (`ad_permute`, `ad_all_to_all`, `ad_psum`,
`ad_all_gather`). Their backward is the transpose JAX takes under
``shard_map(check_vma=False)``, the JAX package's setting: a permutation's
is the reverse permutation, a tiled all-to-all's the reverse all-to-all,
a sum's (``psum``) the sum of the cotangents, an all-gather's the
reduce-scatter of the cotangent (``psum_scatter``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.ops.fusion import padded_length

__all__ = [
    "StreamEvent", "ad_all_gather", "ad_all_to_all", "ad_permute",
    "ad_psum", "all_gather", "all_reduce", "all_reduce_mean",
    "all_reduce_rb", "all_reduce_rsag", "all_to_all", "allreduce",
    "broadcast", "host_allgather", "multi_bcast", "on_host",
    "pad_to_multiple", "padded_length", "permute", "reduce",
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


def on_host(x: torch.Tensor, group) -> bool:
    """Whether ``x`` must go through the host: a CUDA tensor on the gloo
    group of ranks that share a card, where each collective runs
    synchronously (the copy to the host waits for the stream) and an
    ``async_op`` handle is already done. Any other CUDA tensor on gloo
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
    if on_host(out, g):
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
    if on_host(out, g):
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

    if on_host(out, g):
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
    if on_host(x, g):
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
    if on_host(x, g):
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
    ranks; the exchange is the `permute` of its pairs."""
    world = dist.get_world_size(_group(group))
    if len(peer_of) != world or len(set(peer_of)) != world:
        raise ValueError(f"send_recv: peer_of must name each of the {world} "
                         f"ranks once, got {list(peer_of)}")
    return permute(x, list(enumerate(peer_of)), group, async_op=async_op)


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """One rightward hop of a ring: rank i sends ``x`` to rank i + 1 and
    returns what rank i - 1 sent (mod the world)."""
    world = dist.get_world_size(_group(group))
    return send_recv(x, [(i + 1) % world for i in range(world)], group)


def _check_perm(perm, world: int) -> list:
    pairs = [(int(a), int(b)) for a, b in perm]
    srcs, dsts = [a for a, _ in pairs], [b for _, b in pairs]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= r < world for r in srcs + dsts)):
        raise ValueError(f"permute: perm {pairs} must name each source and "
                         f"each destination at most once, in [0, {world})")
    return pairs


def permute(x: torch.Tensor, perm: Sequence[tuple], group=None, *,
            async_op: bool = False):
    """Point-to-point as a collective permute (JAX collectives.py:142,
    ``lax.ppermute``): ``perm`` lists ``(source, destination)`` group ranks;
    each rank sends ``x`` to its destination and returns, as a new tensor,
    what its source sent; a rank that no pair names as a destination gets
    zeros. Send and receive go out as one batch (``batch_isend_irecv``: one
    NCCL group call), so a ring of them cannot deadlock."""
    g = _group(group)
    world, rank = dist.get_world_size(g), dist.get_rank(g)
    pairs = _check_perm(perm, world)
    if on_host(x, g):
        return _staged(lambda o, h: o.copy_(permute(h, pairs, g)),
                       torch.empty_like(x), x, async_op=async_op)
    dst = next((b for a, b in pairs if a == rank), None)
    src = next((a for a, b in pairs if b == rank), None)
    if src == rank:       # a fixed point of the permutation
        return _finish(x.clone(), None, async_op)
    out = torch.empty_like(x) if src is not None else torch.zeros_like(x)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(g, dst), g))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(g, src), g))
    if not ops:
        return _finish(out, None, async_op)
    reqs = dist.batch_isend_irecv(ops)
    # the receive, then the send: a gloo work waited on twice never returns
    return _finish(out, _Then(reqs[-1], lambda: [r.wait() for r in reqs[:-1]]),
                   async_op)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group=None) -> torch.Tensor:
    """The tiled all-to-all (``lax.all_to_all(x, axis, split_dim,
    concat_dim, tiled=True)``): ``x`` splits along ``split_dim`` into one
    chunk per rank, chunk j goes to rank j, and each rank concatenates the
    chunks it receives along ``concat_dim`` in rank order. One
    ``all_to_all_single`` (gloo in torch 2.13 runs it on CPU tensors) over
    the chunks stacked on a new leading dim."""
    g = _group(group)
    world = dist.get_world_size(g)
    if x.shape[split_dim] % world:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not divide by world {world}")
    if world == 1:
        return x.clone()
    send = torch.stack(x.chunk(world, dim=split_dim))
    recv = torch.empty_like(send)
    if on_host(x, g):
        host = torch.empty(recv.shape, dtype=recv.dtype)
        dist.all_to_all_single(host, send.cpu(), group=g)
        recv.copy_(host)
    else:
        dist.all_to_all_single(recv, send, group=g)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pairs, group):
        ctx.pairs, ctx.group = pairs, group
        return permute(x, pairs, group)

    @staticmethod
    def backward(ctx, g):
        return permute(g.contiguous(), [(b, a) for a, b in ctx.pairs],
                       ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (all_to_all(g.contiguous(), concat_dim, split_dim, ctx.group),
                None, None, None)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.group), None


def ad_permute(x: torch.Tensor, perm: Sequence[tuple],
               group=None) -> torch.Tensor:
    """`permute`, differentiable: the cotangent goes back along the
    reverse pairs (JAX's ``ppermute`` transpose)."""
    g = _group(group)
    return _Permute.apply(x, _check_perm(perm, dist.get_world_size(g)), g)


def ad_all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
                  group=None) -> torch.Tensor:
    """`all_to_all`, differentiable: the cotangent takes the reverse
    all-to-all (``concat_dim`` split, ``split_dim`` concatenated)."""
    return _AllToAll.apply(x, split_dim, concat_dim, _group(group))


def ad_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the group (``lax.psum``), differentiable: the
    cotangent is summed over the group too (psum's transpose under
    ``check_vma=False``)."""
    return _Psum.apply(x, _group(group))


def ad_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """`all_gather` along dim 0 (``lax.all_gather(tiled=True)``),
    differentiable: the cotangent is reduce-scattered (summed over the
    group, each rank keeping its own rows)."""
    return _AllGather.apply(x, _group(group))


# ---------------------------------------------------------------------------
# Host-level collectives (JAX collectives.py:245, :264), over the host group
# ---------------------------------------------------------------------------


def _host_world() -> int:
    return backend.size() if backend.is_initialized() else 1


def allreduce(x, average: bool = True):
    """Average (or, with ``average=False``, sum) a host-side metric over
    the processes — the reference's blocking metric all-reduce
    (dear/dear_dopt.py:546-549). The identity in a single process; across
    processes it runs on `comm.backend.host_group`, never on the training
    step's group."""
    world = _host_world()
    if world == 1:
        return x
    t = torch.as_tensor(np.asarray(x))
    wide = torch.float64 if t.is_floating_point() else torch.int64
    total = t.to(wide).clone()
    dist.all_reduce(total, group=backend.host_group())
    total = total.numpy()
    return total / world if average else total


def host_allgather(x) -> np.ndarray:
    """Every process's ``x`` (a host array of the same shape and dtype on
    every rank) stacked on a new leading axis of length ``world``,
    index-ordered: ``x[None]`` in a single process. Across processes one
    all-gather on `comm.backend.host_group` — the host collective the
    cluster layer's `resilience.cluster.AllgatherTransport` builds its
    exchanges on (from a side thread, with a deadline)."""
    arr = np.ascontiguousarray(np.asarray(x))
    world = _host_world()
    if world == 1:
        return arr[None, ...]
    raw = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
    out = torch.empty((world * raw.numel(),), dtype=torch.uint8)
    _all_gather(out, raw, group=backend.host_group())
    return out.numpy().view(arr.dtype).reshape((world,) + arr.shape)
