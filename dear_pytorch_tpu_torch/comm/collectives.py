"""Collectives over the process group on flat tensors — the port of
``dear_pytorch_tpu/comm/collectives.py``.

The JAX package's collectives run inside ``shard_map`` on per-device
shards; here each process holds its own tensor, and every function takes
an optional ``group`` (the default: `comm.backend.group()`). With
``async_op=True``, `reduce_scatter` and `all_gather` return ``(output,
work)``: the caller waits on ``work`` before reading the output.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.ops.fusion import padded_length

__all__ = [
    "all_gather", "all_reduce", "all_reduce_mean", "all_reduce_rsag",
    "pad_to_multiple", "padded_length", "reduce_scatter",
]

# torch 2.13 renamed the single-tensor collectives; older builds have only
# the *_tensor names
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)


def _group(group):
    return backend.group() if group is None else group


def pad_to_multiple(x: torch.Tensor, world: int) -> torch.Tensor:
    """Zero-pad a flat vector to a multiple of ``world``."""
    n = x.shape[0]
    target = padded_length(n, world)
    if target == n:
        return x
    return torch.cat([x, x.new_zeros((target - n,))])


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the group, as a new tensor."""
    out = x.clone()
    dist.all_reduce(out, group=_group(group))
    return out


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
    work = _reduce_scatter(out, x, group=g, async_op=async_op)
    return (out, work) if async_op else out


def all_gather(x: torch.Tensor, group=None, *, async_op: bool = False,
               out: Optional[torch.Tensor] = None):
    """Every rank's ``x`` concatenated along dim 0, in rank order."""
    g = _group(group)
    world = dist.get_world_size(g)
    if out is None:
        out = x.new_empty((x.shape[0] * world,) + tuple(x.shape[1:]))
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
