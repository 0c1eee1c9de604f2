"""Tensor fusion: bucketing an ordered list of parameters into flat, padded
communication buffers — the port of ``dear_pytorch_tpu/ops/fusion.py``.

A plan is static metadata over an ordered leaf list. The JAX package takes
its leaves in jax's sorted-key pytree order; here the order is the caller's:
a module's ``named_parameters()`` order by default (module order, which the
DeAR schedule's per-bucket gather prefetch needs), or any explicit list of
``(name, shape, dtype)``. Given the same leaf list in the same order, every
planner gives the buckets, offsets, padded and shard sizes the JAX package
gives.

A "layer" is a run of leaves sharing a parent name (``h_0.query`` for
``h_0.query.weight`` and ``h_0.query.bias``; ``/``-joined names split the
same way), and plans never split a layer across buckets.

Pack copies leaves into one new flat buffer per bucket; unpack returns
views into a flat buffer, so a module's parameters can live inside it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "Bucket", "FusionPlan", "LeafSpec", "chunk_bounds", "layer_sizes",
    "leaf_specs", "make_plan", "pack_all", "pack_bucket", "padded_length",
    "plan_by_flags", "plan_by_groups", "plan_by_nearby_layers",
    "plan_by_threshold", "rescale_plan", "unpack_all", "unpack_bucket",
]


def padded_length(n: int, world: int) -> int:
    """Smallest multiple of ``world`` that is >= n (0 stays 0)."""
    if n == 0:
        return 0
    return ((n + world - 1) // world) * world


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Static description of one parameter tensor."""

    name: str          # e.g. "h_0.query.weight"
    layer: int         # index of the atomic layer (module) it belongs to
    shape: tuple
    dtype: Any         # a torch.dtype (or anything with .itemsize)
    size: int          # number of elements


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One fusion group: a contiguous run of layers in one flat buffer;
    ``offsets[i]`` is the element offset of ``leaf_ids[i]``."""

    index: int
    leaf_ids: tuple
    offsets: tuple
    size: int          # total elements (unpadded)
    padded_size: int   # rounded up to a multiple of world
    shard_size: int    # padded_size // world

    @property
    def pad(self) -> int:
        return self.padded_size - self.size


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    """Complete static bucketing of an ordered leaf list."""

    leaves: tuple
    buckets: tuple
    world: int
    #: membership epoch the plan was (re)built under (`rescale_plan`)
    epoch: int = 0

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def total_size(self) -> int:
        return sum(leaf.size for leaf in self.leaves)

    def bucket_of_leaf(self, leaf_id: int) -> int:
        for b in self.buckets:
            if leaf_id in b.leaf_ids:
                return b.index
        raise KeyError(leaf_id)

    def segment_ids(self, bucket: int) -> np.ndarray:
        """int32[padded_size]: each element's bucket-local parameter index
        (padding maps to the trailing dummy segment ``len(leaf_ids)``)."""
        b = self.buckets[bucket]
        out = np.full((b.padded_size,), len(b.leaf_ids), np.int32)
        for local, (leaf_id, off) in enumerate(zip(b.leaf_ids, b.offsets)):
            out[off:off + self.leaves[leaf_id].size] = local
        return out

    def describe(self) -> str:
        lines = [f"FusionPlan: {len(self.leaves)} tensors, "
                 f"{self.num_buckets} buckets, world={self.world}"]
        for b in self.buckets:
            names = [self.leaves[i].name for i in b.leaf_ids]
            mb = sum(self.leaves[i].size * self.leaves[i].dtype.itemsize
                     for i in b.leaf_ids) / 2**20
            lines.append(
                f"  bucket {b.index}: {len(names)} tensors, {mb:.2f} MB "
                f"(pad {b.pad}, shard {b.shard_size}) "
                f"[{names[0]} .. {names[-1]}]")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# layer grouping
# ---------------------------------------------------------------------------


def _parent(name: str) -> str:
    cut = max(name.rfind("."), name.rfind("/"))
    return name[:cut] if cut >= 0 else name


def leaf_specs(params) -> tuple:
    """LeafSpecs of ``params``, in its order: an ``nn.Module`` (its
    ``named_parameters()``), a mapping or a sequence of ``(name, tensor)``,
    or a sequence of ``(name, shape, dtype)``."""
    if isinstance(params, torch.nn.Module):
        items = [(n, tuple(p.shape), p.dtype)
                 for n, p in params.named_parameters()]
    else:
        if isinstance(params, Mapping):
            params = list(params.items())
        items = [(e[0], tuple(e[1].shape), e[1].dtype) if len(e) == 2
                 else (e[0], tuple(e[1]), e[2]) for e in params]
    specs, layer_keys = [], {}
    for name, shape, dtype in items:
        layer = layer_keys.setdefault(_parent(name), len(layer_keys))
        specs.append(LeafSpec(name=name, layer=layer, shape=shape,
                              dtype=dtype, size=math.prod(shape)))
    return tuple(specs)


def _specs(params) -> tuple:
    if isinstance(params, tuple) and all(isinstance(s, LeafSpec)
                                         for s in params):
        return params
    return leaf_specs(params)


def layer_sizes(params, *, in_bytes: bool = True,
                comm_itemsize: Optional[int] = None) -> list:
    """Per-layer sizes in order: bytes (optionally at a fixed comm
    itemsize) or element counts."""
    acc: dict = {}
    for s in _specs(params):
        unit = (comm_itemsize or s.dtype.itemsize) if in_bytes else 1
        acc[s.layer] = acc.get(s.layer, 0.0) + s.size * unit
    return [acc[k] for k in sorted(acc)]


def _layers(specs) -> list:
    out: dict = {}
    for i, s in enumerate(specs):
        out.setdefault(s.layer, []).append(i)
    return [out[k] for k in sorted(out)]


# ---------------------------------------------------------------------------
# partitioning strategies (the JAX package's, over the given order)
# ---------------------------------------------------------------------------


def plan_by_threshold(params, world: int,
                      threshold_mb: Optional[float] = 25.0) -> FusionPlan:
    """Consecutive layers in buckets of at most ``threshold_mb`` (a layer
    that would push a bucket past it starts a new one; an oversized layer
    gets its own). ``None``: one bucket."""
    specs = _specs(params)
    if threshold_mb is None:
        groups = [[i for layer in _layers(specs) for i in layer]] \
            if specs else []
        return _build_plan(specs, groups, world)
    limit = threshold_mb * 2**20
    groups, current, current_bytes = [], [], 0.0
    for layer in _layers(specs):
        layer_bytes = sum(specs[i].size * specs[i].dtype.itemsize
                          for i in layer)
        if current and current_bytes + layer_bytes > limit:
            groups.append(current)
            current, current_bytes = [], 0.0
        current.extend(layer)
        current_bytes += layer_bytes
    if current:
        groups.append(current)
    return _build_plan(specs, groups, world)


def plan_by_nearby_layers(params, world: int, k: int = 4) -> FusionPlan:
    """Every ``k`` consecutive layers in one bucket (``-1``: all)."""
    if k < 1 and k != -1:
        raise ValueError(
            f"nearby_layers must be >= 1 or -1 (fuse all), got {k}")
    specs = _specs(params)
    layers = _layers(specs)
    if k == -1:
        k = max(1, len(layers))
    groups = [[i for layer in layers[j:j + k] for i in layer]
              for j in range(0, len(layers), k)]
    return _build_plan(specs, groups, world)


def plan_by_flags(params, world: int, flags: Sequence[int]) -> FusionPlan:
    """Split where ``flags[layer] == 1`` (that layer starts a bucket)."""
    specs = _specs(params)
    layers = _layers(specs)
    if len(flags) != len(layers):
        raise ValueError(
            f"flags has {len(flags)} entries for {len(layers)} layers")
    groups, current = [], []
    for flag, layer in zip(flags, layers):
        if flag and current:
            groups.append(current)
            current = []
        current.extend(layer)
    if current:
        groups.append(current)
    return _build_plan(specs, groups, world)


def plan_by_groups(params, world: int,
                   layer_groups: Sequence[Sequence[int]]) -> FusionPlan:
    """Plan from explicit groups of layer indices."""
    specs = _specs(params)
    layers = _layers(specs)
    groups = [[i for li in grp for i in layers[li]]
              for grp in layer_groups if grp]
    return _build_plan(specs, groups, world)


def chunk_bounds(n_elements: int, itemsize: int,
                 partition_mb: Optional[float]) -> list:
    """Element ranges splitting a flat buffer into chunks of at most
    ``partition_mb`` MB (``None`` or <= 0: one chunk)."""
    if n_elements <= 0:
        return []
    if partition_mb is None or partition_mb <= 0:
        return [(0, int(n_elements))]
    per = max(int(float(partition_mb) * 2**20) // int(itemsize), 1)
    return [(i, min(i + per, int(n_elements)))
            for i in range(0, int(n_elements), per)]


def make_plan(params, world: int, threshold_mb: Optional[float] = 25.0,
              nearby_layers: Optional[int] = None,
              flags: Optional[Sequence[int]] = None) -> FusionPlan:
    """Flags beat the nearby-layer count beat the MB threshold."""
    if flags is not None:
        return plan_by_flags(params, world, flags)
    if nearby_layers is not None:
        return plan_by_nearby_layers(params, world, nearby_layers)
    return plan_by_threshold(params, world, threshold_mb)


def rescale_plan(plan: FusionPlan, world: int, *,
                 epoch: Optional[int] = None) -> FusionPlan:
    """``plan`` for a new world: the same grouping, new padding and shard
    sizes, and the membership ``epoch`` stamped in."""
    if world == plan.world and (epoch is None or epoch == plan.epoch):
        return plan
    rebuilt = _build_plan(plan.leaves,
                          [list(b.leaf_ids) for b in plan.buckets], world)
    return dataclasses.replace(
        rebuilt, epoch=plan.epoch if epoch is None else int(epoch))


def _build_plan(specs, groups, world) -> FusionPlan:
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    buckets, seen = [], set()
    for idx, leaf_ids in enumerate(groups):
        offsets, off = [], 0
        for i in leaf_ids:
            if i in seen:
                raise ValueError(f"leaf {i} assigned to two buckets")
            seen.add(i)
            offsets.append(off)
            off += specs[i].size
        padded = padded_length(off, world)
        buckets.append(Bucket(index=idx, leaf_ids=tuple(leaf_ids),
                              offsets=tuple(offsets), size=off,
                              padded_size=padded,
                              shard_size=padded // world))
    if len(seen) != len(specs):
        missing = [s.name for i, s in enumerate(specs) if i not in seen]
        raise ValueError(f"leaves not covered by any bucket: {missing}")
    return FusionPlan(leaves=tuple(specs), buckets=tuple(buckets),
                      world=world)


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------


def _leaf_list(tensors, plan: FusionPlan) -> list:
    if isinstance(tensors, Mapping):
        return [tensors[s.name] for s in plan.leaves]
    tensors = list(tensors)
    if len(tensors) != len(plan.leaves):
        raise ValueError(f"{len(tensors)} tensors, the plan expects "
                         f"{len(plan.leaves)}")
    return tensors


def pack_bucket(leaves, plan: FusionPlan, bucket: int, dtype=None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One bucket's leaves, flattened, concatenated and zero-padded into a
    new flat buffer (or into ``out``), cast to ``dtype`` if given."""
    b = plan.buckets[bucket]
    leaves = _leaf_list(leaves, plan)
    if out is None:
        dt = dtype or (leaves[b.leaf_ids[0]].dtype if b.leaf_ids
                       else torch.float32)
        dev = leaves[b.leaf_ids[0]].device if b.leaf_ids else None
        out = torch.zeros((b.padded_size,), dtype=dt, device=dev)
    else:
        out[b.size:].zero_()
    for leaf_id, off in zip(b.leaf_ids, b.offsets):
        n = plan.leaves[leaf_id].size
        out[off:off + n].copy_(leaves[leaf_id].reshape(-1))
    return out


def unpack_bucket(buf: torch.Tensor, plan: FusionPlan, bucket: int, *,
                  cast: bool = False) -> dict:
    """``{leaf_id: view}``: views into the flat buffer in each leaf's shape
    (``cast=True`` converts a leaf whose dtype differs — a copy)."""
    b = plan.buckets[bucket]
    out = {}
    for leaf_id, off in zip(b.leaf_ids, b.offsets):
        spec = plan.leaves[leaf_id]
        x = buf[off:off + spec.size].view(spec.shape)
        if cast and x.dtype != spec.dtype:
            x = x.to(spec.dtype)
        out[leaf_id] = x
    return out


def pack_all(tensors, plan: FusionPlan, dtype=None) -> list:
    """Every bucket of ``tensors`` (a mapping by leaf name, or a sequence
    in plan order)."""
    leaves = _leaf_list(tensors, plan)
    return [pack_bucket(leaves, plan, b.index, dtype) for b in plan.buckets]


def unpack_all(buffers: Sequence[torch.Tensor], plan: FusionPlan, *,
               cast: bool = True) -> dict:
    """``{leaf name: tensor}`` from per-bucket flat buffers: views, unless
    ``cast`` converts a leaf back to its own dtype."""
    if len(buffers) != plan.num_buckets:
        raise ValueError(
            f"{len(buffers)} buffers for {plan.num_buckets} buckets")
    out = {}
    for b, buf in zip(plan.buckets, buffers):
        for leaf_id, x in unpack_bucket(buf, plan, b.index,
                                        cast=cast).items():
            out[plan.leaves[leaf_id].name] = x
    return out
