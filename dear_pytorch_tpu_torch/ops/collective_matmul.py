"""The ring collectives of ``mode="dear-fused"`` — the port of the ring
half of ``dear_pytorch_tpu/ops/collective_matmul.py``, with its names:

  - `ring_all_gather` (K4; the TPU kernel ``_ag_kernel`` :218, via
    ``ring_all_gather`` :240): ``(n,) -> (W*n,)``, chunk order = rank
    order; data movement only, bitwise equal to a tiled all-gather;
  - `fused_reduce_scatter_update` (K5 ring; ``_rs_update_kernel`` :317,
    via ``fused_reduce_scatter_update`` :396): the ring reduce-scatter of
    a bucket's gradient with fp32 partial sums — rank i's partial starts
    as its local chunk (i-1) mod W and after round r holds chunk
    (i-1-r) mod W, adding the local copy each round — and, at the last
    hop, ``grad / mean_world`` and the shard update of `ops.fused_sgd` on
    the owned shard, in place.

Both are CUDA kernels for ``sm_90a`` in ``csrc/ring.cu``, over the
transport of `comm.ring`. The ``ring`` argument is a `comm.ring.Ring` (one
rank per process: flat per-rank tensors) or a `comm.ring.LocalRing` (W
ranks in this process: every tensor stacked ``[W, ...]``, one launch for
all). At world 1 both short-cut as in the JAX package (:248, :417): the
gather returns the shard, the update is `ShardOptimizer.update`.

Beside each, the plain PyTorch version in two forms: *stacked*
(`ring_all_gather_stacked`, `fused_reduce_scatter_update_stacked`: all W
ranks' inputs in one process, the ring's exact fp32 association order, so
the kernel is bitwise equal to it on the card), and *distributed* (the same
hops over `comm.collectives.ring_shift`: what a CPU rank of the train step
runs). Dispatch: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises; any other device raises. ``ring_ag_launches``
and ``ring_rs_launches`` count kernel launches (one per call, however many
ranks it drives).

The ring's reduction order differs from NCCL's (and XLA's psum_scatter), so
``dear-fused`` matches ``dear`` at dtype tolerance, not bitwise; the gather
and the update math are exact.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from dear_pytorch_tpu_torch.comm import collectives as C
from dear_pytorch_tpu_torch.comm.ring import check, ring_lib
from dear_pytorch_tpu_torch.ops import fused_sgd as FS

__all__ = [
    "fused_reduce_scatter_update", "fused_reduce_scatter_update_stacked",
    "ring_all_gather", "ring_all_gather_stacked",
]

#: kernel launches so far (incremented only where a kernel launches)
ring_ag_launches = 0
ring_rs_launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
_LAMB = ("LayerwiseShardOptimizer (LAMB) needs cross-shard psums and cannot "
         "run inside the epilogue kernel — use mode='dear'.")


def _device_kind(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    return x.device.type


# ---------------------------------------------------------------------------
# ring all-gather (K4)
# ---------------------------------------------------------------------------


def ring_all_gather_stacked(shards: torch.Tensor) -> torch.Tensor:
    """The plain version over all W ranks' shards ``[W, n]``: each rank's
    output ``[W, W*n]``, filled hop by hop as the ring fills it."""
    world, n = shards.shape
    out = shards.new_empty((world, world * n))
    hop = list(shards)
    for i in range(world):
        out[i, i * n:(i + 1) * n] = shards[i]
    for r in range(1, world):
        hop = [hop[(i - 1) % world] for i in range(world)]  # from the left
        for i in range(world):
            j = (i - r) % world
            out[i, j * n:(j + 1) * n] = hop[i]
    return out


def _ring_all_gather_dist(shard, ring, out):
    world, my, n = ring.world, ring.rank, shard.shape[0]
    out[my * n:(my + 1) * n] = shard
    hop = shard
    for r in range(1, world):
        hop = C.ring_shift(hop, ring.group)
        j = (my - r) % world
        out[j * n:(j + 1) * n] = hop
    return out


def ring_all_gather(shard: torch.Tensor, ring,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every rank's ``shard`` concatenated in rank order, through the ring:
    ``(n,) -> (W*n,)`` on a `Ring`, ``[W, n] -> [W, W*n]`` on a
    `LocalRing`; into ``out`` when given. World 1 returns the shard (or
    copies it into ``out``)."""
    world = ring.world
    n = shard.shape[-1]
    want = (world, n) if ring.stacked else (n,)
    if tuple(shard.shape) != want:
        raise ValueError(f"ring_all_gather: shard of shape "
                         f"{tuple(shard.shape)}, expected {want}")
    if world == 1:
        return shard if out is None else out.copy_(shard)
    shape = (world, world * n) if ring.stacked else (world * n,)
    if out is None:
        out = shard.new_empty(shape)
    if tuple(out.shape) != shape or out.dtype != shard.dtype \
            or out.device != shard.device:
        raise ValueError(f"ring_all_gather: out must be {shape} "
                         f"{shard.dtype} on {shard.device}")
    if _device_kind(shard, "ring_all_gather") == "cpu":
        if ring.stacked:
            return out.copy_(ring_all_gather_stacked(shard))
        return _ring_all_gather_dist(shard, ring, out)
    _launch_ag(shard, ring, out)
    return out


def _launch_ag(shard, ring, out) -> None:
    global ring_ag_launches
    n = shard.shape[-1]
    if shard.dtype not in _DTYPES:
        raise ValueError(f"ring all-gather kernel: {shard.dtype} is not "
                         "float32 or bfloat16")
    if not (shard.is_contiguous() and out.is_contiguous()):
        raise ValueError("ring all-gather kernel: tensors not contiguous")
    if n > ring.max_elems:
        raise ValueError(f"ring all-gather kernel: a shard of {n} elements "
                         f"does not fit the ring's {ring.max_elems}")
    xs = shard.reshape(-1, n)
    outs = out.reshape(xs.shape[0], -1)
    rec = []
    for (rank, link), x, o in zip(ring.links("ag"), xs, outs):
        rec += [rank, x.data_ptr(), o.data_ptr(), *link]
    arr = (ctypes.c_longlong * len(rec))(*rec)
    epoch = ring.next_epoch("ag")
    with torch.cuda.device(shard.device):
        err = ring_lib().ring_all_gather(
            arr, xs.shape[0], ring.world, n, shard.element_size(), epoch,
            int(ring.cooperative),
            torch.cuda.current_stream(shard.device).cuda_stream)
    check(err, "ring all-gather kernel launch")
    ring_ag_launches += 1


# ---------------------------------------------------------------------------
# ring reduce-scatter + shard update (K5 ring)
# ---------------------------------------------------------------------------


def _check_optimizer(optimizer) -> None:
    if isinstance(optimizer, FS.LayerwiseShardOptimizer):
        raise ValueError("dear-fused cannot fuse " + _LAMB)
    if not isinstance(optimizer, FS.ShardOptimizer):
        raise ValueError(f"dear-fused fuses a ShardOptimizer's update, got "
                         f"{type(optimizer).__name__}")


def _check_state(state: dict, shard_size: int) -> None:
    """The state leaves must be shard-shaped vectors or host scalars (the
    JAX package's `_flatten_opt_state`, :280)."""
    for leaf in state.values():
        shape = tuple(leaf.shape) if torch.is_tensor(leaf) else ()
        if torch.is_tensor(leaf) and shape != (shard_size,):
            raise ValueError(
                "dear-fused can only fuse optimizers whose state leaves "
                "are shard-shaped vectors or scalars; got a leaf of shape "
                f"{shape} (shard size {shard_size}). " + _LAMB)


def _update_plain(optimizer, acc, state, param, mean_world, step) -> None:
    """The epilogue's plain version: `fused_update_reference` on the fp32
    sum, then the host bookkeeping."""
    scal = optimizer.scalars(state, mean_world, step)
    FS.fused_update_reference(optimizer, acc, state, param, scal)
    optimizer.advance(state)


def fused_reduce_scatter_update_stacked(gbufs, params, states, optimizer, *,
                                        mean_world: int, step: int = 0):
    """The plain version over all W ranks: ``gbufs [W, W*ss]``, ``params
    [W, ss]`` and ``states`` (W state dicts) updated in place, in the
    ring's exact fp32 association order: chunk c is summed starting at
    rank c+1, then ranks c+2, ..., c (mod W), each local copy converted to
    fp32 before its add. Returns ``(params, states)``."""
    world, ss = params.shape
    chunks = gbufs.reshape(world, world, ss)       # [rank, chunk, ss]
    part = [chunks[i, (i - 1) % world].float() for i in range(world)]
    for r in range(1, world):
        recv = [part[(i - 1) % world] for i in range(world)]
        part = [recv[i] + chunks[i, (i - 1 - r) % world].float()
                for i in range(world)]
    for i in range(world):                         # part[i] is chunk i
        _update_plain(optimizer, part[i], states[i], params[i], mean_world,
                      step)
    return params, states


def _fused_rs_update_dist(gbuf, param, state, optimizer, ring, mean_world,
                          step) -> None:
    world, my, ss = ring.world, ring.rank, param.shape[0]
    chunks = gbuf.reshape(world, ss)
    part = chunks[(my - 1) % world].float()
    for r in range(1, world):
        part = C.ring_shift(part, ring.group) \
            + chunks[(my - 1 - r) % world].float()
    _update_plain(optimizer, part, state, param, mean_world, step)


def fused_reduce_scatter_update(gbuf, param_shard, opt_state, optimizer,
                                ring, *, mean_world: int,
                                step: Optional[int] = None):
    """Reduce-scatter ``gbuf`` (every rank's full padded bucket gradient,
    in the comm dtype) around the ring AND apply ``optimizer``'s update to
    the owned fp32 ``param_shard`` and ``opt_state`` in place; returns
    ``(param_shard, opt_state)``. On a `LocalRing`, ``gbuf [W, W*ss]``,
    ``param_shard [W, ss]`` and ``opt_state`` a list of W states.
    ``mean_world`` divides the ring sum; ``step`` feeds an lr schedule."""
    world = ring.world
    step = 0 if step is None else int(step)
    if world == 1:
        if ring.stacked:
            optimizer.update(gbuf[0], opt_state[0], param_shard[0],
                             mean_world=mean_world, step=step)
            return param_shard, opt_state
        return optimizer.update(gbuf, opt_state, param_shard,
                                mean_world=mean_world, step=step)
    _check_optimizer(optimizer)
    ss = param_shard.shape[-1]
    if gbuf.shape[-1] != world * ss:
        raise ValueError(
            f"gradient buffer length {gbuf.shape[-1]} != world*shard "
            f"({world}x{ss}) — pass the padded bucket buffer")
    states = list(opt_state) if ring.stacked else [opt_state]
    for st in states:
        _check_state(st, ss)
    if param_shard.dtype != torch.float32 or gbuf.dtype not in _DTYPES:
        raise ValueError(
            "ring reduce-scatter: the master shard must be float32 and the "
            f"gradient float32 or bfloat16, got {param_shard.dtype}, "
            f"{gbuf.dtype}")
    if _device_kind(gbuf, "fused_reduce_scatter_update") == "cpu":
        if ring.stacked:
            return fused_reduce_scatter_update_stacked(
                gbuf, param_shard, opt_state, optimizer,
                mean_world=mean_world, step=step)
        _fused_rs_update_dist(gbuf, param_shard, opt_state, optimizer, ring,
                              mean_world, step)
        return param_shard, opt_state
    _launch_rs(gbuf, param_shard, states, optimizer, ring, mean_world, step)
    for st in states:
        optimizer.advance(st)
    return param_shard, opt_state


def _launch_rs(gbuf, param, states, optimizer, ring, mean_world, step):
    global ring_rs_launches
    ss = param.shape[-1]
    host = [{k: v for k, v in st.items() if not torch.is_tensor(v)}
            for st in states]
    if any(h != host[0] for h in host):
        raise ValueError("ring reduce-scatter kernel: the ranks' optimizer "
                         f"states are at different steps: {host}")
    if ss > ring.max_elems:
        raise ValueError(f"ring reduce-scatter kernel: a shard of {ss} "
                         f"elements does not fit the ring's "
                         f"{ring.max_elems}")
    gs, ps = gbuf.reshape(-1, gbuf.shape[-1]), param.reshape(-1, ss)
    tensors = [gs, ps] + [v for st in states for v in st.values()
                          if torch.is_tensor(v)]
    if any(not t.is_contiguous() or t.device != gbuf.device
           for t in tensors):
        raise ValueError("ring reduce-scatter kernel: tensors must be "
                         "contiguous and on one device")
    rec = []
    for (rank, link), g, p, st in zip(ring.links("rs"), gs, ps, states):
        s1 = st.get("buf", st.get("exp_avg"))
        s2 = st.get("exp_avg_sq")
        rec += [rank, g.data_ptr(), p.data_ptr(),
                0 if s1 is None else s1.data_ptr(),
                0 if s2 is None else s2.data_ptr(), *link]
    arr = (ctypes.c_longlong * len(rec))(*rec)
    scal = np.ascontiguousarray(
        optimizer.scalars(states[0], mean_world, step), np.float32)
    epoch = ring.next_epoch("rs")
    with torch.cuda.device(gbuf.device):
        err = ring_lib().ring_rs_update(
            arr, gs.shape[0], ring.world, ss,
            int(gbuf.dtype == torch.bfloat16),
            FS._KINDS[FS._kind(optimizer)], scal.ctypes.data,
            int(bool(states[0].get("initialized", False))),
            int(optimizer.nesterov), epoch, int(ring.cooperative),
            torch.cuda.current_stream(gbuf.device).cuda_stream)
    check(err, "ring reduce-scatter kernel launch")
    ring_rs_launches += 1
