"""The ring collectives of ``mode="dear-fused"`` and the ring collective
matmul of ``--ring-projections`` — the port of
``dear_pytorch_tpu/ops/collective_matmul.py``, with its names:

  - `ring_all_gather` (K4; the TPU kernel ``_ag_kernel`` :218, via
    ``ring_all_gather`` :240): ``(n,) -> (W*n,)``, chunk order = rank
    order; data movement only, bitwise equal to a tiled all-gather;
  - `fused_reduce_scatter_update` (K5 ring; ``_rs_update_kernel`` :317,
    via ``fused_reduce_scatter_update`` :396): the ring reduce-scatter of
    a bucket's gradient with fp32 partial sums — rank i's partial starts
    as its local chunk (i-1) mod W and after round r holds chunk
    (i-1-r) mod W, adding the local copy each round; the first hop carries
    the local chunk in the gradient's own dtype, widened on receipt — and,
    at the last hop, ``grad / mean_world`` and the shard update of
    `ops.fused_sgd` on the owned shard, in place.

  - `allgather_matmul` (K6 forward, ``_cm_fwd_kernel`` :510; K7 and K8
    backward, ``_cm_dx_kernel`` :545 and ``_cm_dw_kernel`` :572, via the
    custom VJP :651): ``x @ all_gather(w_shard over rows)`` as a
    ``torch.autograd.Function`` over the kernel wrappers `ring_matmul`,
    `ring_matmul_dx` and `ring_matmul_dw`; the weight gradient arrives as
    this rank's row shard summed over the ranks. `make_ring_projection_impl`
    is the models' ``projection_impl`` over it, on the ring `bind_ring`
    binds.

K4 takes one of two routes (`ag_route`): "direct" into an output the ring
registered (`comm.ring.Ring.register_outputs`: the train step's gather
buffers), each chunk written straight into the right neighbour's output,
else "slot" through the ring's staging slots; K4 and the K5 ring each take
one of two widths, "vector" (bulk asynchronous copies through shared
memory, where every offset and pointer is 16-byte aligned) or "scalar".
K4 and the K5 ring are CUDA kernels for ``sm_90a`` in ``csrc/ring.cu``,
K6–K8 in ``csrc/ring_matmul.cu``, over the transport of `comm.ring`. The ``ring`` argument is a `comm.ring.Ring` (one
rank per process: flat per-rank tensors) or a `comm.ring.LocalRing` (W
ranks in this process: every tensor stacked ``[W, ...]``, one launch for
all). At world 1 they short-cut as in the JAX package (:248, :417,
:639): the gather returns the shard, the update is
`ShardOptimizer.update`, the ring matmul is the dense product.

Beside each, the plain PyTorch version in two forms: *stacked*
(`ring_all_gather_stacked`, `fused_reduce_scatter_update_stacked`: all W
ranks' inputs in one process, the ring's exact fp32 association order, so
the kernel is bitwise equal to it on the card), and *distributed* (the same
hops over `comm.collectives.ring_shift`: what a CPU rank of the train step
runs).
K6–K8's plain versions sum fp32 products in torch's order, the
kernels in the tensor cores', so those agree at a tolerance, not bitwise;
the ring order of K8's cross-rank sum is the same in both. K6 and K7 take
one of two routes (`cm_core`: TMA and wgmma for bf16 chunks TMA can
address, else the tiled mma.sync / CUDA-core product); each output element
is summed by one block in one order, so two calls on the same inputs give
the same bits. K8 splits its reduction over M across blocks (`dw_core`
picks the tile core, `dw_plan` cuts tiles x slabs of M into runs,
`_launch_cm` allocates the fp32 partials' workspace): the last unit of an
output tile sums the tile's partials in the order of M, so it too repeats
its bits. Dispatch: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises; any other device raises. ``ring_ag_launches``,
``ring_rs_launches``, ``cm_fwd_launches``, ``cm_dx_launches`` and
``cm_dw_launches`` count kernel launches (one per call, however many ranks
it drives), ``ring_ag_route_launches`` K4's by route and width,
``ring_rs_route_launches`` the K5 ring's by width, ``cm_route_launches``
K6's and K7's by route.

The ring's reduction order differs from NCCL's (and XLA's psum_scatter), so
``dear-fused`` matches ``dear`` at dtype tolerance, not bitwise; the gather
and the update math are exact.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, Optional

import numpy as np
import torch

from dear_pytorch_tpu_torch.comm import collectives as C
from dear_pytorch_tpu_torch.comm.ring import check, ring_lib
from dear_pytorch_tpu_torch.ops import fused_sgd as FS
from dear_pytorch_tpu_torch.ops import remat as R

__all__ = [
    "ag_route", "allgather_matmul", "bind_ring", "bound_ring",
    "fused_reduce_scatter_update", "fused_reduce_scatter_update_stacked",
    "make_ring_projection_impl", "ring_all_gather", "ring_all_gather_stacked",
    "ring_matmul", "ring_matmul_dw", "ring_matmul_dw_stacked",
    "ring_matmul_dx", "ring_matmul_dx_stacked", "ring_matmul_stacked",
    "rs_route",
]

#: kernel launches so far (incremented only where a kernel launches)
ring_ag_launches = 0
ring_rs_launches = 0
cm_fwd_launches = 0
cm_dx_launches = 0
cm_dw_launches = 0
#: K4's launches by route and width (`ag_route`), the K5 ring's by width
#: (`rs_route`), beside the totals
ring_ag_route_launches = {"direct": {"vector": 0, "scalar": 0},
                          "slot": {"vector": 0, "scalar": 0}}
ring_rs_route_launches = {"vector": 0, "scalar": 0}
#: K6's and K7's launches by route (`cm_core`), beside the totals
cm_route_launches = {"fwd": {"wgmma": 0, "mma": 0},
                     "dx": {"wgmma": 0, "mma": 0}}

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
                    out: Optional[torch.Tensor] = None, *,
                    direct: bool = False) -> torch.Tensor:
    """Every rank's ``shard`` concatenated in rank order, through the ring:
    ``(n,) -> (W*n,)`` on a `Ring`, ``[W, n] -> [W, W*n]`` on a
    `LocalRing`; into ``out`` when given. World 1 returns the shard (or
    copies it into ``out``). On the card the route follows ``out``
    (`ag_route`): "direct" when the ring registered it, else "slot";
    ``direct=True`` demands the direct route (raises if ``out`` is not
    registered)."""
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
    _launch_ag(shard, ring, out, direct)
    return out


def _width(nbytes: int, ptrs) -> str:
    """"vector" (bulk copies) when a chunk's bytes and every pointer are
    16-byte aligned, else "scalar"."""
    return ("vector" if nbytes % 16 == 0 and all(p % 16 == 0 for p in ptrs)
            else "scalar")


def ag_route(n: int, esize: int, ptrs, *, registered: bool, direct: bool,
             max_elems: int) -> tuple:
    """K4's route for a shard of ``n`` elements of ``esize`` bytes whose
    kernel pointers are ``ptrs``: ``(transport, width)``. Transport
    "direct" (every chunk written straight into the right neighbour's
    output; no slot, so no size limit) when the output is ``registered``
    with the ring, else "slot" (through the ring's slots of ``max_elems``
    elements); width as `_width`. Refuses an element size the kernel has
    no copy for, ``direct`` (demanded) with an output the ring did not
    register, and a slot-route shard larger than the slots."""
    if esize not in (2, 4):
        raise ValueError(f"ring all-gather kernel: {esize}-byte elements "
                         "are not float32 or bfloat16")
    if direct and not registered:
        raise ValueError("ring all-gather kernel: the direct route needs "
                         "an output registered with the ring "
                         "(Ring.register_outputs)")
    transport = "direct" if registered else "slot"
    if transport == "slot" and n > max_elems:
        raise ValueError(f"ring all-gather kernel: a shard of {n} elements "
                         f"does not fit the ring's {max_elems}")
    return transport, _width(n * esize, ptrs)


def _launch_ag(shard, ring, out, direct) -> None:
    global ring_ag_launches
    n = shard.shape[-1]
    if shard.dtype not in _DTYPES:
        raise ValueError(f"ring all-gather kernel: {shard.dtype} is not "
                         "float32 or bfloat16")
    if not (shard.is_contiguous() and out.is_contiguous()):
        raise ValueError("ring all-gather kernel: tensors not contiguous")
    xs = shard.reshape(-1, n)
    outs = out.reshape(xs.shape[0], -1)
    dlinks = ring.direct_links(out)
    # the slots and a peer's registered output start allocations (256-byte
    # aligned); the kernel checks every pointer again
    transport, width = ag_route(
        n, shard.element_size(), [t.data_ptr() for t in (*xs, *outs)],
        registered=dlinks is not None, direct=direct,
        max_elems=ring.max_elems)
    rec = []
    for i, ((rank, link), x, o) in enumerate(zip(ring.links("ag"), xs,
                                                 outs)):
        # the right neighbour's output and the ready flags: direct only
        peer = dlinks[i][1] if transport == "direct" else (0, 0, 0)
        rec += [rank, x.data_ptr(), o.data_ptr(), *peer, *link]
    arr = (ctypes.c_longlong * len(rec))(*rec)
    epoch = ring.next_epoch("ag")
    with torch.cuda.device(shard.device):
        err = ring_lib().ring_all_gather(
            arr, xs.shape[0], ring.world, n, shard.element_size(),
            int(transport == "direct"), int(width == "vector"), epoch,
            int(ring.cooperative),
            torch.cuda.current_stream(shard.device).cuda_stream)
    check(err, f"ring all-gather kernel launch ({transport}, {width})")
    ring_ag_launches += 1
    ring_ag_route_launches[transport][width] += 1


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
    """The stacked version's sums for this rank over the group, with the
    kernel's hops: the first in the gradient's dtype, widened on receipt
    (exactly: the same adds, bitwise)."""
    world, my, ss = ring.world, ring.rank, param.shape[0]
    chunks = gbuf.reshape(world, ss)
    hop = chunks[(my - 1) % world]
    for r in range(1, world):
        hop = C.ring_shift(hop, ring.group).float() \
            + chunks[(my - 1 - r) % world].float()
    _update_plain(optimizer, hop, state, param, mean_world, step)


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
    gs, ps = gbuf.reshape(-1, gbuf.shape[-1]), param.reshape(-1, ss)
    tensors = [gs, ps] + [v for st in states for v in st.values()
                          if torch.is_tensor(v)]
    if any(not t.is_contiguous() or t.device != gbuf.device
           for t in tensors):
        raise ValueError("ring reduce-scatter kernel: tensors must be "
                         "contiguous and on one device")
    # the slots start allocations (256-byte aligned)
    width = rs_route(ss, gbuf.element_size(),
                     [t.data_ptr() for t in (*gs, *ps, *tensors[2:])],
                     max_elems=ring.max_elems)
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
            int(optimizer.nesterov), int(width == "vector"), epoch,
            int(ring.cooperative),
            torch.cuda.current_stream(gbuf.device).cuda_stream)
    check(err, f"ring reduce-scatter kernel launch ({width})")
    ring_rs_launches += 1
    ring_rs_route_launches[width] += 1


def rs_route(n: int, gsize: int, ptrs, *, max_elems: int) -> str:
    """The K5 ring's width for a shard of ``n`` elements, a gradient of
    ``gsize``-byte elements and the kernel's pointers ``ptrs``: "vector"
    (bulk copies) when a chunk's bytes — and so its fp32 partials' — and
    every pointer are 16-byte aligned, else "scalar". Refuses a gradient
    dtype the kernel does not read and a shard larger than the ring's
    slots (``max_elems``)."""
    if gsize not in (2, 4):
        raise ValueError(f"ring reduce-scatter kernel: {gsize}-byte "
                         "gradients are not float32 or bfloat16")
    if n > max_elems:
        raise ValueError(f"ring reduce-scatter kernel: a shard of {n} "
                         f"elements does not fit the ring's {max_elems}")
    return _width(n * gsize, ptrs)


# ---------------------------------------------------------------------------
# the ring collective matmul (K6 forward, K7 dx, K8 dw)
# ---------------------------------------------------------------------------

#: ring-matmul calls made so far, by kernel, on any device (a `TrainStep`
#: checks that every forward call got its two backward calls)
ring_matmul_calls = {"fwd": 0, "dx": 0, "dw": 0}
#: of the forward calls, those a checkpoint's recompute made (`ops.remat`)
ring_matmul_recomputes = 0

_CM_KINDS = {"fwd": "rmm_forward", "dx": "rmm_dx", "dw": "rmm_dw"}


def _blk(x, j, kc):
    """Columns ``[j*kc, (j+1)*kc)`` of ``x`` (the last axis)."""
    return x[..., j * kc:(j + 1) * kc]


def ring_matmul_stacked(x: torch.Tensor, w_shard: torch.Tensor
                        ) -> torch.Tensor:
    """K6's plain version over all W ranks: ``x [W, M, K]``, ``w_shard [W,
    kc, N]`` -> ``y [W, M, N]``; rank i starts on its own shard and adds the
    chunk of owner (i - r) mod W in round r, in fp32, then casts."""
    world, kc = w_shard.shape[:2]
    acc = [_blk(x[i], i, kc).float() @ w_shard[i].float()
           for i in range(world)]
    hop = list(w_shard)
    for r in range(1, world):
        hop = [hop[(i - 1) % world] for i in range(world)]  # from the left
        acc = [acc[i] + _blk(x[i], (i - r) % world, kc).float()
               @ hop[i].float() for i in range(world)]
    return torch.stack(acc).to(x.dtype)


def ring_matmul_dx_stacked(dy: torch.Tensor, w_shard: torch.Tensor
                           ) -> torch.Tensor:
    """K7's plain version: ``dy [W, M, N]``, ``w_shard [W, kc, N]`` ->
    ``dx [W, M, W*kc]``; the column block of owner j is ``dy @ w_jᵀ``."""
    world, kc = w_shard.shape[:2]
    dx = dy.new_empty(dy.shape[:2] + (world * kc,))
    for i in range(world):
        for r in range(world):
            j = (i - r) % world
            _blk(dx[i], j, kc).copy_(dy[i].float() @ w_shard[j].float().T)
    return dx


def ring_matmul_dw_stacked(x: torch.Tensor, dy: torch.Tensor
                           ) -> torch.Tensor:
    """K8's plain version: ``x [W, M, W*kc]``, ``dy [W, M, N]`` -> ``dw
    [W, kc, N]``, rank i's shard of ``sum over ranks of xᵀ·dy``, in the
    ring's fp32 order: chunk c's sum starts at rank c+1 and adds ranks
    c+2, ..., c (mod W)."""
    world = x.shape[0]
    kc = x.shape[-1] // world

    def contrib(i, c):
        return _blk(x[i], c, kc).float().T @ dy[i].float()

    part = [contrib(i, (i - 1) % world) for i in range(world)]
    for r in range(1, world):
        recv = [part[(i - 1) % world] for i in range(world)]
        part = [recv[i] + contrib(i, (i - 1 - r) % world)
                for i in range(world)]
    return torch.stack(part).to(x.dtype)


def _ring_matmul_dist(x, w_shard, ring):
    world, my, kc = ring.world, ring.rank, w_shard.shape[0]
    acc = _blk(x, my, kc).float() @ w_shard.float()
    hop = w_shard
    for r in range(1, world):
        hop = C.ring_shift(hop, ring.group)
        acc = acc + _blk(x, (my - r) % world, kc).float() @ hop.float()
    return acc.to(x.dtype)


def _ring_matmul_dx_dist(dy, w_shard, ring):
    world, my, kc = ring.world, ring.rank, w_shard.shape[0]
    dx = dy.new_empty(dy.shape[:1] + (world * kc,))
    hop = w_shard
    for r in range(world):
        if r:
            hop = C.ring_shift(hop, ring.group)
        _blk(dx, (my - r) % world, kc).copy_(dy.float() @ hop.float().T)
    return dx


def _ring_matmul_dw_dist(x, dy, ring):
    world, my = ring.world, ring.rank
    kc = x.shape[-1] // world

    def contrib(c):
        return _blk(x, c, kc).float().T @ dy.float()

    part = contrib((my - 1) % world)
    for r in range(1, world):
        part = C.ring_shift(part, ring.group) + contrib((my - 1 - r) % world)
    return part.to(x.dtype)


def _cm_check(name, ring, a, b, a_shape, b_shape):
    lead = (ring.world,) if ring.stacked else ()
    for t, want, what in ((a, a_shape, "first"), (b, b_shape, "second")):
        if tuple(t.shape) != lead + want:
            raise ValueError(f"{name}: {what} operand of shape "
                             f"{tuple(t.shape)}, expected {lead + want}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise ValueError(f"{name}: operands must share a dtype, float32 or "
                         f"bfloat16; got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    return _device_kind(a, name)


def ring_matmul(x: torch.Tensor, w_shard: torch.Tensor, ring
                ) -> torch.Tensor:
    """K6: ``x @ all_gather(w_shard over rows)`` through the ring, ``x [M,
    W*kc]``, ``w_shard [kc, N]`` -> ``[M, N]`` in their dtype (every tensor
    stacked ``[W, ...]`` on a `LocalRing`). No autograd: see
    `allgather_matmul`. World 1 is the dense product."""
    kc, n = w_shard.shape[-2:]
    m = x.shape[-2]
    kind = _cm_check("ring_matmul", ring, x, w_shard,
                     (m, ring.world * kc), (kc, n))
    global ring_matmul_recomputes
    ring_matmul_calls["fwd"] += 1
    ring_matmul_recomputes += R.recomputing()
    if ring.world == 1:
        return (x.float() @ w_shard.float()).to(x.dtype)
    if kind == "cpu":
        if ring.stacked:
            return ring_matmul_stacked(x, w_shard)
        return _ring_matmul_dist(x, w_shard, ring)
    y = x.new_empty(x.shape[:-1] + (n,))
    _launch_cm("fwd", x, w_shard, y, ring, m, kc, n)
    return y


def ring_matmul_dx(dy: torch.Tensor, w_shard: torch.Tensor, ring
                   ) -> torch.Tensor:
    """K7: ``dy @ all_gather(w_shard)ᵀ`` as the shards re-stream, ``dy [M,
    N]``, ``w_shard [kc, N]`` -> ``dx [M, W*kc]`` in their dtype."""
    kc, n = w_shard.shape[-2:]
    m = dy.shape[-2]
    kind = _cm_check("ring_matmul_dx", ring, dy, w_shard, (m, n), (kc, n))
    ring_matmul_calls["dx"] += 1
    if ring.world == 1:
        return (dy.float() @ w_shard.float().transpose(-1, -2)).to(dy.dtype)
    if kind == "cpu":
        if ring.stacked:
            return ring_matmul_dx_stacked(dy, w_shard)
        return _ring_matmul_dx_dist(dy, w_shard, ring)
    dx = dy.new_empty(dy.shape[:-1] + (ring.world * kc,))
    _launch_cm("dx", dy, w_shard, dx, ring, m, kc, n)
    return dx


def ring_matmul_dw(x: torch.Tensor, dy: torch.Tensor, ring) -> torch.Tensor:
    """K8: this rank's row shard of ``sum over ranks of xᵀ·dy``, reduced
    around the ring with fp32 partials, ``x [M, W*kc]``, ``dy [M, N]`` ->
    ``dw_shard [kc, N]`` in their dtype."""
    m, k = x.shape[-2:]
    n = dy.shape[-1]
    if k % ring.world:
        raise ValueError(f"ring_matmul_dw: {k} input features do not split "
                         f"over {ring.world} ranks")
    kc = k // ring.world
    kind = _cm_check("ring_matmul_dw", ring, x, dy, (m, k), (m, n))
    ring_matmul_calls["dw"] += 1
    if ring.world == 1:
        return (x.float().transpose(-1, -2) @ dy.float()).to(x.dtype)
    if kind == "cpu":
        if ring.stacked:
            return ring_matmul_dw_stacked(x, dy)
        return _ring_matmul_dw_dist(x, dy, ring)
    dw = x.new_empty(x.shape[:-2] + (kc, n))
    _launch_cm("dw", x, dy, dw, ring, m, kc, n)
    return dw


#: K8's tile cores: (csrc/ring_matmul.cu's enum Core, which also numbers
#: K6's and K7's routes; output tile rows, output tile columns)
DW_CORES = {"mma": (0, 64, 64), "wgmma": (1, 128, 128)}
#: K8's reduction slab: a segment of M is a multiple of it
DW_SLAB = 64
#: the columns of the wgmma route's 128-row output tiles (128, 192 or 256)
CM_TILE_N = {"fwd": 256, "dx": 192}


def cm_core(dtype: torch.dtype, world: int, kc: int, n: int) -> str:
    """K6's and K7's route for a call (`dw_core`'s arguments; the world
    does not decide it): ``"wgmma"`` (TMA and wgmma, 128-row tiles) for
    bf16 operands whose chunks TMA can address (``kc`` and ``n`` multiples
    of 8 elements: 16-byte strides between x's chunks and the rows of dy,
    of the weight chunk and of every slot; K8's ``world * kc`` would not
    do); else ``"mma"`` (the tiled product: CUDA cores for fp32, mma.sync
    for ragged bf16)."""
    if dtype == torch.bfloat16 and kc % 8 == 0 and n % 8 == 0:
        return "wgmma"
    return "mma"


def dw_core(dtype: torch.dtype, world: int, kc: int, n: int) -> str:
    """K8's tile core for a call: ``"wgmma"`` (TMA and wgmma, 128 x 128
    tiles) for bf16 operands whose rows TMA can address (``world * kc`` and
    ``n`` multiples of 8 elements: 16-byte row strides); else ``"mma"``
    (64 x 64 tiles: fp32 on CUDA cores, ragged bf16 on mma.sync)."""
    if dtype == torch.bfloat16 and (world * kc) % 8 == 0 and n % 8 == 0:
        return "wgmma"
    return "mma"


def _range_of(i: int, ranges: int, total: int) -> int:
    """The range holding iteration ``i`` of ``total`` cut into ``ranges``
    (csrc/ring_matmul.cu's ``range_of``)."""
    return ((i + 1) * ranges - 1) // total


def dw_plan(m: int, kc: int, n: int, blocks: int, core: str,
            ranges: Optional[int] = None) -> tuple:
    """``(ranges, contrib, slab_rows)``: K8's output tiles x slabs of M
    (`DW_SLAB` rows each) cut evenly into ``ranges`` contiguous runs, and
    ``contrib``, the most runs that touch one tile (the partials its
    finishing unit sums; the workspace tiles it needs). By default, with no
    more tiles than the ``blocks`` of a rank, every tile is cut into the
    same S = blocks // tiles segments (ranges = tiles x S: one wave, each
    unit one piece of one tile); with more tiles, one run per block
    (stream-K: every block reduces the same number of slabs, a run may
    span two tiles). Never more runs than tiles x slabs, so none is empty.
    The main path's shapes (M = 8192, kc = 384) on 66 blocks: 18 tiles x 3
    segments at N = 768, 66 runs over 72 tiles (up to 2 per tile) at N =
    3072."""
    _, bm, bn = DW_CORES[core]
    tiles = -(-kc // bm) * -(-n // bn)
    slabs = max(1, -(-m // DW_SLAB))
    total = tiles * slabs
    blocks = max(1, blocks)
    if ranges is None:
        ranges = tiles * (blocks // tiles) if tiles <= blocks else blocks
    # no empty run: every run that touches a tile then arrives at its count
    ranges = min(max(1, ranges), total)
    contrib = max(_range_of((t + 1) * slabs - 1, ranges, total)
                  - _range_of(t * slabs, ranges, total) + 1
                  for t in range(tiles))
    return ranges, contrib, DW_SLAB


def dw_launch_plan(ring, m: int, kc: int, n: int, dtype) -> tuple:
    """``(core, ranges, contrib, slab_rows)`` of a K8 launch on ``ring``
    (its blocks per rank from the built kernel: ``rmm_blocks``)."""
    from dear_pytorch_tpu_torch.comm.ring import matmul_lib

    core = dw_core(dtype, ring.world, kc, n)
    lead = ring.world if ring.stacked else 1
    with torch.cuda.device(ring.device):
        blocks = matmul_lib().rmm_blocks(lead, int(ring.cooperative))
    return (core,) + dw_plan(m, kc, n, blocks, core)


def _launch_cm(kind, a, b, out, ring, m, kc, n) -> None:
    """One launch of K6 (``fwd``), K7 (``dx``) or K8 (``dw``) over the
    ranks ``ring`` drives: K6 and K7 on their route (`cm_core`; the wgmma
    route's tiles `CM_TILE_N` wide), K8 with its plan (`dw_core`,
    `dw_plan`) and a fresh workspace of fp32 partials."""
    from dear_pytorch_tpu_torch.comm.ring import matmul_lib

    global cm_fwd_launches, cm_dx_launches, cm_dw_launches
    if "cm" not in ring.legs:
        raise ValueError("ring matmul kernel: the ring has no cm leg (build "
                         "it with cm_elems)")
    hop = kc * n * (4 if kind == "dw" else a.element_size())
    if hop > ring.cm_slot_bytes:
        raise ValueError(f"ring matmul kernel: a hop of {hop} bytes does "
                         f"not fit the ring's {ring.cm_slot_bytes}-byte slot")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("ring matmul kernel: operands not contiguous")
    lead = ring.world if ring.stacked else 1
    As, Bs, Os = (t.reshape((lead,) + t.shape[-2:]) for t in (a, b, out))
    lib = matmul_lib()
    ws = [0] * lead
    if kind == "dw":
        core, ranges, contrib, slab_rows = dw_launch_plan(ring, m, kc, n,
                                                          a.dtype)
        _, bm, bn = DW_CORES[core]
        parts = -(-kc // bm) * -(-n // bn) * contrib
        work = torch.empty((lead, ring.world * parts * bm * bn),
                           dtype=torch.float32, device=a.device)
        ws = [w.data_ptr() for w in work]
        plan = (ranges, contrib, slab_rows, DW_CORES[core][0])
    else:
        core = cm_core(a.dtype, ring.world, kc, n)
        plan = (DW_CORES[core][0], CM_TILE_N[kind])
    rec = []
    for (rank, (own, right, left)), ai, bi, oi, wi in zip(
            ring.links("cm"), As, Bs, Os, ws):
        rec += [rank, ai.data_ptr(), bi.data_ptr(), oi.data_ptr(), own,
                right, left, wi]
    arr = (ctypes.c_longlong * len(rec))(*rec)
    epoch = ring.next_epoch("cm")
    with torch.cuda.device(a.device):
        err = getattr(lib, _CM_KINDS[kind])(
            arr, lead, ring.world, m, kc, n, ring.cm_slot_bytes,
            int(a.dtype == torch.bfloat16), epoch, int(ring.cooperative),
            *plan, torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"ring matmul kernel ({kind}) launch failed: "
                           + lib.rmm_error_string(err).decode())
    if kind == "fwd":
        cm_fwd_launches += 1
    elif kind == "dx":
        cm_dx_launches += 1
    else:
        cm_dw_launches += 1
    if kind in cm_route_launches:
        cm_route_launches[kind][core] += 1


class _AllgatherMatmul(torch.autograd.Function):
    """K6 forward; K7 (dx) and K8 (dw_shard, summed over the ranks)
    backward, both always, so every rank issues the same ring calls."""

    @staticmethod
    def forward(ctx, x, w_shard, ring):
        ctx.ring = ring
        ctx.save_for_backward(x, w_shard)
        return ring_matmul(x, w_shard, ring)

    @staticmethod
    def backward(ctx, dy):
        x, w_shard = ctx.saved_tensors
        dy = dy.contiguous()
        dx = ring_matmul_dx(dy, w_shard, ctx.ring)
        dw = ring_matmul_dw(x, dy, ctx.ring)
        return dx, dw.to(w_shard.dtype), None


def allgather_matmul(x: torch.Tensor, w_shard: torch.Tensor, ring
                     ) -> torch.Tensor:
    """``x @ all_gather(w_shard over rows)`` through the ring, with its
    gradient (the JAX package's custom VJP, :631-696): ``x [M, K]`` (this
    rank's activations), ``w_shard [K/W, N]`` (this rank's contiguous row
    block in rank order) -> ``[M, N]`` in ``result_type(x, w)``; stacked
    ``[W, ...]`` on a `LocalRing`. The gradient of ``w_shard`` arrives
    summed over the ranks. World 1 is the dense product."""
    dt = torch.promote_types(x.dtype, w_shard.dtype)
    x, w_shard = x.to(dt), w_shard.to(dt)
    if ring.world == 1:
        return x @ w_shard
    return _AllgatherMatmul.apply(x.contiguous(), w_shard.contiguous(), ring)


# ---------------------------------------------------------------------------
# model integration: the projection_impl hook
# ---------------------------------------------------------------------------

_bound: list = []


@contextlib.contextmanager
def bind_ring(ring):
    """Bind ``ring`` for the ring projections run inside the block — the
    analogue of the mesh axis that ``shard_map`` binds in the JAX package.
    `parallel.dear.TrainStep` binds its ring around each step's forward
    and backward; ``None`` binds nothing."""
    _bound.append(ring)
    try:
        yield ring
    finally:
        _bound.pop()


def bound_ring():
    """The innermost bound ring, or ``None``."""
    return _bound[-1] if _bound else None


def make_ring_projection_impl() -> Callable:
    """The models' ``projection_impl`` (`models.bert.ProjDense`'s contract:
    ``impl(x2d [M, in], kernel2d [in, out], bias1d [out] or None, dtype)``)
    backed by `allgather_matmul` over the bound ring (`bind_ring`).

    It applies flax's dtype promotion (every operand to ``dtype``) and
    computes the dense product where no ring is bound (building a model, an
    eval outside a train step: the JAX impl outside ``shard_map``), at
    world 1, or where ``in`` does not split over the ranks; otherwise it
    takes this rank's row shard ``kernel2d[my*kc:(my+1)*kc]`` and runs the
    ring, then adds the bias. The port keeps the weight as torch's ``[out,
    in]``, so the shard is the strided column block ``weight[:,
    my*kc:(my+1)*kc]``: it is sliced before the cast and copied contiguous
    once (kc·out elements), which makes flax's promotion and the copy one
    pass over the shard and gives the kernel dense 16-byte rows to stream.
    The gradient of the slice lands at this rank's rows of the full-weight
    gradient, zeros elsewhere; the bucket reduce-scatter then sums the
    ranks. On a `LocalRing` every operand is stacked ``[W, ...]`` and rank
    i takes its own rows of its own ``kernel2d[i]``."""

    def impl(x2, kernel2, bias1, dtype):
        ring = bound_ring()
        world = 1 if ring is None else ring.world
        k = kernel2.shape[-2]
        if world == 1 or k % world:
            y = x2.to(dtype) @ kernel2.to(dtype)
        else:
            kc = k // world
            if ring.stacked:
                w_shard = torch.stack([kernel2[i, i * kc:(i + 1) * kc]
                                       for i in range(world)])
            else:
                w_shard = kernel2[ring.rank * kc:(ring.rank + 1) * kc]
            y = allgather_matmul(x2.to(dtype),
                                 w_shard.to(dtype).contiguous(), ring)
        return y if bias1 is None else y + bias1.to(dtype).unsqueeze(-2)

    return impl
