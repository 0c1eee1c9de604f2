"""The DeAR schedule in eager PyTorch — the port of
``dear_pytorch_tpu/parallel/dear.py`` for ``mode="dear"``.

This is the reference system's own shape (the JAX module's docstring,
dear.py:3-9), kept to the JAX package's semantics (dear.py:11-32):

  - ZeRO-1: each rank owns one fp32 master shard of every fusion bucket
    (`ops.fusion`) and that shard's optimizer state;
  - the model's parameters are views into one full flat buffer per bucket
    (in ``gather_dtype``, else fp32), which the bucket's all-gather fills;
  - backward: a post-accumulate-grad hook on every parameter packs its
    gradient into the bucket's flat grad buffer (cast to ``comm_dtype``, as
    ``F.pack_all(grads, plan, dtype=comm_dtype)``); when a bucket's last
    gradient is in, its reduce-scatter starts asynchronously, on a comm
    stream that waits on an event recorded on the compute stream — under
    the rest of the backward;
  - after backward: wait on each bucket's reduce-scatter; with
    ``clip_norm``, the global norm of the reduced fp32 gradients (the
    shard-local sum of squares, all-reduced over the group); then per
    bucket the shard update (`ops.fused_sgd`: the K5 epilogue, a Hopper
    kernel on the card) and an async all-gather of the updated shard (cast
    to ``gather_dtype``) into the full buffer;
  - next forward: a forward pre-hook on every module that owns parameters
    waits on the gathers of their buckets — the gather runs under the
    forward of the layers before;
  - step 0: `TrainStep.init` gathers the master shards before the first
    forward, so step 0 trains on reduced gradients (the JAX package's fix
    of the reference's iteration-0 quirk).

`TrainStep.init` copies the model's parameters into the shards, so the
caller's tensors are never aliased (the donation hazard dear.py:1056-1061
guards against), and then rebinds each parameter as a view into its
bucket's full buffer: from then on the model belongs to the step. The plan
follows ``model.named_parameters()`` order (module order: the gather
prefetch needs it), where the JAX package buckets in sorted-key order, so
parity with it is held per parameter by name.

``mode="dear-fused"`` (the JAX module's dear.py:58-73) runs both legs as
the hand-written ring kernels of `ops.collective_matmul` over a
`comm.ring.Ring` whose peer buffers are exchanged here, at build time:
when a bucket's last gradient is in, ONE kernel (K5 ring) reduce-scatters
it around the ring with fp32 partial sums and applies the shard update at
the last hop, on the comm stream; after backward each bucket's gather is
the ring all-gather (K4), on its direct route: the full buffers are the
ring's registered outputs (`comm.ring.Ring.register_outputs`), and each
rank writes its chunk straight into its right neighbour's (csrc/ring.cu
argues from this module's stream order why that is safe). No collective
library and no separate update
run on these legs. Every rank must issue its ring calls in the same order
(they pair up across ranks), so the reduce-scatters are issued in one
fixed order, descending bucket index (the order a backward over a
module-order plan completes them): a bucket that completes early waits
for its turn; the gathers run in ascending order. The mode takes the JAX
package's build-time guards (dear.py:401-457): no ``clip_norm``, no
`LayerwiseShardOptimizer` (LAMB), no compression and no ``dcn``, each a
``ValueError`` with the JAX package's message. At world 1 both legs
short-cut as in JAX: the update is the plain shard update, the gather the
shard itself.

A model built with `ops.collective_matmul.make_ring_projection_impl` (the
CLI's ``--ring-projections``) runs its query, key, value and ``mlp_in``
projections as the ring collective matmul (K6 forward, K7 and K8
backward) on the compute stream. In ``dear-fused`` the step builds the
ring's third leg, "cm", sized for the model's largest projection shard
(`models.bert.ProjDense` modules), and binds the ring around each
forward and backward (`ops.collective_matmul.bind_ring`: the analogue of
the axis ``shard_map`` binds). Those calls pair up across ranks in the
order the forward and autograd's backward issue them, the same on every
rank; the step checks that every forward call got its two backward
calls. Under ``mode="dear"`` no ring is bound and the impl is the dense
product, the same function.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the other modes, compression, ``exclude_parts``, model state (BN
statistics), ``remat``, the multi-slice ``dcn`` schedule and
``multi_step``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from dear_pytorch_tpu_torch._device import check_model_device
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import collectives as C
from dear_pytorch_tpu_torch.comm.ring import Ring
from dear_pytorch_tpu_torch.models.bert import ProjDense
from dear_pytorch_tpu_torch.ops import collective_matmul as CM
from dear_pytorch_tpu_torch.ops import fusion as F
from dear_pytorch_tpu_torch.ops.fused_sgd import (
    LayerwiseShardOptimizer,
    ShardOptimizer,
    fused_sgd,
)

__all__ = ["DearState", "MODES", "TrainStep", "build_train_step"]

MODES = ("dear", "dear-fused", "allreduce", "rsag", "rb", "bytescheduler",
         "fsdp")


class DearState(NamedTuple):
    """Carried training state: per bucket the fp32 master shard this rank
    owns and its optimizer state; the global step count. The tensors are
    updated in place by `TrainStep.step`."""

    shards: tuple
    opt_state: tuple
    step: int


#: options of the JAX package's ``build_train_step`` that are not ported
#: yet -> the ROADMAP Queue 1 item that brings them
_UNPORTED = {
    "exclude_parts": "7 (modes and ablations)",
    "compressor": "7 (compression)", "gtopk": "7 (compression)",
    "momentum_correction": "7 (compression)",
    "model_state_template": "5 (model state: BatchNorm statistics)",
    "remat": "7 (remat)", "dcn": "9 (the multi-slice schedule)",
}


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP Queue 1 item {item}")


def _fused_guards(optimizer, clip_norm, unported) -> None:
    """The JAX package's build-time guards of ``mode="dear-fused"``, in its
    order and with its messages (dear.py:401-457)."""
    if unported.get("dcn") is not None:
        raise ValueError(
            "multislice (dcn=) cannot ride mode='dear-fused': the "
            "Pallas ring kernels address devices by single-mesh axis "
            "index and a ring spanning the DCN boundary would issue "
            "remote copies to devices outside this slice's ICI mesh "
            "— use mode='dear' (hierarchical RS+AG over ICI + host "
            "DCN exchange)")
    if clip_norm is not None:
        raise ValueError(
            "dear-fused applies the optimizer inside the per-bucket "
            "reduce-scatter kernel; the cross-bucket global-norm clip "
            "needs every bucket's reduced gradient first — use "
            "mode='dear' with clip_norm")
    if isinstance(optimizer, LayerwiseShardOptimizer):
        raise ValueError(
            "dear-fused cannot fuse LayerwiseShardOptimizer (LAMB) "
            "into the epilogue kernel: trust ratios need cross-shard "
            "psums — use mode='dear'")
    if unported.get("compressor") not in (None, "none"):
        raise ValueError(
            "gradient compression cannot ride mode='dear-fused': the "
            "Pallas ring kernels execute the reduce-scatter leg (fused "
            "with the optimizer epilogue) on dense fp tiles and cannot "
            "exchange sparse/sign/int8-packed payloads — use mode='dear' "
            "(compressed decoupled schedule) or mode='allreduce'")


def build_train_step(loss_fn: Callable, model: nn.Module, *,
                     optimizer: Optional[ShardOptimizer] = None,
                     group=None, mode: str = "dear",
                     threshold_mb: Optional[float] = 25.0,
                     nearby_layers: Optional[int] = None,
                     flags: Optional[Sequence[int]] = None,
                     plan: Optional[F.FusionPlan] = None,
                     comm_dtype=None, gather_dtype=None,
                     has_aux: bool = False, rng_seed: Optional[int] = None,
                     accum_steps: int = 1,
                     clip_norm: Optional[float] = None, device=None,
                     **unported) -> "TrainStep":
    """Build the eager DeAR train step over ``model``.

    ``loss_fn(model, batch) -> loss`` (``(loss, aux)`` with ``has_aux``);
    with ``rng_seed`` it is called as ``loss_fn(model, batch, generator)``
    with a ``torch.Generator`` on the model's device seeded from
    ``(rng_seed, step, rank)`` and, under accumulation, the microbatch — for
    dropout. ``optimizer``: a `ShardOptimizer` (default: SGD, lr 0.01).
    ``group``: the process group (default: `comm.backend.init` on
    ``device``, which must be the model's; the card unless told
    otherwise). ``threshold_mb`` / ``nearby_layers`` / ``flags`` / ``plan``:
    the bucketing (`ops.fusion.make_plan` over ``named_parameters()``).
    ``comm_dtype``: the dtype gradients travel in; ``gather_dtype``: the
    dtype the shards are gathered in, which the parameters then have.
    ``accum_steps``: microbatches per step (every batch tensor splits along
    dim 0); gradients accumulate in fp32 and are divided by
    ``accum_steps`` before the cast, and one reduce-scatter per bucket runs
    after the last microbatch. ``clip_norm``: clip the reduced gradient to
    this global L2 norm (``metrics["grad_norm"]``). The JAX package's other
    options (``exclude_parts``, ``compressor``, ``gtopk``,
    ``momentum_correction``, ``model_state_template``, ``remat``, ``dcn``)
    are accepted at their defaults and raise ``NotImplementedError``
    otherwise."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "dear-fused":
        _fused_guards(optimizer, clip_norm, unported)
    elif mode != "dear":
        raise _unported(f"mode={mode!r}", "7 (modes and ablations)")
    if isinstance(optimizer, LayerwiseShardOptimizer):
        raise _unported("LayerwiseShardOptimizer (LAMB)", "3")
    for name, value in unported.items():
        if name not in _UNPORTED:
            raise TypeError(f"build_train_step() got an unexpected keyword "
                            f"argument {name!r}")
        if value not in (None, "none", False, ()):
            raise _unported(f"{name}={value!r}", _UNPORTED[name])
    if int(accum_steps) != accum_steps or accum_steps < 1:
        raise ValueError(
            f"accum_steps must be a positive int, got {accum_steps}")
    if clip_norm is not None and clip_norm <= 0:
        raise ValueError(f"clip_norm must be positive, got {clip_norm}")
    dev = check_model_device(model.device, device)
    group = backend.init(dev) if group is None else group
    world = dist.get_world_size(group)
    if plan is None:
        plan = F.make_plan(model, world, threshold_mb=threshold_mb,
                           nearby_layers=nearby_layers, flags=flags)
    if plan.world != world:
        raise ValueError(f"plan was built for world={plan.world} but the "
                         f"group has {world} ranks")
    return TrainStep(loss_fn, model, optimizer or fused_sgd(lr=0.01), group,
                     plan, comm_dtype=comm_dtype, gather_dtype=gather_dtype,
                     has_aux=has_aux, rng_seed=rng_seed,
                     accum_steps=int(accum_steps), clip_norm=clip_norm,
                     fused=mode == "dear-fused")


def _ring_matmul_elems(model, world: int) -> int:
    """The cm leg's hop capacity: the largest row shard (in/W x out) of the
    model's `ProjDense` projections that split over the ranks; 0 when
    there are none (no leg)."""
    return max((p.in_features // world * p.out_features
                for p in model.modules() if isinstance(p, ProjDense)
                and p.in_features % world == 0), default=0)


class TrainStep:
    """What `build_train_step` returns: ``init``, ``step``,
    ``gather_params``, ``plan`` and ``group``, and the per-run counters
    ``rs_launches``, ``ag_launches`` and ``update_launches`` (one of each
    per bucket per step) that show the schedule ran per bucket, and
    ``cm_calls`` (ring-matmul calls, three per ring projection per step).
    In ``dear-fused`` mode ``ring`` is the step's `comm.ring.Ring` (holding
    no buffers at world 1; with a "cm" leg when the model has ring
    projections); `close` frees it once every rank is done."""

    def __init__(self, loss_fn, model, optimizer, group, plan, *,
                 comm_dtype, gather_dtype, has_aux, rng_seed, accum_steps,
                 clip_norm, fused=False):
        self.loss_fn, self.model, self.optimizer = loss_fn, model, optimizer
        self.group, self.plan = group, plan
        self.has_aux, self.rng_seed = has_aux, rng_seed
        self.accum_steps, self.clip_norm = accum_steps, clip_norm
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = dev = model.device
        self.rs_launches = self.ag_launches = self.update_launches = 0
        self.cm_calls = 0

        params = dict(model.named_parameters())
        for s in plan.leaves:
            if s.name not in params or tuple(params[s.name].shape) != s.shape:
                raise ValueError(f"plan leaf {s.name} {s.shape} is not a "
                                 "parameter of the model")
        if len(params) != len(plan.leaves):
            raise ValueError("the plan does not cover every parameter")
        self._gather_dtype = gdt = gather_dtype or torch.float32
        cdt = comm_dtype or gdt

        def zeros(n, dt):
            return torch.zeros((n,), dtype=dt, device=dev)

        bks = plan.buckets
        self.fused = fused
        # every rank builds its ring here, at the same point: the peer
        # buffers' handles are exchanged over the group (none at world 1)
        self.ring = (Ring(group, dev, max(b.shard_size for b in bks),
                          cm_elems=_ring_matmul_elems(model, self.world))
                     if fused else None)
        # dear-fused: the gather buffers are the ring's registered outputs,
        # which K4 fills directly, a neighbour's chunks included
        self._full = (self.ring.register_outputs(
            [b.padded_size for b in bks], gdt) if fused
            else [zeros(b.padded_size, gdt) for b in bks])
        self._send = [zeros(b.shard_size, gdt) if gdt != torch.float32
                      else None for b in bks]
        self._gbuf = [zeros(b.padded_size, cdt) for b in bks]
        self._rs_out = [zeros(b.shard_size, cdt) for b in bks]
        self._acc = ([zeros(b.padded_size, torch.float32) for b in bks]
                     if accum_steps > 1 else None)
        self._slot = {}
        for b in bks:
            for leaf_id, off in zip(b.leaf_ids, b.offsets):
                self._slot[leaf_id] = (b.index, off, plan.leaves[leaf_id].size)
        self._rs_work = [None] * len(bks)
        self._ag_work = [None] * len(bks)
        self._pending = [0] * len(bks)
        self._fired: set = set()
        self._last_mb = True
        self._comm = (torch.cuda.Stream(dev) if dev.type == "cuda" else None)
        self._bound = False
        #: dear-fused: the one order every rank issues its reduce-scatters in
        self._rs_order = [b.index for b in reversed(bks)]
        self._rs_next = 0
        self._rs_ready: set = set()
        self._state: Optional[DearState] = None

    # -- streams and collectives ---------------------------------------------

    @contextlib.contextmanager
    def _on_comm(self):
        """Run collectives on the comm stream, after the compute stream's
        work so far (an event, not a host sync); a no-op on the CPU."""
        if self._comm is None:
            yield
            return
        self._comm.wait_event(torch.cuda.current_stream(self.device)
                              .record_event())
        with torch.cuda.stream(self._comm):
            yield

    def _reduce_scatter(self, g: int) -> None:
        if self.fused:
            self._rs_ready.add(g)
            self._fused_reduce_scatters()
            return
        with self._on_comm():
            _, self._rs_work[g] = C.reduce_scatter(
                self._gbuf[g], self.group, async_op=True,
                out=self._rs_out[g])
        self.rs_launches += 1

    def _fused_reduce_scatters(self) -> None:
        """Issue K5 ring for every bucket whose turn in the fixed order has
        come and whose gradient is complete: the reduce-scatter and the
        shard update in one launch per bucket."""
        state = self._state
        while (self._rs_next < len(self._rs_order)
               and self._rs_order[self._rs_next] in self._rs_ready):
            g = self._rs_order[self._rs_next]
            with self._on_comm():
                CM.fused_reduce_scatter_update(
                    self._gbuf[g], state.shards[g], state.opt_state[g],
                    self.optimizer, self.ring, mean_world=self.world,
                    step=state.step)
            self._rs_next += 1
            self.rs_launches += 1
            self.update_launches += 1

    def _gather(self, g: int, shard: torch.Tensor) -> None:
        with self._on_comm():   # the cast too: K5 ring updates the shard there
            src = (shard if self._send[g] is None
                   else self._send[g].copy_(shard))
            if self.fused:   # the direct route, or an error on the card
                CM.ring_all_gather(src, self.ring, out=self._full[g],
                                   direct=True)
                self._ag_work[g] = C.StreamEvent.after_current(self.device)
            else:
                _, self._ag_work[g] = C.all_gather(
                    src, self.group, async_op=True, out=self._full[g])
        self.ag_launches += 1

    def _wait_gathers(self, buckets) -> None:
        for g in buckets:
            work = self._ag_work[g]
            if work is not None:
                work.wait()  # on the card: the current stream waits
                self._ag_work[g] = None

    # -- binding the model ---------------------------------------------------

    def _grad_hook(self, leaf_id: int):
        g, off, n = self._slot[leaf_id]
        sl = slice(off, off + n)

        def hook(p):
            grad, p.grad = p.grad.reshape(-1), None
            if self._acc is not None:
                self._acc[g][sl].add_(grad)
                if not self._last_mb:
                    return
                self._gbuf[g][sl].copy_(self._acc[g][sl] / self.accum_steps)
            else:
                self._gbuf[g][sl].copy_(grad)
            self._fired.add(leaf_id)
            self._pending[g] -= 1
            if self._pending[g] == 0:
                self._reduce_scatter(g)

        return hook

    def _bind(self) -> None:
        """Rebind every parameter as a view into its bucket's full buffer,
        with a gradient hook, and hang the gather waits on the modules."""
        views = {}
        for b in self.plan.buckets:
            views.update(F.unpack_bucket(self._full[b.index], self.plan,
                                         b.index))
        ids = {s.name: i for i, s in enumerate(self.plan.leaves)}
        for mname, mod in self.model.named_modules():
            owned = []
            for pname, _ in list(mod.named_parameters(recurse=False)):
                leaf_id = ids[f"{mname}.{pname}" if mname else pname]
                p = nn.Parameter(views[leaf_id])
                p.register_post_accumulate_grad_hook(self._grad_hook(leaf_id))
                setattr(mod, pname, p)
                owned.append(self._slot[leaf_id][0])
            if owned:
                buckets = sorted(set(owned))
                mod.register_forward_pre_hook(
                    lambda m, args, gs=buckets: self._wait_gathers(gs))
        self._bound = True

    # -- the step ------------------------------------------------------------

    def init(self, params: Optional[dict] = None) -> DearState:
        """Copy ``params`` (``{name: tensor}``; default: the model's own)
        into this rank's fp32 master shards, bind the model to the step,
        and start the gathers that the first forward waits on."""
        if params is None:
            params = {n: p.detach() for n, p in
                      self.model.named_parameters()}
        leaves = {s.name: torch.as_tensor(params[s.name]).to(
            device=self.device, dtype=torch.float32)
            for s in self.plan.leaves}
        shards = []
        with torch.no_grad():
            for b in self.plan.buckets:
                flat = F.pack_bucket(leaves, self.plan, b.index,
                                     dtype=torch.float32)
                lo = self.rank * b.shard_size
                shards.append(flat[lo:lo + b.shard_size].clone())
        opt = tuple(self.optimizer.init(s) for s in shards)
        if not self._bound:
            self._bind()
        for g, shard in enumerate(shards):
            self._gather(g, shard)
        return DearState(tuple(shards), opt, 0)

    def _generator(self, step: int, microbatch: int) -> torch.Generator:
        seed = np.random.SeedSequence(
            [self.rng_seed, step, self.rank, microbatch]).generate_state(
                1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(
            int(seed) & (2**63 - 1))

    def _microbatches(self, batch) -> list:
        k = self.accum_steps
        if k == 1:
            return [batch]

        def split(x):
            if x.shape[0] % k:
                raise ValueError(
                    f"batch leaf leading axis {x.shape[0]} is not divisible "
                    f"by accum_steps={k} (note: this is the PER-RANK batch)")
            return x.chunk(k)

        if torch.is_tensor(batch):
            return list(split(batch))
        parts = {key: split(x) for key, x in batch.items()}
        return [{key: v[i] for key, v in parts.items()} for i in range(k)]

    def _finish_buckets(self) -> None:
        """Reduce the buckets whose every gradient did not arrive (a
        parameter the loss does not reach has gradient zero, as under JAX's
        ``value_and_grad``)."""
        for b in self.plan.buckets:
            if self._pending[b.index] == 0:
                continue
            for leaf_id in b.leaf_ids:
                if leaf_id not in self._fired:
                    _, off, n = self._slot[leaf_id]
                    sl = slice(off, off + n)
                    if self._acc is not None:
                        self._gbuf[b.index][sl].copy_(
                            self._acc[b.index][sl] / self.accum_steps)
                    else:
                        self._gbuf[b.index][sl].zero_()
            self._reduce_scatter(b.index)

    def step(self, state: DearState, batch) -> tuple:
        """One training step: forward and backward per microbatch, the
        per-bucket reduce-scatters under the backward, the update and the
        gathers. Returns ``(next_state, metrics)``; ``metrics["loss"]`` is
        the mean over ranks (and microbatches), a device scalar."""
        if not self._bound:
            raise RuntimeError("TrainStep.init() must run before step()")
        if self._acc is not None:
            for a in self._acc:
                a.zero_()
        self._state = state
        self._rs_next, self._rs_ready = 0, set()
        losses, auxs = [], []
        mbs = self._microbatches(batch)
        for i, mb in enumerate(mbs):
            self._last_mb = i == len(mbs) - 1
            self._pending = [len(b.leaf_ids) for b in self.plan.buckets]
            self._fired = set()
            args = (self.model, mb)
            if self.rng_seed is not None:
                args += (self._generator(state.step, i),)
            calls = dict(CM.ring_matmul_calls)
            with CM.bind_ring(self.ring):
                out = self.loss_fn(*args)
                loss, aux = out if self.has_aux else (out, None)
                loss.backward()
            self._count_ring_matmuls(calls)
            losses.append(loss.detach().float())
            if aux is not None:
                auxs.append(torch.as_tensor(aux).detach().float())
        self._finish_buckets()
        metrics: dict = {}
        if self.fused:
            self._fused_gathers(state)
        else:
            self._update_and_gather(state, metrics)
        loss = torch.stack(losses).mean()
        metrics["loss"] = self._mean_over_ranks(loss)
        if auxs:
            metrics["aux"] = self._mean_over_ranks(torch.stack(auxs).mean(0))
        return DearState(state.shards, state.opt_state, state.step + 1), \
            metrics

    def _count_ring_matmuls(self, before: dict) -> None:
        """Every ring projection's forward call (K6) must have had its two
        backward calls (K7, K8): the ranks' ring calls pair up."""
        got = {k: CM.ring_matmul_calls[k] - v for k, v in before.items()}
        if not got["fwd"] == got["dx"] == got["dw"]:
            raise RuntimeError(f"ring-matmul calls of one microbatch do not "
                               f"pair up (forward, dx, dw): {got}")
        self.cm_calls += 3 * got["fwd"]

    def _fused_gathers(self, state: DearState) -> None:
        """dear-fused, after backward: every K5 ring was issued (in the one
        order); the gathers follow on the comm stream, and the compute
        stream waits for the reduce-scatters (the next backward rewrites
        their gradient buffers), not for the gathers (the next forward's
        pre-hooks wait for those)."""
        if self._rs_next != len(self._rs_order):
            raise RuntimeError(
                f"dear-fused issued {self._rs_next} of "
                f"{len(self._rs_order)} bucket reduce-scatters")
        done = (self._comm.record_event() if self._comm is not None
                else None)
        with torch.no_grad():
            for g, shard in enumerate(state.shards):
                self._gather(g, shard)
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)

    def _update_and_gather(self, state: DearState, metrics: dict) -> None:
        """dear: wait for each bucket's reduce-scatter, clip, update each
        shard, and start its gather."""
        for g, work in enumerate(self._rs_work):
            work.wait()
            self._rs_work[g] = None
        clip_scale = None
        if self.clip_norm is not None:
            mw = torch.tensor(float(self.world), device=self.device)
            sumsq = sum((r.float() / mw).square().sum() for r in self._rs_out)
            if self.world > 1:
                sumsq = C.all_reduce(sumsq, self.group)
            gnorm = sumsq.sqrt()
            clip_scale = torch.clamp(
                self.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
            metrics["grad_norm"] = gnorm
        with torch.no_grad():
            for g, shard in enumerate(state.shards):
                self.optimizer.update(
                    self._rs_out[g], state.opt_state[g], shard,
                    mean_world=self.world, clip_scale=clip_scale,
                    step=state.step)
                self.update_launches += 1
                self._gather(g, shard)

    def _mean_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        if self.world == 1:
            return x
        return C.all_reduce(x, self.group) / self.world

    def gather_params(self, state: DearState) -> dict:
        """``{name: fp32 tensor}``: the full master parameters, gathered
        from every rank's shards (for eval and checkpoints; in dear-fused
        mode through the ring all-gather, K4)."""
        if not self.fused:
            bufs = [C.all_gather(s, self.group) for s in state.shards]
            return F.unpack_all(bufs, self.plan)
        bufs = [s.new_empty((self.world * s.shape[0],))
                for s in state.shards]
        with self._on_comm():
            for s, buf in zip(state.shards, bufs):
                CM.ring_all_gather(s, self.ring, out=buf)
            done = C.StreamEvent.after_current(self.device)
        if done is not None:
            done.wait()
        return F.unpack_all(bufs, self.plan)

    def close(self) -> None:
        """Free the ring's buffers (dear-fused) once every rank's last ring
        call is done; every rank calls it. The gather buffers die with the
        ring, so the model's parameters get memory of their own first.
        Nothing to do otherwise."""
        if self.ring is None:
            return
        if (self._bound and not self.ring.closed
                and self.device.type == "cuda" and self.world > 1):
            with torch.no_grad():
                for p in self.model.parameters():
                    p.data = p.data.clone()
        self._full = []
        self.ring.close()

    def multi_step(self, n: int):
        raise _unported("multi_step (as CUDA-graph capture)", "7")
