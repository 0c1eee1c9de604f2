"""The DeAR schedule and its baselines in eager PyTorch — the port of
``dear_pytorch_tpu/parallel/dear.py``.

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
package's build-time guards (dear.py:401-457): no ``dcn``, no
``clip_norm``, no `LayerwiseShardOptimizer` (LAMB) and no compression, each a
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

Model state (the JAX module's ``model_state_template``, dear.py:241-247,
:744-758) is the model's buffers — BatchNorm's running statistics and
counters — which the forward updates in place, microbatch after
microbatch under accumulation (as JAX's ``lax.scan`` threads them). Once
per step, after the last microbatch's backward, the step packs them into
one flat buffer and all-gathers it over the group on the comm stream (one
collective, no host sync); there each floating buffer becomes the mean over
the ranks and each integer or bool buffer the max. The next forward (a
pre-hook on the model) and `TrainStep.gather_params` wait for it. At world
1, and for a model without buffers (the GPT models), nothing runs.

The baseline schedules (the JAX module's docstring, dear.py:34-90) share
one path. ``allreduce``, ``rsag``, ``rb`` and ``bytescheduler`` replicate:
each bucket's fp32 master is the whole padded bucket on every rank
(``DearState.shards`` holds the full buckets, the JAX package's
``state.buffers``), the model's parameters are views into it, the
optimizer state is full size, and nothing is gathered. When a bucket's
last gradient is in, its reduction starts asynchronously on the comm
stream, in place in the bucket's gradient buffer, as DDP/WFBP do; the four
modes differ only in that collective (`_REDUCTIONS`): an all-reduce; a
reduce-scatter then an all-gather (``all_reduce_rsag``); a reduce to rank
0 then a broadcast (``all_reduce_rb``); or, for ``bytescheduler``, one
independent reduce-scatter + all-gather pair per ``partition_mb`` chunk of
the bucket (`ops.fusion.chunk_bounds` in the comm dtype), in layer order.
After backward each full bucket gets the K5 epilogue; with ``clip_norm``
the local sum of squares already is the global one (no all-reduce of it,
JAX dear.py:900-904).

``fsdp`` is ZeRO-3 (JAX dear.py:581, :641-700): the ``dear`` schedule,
except that no full bucket lives from the forward to the backward. The
forward runs under ``saved_tensors_hooks`` whose pack replaces every
saved tensor that is a view of a full bucket (a parameter, its
transpose) by a reference to it; after the forward every bucket's
storage is freed (``untyped_storage().resize_(0)``; the parameters stay
views of the emptied storage); in the backward the unpack of the first
such reference re-gathers the bucket (the analogue of JAX's
``checkpoint_name`` policy), and the bucket is freed again once its last
gradient is in, where its reduce-scatter — the transpose of the gather —
starts. Both legs travel in ``gather_dtype`` (``comm_dtype`` must be
None), so the numerics are ``dear``'s with ``comm_dtype = gather_dtype``.
A saved cast of a parameter (``gather_dtype`` unlike the compute dtype:
``weight.to(dt)``), or a view of one, is not the bucket's storage; the
pack saves it as a reference to the parameter and its dtype, and the
unpack casts the re-gathered bucket again, as JAX's policy denies saving
``convert_element_type`` (dear.py:680-689). So is a cast of a view of a
parameter (``weight.t().to(dt)``, a reshape, transpose or permute before
the cast): the reference holds the view and the cast, and the unpack
applies both to the re-gathered bucket. With ``accum_steps`` every
microbatch gathers again.
Freeing after the whole forward, not after each module, keeps a
parameter that a later module reads again (GPT-2's tied ``wte`` in the
head) alive; a training step's peak lies in the backward, after the
loss, where no bucket is gathered yet.

``exclude_parts`` (``mode="dear"`` only; JAX dear.py:584-594, :852-856)
are the reference's time-breakdown ablations, garbage numerics by design:
without ``allgather`` the full buffer is zeros with this rank's shard at
its slot and no gather runs; without ``reducescatter`` the update reads
this rank's slice of its own gradient and no reduce-scatter runs.

Gradient compression (``compressor``, ``density``, ``gtopk``,
``momentum_correction``; ``mode="allreduce"`` and ``"dear"`` only, JAX
dear.py:776-851) replaces a bucket's dense reduction: when its last
gradient is in, on the comm stream, the bucket's gradient (in fp32, the
master dtype: a bf16 gradient is compressed as its fp32 value) plus this
rank's error-feedback residual is compressed (`ops.compression`), the
payload goes through ONE collective (gTop-k: one pair exchange per round,
partner ``rank ^ 2^r``) and every rank rebuilds the same dense mean over
the ranks. ``allreduce`` updates the whole bucket from it; ``dear`` keeps
its slice ``[rank * shard, (rank + 1) * shard)`` and the all-gather leg
stays dense. The mean is already over the ranks (the sign vote: ±1), so
the update divides by nothing. ``DearState.comp_state`` holds per bucket
this rank's residual over the padded bucket (``()`` for the stateless
topk and signum) and, with momentum correction, the local velocity
(``{"res", "vel"}``): the JAX package's ``(world, padded)`` rows, one per
rank. Under gTop-k a coordinate this rank sent but the global top-k
rejected goes back into its residual; under momentum correction the
velocity is cleared at the coordinates this rank sent. Every rank issues
the payload collectives in the order its gradient hooks complete the
buckets, which is the backward's order, the same on every rank.

A `LayerwiseShardOptimizer` (LAMB, `ops.fused_sgd.fused_lamb`; JAX
dear.py:912-958) gets, per bucket, the segment ids of this rank's slice
(searchsorted over the bucket's offsets; padding in a dummy last segment)
and a ``psum``: in the sharded modes at world > 1 an all-reduce of its two
segment sums in one collective (counted in ``ar_launches``), else the
identity.

``remat="full"`` (JAX dear.py:694-698) recomputes the whole forward for
the backward (`ops.remat.recompute_whole`): the loss runs once keeping no
activation, then again on the same thread with the dropout generator
replayed from its state at the first pass's start and the model's buffers
left as the first pass left them (BatchNorm's running statistics are
updated once per microbatch, as JAX's functional state is); the backward
runs the second pass's graph. Running the recompute on the forward's
thread, not on autograd's, makes every cuDNN conv take the forward's
algorithm (cuDNN caches its picks per thread), so the result is the run
without remat's bit for bit under the ImageNet CLI's benchmark mode too.
The gather waits run again in the recompute (they find nothing to wait
for); each parameter's gradient hook still fires once. Under
``dear-fused`` with ring projections the recompute issues K6 again, in
the same order on every rank: a microbatch's K6 calls, less those its
first pass made (`ops.remat.recomputing`), pair with its K7 and K8
calls. ``fsdp`` refuses remat, as JAX's does.

Every schedule counts its collectives on the `TrainStep` (with B buckets,
per step):

  mode                  rs   ag   ar   reduce/bcast   comp          update
  dear                  B    B    -    -              -             B
  dear, compressed      -    B    -    -              B (gTop-k:    B
  allreduce, compressed -    -    -    -               B log2 W)    B
  fsdp                  B    2B   -    -              -             B
  allreduce             -    -    B    -              -             B
  rsag                  B    B    -    -              -             B
  rb                    -    -    -    B / B          -             B
  bytescheduler         one rs and one ag per chunk                 B

(``fsdp`` with ``accum_steps`` k: 2kB all-gathers.) ``comp_launches``
counts the payload collectives; a LAMB step adds B to ``ar`` in the
sharded modes at world > 1; an excluded leg counts 0.

`TrainStep.multi_step` (JAX dear.py:1320-1358) returns ``fn(state,
batch)``, which runs n steps on the one batch and returns the final state
and the LAST step's metrics; the callable is cached per n. Where JAX
compiles the n steps as one ``lax.scan`` program, here they are n eager
`TrainStep.step` calls: every collective, launch and counter of n
``step()`` calls, and the dropout generators of steps ``state.step`` to
``state.step + n - 1``, so it equals n ``step()`` calls bit for bit.
Capturing it as one CUDA graph is a performance item (ROADMAP Queue 2).

Telemetry (`observability.tracer`, the JAX package's names): building a
step counts ``dear.plan_builds`` (event ``dear.plan_built``); each step,
when the tracer is on, counts ``dear.steps`` and ``dear.<leg>_bytes``
(the per-step payload of each collective leg,
`observability.counters.plan_comm_accounting`) and, in ``dear-fused``,
``kernel.fused_rs_launches`` and ``kernel.ring_ag_launches`` (the K5
ring's and K4's launches in the step, from `ops.collective_matmul`'s
launch counts: none at world 1, whose short-cut runs no ring, nor on the
CPU), in every mode ``kernel.fused_update_launches`` (the K5 epilogue's)
and ``kernel.flash_{fwd,bwd_dq,bwd_dkv}_launches`` (K1, K2 and K3's, from
`ops.fused_sgd`'s and `ops.flash_attention`'s counts: what a process that
ran the step reports to its driver), and runs in a ``dear.step`` span (the host's enqueue time,
not the card's); ``multi_step`` counts ``dear.multi_step_compiles`` once
per n, when its callable is first built. With the tracer off (the
default) a step does none of this.

SDC fingerprint (JAX dear.py:399-400, :964-980): with ``DEAR_SDC=1`` at
build time, every step adds ``metrics["sdc_fp"]``, per bucket the uint32
wraparound sum of the post-update fp32 masters' words (an int64 tensor on
the device: the int32 view summed in int64, one all-reduce of the ranks'
sums in the sharded modes, then ``& 0xFFFFFFFF``); `utils.guard` fetches
it at its check cadence. Without ``DEAR_SDC`` the step adds no operation.

Checkpoints (`utils.checkpoint`): a restore writes into the live step in
place (`TrainStep.load_state`, after `TrainStep.quiesce` has waited for
or dropped what a step left in flight; the gathers are issued again, as
`init` issues them), and an asynchronous save's snapshot copy holds the
next step's first in-place write of the masters, the optimizer or the
compressor state (`TrainStep.hold_for_snapshot`: an event wait on the
stream, not a host sync). `TrainStep.last_state` is the state the step
last returned.

The hierarchical (multi-slice) schedule (``dcn=``, a
`comm.dcn.DcnExchanger`; JAX dear.py:335-358, :1155-1276): ``mode="dear"``
over ``group`` = this rank's SLICE group (`comm.backend.slice_group`; the
JAX package's intra-slice ICI axis), with the cross-slice leg on the host
between the backward and the update. Per step: forward and backward with
the per-bucket reduce-scatters on the slice group, as above;
``dcn.prefetch(step)``; per bucket one all-gather of the reduced bucket
over the slice group (every rank of the slice then holds the slice's
whole reduced bucket), divided by the slice's world in fp32 (the JAX
package's intra-slice mean) and copied to the host, so every rank of a
slice publishes byte-identical payloads; ``dcn.exchange`` (the mean over
the live slices, and of the slices' losses); ONE ``all_gather_object``
over the slice group on which its ranks agree on the outcome — ok, or the
lowest failing rank's exception, raised on every rank of the slice with
its type and message, before any of them updates (a rank that went on
alone would issue collectives its failed peer never joins); this rank's
shard of each mean copied to the card; the K5 epilogue per bucket with no
further division (the means are means); the gathers, as above.
``metrics["loss"]`` is the exchanged loss mean. A slice's dropout
streams fold ``slice * world + rank`` (JAX dear.py:614-620), so ranks at
the same position of two slices draw different masks. The guards are the
JAX package's (dear.py:401-406, :509-552) in its order, and its mesh
guards become one: the exchanger has exactly one local slice and
``group`` is that slice's group. ``multi_step`` raises, as JAX's does.
`rebind` moves the step to the next membership epoch's slice group
(`tuning.autotune.AutoTuner.rescale`) without touching its state. With
B buckets a hierarchical step counts B reduce-scatters, 2B all-gathers
(B of the reduced buckets, B of the updated shards) and B updates.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from dear_pytorch_tpu_torch._device import check_model_device
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import collectives as C
from dear_pytorch_tpu_torch.comm import dcn as DCN
from dear_pytorch_tpu_torch.comm.ring import Ring
from dear_pytorch_tpu_torch.models.bert import ProjDense
from dear_pytorch_tpu_torch.observability import counters as CTR
from dear_pytorch_tpu_torch.observability import tracer as _telemetry
from dear_pytorch_tpu_torch.ops import collective_matmul as CM
from dear_pytorch_tpu_torch.ops import compression as Z
from dear_pytorch_tpu_torch.ops import fusion as F
from dear_pytorch_tpu_torch.ops import remat as R
from dear_pytorch_tpu_torch.ops.fused_sgd import (
    LayerwiseShardOptimizer,
    fused_sgd,
    segment_pieces,
)

__all__ = ["DearState", "EXCLUDABLE", "MODES", "TrainStep",
           "build_train_step"]

MODES = ("dear", "dear-fused", "allreduce", "rsag", "rb", "bytescheduler",
         "fsdp")
#: the ablation switches of ``mode="dear"`` (JAX dear.py:120-123)
EXCLUDABLE = ("reducescatter", "allgather")
#: the schedules whose fp32 masters are shards (ZeRO); the others replicate
_SHARDED = ("dear", "dear-fused", "fsdp")


class DearState(NamedTuple):
    """Carried training state: per bucket the fp32 master shard this rank
    owns (in the replicated modes the whole padded bucket) and its
    optimizer state; the global step count; with compression, per bucket
    this rank's compressor state (module docstring; else ``()``). The
    tensors are updated in place by `TrainStep.step`."""

    shards: tuple
    opt_state: tuple
    step: int
    comp_state: tuple = ()


class _SavedView(NamedTuple):
    """What ``fsdp``'s pack hook saves for a view of full bucket
    ``bucket`` (shape, stride, offset), or for a cast of such a view:
    enough to rebuild it once the bucket is gathered again. ``cast``: None,
    or the cast's dtype and the saved tensor's shape, stride and offset in
    the cast's copy."""

    bucket: int
    shape: tuple
    stride: tuple
    offset: int
    cast: Optional[tuple] = None


#: the autograd nodes of the views `TrainStep._pack` sees through between a
#: parameter and its cast (``t``, ``transpose``, ``permute``, ``view`` and
#: a ``reshape`` that views)
_VIEW_NODES = frozenset({"TBackward0", "TransposeBackward0",
                         "PermuteBackward0", "ViewBackward0",
                         "ReshapeAliasBackward0"})


def _kernel_launches() -> dict:
    """The K5 epilogue's and K1-K3's launch counts so far (the wrappers'
    own counters)."""
    from dear_pytorch_tpu_torch.ops import fused_sgd as FS
    from dear_pytorch_tpu_torch.ops import flash_attention as FA

    return {"fused_update_launches": FS.fused_update_launches,
            "flash_fwd_launches": FA.flash_fwd_launches,
            "flash_bwd_dq_launches": FA.flash_bwd_dq_launches,
            "flash_bwd_dkv_launches": FA.flash_bwd_dkv_launches}


def _allreduce(step, buf):
    step.ar_launches += 1
    return [C.all_reduce(buf, step.group, async_op=True, out=buf)[1]]


def _rsag(step, buf):
    step.rs_launches += 1
    step.ag_launches += 1
    return [C.all_reduce_rsag(buf, step.group, async_op=True, out=buf)[1]]


def _rb(step, buf):
    step.reduce_launches += 1
    step.bcast_launches += 1
    return [C.all_reduce_rb(buf, 0, step.group, async_op=True, out=buf)[1]]


def _bytescheduler(step, buf):
    bounds = F.chunk_bounds(buf.shape[0], buf.element_size(),
                            step.partition_mb)
    step.rs_launches += len(bounds)
    step.ag_launches += len(bounds)
    return [C.all_reduce_rsag(buf[lo:hi], step.group, async_op=True,
                              out=buf[lo:hi])[1] for lo, hi in bounds]


#: the replicated modes: ``(step, buf) -> works``, the collective each
#: applies to a bucket's whole gradient buffer, in place and async; each
#: counts its launches on the step
_REDUCTIONS = {"allreduce": _allreduce, "rsag": _rsag, "rb": _rb,
               "bytescheduler": _bytescheduler}


def _fused_guards(optimizer, clip_norm, dcn, axes) -> None:
    """The JAX package's build-time guards of ``mode="dear-fused"`` that
    come before the others, in its order and with its messages
    (dear.py:401-457)."""
    if dcn is not None:
        raise ValueError(
            "multislice (dcn=) cannot ride mode='dear-fused': the "
            "Pallas ring kernels address devices by single-mesh axis "
            "index and a ring spanning the DCN boundary would issue "
            "remote copies to devices outside this slice's ICI mesh "
            "— use mode='dear' (hierarchical RS+AG over ICI + host "
            "DCN exchange)")
    if len(axes) != 1:
        raise ValueError(
            "dear-fused rings address devices by LOGICAL mesh id and "
            "currently support a single data-parallel axis; got "
            f"{axes}")
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


def _dcn_guards(dcn, mode, comp, clip_norm, model_state, has_aux,
                exclude_parts, group, axes, mean_axes) -> None:
    """The JAX package's guards of the hierarchical schedule, in its order
    and with its messages (dear.py:509-552); its nested-mesh guards
    (:553-565) become the port's: one local slice, and ``group`` is that
    slice's group (`comm.backend.slice_group`)."""
    if mode != "dear":
        raise ValueError(
            "the hierarchical (dcn=) schedule is the two-level "
            f"decoupled 'dear' mode; got mode={mode!r}")
    if comp.name != "none":
        raise ValueError(
            "gradient compression on the hierarchical schedule is "
            "unsupported: the cross-slice leg averages DENSE reduced "
            "partials on the host — compress-on-DCN is a named "
            "follow-up, not a silent fallback")
    if clip_norm is not None:
        raise ValueError(
            "clip_norm needs the GLOBAL gradient norm, which crosses "
            "the slice boundary inside the step — unsupported with "
            "dcn= (the host leg averages per-bucket partials only)")
    if model_state:
        raise ValueError(
            "model_state (BatchNorm stats etc.) syncs over the "
            "intra-slice axes only and would silently diverge across "
            "slices — unsupported with dcn=")
    if has_aux:
        raise ValueError(
            "has_aux is unsupported with dcn=: only the loss travels "
            "the cross-slice scalar path")
    if exclude_parts:
        raise ValueError(
            "exclude_parts ablations assume the single-level "
            "schedule; unsupported with dcn=")
    if mean_axes != axes:
        raise ValueError(
            "mean_axes != axis_name is unsupported with dcn=: the "
            "intra-slice legs average over every local axis and the "
            "host leg averages over slices")
    if backend.sp_layout() is not None:
        raise NotImplementedError(
            "sequence parallelism on the hierarchical (dcn=) schedule is "
            "not ported yet (ROADMAP Queue 1 item 10d)")
    local = tuple(getattr(dcn, "local_slices", ()))
    if len(local) != 1:
        raise ValueError(
            f"dcn= needs an exchanger with exactly one local slice (a "
            f"process of the port is one rank of one slice); got "
            f"local_slices={local or None}")
    if backend.slice_id() is None:
        raise ValueError(
            "dcn= runs its intra-slice legs over the slice's process "
            "group: form the slice groups first (comm.backend."
            "form_slice_groups, or regroup a slice-granular view)")
    if local[0] != backend.slice_id():
        raise ValueError(
            f"the exchanger's local slice {local[0]} is not this rank's "
            f"slice {backend.slice_id()}")
    if group is not None and group is not backend.slice_group():
        raise ValueError(
            f"group must be slice {local[0]}'s group (comm.backend."
            "slice_group()): the hierarchical step's reduce-scatters and "
            "gathers run inside the slice")


def _compression_guards(comp, mode, exclude_parts) -> None:
    """The JAX package's guards of a compressor against the schedule, in
    its order and with its messages (dear.py:464-486)."""
    if comp.name == "none":
        return
    if mode == "dear-fused":
        raise ValueError(
            "gradient compression cannot ride mode='dear-fused': the "
            "Pallas ring kernels execute the reduce-scatter leg (fused "
            "with the optimizer epilogue) on dense fp tiles and cannot "
            "exchange sparse/sign/int8-packed payloads — use mode='dear' "
            "(compressed decoupled schedule) or mode='allreduce'")
    if mode not in ("allreduce", "dear"):
        raise ValueError(
            "gradient compression is supported on the 'allreduce' "
            "(WFBP-family, reference parity) and 'dear' (decoupled "
            f"RS+AG) schedules; got mode={mode!r}")
    if exclude_parts:
        raise ValueError(
            "exclude_parts ablations assume dense collectives; the "
            "compressed gradient leg has no reduce-scatter to exclude")


def build_train_step(loss_fn: Callable, model: nn.Module, *,
                     optimizer=None, group=None, mode: str = "dear",
                     threshold_mb: Optional[float] = 25.0,
                     nearby_layers: Optional[int] = None,
                     flags: Optional[Sequence[int]] = None,
                     plan: Optional[F.FusionPlan] = None,
                     comm_dtype=None, gather_dtype=None,
                     compressor: Optional[str] = None, density: float = 1.0,
                     gtopk: bool = False, momentum_correction: float = 0.0,
                     has_aux: bool = False, rng_seed: Optional[int] = None,
                     accum_steps: int = 1,
                     clip_norm: Optional[float] = None, device=None,
                     model_state_template=None,
                     exclude_parts: Sequence[str] = (),
                     partition_mb: Optional[float] = 4.0,
                     remat: Optional[str] = None,
                     dcn=None, dcn_slice_axis: str = "slice",
                     mean_axes: Optional[Sequence[str]] = None
                     ) -> "TrainStep":
    """Build the eager DeAR (or baseline) train step over ``model``.

    ``loss_fn(model, batch) -> loss`` (``(loss, aux)`` with ``has_aux``);
    with ``rng_seed`` it is called as ``loss_fn(model, batch, generator)``
    with a ``torch.Generator`` on the model's device seeded from
    ``(rng_seed, step, rank)`` and, under accumulation, the microbatch — for
    dropout. ``optimizer``: a `ShardOptimizer`, a `LayerwiseShardOptimizer`
    (`fused_lamb`) or a `from_torch_optim` adapter (default: SGD, lr
    0.01). ``group``: the process group (default: `comm.backend.init` on
    ``device``, which must be the model's; the card unless told
    otherwise). ``threshold_mb`` / ``nearby_layers`` / ``flags`` / ``plan``:
    the bucketing (`ops.fusion.make_plan` over ``named_parameters()``).
    ``comm_dtype``: the dtype gradients travel in; ``gather_dtype``: the
    dtype the shards are gathered in, which the parameters then have.
    ``compressor`` (a name of `ops.compression.compressors`), ``density``,
    ``gtopk`` and ``momentum_correction``: gradient compression on
    ``allreduce`` and ``dear`` (module docstring).
    ``accum_steps``: microbatches per step (every batch tensor splits along
    dim 0); gradients accumulate in fp32 and are divided by
    ``accum_steps`` before the cast, and one reduce-scatter per bucket runs
    after the last microbatch. ``clip_norm``: clip the reduced gradient to
    this global L2 norm (``metrics["grad_norm"]``).
    ``model_state_template``: the names of the model's buffers that are its
    state (any iterable of names, e.g. a ``state_dict``-like mapping; the
    default, None, is every buffer), synced over the group once per step
    (module docstring). ``mode``: one of `MODES` (module docstring).
    ``exclude_parts``: a subset of `EXCLUDABLE`, the time-breakdown
    ablations of ``mode="dear"``. ``partition_mb``: ``bytescheduler``'s
    chunk size in MB of the comm dtype, and under ``dcn`` the cross-slice
    message size (other modes ignore it). ``remat``: None, ``"none"`` or
    ``"full"`` (recompute the forward in the backward; ``fsdp`` refuses
    it). ``dcn``: a `comm.dcn.DcnExchanger`, the hierarchical schedule
    (module docstring); ``group`` then defaults to this rank's slice group.
    ``dcn_slice_axis`` is the JAX package's mesh axis name, accepted and
    unused: the slice is a process group here. ``mean_axes``: the JAX
    package's (dear.py:326-331), the axes over which the ranks' losses are
    independent equal-weight samples — gradients are AVERAGED over these
    and summed over the rest. The axes are ``("dp",)``, or ``("dp",
    "sp")`` when ``group``'s ranks carry a dp x sp layout
    (`comm.backend.form_sp_groups` over them); the default is all of them.
    For sequence parallelism pass ``("dp",)``: an sp group computes ONE
    loss (its ranks hold partial gradients, which sum), dp replicas hold
    different samples (theirs average). The update then divides by ``dp =
    world // sp`` instead of the world, on every bucket (the K5 epilogue's
    ``mean_world``); the buckets still reduce over the whole group. The
    guards are the JAX package's, in its order and with its messages
    (dear.py:361-565)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    for e in exclude_parts:
        if e not in EXCLUDABLE:
            raise ValueError(f"exclude_parts entries must be in {EXCLUDABLE}")
    if exclude_parts and mode != "dear":
        raise ValueError("exclude_parts is a 'dear'-mode ablation")
    on_layout = _on_sp_layout(group, dcn)
    axes = ((backend.DP_AXIS, backend.SP_AXIS) if on_layout
            else (backend.DP_AXIS,))
    mean_axes = tuple(mean_axes) if mean_axes is not None else axes
    if not set(mean_axes) <= set(axes):
        raise ValueError(f"mean_axes {mean_axes} not a subset of {axes}")
    if mode == "dear-fused":
        _fused_guards(optimizer, clip_norm, dcn, axes)
    if gather_dtype is not None and mode not in _SHARDED:
        raise ValueError("gather_dtype applies to the sharded ('dear'/'fsdp') "
                         "schedules only")
    if mode == "fsdp" and comm_dtype is not None:
        raise ValueError(
            "'fsdp' communicates both legs in gather_dtype (the "
            "reduce-scatter is the all-gather's AD transpose); comm_dtype "
            "must be None")
    comp = Z.get_compressor(compressor)
    _compression_guards(comp, mode, exclude_parts)
    if remat not in (None, "none", "full"):
        raise ValueError(
            f"remat must be None, 'none' or 'full', got {remat!r}")
    remat = None if remat in (None, "none") else remat
    if remat is not None and mode == "fsdp":
        raise ValueError(
            "'fsdp' owns its rematerialization policy (the re-gather-in-"
            "backward checkpoint); remat applies to the other schedules")
    if comp.name != "none" and mean_axes != axes:
        raise ValueError(
            "compressed reductions divide by the full axis product and do "
            "not support mean_axes != axis_name (e.g. sequence-parallel "
            "partial-gradient sums); use dense schedules on multi-axis "
            "meshes with mean_axes")
    if gtopk and comp.name not in Z.SPARSE:
        raise ValueError("gtopk requires a top-k-family compressor")
    if int(accum_steps) != accum_steps or accum_steps < 1:
        raise ValueError(
            f"accum_steps must be a positive int, got {accum_steps}")
    if clip_norm is not None:
        if comp.name != "none":
            raise ValueError(
                "clip_norm with compression is unsupported: the sparse "
                "payloads are already a lossy gradient transform")
        if clip_norm <= 0:
            raise ValueError(f"clip_norm must be positive, got {clip_norm}")
    if momentum_correction and comp.name not in Z.SPARSE:
        raise ValueError(
            "momentum_correction requires a sparse (top-k-family) "
            "compressor (reference wfbp/dopt.py:769: mc applies on the "
            "sparse path only)")
    mstate = _model_state(model, model_state_template)
    if dcn is not None:
        _dcn_guards(dcn, mode, comp, clip_norm, mstate, has_aux,
                    exclude_parts, group, axes, mean_axes)
    dev = check_model_device(model.device, device)
    if group is None:
        group = backend.slice_group() if dcn is not None else backend.init(dev)
    world = dist.get_world_size(group)
    if gtopk and world & (world - 1):
        raise ValueError(f"gtopk needs a power-of-two world, got {world}")
    if plan is None:
        plan = F.make_plan(model, world, threshold_mb=threshold_mb,
                           nearby_layers=nearby_layers, flags=flags)
    if plan.world != world:
        raise ValueError(f"plan was built for world={plan.world} but the "
                         f"group has {world} ranks")
    sizes = {backend.DP_AXIS: world // backend.sp_size() if on_layout
             else world, backend.SP_AXIS: backend.sp_size()}
    mean_world = int(np.prod([sizes[a] for a in mean_axes]))
    return TrainStep(loss_fn, model, optimizer or fused_sgd(lr=0.01), group,
                     plan, comm_dtype=comm_dtype, gather_dtype=gather_dtype,
                     has_aux=has_aux, rng_seed=rng_seed,
                     accum_steps=int(accum_steps), clip_norm=clip_norm,
                     mode=mode, exclude_parts=exclude_parts,
                     partition_mb=partition_mb, model_state=mstate,
                     compressor=comp, density=density, gtopk=bool(gtopk),
                     momentum_correction=momentum_correction, remat=remat,
                     dcn=dcn, mean_world=mean_world)


def _on_sp_layout(group, dcn) -> bool:
    """Whether the step's group (``group``, or the world when None and
    there is no ``dcn``) is the one a dp x sp layout was formed over."""
    layout = backend.sp_layout()
    if layout is None or (group is None and dcn is not None):
        return False
    ranks = (tuple(range(dist.get_world_size())) if group is None
             else tuple(dist.get_process_group_ranks(group)))
    return ranks == layout.base


def _model_state(model, template) -> dict:
    """``{name: buffer}`` of the buffers that ``template`` names (None:
    every buffer)."""
    bufs = dict(model.named_buffers())
    names = list(bufs) if template is None else list(template)
    unknown = [n for n in names if n not in bufs]
    if unknown:
        raise ValueError(f"model_state_template names {unknown}, which are "
                         "not buffers of the model")
    return {n: bufs[n] for n in names}


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
    that show the schedule ran per bucket: ``rs_launches``,
    ``ag_launches``, ``ar_launches``, ``reduce_launches``,
    ``bcast_launches`` and ``comp_launches`` (each collective launched, by
    kind, ``comp`` the compressed payloads'; the module docstring has
    their counts per step for each mode), ``update_launches`` (one per
    bucket per step), ``cm_calls`` (ring-matmul calls, three per ring
    projection per step, and one more K6 call per recompute) and
    ``state_syncs`` (model-state collectives: one per step at world > 1
    when the model has state, else none). ``dcn``: the hierarchical
    schedule's exchanger (None on the single-level schedules), whose
    per-step legs are timed in ``dcn_times`` (seconds of the last step:
    the wait for the backward's reduce-scatters, the slice gathers, the
    host copy, the exchange with its agreement, the copy back) and counted in ``dcn_bytes`` (the host payload of the last
    step).
    In ``dear-fused`` mode ``ring`` is the step's `comm.ring.Ring` (holding
    no buffers at world 1; with a "cm" leg when the model has ring
    projections); `close` frees it once every rank is done."""

    def __init__(self, loss_fn, model, optimizer, group, plan, *,
                 comm_dtype, gather_dtype, has_aux, rng_seed, accum_steps,
                 clip_norm, mode="dear", exclude_parts=(), partition_mb=4.0,
                 model_state=None, compressor=None, density=1.0, gtopk=False,
                 momentum_correction=0.0, remat=None, dcn=None,
                 mean_world=None):
        self.loss_fn, self.model, self.optimizer = loss_fn, model, optimizer
        self.dcn = dcn
        #: the hierarchical step's leg times (seconds) and host payload
        #: bytes, of the last step
        self.dcn_times: dict = {}
        self.dcn_bytes = 0
        self.group, self.plan = group, plan
        self.has_aux, self.rng_seed = has_aux, rng_seed
        self.accum_steps, self.clip_norm = accum_steps, clip_norm
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = dev = model.device
        self.mode = mode
        self.sharded = mode in _SHARDED
        self.fsdp = mode == "fsdp"
        self._exclude = frozenset(exclude_parts)
        self._reduction = _REDUCTIONS.get(mode)
        self.partition_mb = partition_mb
        comp = compressor or Z.get_compressor(None)
        #: the compressor (None: dense), its density and options
        self.compressor = comp if comp.name != "none" else None
        self.density, self.gtopk = density, gtopk
        self.momentum_correction = momentum_correction
        self.remat = remat
        self.layerwise = isinstance(optimizer, LayerwiseShardOptimizer)
        self.rs_launches = self.ag_launches = self.update_launches = 0
        self.ar_launches = self.reduce_launches = self.bcast_launches = 0
        self.comp_launches = self.cm_calls = self.state_syncs = 0
        model_state = model_state or {}   # {name: buffer}
        #: the names of the model-state buffers (what a checkpoint keeps)
        self.model_state_names = list(model_state)
        self._mstate = list(model_state.values())
        self._mstate_done = None
        # SDC sentinel (resilience.sdc): the per-bucket fingerprint is
        # added to the step's metrics only when DEAR_SDC is armed at build
        # time — the disabled path adds no operation at all
        from dear_pytorch_tpu_torch.resilience import sdc as _sdc
        self.sdc_fp = _sdc.sdc_enabled()
        #: an asynchronous checkpoint's snapshot copy in flight (a CUDA
        #: event): the next in-place write of the masters, the optimizer
        #: or the compressor state waits for it (`hold_for_snapshot`)
        self._snapshot = None
        #: a member of the group died (`abandon`): `quiesce` and `close`
        #: drop what is in flight instead of waiting on the group
        self.group_lost = False

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
        self.fused = fused = mode == "dear-fused"
        # every rank builds its ring here, at the same point: the peer
        # buffers' handles are exchanged over the group (none at world 1)
        self.ring = (Ring(group, dev, max(b.shard_size for b in bks),
                          cm_elems=_ring_matmul_elems(model, self.world))
                     if fused else None)
        # dear-fused: the gather buffers are the ring's registered outputs,
        # which K4 fills directly, a neighbour's chunks included; the
        # replicated modes: the fp32 masters themselves (gdt is fp32)
        self._full = (self.ring.register_outputs(
            [b.padded_size for b in bks], gdt) if fused
            else [zeros(b.padded_size, gdt) for b in bks])
        #: fsdp: each full bucket's bytes, and bucket by storage address
        self._full_bytes = [f.untyped_storage().nbytes() for f in self._full]
        self._bucket_of_storage: dict = {}
        if self.fsdp:
            self._index_storages()
        self._send = [zeros(b.shard_size, gdt)
                      if self.sharded and gdt != torch.float32 else None
                      for b in bks]
        self._gbuf = [zeros(b.padded_size, cdt) for b in bks]
        # the reduced gradient each update reads: the reduce-scatter's
        # output, or (replicated) the gradient buffer reduced in place;
        # compressed, the dense mean (fp32; dear: this rank's slice)
        self._dense = ([zeros(b.padded_size, torch.float32) for b in bks]
                       if self.compressor is not None else None)
        if self._dense is not None:
            self._reduced = [
                d[self.rank * b.shard_size:(self.rank + 1) * b.shard_size]
                if self.sharded else d for d, b in zip(self._dense, bks)]
        else:
            self._reduced = ([zeros(b.shard_size, cdt) for b in bks]
                             if self.sharded else self._gbuf)
        # the divisor of the update: the compressed means are means
        # already; under sequence parallelism the dp degree (`mean_axes`)
        #: the ranks the gradients are averaged over (the rest are summed)
        self.mean_world = self.world if mean_world is None else mean_world
        self._mean_world = (1 if self.compressor is not None
                            else self.mean_world)
        #: LAMB: per bucket its parameters' offsets (the segment starts)
        self._starts = ([torch.tensor(b.offsets, dtype=torch.int32,
                                      device=dev) for b in bks]
                        if self.layerwise else None)
        #: LAMB: per bucket its `_segment_pieces`, made on first use
        self._pieces: dict = {}
        self._acc = ([zeros(b.padded_size, torch.float32) for b in bks]
                     if accum_steps > 1 else None)
        self._slot = {}
        for b in bks:
            for leaf_id, off in zip(b.leaf_ids, b.offsets):
                self._slot[leaf_id] = (b.index, off, plan.leaves[leaf_id].size)
        self._rs_work: list = [[] for _ in bks]
        self._ag_work = [None] * len(bks)
        self._pending = [0] * len(bks)
        self._fired: set = set()
        self._last_mb = True
        self._comm = (torch.cuda.Stream(dev) if dev.type == "cuda" else None)
        self._bound = False
        self._hooks: list = []
        #: dear-fused: the one order every rank issues its reduce-scatters in
        self._rs_order = [b.index for b in reversed(bks)]
        self._rs_next = 0
        self._rs_ready: set = set()
        self._state: Optional[DearState] = None
        #: the state most recently returned by `init`, `step` or
        #: `load_state` (what a checkpoint restore overwrites in place)
        self.last_state: Optional[DearState] = None
        self._comm_dtype, self._multi = cdt, {}
        self._leg_bytes_cache: Optional[dict] = None
        tr = _telemetry.get_tracer()
        if tr.enabled:
            acct = self._accounting()
            tr.count("dear.plan_builds")
            tr.event("dear.plan_built", mode=mode, world=self.world,
                     buckets=plan.num_buckets,
                     total_elements=plan.total_size,
                     payload_bytes_per_step=acct.payload_bytes_per_step)

    # -- telemetry -----------------------------------------------------------

    def _accounting(self) -> CTR.CommAccounting:
        """The plan's static per-step communication accounting."""
        itemsize = self._comm_dtype.itemsize
        # hierarchical: the cross-slice host leg at the slice count the
        # step was built (or rebound) at, as the JAX package states it
        dcn = self.dcn
        return CTR.plan_comm_accounting(
            self.plan, mode=self.mode, comm_itemsize=itemsize,
            gather_itemsize=self._gather_dtype.itemsize,
            compressor=self.compressor.name if self.compressor else None,
            density=self.density,
            num_slices=dcn.num_slices if dcn is not None else 1,
            dcn_partition_mb=self.partition_mb if dcn is not None else None)

    def _leg_bytes(self) -> dict:
        if self._leg_bytes_cache is None:
            acct = self._accounting()
            self._leg_bytes_cache = {
                leg: acct.leg_bytes_per_step(leg)
                for leg in sorted({r.leg for r in acct.rows})}
        return self._leg_bytes_cache

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
        if self._snapshot is not None:
            self._comm.wait_event(self._snapshot)
        with torch.cuda.stream(self._comm):
            yield

    def _reduce(self, g: int) -> None:
        """Start bucket g's reduction, on the comm stream: its
        reduce-scatter (or, in a replicated mode, the mode's collective in
        place; without ``reducescatter``, the copy of this rank's slice)."""
        if self.fused:
            self._rs_ready.add(g)
            self._fused_reduce_scatters()
            return
        with self._on_comm():
            if self.compressor is not None:
                works = [self._compressed_reduce(g)]
            elif self._reduction is not None:
                works = self._reduction(self, self._gbuf[g])
            elif "reducescatter" in self._exclude:
                n = self.plan.buckets[g].shard_size
                self._reduced[g].copy_(
                    self._gbuf[g][self.rank * n:(self.rank + 1) * n])
                works = [C.StreamEvent.after_current(self.device)]
            else:
                _, work = C.reduce_scatter(
                    self._gbuf[g], self.group, async_op=True,
                    out=self._reduced[g])
                works = [work]
                self.rs_launches += 1
        self._rs_work[g] = works

    def _compressed_reduce(self, g: int):
        """Bucket g's compressed reduction (JAX dear.py:776-851), on the
        current stream: the velocity (momentum correction), the compression
        of the fp32 gradient plus this rank's residual, the payload's
        collective, the dense mean into ``_dense[g]``, the residual's
        re-add of gTop-k's rejected coordinates, and the velocity cleared
        where this rank sent. Returns the work handle of all of it."""
        b = self.plan.buckets[g]
        comp, n = self.compressor, b.padded_size
        entry = self._state.comp_state[g]
        mc = self.momentum_correction
        res, vel = (entry["res"], entry["vel"]) if mc else (entry, None)
        with torch.no_grad():
            gin = self._gbuf[g].float()
            if mc:
                vel.mul_(mc).add_(gin)
                gin = vel
            payload, new_res = comp.compress(gin, res, self.density)
            if comp.name in Z.SIGN:
                dense = Z.sign_majority_vote_allreduce(
                    payload, n, torch.float32, self.group)
                self.comp_launches += 1
            elif self.gtopk:
                dense, kept = Z.gtopk_sparse_allreduce(
                    payload, n, torch.float32, Z._k_of(n, self.density),
                    self.group)
                self.comp_launches += self.world.bit_length() - 1
                if torch.is_tensor(new_res):   # the rejected back in
                    sent = payload["indices"].long()
                    kept_mask = torch.zeros((n,), dtype=torch.bool,
                                            device=self.device)
                    kept_mask[kept.long()] = True
                    rejected = torch.where(
                        kept_mask[sent], torch.zeros_like(payload["values"]),
                        payload["values"])
                    new_res.index_add_(0, sent, rejected.to(new_res.dtype))
            elif comp.name in Z.QUANT:
                dense = Z.int8_allreduce(payload, n, torch.float32,
                                         self.group)
                self.comp_launches += 1
            else:
                dense = Z.sparse_allreduce(payload, n, torch.float32,
                                           self.group)
                self.comp_launches += 1
            self._dense[g].copy_(dense)
            if torch.is_tensor(new_res):
                res.copy_(new_res)
            if mc:
                vel[payload["indices"].long()] = 0.0
        return C.StreamEvent.after_current(self.device)

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
                    self.optimizer, self.ring, mean_world=self.mean_world,
                    step=state.step)
            self._rs_next += 1
            self.rs_launches += 1
            self.update_launches += 1

    def _gather(self, g: int, shard: torch.Tensor) -> None:
        if self.fsdp:
            self._alloc(g)
        with self._on_comm():   # the cast too: K5 ring updates the shard there
            src = (shard if self._send[g] is None
                   else self._send[g].copy_(shard))
            if "allgather" in self._exclude:   # zeros, this rank's slot
                full, n = self._full[g], shard.shape[0]
                full.zero_()[self.rank * n:(self.rank + 1) * n].copy_(src)
                self._ag_work[g] = C.StreamEvent.after_current(self.device)
                return
            if self.fused:   # the direct route, or an error on the card
                CM.ring_all_gather(src, self.ring, out=self._full[g],
                                   direct=True)
                self._ag_work[g] = C.StreamEvent.after_current(self.device)
            else:
                _, self._ag_work[g] = C.all_gather(
                    src, self.group, async_op=True, out=self._full[g])
        self.ag_launches += 1

    # -- fsdp: full buckets freed from the forward to the backward -----------

    def _storage(self, g: int):
        return self._full[g].untyped_storage()

    def _index_storages(self) -> None:
        self._bucket_of_storage = {
            self._storage(g).data_ptr(): g for g in range(len(self._full))
            if self._storage(g).nbytes()}

    def _alloc(self, g: int) -> None:
        if not self._storage(g).nbytes():
            self._storage(g).resize_(self._full_bytes[g])
            self._index_storages()

    def _free(self, g: int) -> None:
        if self._storage(g).nbytes():
            self._wait_gathers([g])
            self._storage(g).resize_(0)
            self._index_storages()

    def _free_all(self) -> None:
        if self.fsdp:
            for g in range(len(self._full)):
                self._free(g)

    def _bucket_of(self, t: torch.Tensor) -> Optional[int]:
        """The full bucket whose storage ``t`` views, if any."""
        if t.layout != torch.strided or t.device != self.device:
            return None
        return self._bucket_of_storage.get(t.untyped_storage().data_ptr())

    def _pack(self, t: torch.Tensor):
        """Save a view of a full bucket, or a (view of a) cast of a
        parameter or of a view of one (`_VIEW_NODES` between them), as a
        `_SavedView`; anything else as itself. A cast keeps its input's
        strides (``preserve_format`` on a dense input, and every such view
        of a contiguous parameter is dense), so the cast's own shape and
        strides at the parameter's offset in the bucket are its input."""
        g = self._bucket_of(t)
        if g is not None:
            return _SavedView(g, tuple(t.shape), tuple(t.stride()),
                              t.storage_offset())
        copy = t if t._base is None else t._base
        fn = copy.grad_fn
        if type(fn).__name__ != "ToCopyBackward0":
            return t
        node = fn.next_functions[0][0]
        while type(node).__name__ in _VIEW_NODES:
            node = node.next_functions[0][0]
        p = getattr(node, "variable", None)
        g = None if p is None else self._bucket_of(p)
        if (g is None or not p.is_contiguous()
                or copy.numel() != p.numel() or copy.storage_offset()):
            return t
        return _SavedView(g, tuple(copy.shape), tuple(copy.stride()),
                          p.storage_offset(),
                          (copy.dtype, tuple(t.shape), tuple(t.stride()),
                           t.storage_offset()))

    def _unpack(self, saved):
        """A `_SavedView`'s view (cast again, for a cast), its bucket
        gathered again if it was freed."""
        if not isinstance(saved, _SavedView):
            return saved
        g = saved.bucket
        if not self._storage(g).nbytes():
            self._gather(g, self._state.shards[g])
        self._wait_gathers([g])
        view = self._full[g].as_strided(saved.shape, saved.stride,
                                        saved.offset)
        if saved.cast is None:
            return view
        dtype, shape, stride, offset = saved.cast
        return view.to(dtype).as_strided(shape, stride, offset)

    def _saving(self):
        """The forward's saved-tensor hooks (fsdp; else nothing)."""
        if not self.fsdp:
            return contextlib.nullcontext()
        return torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                        self._unpack)

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
            if self._acc is None:
                self._gbuf[g][sl].copy_(grad)
            else:
                self._acc[g][sl].add_(grad)
                if self._last_mb:
                    self._gbuf[g][sl].copy_(
                        self._acc[g][sl] / self.accum_steps)
            self._fired.add(leaf_id)
            self._pending[g] -= 1
            if self._pending[g] == 0:   # the bucket's gradients are in
                if self.fsdp:
                    self._free(g)
                if self._last_mb:
                    self._reduce(g)

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
                self._hooks.append(p.register_post_accumulate_grad_hook(
                    self._grad_hook(leaf_id)))
                setattr(mod, pname, p)
                owned.append(self._slot[leaf_id][0])
            if owned:
                buckets = sorted(set(owned))
                self._hooks.append(mod.register_forward_pre_hook(
                    lambda m, args, gs=buckets: self._wait_gathers(gs)))
        if self._mstate:
            self._hooks.append(self.model.register_forward_pre_hook(
                lambda m, args: self._wait_model_state()))
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
                if not self.sharded:   # the full master: the model's buffer
                    shards.append(F.pack_bucket(leaves, self.plan, b.index,
                                                out=self._full[b.index]))
                    continue
                flat = F.pack_bucket(leaves, self.plan, b.index,
                                     dtype=torch.float32)
                lo = self.rank * b.shard_size
                shards.append(flat[lo:lo + b.shard_size].clone())
        opt = tuple(self.optimizer.init(s) for s in shards)
        if not self._bound:
            self._bind()
        if self.sharded:
            for g, shard in enumerate(shards):
                self._gather(g, shard)
        self.last_state = DearState(tuple(shards), opt, 0,
                                    self._init_comp_state())
        return self.last_state

    def _init_comp_state(self) -> tuple:
        """Per bucket this rank's compressor state: the residual over the
        padded bucket (``()`` when stateless) and, with momentum
        correction, the velocity: ``{"res", "vel"}``."""
        if self.compressor is None:
            return ()
        out = []
        for b in self.plan.buckets:
            res = self.compressor.init(b.padded_size, torch.float32,
                                       self.device)
            if self.momentum_correction:
                res = {"res": res, "vel": torch.zeros(
                    (b.padded_size,), dtype=torch.float32,
                    device=self.device)}
            out.append(res)
        return tuple(out)

    def _generator(self, step: int, microbatch: int) -> torch.Generator:
        # hierarchical: a globally unique index (JAX dear.py:614-620), so
        # the same position in two slices draws different masks; on a dp x
        # sp layout the group rank is dp index * sp + sp index, so every
        # (dp, sp) rank draws its own stream (JAX folds the same index)
        idx = (self.rank if self.dcn is None
               else self.dcn.local_slices[0] * self.world + self.rank)
        seed = np.random.SeedSequence(
            [self.rng_seed, step, idx, microbatch]).generate_state(
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
            self._reduce(b.index)

    def step(self, state: DearState, batch) -> tuple:
        """One training step: forward and backward per microbatch, the
        per-bucket reduce-scatters under the backward, the update and the
        gathers. Returns ``(next_state, metrics)``; ``metrics["loss"]`` is
        the mean over ranks (and microbatches), a device scalar. With the
        tracer on, the step's counters and its ``dear.step`` span (module
        docstring)."""
        tr = _telemetry.get_tracer()
        if not tr.enabled:
            return self._step(state, batch)
        tr.count("dear.steps")
        for leg, nbytes in self._leg_bytes().items():
            tr.count(f"dear.{leg}_bytes", nbytes)
        rings = (CM.ring_rs_launches, CM.ring_ag_launches)
        kernels = _kernel_launches()
        with tr.span("dear.step", mode=self.mode):
            out = self._step(state, batch)
        if self.fused:   # the wrappers' own launch counts
            tr.count("kernel.fused_rs_launches",
                     CM.ring_rs_launches - rings[0])
            tr.count("kernel.ring_ag_launches",
                     CM.ring_ag_launches - rings[1])
        for name, n in _kernel_launches().items():
            tr.count(f"kernel.{name}", n - kernels[name])
        return out

    def _step(self, state: DearState, batch) -> tuple:
        if not self._bound:
            raise RuntimeError("TrainStep.init() must run before step()")
        if self.group_lost and self.world > 1:
            raise RuntimeError(
                "this step's group was abandoned (a member was lost, or a "
                "rescale failed after releasing it): rebuild the step "
                "(tuning.autotune.AutoTuner.rescale) or exit for relaunch")
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
            if self.fsdp and i:   # the last backward freed every bucket
                for g, shard in enumerate(state.shards):
                    self._gather(g, shard)
            args = (self.model, mb)
            if self.rng_seed is not None:
                args += (self._generator(state.step, i),)
            calls = dict(CM.ring_matmul_calls,
                         again=CM.ring_matmul_recomputes)
            with CM.bind_ring(self.ring):
                with self._saving():
                    out = self._loss(args)
                loss, aux = out if self.has_aux else (out, None)
                self._free_all()
                loss.backward()
            self._free_all()   # buckets no saved tensor brought back
            self._count_ring_matmuls(calls)
            losses.append(loss.detach().float())
            if aux is not None:
                auxs.append(torch.as_tensor(aux).detach().float())
        self._finish_buckets()
        self._sync_model_state()
        metrics: dict = {}
        loss = torch.stack(losses).mean()
        if self.dcn is not None:
            self._dcn_update_and_gather(state, metrics, loss)
        elif self.fused:
            self._fused_gathers(state)
        else:
            self._update_and_gather(state, metrics)
        self._snapshot = None   # both streams have waited for it
        if self.sdc_fp:
            metrics["sdc_fp"] = self._fingerprint(state)
        if self.dcn is None:
            metrics["loss"] = self._mean_over_ranks(loss)
        if auxs:
            metrics["aux"] = self._mean_over_ranks(torch.stack(auxs).mean(0))
        self.last_state = DearState(state.shards, state.opt_state,
                                    state.step + 1, state.comp_state)
        return self.last_state, metrics

    def _fingerprint(self, state: DearState) -> torch.Tensor:
        """``metrics["sdc_fp"]`` (JAX dear.py:964-980): per bucket the
        uint32 wraparound sum of the post-update fp32 masters' words, as an
        int64 tensor on the device: the int32 view summed in int64 is
        congruent to the unsigned sum mod 2^32; in the sharded modes one
        all-reduce adds the ranks' sums. Exact and order-independent, so
        replica-identical masters give identical fingerprints. Nothing is
        fetched: the guard reads it at its check cadence."""
        fps = torch.stack([torch.sum(s.view(torch.int32), dtype=torch.int64)
                           for s in state.shards])
        if self.sharded and self.world > 1:
            fps = C.all_reduce(fps, self.group)
        return fps & 0xFFFFFFFF

    def _loss(self, args):
        """``loss_fn(*args)``; under ``remat="full"`` computed once keeping
        nothing, then recomputed on this thread with the dropout generator
        replayed and the model's buffers kept (module docstring)."""
        if self.remat != "full":
            return self.loss_fn(*args)
        gens = [a for a in args[2:] if isinstance(a, torch.Generator)]
        return R.recompute_whole(self.loss_fn, *args, generators=gens,
                                 buffers=list(self.model.buffers()))

    def _count_ring_matmuls(self, before: dict) -> None:
        """Every ring projection's forward call (K6) that no recompute made
        must have had its two backward calls (K7, K8): the ranks' ring
        calls pair up."""
        now = dict(CM.ring_matmul_calls, again=CM.ring_matmul_recomputes)
        got = {k: now[k] - v for k, v in before.items()}
        if not got["fwd"] - got["again"] == got["dx"] == got["dw"]:
            raise RuntimeError(f"ring-matmul calls of one microbatch do not "
                               f"pair up (again: the recomputed forward "
                               f"calls): {got}")
        self.cm_calls += got["fwd"] + got["dx"] + got["dw"]

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
        """Wait for each bucket's reduction, clip, update each shard (or
        full bucket), and start each shard's gather."""
        self.wait_snapshot()
        for g, works in enumerate(self._rs_work):
            for work in works:
                if work is not None:
                    work.wait()
            self._rs_work[g] = []
        clip_scale = None
        if self.clip_norm is not None:
            mw = torch.tensor(float(self.mean_world), device=self.device)
            sumsq = sum((r.float() / mw).square().sum() for r in self._reduced)
            if self.sharded and self.world > 1:   # replicated: already global
                sumsq = C.all_reduce(sumsq, self.group)
            gnorm = sumsq.sqrt()
            clip_scale = torch.clamp(
                self.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
            metrics["grad_norm"] = gnorm
        with torch.no_grad():
            for g, shard in enumerate(state.shards):
                layer, kw = (), {}
                if self.layerwise:
                    layer = self._segments(g)
                    kw = {"seg_pieces": self._segment_pieces(g)}
                self.optimizer.update(
                    self._reduced[g], state.opt_state[g], shard, *layer,
                    mean_world=self._mean_world, clip_scale=clip_scale,
                    step=state.step, **kw)
                self.update_launches += 1
                if self.sharded:
                    self._gather(g, shard)

    def _dcn_update_and_gather(self, state: DearState, metrics: dict,
                               loss: torch.Tensor) -> None:
        """The hierarchical step after backward (module docstring; JAX
        dear.py:1228-1276): the slice's reduced buckets and mean loss to
        the host, the cross-slice exchange, the slice's agreement on its
        outcome, then the update from this rank's shard of each mean and
        the gathers."""
        dcn, step_no = self.dcn, int(state.step)
        # bounded-stale mode: pull peers' partials while this rank gathers
        dcn.prefetch(step_no)
        self.wait_snapshot()
        t0 = time.perf_counter()
        for g, works in enumerate(self._rs_work):
            for work in works:
                if work is not None:
                    work.wait()
            self._rs_work[g] = []
        tw = time.perf_counter()
        with torch.no_grad():
            fulls = [C.all_gather(r, self.group) for r in self._reduced]
            self.ag_launches += len(fulls)
            slice_loss = self._mean_over_ranks(loss.float())
            t1 = time.perf_counter()
            # the JAX package's intra-slice mean (fp32, then / world);
            # the host copies are the leg's payload, a sync by design
            host = [(f.float() / self.world).cpu().numpy() for f in fulls]
            sid = dcn.local_slices[0]
            scalar = float(slice_loss.cpu())
        t2 = time.perf_counter()
        err = None
        try:
            means, loss_mean = dcn.exchange(
                step_no, {sid: host}, {sid: scalar},
                partition_mb=self.partition_mb)
        except Exception as exc:   # agreed below, then raised
            err = exc
        self._agree_on_exchange(err)
        t3 = time.perf_counter()
        with torch.no_grad():
            grads = []
            for g, b in enumerate(self.plan.buckets):
                lo = self.rank * b.shard_size
                grads.append(torch.from_numpy(
                    means[g][lo:lo + b.shard_size]).to(self.device))
            metrics["loss"] = torch.tensor(loss_mean, dtype=torch.float32,
                                           device=self.device)
            t4 = time.perf_counter()
            for g, shard in enumerate(state.shards):
                self.optimizer.update(grads[g], state.opt_state[g], shard,
                                      mean_world=1, step=state.step)
                self.update_launches += 1
                self._gather(g, shard)
        self.dcn_bytes = sum(h.nbytes for h in host)
        self.dcn_times = {"rs_wait_s": tw - t0, "gather_s": t1 - tw,
                          "to_host_s": t2 - t1,
                          "exchange_s": t3 - t2, "to_device_s": t4 - t3}

    def _agree_on_exchange(self, err: Optional[BaseException]) -> None:
        """ONE collective on the slice group over the exchange's outcome:
        when any rank of the slice failed, every rank raises one exception
        of one class before any of them updates: the lowest failing rank's
        when it is a `comm.dcn.DcnError` (its class and message), else a
        `DcnError` wrapping it (a transport's `OSError`, a `RetryError`),
        on that rank too, so the guard takes one branch on the whole
        slice. Only the wrapping at world 1."""
        mine = None if err is None else (type(err).__name__, str(err))
        outs = [mine]
        if self.world > 1:
            outs = [None] * self.world
            dist.all_gather_object(outs, mine, group=self.group)
        first = next((o for o in outs if o is not None), None)
        if first is None:
            return
        cls = getattr(DCN, first[0], None)
        if mine == first and isinstance(err, DCN.DcnError):
            raise err
        if not (isinstance(cls, type) and issubclass(cls, DCN.DcnError)):
            cls = DCN.DcnError
            msg = f"{first[0]}: {first[1]}"
        else:
            msg = first[1]
        if mine != first:
            msg += (" (a peer rank's exchange failed; this slice stops "
                    "before its update)")
        raise cls(msg) from err

    def _segment_ids(self, g: int, lo: int, hi: int) -> torch.Tensor:
        """int32 ids of bucket g's elements ``[lo, hi)``: each element's
        bucket-local parameter (searchsorted over the parameters' starts),
        padding the dummy last segment — `FusionPlan.segment_ids`'s slice.
        Made on every step rather than kept: kept, they would hold 4 bytes
        per element of the shard on the card."""
        b = self.plan.buckets[g]
        pos = torch.arange(lo, hi, dtype=torch.int32, device=self.device)
        seg = torch.searchsorted(self._starts[g], pos, right=True,
                                 out_int32=True) - 1
        return torch.where(pos < b.size, seg, len(b.leaf_ids))

    def _span(self, g: int) -> tuple:
        """This rank's buffer of bucket g, ``(lo, hi)`` in the bucket."""
        b = self.plan.buckets[g]
        return ((self.rank * b.shard_size, (self.rank + 1) * b.shard_size)
                if self.sharded else (0, b.padded_size))

    def _segment_lengths(self, g: int) -> list:
        """Per segment of bucket g (its parameters, then the padding) the
        number of this rank's elements in it, from the plan on the host
        (`_segment_pieces`)."""
        b = self.plan.buckets[g]
        lo, hi = self._span(g)
        spans = [(off, off + self.plan.leaves[i].size)
                 for i, off in zip(b.leaf_ids, b.offsets)]
        spans.append((b.size, b.padded_size))
        return [max(0, min(e, hi) - max(s, lo)) for s, e in spans]

    def _segment_pieces(self, g: int) -> tuple:
        """`ops.fused_sgd.segment_pieces` of bucket g's `_segment_lengths`
        for LAMB's two sums of squares, on the card, made on the first
        step and kept (the plan, the rank and the bucketing stay fixed for
        the step's life, `rebind` included): two small int64 tensors a
        bucket."""
        if g not in self._pieces:
            self._pieces[g] = segment_pieces(self._segment_lengths(g),
                                             self.device, rows=2)
        return self._pieces[g]

    def _segments(self, g: int) -> tuple:
        """A `LayerwiseShardOptimizer`'s ``(seg_ids, num_segments, psum)``
        for bucket g (JAX dear.py:912-958): the segment ids of this rank's
        buffer (`_segment_ids`); ``psum`` an all-reduce over the group in
        the sharded modes at world > 1, else the identity."""
        b = self.plan.buckets[g]
        seg = self._segment_ids(g, *self._span(g))
        if not (self.sharded and self.world > 1):
            return seg, len(b.leaf_ids) + 1, lambda x: x

        def psum(x):
            self.ar_launches += 1
            return C.all_reduce(x, self.group)

        return seg, len(b.leaf_ids) + 1, psum

    def _sync_model_state(self) -> None:
        """After the last microbatch's backward: the mean over the ranks of
        every floating buffer of the model state and the max of every
        integer or bool one, through ONE all-gather of the buffers packed
        as 32-bit words, on the comm stream (the reduction and the copies
        back too); the next forward waits for it."""
        if self.world == 1 or not self._mstate:
            return
        fl = [t for t in self._mstate if t.is_floating_point()]
        ints = [t for t in self._mstate if not t.is_floating_point()]
        nf = sum(t.numel() for t in fl)
        with torch.no_grad(), self._on_comm():   # after the forwards
            parts = ([torch.cat([t.reshape(-1).float() for t in fl])
                      .view(torch.int32)] if fl else []) + \
                ([torch.cat([t.reshape(-1).long() for t in ints])
                  .view(torch.int32)] if ints else [])
            rows = C.all_gather(torch.cat(parts), self.group).view(
                self.world, -1)
            new = []
            if fl:
                mean = rows[:, :nf].contiguous().view(torch.float32).sum(0) \
                    / self.world
                new += mean.split([t.numel() for t in fl])
            if ints:
                top = rows[:, nf:].contiguous().view(torch.int64).amax(0)
                new += top.split([t.numel() for t in ints])
            bufs = fl + ints
            torch._foreach_copy_(bufs, [n.view(t.shape)
                                        for n, t in zip(new, bufs)])
            self._mstate_done = C.StreamEvent.after_current(self.device)
        self.state_syncs += 1

    def _wait_model_state(self) -> None:
        if self._mstate_done is not None:
            self._mstate_done.wait()   # the current stream waits
            self._mstate_done = None

    def _mean_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        if self.world == 1:
            return x
        return C.all_reduce(x, self.group) / self.world

    def gather_params(self, state: DearState) -> dict:
        """``{name: fp32 tensor}``: the full master parameters, gathered
        from every rank's shards (for eval and checkpoints; in dear-fused
        mode through the ring all-gather, K4). The model state's last sync
        is done too."""
        self._wait_model_state()
        if not self.sharded:
            return F.unpack_all([s.clone() for s in state.shards], self.plan)
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

    # -- checkpoints: snapshots and in-place restores -------------------------

    def hold_for_snapshot(self, event) -> None:
        """An asynchronous checkpoint copies the masters, the optimizer and
        the compressor state on a side stream behind ``event`` (a CUDA
        event recorded when the copy is done): the next step's first
        in-place write of any of them — the update, the K5 ring, the
        compressed reduction — waits for it on its stream (an event wait,
        not a host sync). JAX's arrays are immutable and never had this
        hazard; this step updates its tensors in place."""
        self._snapshot = event

    def wait_snapshot(self) -> None:
        """Make the current stream wait for an in-flight snapshot copy
        (`hold_for_snapshot`), if any."""
        if self._snapshot is not None:
            torch.cuda.current_stream(self.device).wait_event(self._snapshot)

    def abandon(self) -> None:
        """Mark the step's group as lost — a member died, so no collective
        of it may be issued or waited on again (an elastic membership
        change, `tuning.autotune.AutoTuner.rescale`): `quiesce` and
        `close` then drop the work the step left in flight unwaited, and
        at world > 1 the step refuses to run."""
        self.group_lost = True

    def _drop_in_flight(self) -> None:
        """Forget every collective handle of the step without waiting."""
        self._rs_work = [[] for _ in self.plan.buckets]
        self._ag_work = [None] * len(self.plan.buckets)
        self._mstate_done = None

    def quiesce(self) -> None:
        """Wait for, or drop, whatever a step left in flight — an aborted
        step's reduce-scatters, its pending-gradient counts and fired
        hooks, the gathers and their events, the model state's sync and a
        checkpoint snapshot's copy — so the tensors can be overwritten.
        The parameters' leftover gradients are dropped too. After
        `abandon`, the collectives are dropped unwaited."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # the snapshot copy too
        self._snapshot = None
        if self.group_lost:
            self._drop_in_flight()
        for g, works in enumerate(self._rs_work):
            for work in works:
                if work is not None:
                    work.wait()
            self._rs_work[g] = []
        self._pending = [len(b.leaf_ids) for b in self.plan.buckets]
        self._fired = set()
        self._rs_next, self._rs_ready = 0, set()
        self._wait_gathers(range(len(self._ag_work)))
        self._wait_model_state()
        for p in self.model.parameters():
            p.grad = None

    def load_state(self, state: DearState, *, shards, opt_state,
                   comp_state=(), buffers=None, step: int) -> DearState:
        """Restore a checkpoint into this step, in place: `quiesce`, then
        copy ``shards`` (per bucket this rank's fp32 master, in this
        step's plan) into ``state.shards`` (in the replicated modes the
        masters ARE the model's buffers), ``opt_state`` (per bucket a dict:
        the tensors copied, the host scalars set) into
        ``state.opt_state``, ``comp_state`` (per bucket a tensor, a
        ``{"res", "vel"}`` dict or ``()``) into ``state.comp_state``, and
        ``buffers`` (``{name: tensor}``) into the model's buffers; then
        issue the gathers as `init` does, so the next forward sees the
        restored parameters. Returns the state at ``step``."""
        self.quiesce()
        with torch.no_grad():
            for dst, src in zip(state.shards, shards):
                dst.copy_(src)
            for dst, src in zip(state.opt_state, opt_state):
                for k, v in src.items():
                    if torch.is_tensor(dst.get(k)):
                        dst[k].copy_(v)
                    else:
                        dst[k] = v
            for dst, src in zip(state.comp_state, comp_state):
                if torch.is_tensor(dst):
                    dst.copy_(src)
                elif isinstance(dst, dict):
                    for k in dst:
                        dst[k].copy_(src[k])
            if buffers:
                live = dict(self.model.named_buffers())
                for n, b in buffers.items():
                    live[n].copy_(b)
            if self.sharded:
                for g, shard in enumerate(state.shards):
                    self._gather(g, shard)
        self.last_state = DearState(state.shards, state.opt_state,
                                    int(step), state.comp_state)
        return self.last_state

    def close(self) -> None:
        """Release the model once every rank is done with the step (every
        rank calls it): remove the step's hooks from the model (a
        parameter's gradient hook is held from C++, so the cycle it closes
        between the model and the step is never collected; the model and
        the step's buffers are freed once the caller drops them), and in
        dear-fused free the ring's buffers. The gather buffers die with the
        ring, so the model's parameters get memory of their own first.
        The last step's gathers are waited for first: they write the
        updated parameters into the model. After `abandon`, nothing of the
        group is waited on (the ring's closing barrier included)."""
        if self.group_lost:
            self._drop_in_flight()
        self._wait_gathers(range(len(self._ag_work)))
        for hook in self._hooks:
            hook.remove()
        self._hooks = []
        if self.ring is None:
            return
        if self.group_lost:
            self._full = []
            self.ring = None
            return
        if (self._bound and not self.ring.closed
                and self.device.type == "cuda" and self.world > 1):
            with torch.no_grad():
                for p in self.model.parameters():
                    p.data = p.data.clone()
        self._full = []
        self.ring.close()

    def rebind(self, group, plan: F.FusionPlan) -> None:
        """Move the step to ``group`` (the next membership epoch's slice
        group, of the same size, at the same rank) and ``plan`` (the same
        bucketing, the epoch restamped): `tuning.autotune.AutoTuner.
        rescale` of a hierarchical step, whose slice's process group
        `comm.backend.regroup` released. Nothing is rebuilt: the masters,
        the optimizer state, the full buffers and the model's binding stay
        as they are; what the old group had in flight is dropped unwaited
        (the caller waited for it while that group lived)."""
        if (dist.get_world_size(group) != self.world
                or dist.get_rank(group) != self.rank):
            raise ValueError(
                f"rebind to a group of {dist.get_world_size(group)} ranks "
                f"(rank {dist.get_rank(group)}); the step's slice has "
                f"{self.world} (rank {self.rank}): its shards stay in place")
        if [b.leaf_ids for b in plan.buckets] != \
                [b.leaf_ids for b in self.plan.buckets] \
                or plan.world != self.plan.world:
            raise ValueError("rebind keeps the bucketing and the world; "
                             "rebuild the step for another plan")
        self._drop_in_flight()
        self.group, self.plan = group, plan
        self.group_lost = False
        self._leg_bytes_cache = None

    def multi_step(self, n: int) -> Callable:
        """``fn(state, batch) -> (state, metrics)`` running ``n`` steps on
        the one batch and returning the final state and the LAST step's
        metrics (the benchmark protocol; JAX dear.py:1320-1358); cached per
        ``n``, and ``dear.multi_step_compiles`` counted when it is first
        built. The steps are n eager `step` calls (module docstring)."""
        if self.dcn is not None:
            raise ValueError(
                "multi_step is unavailable on the hierarchical (dcn=) "
                "schedule: the cross-slice exchange is a host-level leg "
                "and cannot ride inside a compiled lax.scan")
        n = int(n)
        if n < 1:
            raise ValueError(f"multi_step needs n >= 1, got {n}")
        cached = self._multi.get(n)
        if cached is not None:
            return cached
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.count("dear.multi_step_compiles")
            tr.event("dear.multi_step_compile", mode=self.mode, n=n)

        def fn(state: DearState, batch) -> tuple:
            metrics = None
            for _ in range(n):
                state, metrics = self.step(state, batch)
            return state, metrics

        self._multi[n] = fn
        return fn
