"""Live re-bucketing: drive a training loop while a tuner changes the fusion
plan under it — the port of ``dear_pytorch_tpu/tuning/autotune.py``.

Reference flow (dear/dopt_rsag_bo.py): every tuner interval the BO tuner
proposes a new threshold; rank 0's choice is broadcast for consistency
(dopt_rsag_bo.py:153, via mpi4py), fusion buffers are freed and regenerated
(:163-171), and training continues — momentum state survives because torch
keeps it per parameter.

Here a plan change means a new `parallel.dear.TrainStep` over the same
model. `AutoTuner` builds it for the proposed plan and *repacks* the
carried state (`repack_state`): the fp32 masters, every per-element
optimizer-state tensor and the compressor's residual and velocity are
taken to parameter granularity under the old plan, by name, and packed
under the new one, so training continues exactly where it was (SGD
momentum, AdamW's and LAMB's moments and step counts, the error-feedback
residual per rank). The model's buffers (BatchNorm's running statistics)
live in the model and are not touched; the step count carries.

Rank consistency. The JAX package's single controller gets it for free;
here every rank times its own steps, so their tuners would propose
different plans and the ranks would deadlock on mismatched buckets. As the
reference does, rank 0 decides: while a tuner is searching, every step
broadcasts rank 0's proposal (and its current point) over the step's
group, and every rank adopts it — BO thresholds, wait-time flags and plan
configurations alike. Whether the new step built is agreed over the group
too, so a plan that fails to build on any rank is refused on all, with
the old step still live. Once the repack has begun there is no way back
(it closes the old step and rebinds the model): a failure there raises,
on every rank that gets past the repack's last collective.

A rebuild in eager PyTorch: the old step owns the model (its parameters
are views into the step's full buckets, its gradient hooks are held from
C++). `repack_state` gathers the old step's state by name, closes the old
step (which waits for its last gathers and removes its hooks), then
initializes the new step over the same model — which rebinds the
parameters into the new plan's buckets — and installs the repacked state.
Nothing of the old step stays referenced, so device memory does not grow
with the number of rebuilds.

Compilation cost accounting matches the reference's protocol: the first
measurement window after each rebuild is discarded as warmup
(tuner.py:62-64 via `Tuner.notify_rebuild`).
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import collectives as C
from dear_pytorch_tpu_torch.observability import tracer as _telemetry
from dear_pytorch_tpu_torch.ops import fusion as F
from dear_pytorch_tpu_torch.ops.fused_sgd import TorchOptimShard
from dear_pytorch_tpu_torch.parallel import dear as D
from dear_pytorch_tpu_torch.tuning.bo import Tuner
from dear_pytorch_tpu_torch.tuning.wait_time import (
    estimate_layer_backward_times,
    wait_time_flags,
)

__all__ = ["AutoTuner", "export_state", "install_state", "repack_state"]

logger = logging.getLogger("dear_pytorch_tpu_torch")


# ---------------------------------------------------------------------------
# the state by parameter name, and back
# ---------------------------------------------------------------------------


def _full(ts: D.TrainStep, x: torch.Tensor) -> torch.Tensor:
    """Bucket-length ``x`` of this rank: a sharded step's shard gathered
    over the group (every rank calls it, in the same order); a replicated
    step's buffer as it is."""
    if ts.sharded and ts.world > 1:
        return C.all_gather(x, ts.group)
    return x


def _by_name(ts: D.TrainStep, bufs) -> dict:
    """``{parameter name: fp32 copy}`` from per-bucket bucket-length
    buffers of ``ts``'s plan (no cast to the parameters' dtype)."""
    return {name: t.detach().float().clone()
            for name, t in F.unpack_all(list(bufs), ts.plan,
                                        cast=False).items()}


def _elementwise_keys(optimizer) -> tuple:
    """The keys of an optimizer's per-element state tensors: those its
    ``init`` makes as tensors (SGD's ``buf``, AdamW's ``exp_avg`` and
    ``exp_avg_sq``, LAMB's ``m`` and ``v``); its other entries are host
    scalars (``initialized``, ``t``)."""
    if isinstance(optimizer, TorchOptimShard):
        raise NotImplementedError(
            "repack_state: a from_torch_optim optimizer keeps its state in "
            "a torch.optim object bound to the shard, which cannot be "
            "repacked across plans; use fused_sgd / fused_adamw / "
            "fused_lamb with the autotuner")
    init = optimizer.init(torch.zeros((0,)))
    return tuple(k for k, v in init.items() if torch.is_tensor(v))


def _comp_entries(entry) -> dict:
    """One bucket's compressor state as ``{key: residual-like tensor}``:
    ``{"res"}`` for a residual, ``{"res", "vel"}`` with momentum
    correction, ``{}`` when stateless."""
    if torch.is_tensor(entry):
        return {"res": entry}
    if isinstance(entry, dict):
        return dict(entry)
    return {}


def export_state(state: D.DearState, ts: D.TrainStep) -> dict:
    """``state`` of ``ts`` by parameter name, in copies that outlive the
    step: ``params`` (the fp32 masters), ``opt`` (per-element optimizer
    state, ``{key: {name: tensor}}``), ``opt_scalars`` (the host scalars,
    from bucket 0: they are the same in every bucket), ``comp`` (this
    rank's compressor state, ``{key: {name: tensor}}``, ``{}`` when
    stateless), ``step`` and
    ``buffers`` (copies of the model's buffers). Every rank of the group
    must call it (a sharded step's shards are gathered)."""
    ts._wait_model_state()
    keys = _elementwise_keys(ts.optimizer)
    with torch.no_grad():
        params = _by_name(ts, [_full(ts, s) for s in state.shards])
        opt = {k: _by_name(ts, [_full(ts, o[k]) for o in state.opt_state])
               for k in keys}
        scalars = ({k: v for k, v in state.opt_state[0].items()
                    if not torch.is_tensor(v)} if state.opt_state else {})
        entries = [_comp_entries(e) for e in state.comp_state]
        comp = ({k: _by_name(ts, [e[k] for e in entries])
                 for k in entries[0]} if entries else {})
        buffers = {n: b.detach().clone()
                   for n, b in ts.model.named_buffers()}
    return {"params": params, "opt": opt, "opt_scalars": scalars,
            "comp": comp, "step": int(state.step), "buffers": buffers}


def _this_rank(ts: D.TrainStep, full: torch.Tensor, g: int) -> torch.Tensor:
    if not ts.sharded:
        return full
    n = ts.plan.buckets[g].shard_size
    return full[ts.rank * n:(ts.rank + 1) * n]


def install_state(fresh: D.DearState, ts: D.TrainStep, saved: dict,
                  *, log: Callable[[str], None] = lambda s: None
                  ) -> D.DearState:
    """Write an `export_state` image into ``fresh`` (``ts.init``'s state,
    whose masters already hold ``saved["params"]``): the per-element
    optimizer state packed by ``ts``'s plan (this rank's shard), the host
    scalars into every bucket, the compressor state (fresh zeros when
    either side has none; reset with a log line when both have one but
    its structure changed: momentum correction appearing or going), and
    the step count."""
    plan = ts.plan
    keys = _elementwise_keys(ts.optimizer)
    if set(keys) != set(saved["opt"]):
        raise ValueError(
            f"optimizer state changed across plans: {sorted(saved['opt'])} "
            f"vs {sorted(keys)} — was the step rebuilt with a different "
            "optimizer?")
    dev = ts.device
    with torch.no_grad():
        for g, entry in enumerate(fresh.opt_state):
            for k in keys:
                full = F.pack_bucket({n: t.to(dev) for n, t in
                                      saved["opt"][k].items()}, plan, g,
                                     dtype=torch.float32)
                entry[k].copy_(_this_rank(ts, full, g))
            for k, v in saved["opt_scalars"].items():
                if k in entry:
                    entry[k] = v
        entries = [_comp_entries(e) for e in fresh.comp_state]
        keys = set(entries[0]) if entries else set()
        if keys and keys == set(saved["comp"]):
            for g, e in enumerate(entries):
                for k, t in e.items():
                    t.copy_(F.pack_bucket(
                        {n: x.to(dev) for n, x in saved["comp"][k].items()},
                        plan, g, dtype=t.dtype))
        elif keys and saved["comp"]:
            log("autotune: compressor state structure changed across "
                "plans; error-feedback residuals reset")
    return D.DearState(fresh.shards, fresh.opt_state, saved["step"],
                       fresh.comp_state)


def restore_buffers(model: torch.nn.Module, buffers: dict) -> None:
    """Copy saved buffers back into ``model`` (a reverted trial)."""
    with torch.no_grad():
        for n, b in model.named_buffers():
            b.copy_(buffers[n])


def repack_state(state: D.DearState, old_ts: D.TrainStep,
                 new_ts: D.TrainStep, *,
                 log: Callable[[str], None] = lambda s: None
                 ) -> D.DearState:
    """Carry a `DearState` across a plan change (JAX autotune.py:222): the
    fp32 masters by name, the per-element optimizer state, the host
    scalars (SGD's ``initialized``, AdamW's and LAMB's ``t``), this rank's
    compressor residual and velocity, and the step count. ``old_ts`` is
    CLOSED here (its last gathers waited for, its hooks removed) and
    ``new_ts`` initialized over the same model, which it then owns; the
    model's buffers stay as they are. Every rank must call it."""
    return _adopt(old_ts, new_ts, export_state(state, old_ts), log)


def _adopt(old_ts: D.TrainStep, new_ts: D.TrainStep, saved: dict,
           log: Callable[[str], None]) -> D.DearState:
    """Close ``old_ts``, initialize ``new_ts`` over the same model from
    ``saved``'s masters and install the rest of ``saved`` into it."""
    old_ts.close()
    fresh = new_ts.init(saved["params"])
    return install_state(fresh, new_ts, saved, log=log)


def _share_carried(saved: Optional[dict], group) -> Optional[dict]:
    """An `export_state` image carried across a rescale, on every member
    of the new ``group``: the lowest-ranked member that holds one (an old
    member) broadcasts it over the host group to those that hold none (a
    joiner). None when no member carries state. Every member calls it."""
    world = dist.get_world_size(group)
    if world == 1:
        return saved
    hg = backend.host_group()
    flags = [None] * world
    dist.all_gather_object(flags, saved is not None, group=hg)
    if not any(flags):
        return None
    src = flags.index(True)
    mine = None
    if dist.get_rank(group) == src:
        mine = {k: ({n: t.cpu() for n, t in v.items()} if k == "params"
                    else v) for k, v in saved.items()}
        mine["opt"] = {k: {n: t.cpu() for n, t in named.items()}
                       for k, named in saved["opt"].items()}
        mine["comp"] = {k: {n: t.cpu() for n, t in named.items()}
                        for k, named in saved["comp"].items()}
        mine["buffers"] = {n: t.cpu() for n, t in saved["buffers"].items()}
    obj = [mine]
    dist.broadcast_object_list(obj, src=dist.get_global_rank(hg, src),
                               group=hg)
    return saved if saved is not None else obj[0]


def _plan_key(plan: F.FusionPlan) -> tuple:
    """What makes two plans the same bucketing."""
    return (plan.world, plan.epoch,
            tuple(b.leaf_ids for b in plan.buckets))


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------


class AutoTuner:
    """A training loop with runtime plan tuning (JAX autotune.py:302).

    strategy='bo': Bayesian optimization over the MB threshold
      (reference dopt_rsag_bo.py; bound (1, 256) MB, 10 trials).
    strategy='wait_time': start with one all-layers bucket
      (nearby_layers=-1, dopt_rsag_wt.py) and after ``warmup_steps``
      switch to flags derived from per-layer backward times.
    strategy='plan': the plan-space search (`tuning.planspace.PlanTuner`)
      over fusion threshold x compressor x comm/gather wire dtype x mode
      (dear / dear-fused) x remat, with the α-β cost model pruning
      dominated configurations once a fit is known. Trial sandboxing is
      snapshot-based: while a trial is live, an `export_state` image of
      the pre-trial state (a device copy of masters, optimizer and
      compressor state, and the model's buffers) and the pre-trial
      configuration are held, so a diverging trial reverts plan AND
      parameters; the snapshot is dropped once the tuner finishes.

    ``model``: the ``nn.Module`` to train (the JAX package's
    ``params_template``); ``build_kwargs`` go to
    `parallel.dear.build_train_step` (``optimizer``, ``group``,
    ``device``, ``mode``, dtypes, ...). ``alpha_beta``: (α, β) for the
    cost model; when None it is measured once at construction
    (`observability.overlap.fit_interconnect`) if ``DEAR_TUNE_FIT=1``,
    else analytic pruning is off. ``space`` defaults to
    `planspace.PlanSpace.from_env()`. ``trial_log`` is not ported
    (`planspace.PlanTuner` raises naming ROADMAP item 12).
    """

    def __init__(
        self,
        loss_fn: Callable,
        model: torch.nn.Module,
        *,
        strategy: str = "bo",
        threshold_mb: float = 25.0,
        bound: tuple = (1.0, 256.0),
        max_trials: int = 10,
        interval: int = 5,
        cycle_time_s: float = 5e-3,
        warmup_steps: int = 5,
        layer_times: Optional[Sequence[float]] = None,
        log: Callable[[str], None] = lambda s: None,
        clock=None,
        tuner_seed: int = 0,
        space=None,
        alpha_beta: Optional[tuple] = None,
        trial_log: Optional[str] = None,
        **build_kwargs: Any,
    ):
        if strategy not in ("bo", "wait_time", "plan"):
            raise ValueError(
                f"unknown strategy {strategy!r}: valid strategies are "
                "'bo' (Bayesian optimization over the fusion threshold), "
                "'wait_time' (layer-timing split flags) and 'plan' "
                "(unified plan-space search over fusion x compression x "
                "wire dtypes x mode x remat)"
            )
        for k in ("plan", "flags", "nearby_layers"):
            if build_kwargs.get(k) is not None:
                raise ValueError(f"the autotuner owns the fusion plan; "
                                 f"{k}= is not accepted")
            build_kwargs.pop(k, None)
        self.strategy = strategy
        self._loss_fn = loss_fn
        self.model = model
        self._build_kwargs = dict(build_kwargs)
        self._build_kwargs.pop("threshold_mb", None)
        self._log = log
        self.rebuilds = 0
        self.planner = None
        self._host_step = 0
        self._specs = F.leaf_specs(model)
        _elementwise_keys(self._build_kwargs.get("optimizer")
                          or D.fused_sgd(lr=0.01))   # repackable state

        if strategy == "plan":
            import os as _os

            from dear_pytorch_tpu_torch.tuning import planspace as PS

            # the searched axes come OUT of the static build kwargs and
            # into the starting PlanConfig — the tuner owns them now
            base_mode = self._build_kwargs.pop("mode", "dear")
            if base_mode not in ("dear", "dear-fused"):
                raise ValueError(
                    "strategy='plan' searches the dear/dear-fused "
                    f"schedule family; start from one of those, not "
                    f"mode={base_mode!r}")
            if space is not None:
                self.space = space
            else:
                ov = ({"threshold_bound": tuple(bound)}
                      if tuple(bound) != (1.0, 256.0) else {})
                self.space = PS.PlanSpace.from_env(**ov)
            base_comp = self._build_kwargs.pop("compressor", None)
            base_density = self._build_kwargs.pop("density", 1.0)
            base = PS.PlanConfig(
                threshold_mb=float(threshold_mb or 25.0),
                mode=base_mode,
                compressor=base_comp,
                density=(float(base_density) if base_comp
                         else self.space.density),
                comm_dtype=PS.dtype_token(
                    self._build_kwargs.pop("comm_dtype", None)),
                gather_dtype=PS.dtype_token(
                    self._build_kwargs.pop("gather_dtype", None)),
                remat=self._build_kwargs.pop("remat", None),
            )
            kw = {} if clock is None else {"clock": clock}
            self.planner = PS.PlanTuner(
                self.space, x=base, max_trials=max_trials,
                interval=interval, log=log, seed=tuner_seed,
                trial_log=trial_log, **kw,
            )
            self.tuner = self.planner  # shared notify_* hooks
            self.ts = self._build(base.build_kwargs())
            self._live_config = base
            self._last_good_config = base
            self._trial_backup = None
            self._last_finite_loss: Optional[float] = None
            if alpha_beta is None and _os.environ.get(
                    "DEAR_TUNE_FIT", "").strip().lower() in (
                        "1", "true", "yes", "on"):
                from dear_pytorch_tpu_torch.observability import overlap

                alpha_beta = overlap.fit_interconnect(
                    self.ts.group, device=self.ts.device)
                self._log(f"autotune: interconnect fit alpha="
                          f"{alpha_beta[0]:.3e}s beta={alpha_beta[1]:.3e}s/B")
            self._alpha_beta = alpha_beta
            self._install_cost_model()
            return

        if strategy == "bo":
            kw = {} if clock is None else {"clock": clock}
            self.tuner: Optional[Tuner] = Tuner(
                x=threshold_mb, bound=bound, max_num_steps=max_trials,
                interval=interval, log=log, seed=tuner_seed, **kw,
            )
            self.ts = self._build({"threshold_mb": threshold_mb})
            # trial sandboxing bookkeeping: the threshold built into the
            # live plan, and the last one that produced a finite loss (the
            # revert target when a trial fails or diverges)
            self._live_threshold = float(threshold_mb)
            self._last_good_threshold = float(threshold_mb)
        else:
            self.tuner = None
            self._cycle = cycle_time_s
            self._warmup_steps = warmup_steps
            self._layer_times = layer_times
            self._switched = False
            # all layers in one bucket to start (nearby_layers=-1)
            self.ts = self._build({"nearby_layers": -1})

    # -- building ------------------------------------------------------------

    def _make_plan(self, threshold_mb=25.0, nearby_layers=None, flags=None,
                   world: Optional[int] = None) -> F.FusionPlan:
        world = self.ts.world if world is None else world
        return F.make_plan(self._specs, world, threshold_mb=threshold_mb,
                           nearby_layers=nearby_layers, flags=flags)

    def _build(self, plan_kwargs: dict, plan: Optional[F.FusionPlan] = None
               ) -> D.TrainStep:
        """A train step over the model for ``plan_kwargs`` (the bucketing
        keys ``threshold_mb`` / ``nearby_layers`` / ``flags`` and, for the
        plan strategy, the configuration's build kwargs)."""
        kw = dict(plan_kwargs)
        bucketing = {k: kw.pop(k) for k in ("threshold_mb", "nearby_layers",
                                            "flags") if k in kw}
        if plan is not None:
            kw["plan"] = plan
        return D.build_train_step(self._loss_fn, self.model, **bucketing,
                                  **{**self._build_kwargs, **kw})

    def init(self, params: Optional[dict] = None) -> D.DearState:
        return self.ts.init(params)

    @property
    def plan(self) -> F.FusionPlan:
        """The LIVE train step's fusion plan."""
        return self.ts.plan

    def close(self) -> None:
        """Close the live train step (every rank calls it)."""
        self.ts.close()

    def _install_cost_model(self) -> None:
        """(Re)build the planner's analytic cost model for the current
        world from the α-β fit, when there is one."""
        if self.planner is None or self._alpha_beta is None:
            return
        from dear_pytorch_tpu_torch.tuning import planspace as PS

        world = self.ts.world
        self.planner.cost_model = PS.CostModel(
            lambda thr: self._make_plan(threshold_mb=thr, world=world),
            *self._alpha_beta)

    # -- rank consistency ----------------------------------------------------

    def _object_device(self):
        g = self.ts.group
        return (self.ts.device if dist.get_backend(g) == "nccl"
                else torch.device("cpu"))

    def _agree(self, proposal):
        """Rank 0's proposal, and its tuner's current point installed in
        this rank's tuner (one object broadcast over the group; nothing at
        world 1)."""
        if self.ts.world == 1:
            return proposal
        g = self.ts.group
        obj = [(proposal, None if self.tuner is None
                else self.tuner._current)]
        dist.broadcast_object_list(obj, src=dist.get_global_rank(g, 0),
                                   group=g, device=self._object_device())
        proposal, current = obj[0]
        if self.tuner is not None:
            self.tuner._current = current
        return proposal

    def _first_failure(self, why: Optional[str]) -> Optional[str]:
        """The failure of the lowest rank that had one (``why`` is this
        rank's, None when it had none): the same on every rank."""
        if self.ts.world == 1:
            return why
        whys = [None] * self.ts.world
        dist.all_gather_object(whys, why, group=self.ts.group)
        return next((w for w in whys if w is not None), None)

    # -- rebuilds ------------------------------------------------------------

    def _build_agreed(self, plan_kwargs: dict,
                      plan: Optional[F.FusionPlan] = None) -> tuple:
        """``(new step, None)``, or ``(None, why)`` on every rank when the
        build raised on any: ``why`` is ``"<Type>: <message>"`` of the
        lowest such rank. The live step and state are untouched."""
        new_ts, why = None, None
        try:
            new_ts = self._build(plan_kwargs, plan)
        except Exception as exc:   # agreed below, then reported
            why = f"{type(exc).__name__}: {exc}"
        why = self._first_failure(why)
        if why is not None and new_ts is not None:
            new_ts.close()
            new_ts = None
        return new_ts, why

    def _rebuild(self, state, *, force: bool = False, **plan_kwargs):
        """Build the step for ``plan_kwargs`` and repack ``state`` into it:
        ``(state, None)``, also when the plan bucketizes like the live one
        (skipped unless ``force``); ``(state, why)`` with the old step
        still live and ``state`` unchanged when the build failed on any
        rank (`_build_agreed`). A failure in the repack raises."""
        tr = _telemetry.get_tracer()
        old_ts = self.ts
        bucketing = {k: plan_kwargs[k] for k in
                     ("threshold_mb", "nearby_layers", "flags")
                     if k in plan_kwargs}
        plan = self._make_plan(**bucketing)
        if not force and _plan_key(plan) == _plan_key(old_ts.plan):
            # a different threshold that bucketizes identically: skip the
            # repack AND keep the current (still valid) measurement window
            if tr.enabled:
                tr.event("autotune.plan_unchanged",
                         kwargs=repr(plan_kwargs)[:120])
            self._log(f"autotune: plan unchanged by {plan_kwargs}; no rebuild")
            return state, None
        with tr.span("autotune.rebuild", strategy=self.strategy,
                     buckets=plan.num_buckets):
            new_ts, why = self._build_agreed(plan_kwargs, plan)
            if why is not None:
                return state, why
            err = None
            try:
                state = repack_state(state, old_ts, new_ts, log=self._log)
            except Exception as exc:   # raised below, on every rank
                err = exc
            why = self._first_failure(None if err is None else repr(err))
            if why is not None:
                raise err if err is not None else RuntimeError(
                    f"autotune: the repack failed on another rank ({why})")
        self.ts = new_ts
        self.rebuilds += 1
        if tr.enabled:
            tr.count("autotune.rebuilds")
            tr.event("autotune.rebuilt", strategy=self.strategy,
                     buckets=new_ts.plan.num_buckets,
                     kwargs=repr(plan_kwargs)[:120])
        if self.tuner is not None:
            self.tuner.notify_rebuild()
        self._log(
            f"autotune: re-bucketed to {new_ts.plan.num_buckets} buckets "
            f"({plan_kwargs})"
        )
        return state, None

    def _failed(self, what: str, why: str, **event) -> None:
        """Record a trial that failed (``autotune.trial_failures``, an
        ``autotune.trial_infeasible`` event) and log it."""
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.count("autotune.trial_failures")
            tr.event("autotune.trial_infeasible", why=why[:120], **event)
        logger.error("autotune: %s: %s", what, why)
        self._log(f"autotune: {what} ({why})")

    def _trial_infeasible(self, state, bad_threshold: float, why: str):
        """Sandbox a failed/diverged BO trial: record it as infeasible
        (dominated observation, consumed trial) and revert the live plan
        to the last known-good threshold — the tuning run survives.
        Returns the (possibly reverted) state."""
        self._failed(f"trial threshold {bad_threshold:.4f} MB infeasible; "
                     f"reverting to {self._last_good_threshold:.4f} MB",
                     why, threshold_mb=float(bad_threshold))
        self.tuner.mark_infeasible(
            float(bad_threshold), revert_to=self._last_good_threshold
        )
        if self._live_threshold != self._last_good_threshold:
            state, failed = self._rebuild(
                state, threshold_mb=self._last_good_threshold)
            if failed is None:
                self._live_threshold = self._last_good_threshold
            else:   # the trial's plan stays live
                logger.error("autotune: the revert to %.4f MB did not "
                             "build (%s); continuing on the trial plan",
                             self._last_good_threshold, failed)
        return state

    def rescale(self, view, *, state=None, store=None):
        """Rebuild the train step for a new membership after an elastic
        transition (JAX autotune.py:550; `utils.guard.GuardedTrainer`'s
        ``on_membership_change`` hook calls it with the committed
        `resilience.membership.MembershipView`): `comm.backend.regroup`
        forms the view's groups (over ``store``, default the
        ``DEAR_ELASTIC_DIR`` store), `ops.fusion.rescale_plan` keeps the
        bucket grouping with the view's world and epoch stamped in, and a
        new step is built over the same model on the new group and
        initialized from the model's parameters. Returns the carried
        state, or None.

        Without ``state`` the guard's restore (after this hook) lands the
        checkpoint in the new plan — JAX's order. With a live ``state``
        every OLD member must call this (a scale-up, or a drain whose
        leaver cooperates): the state is exported by parameter name on the
        old group before it is released (`export_state` gathers the
        shards), and across a world change the compressor residual of
        every new rank is the mean of the old ranks' (JAX's
        mass-preserving ``_repack_comp_state``). A rank outside
        ``view.members`` only releases its groups and closes its step.

        If the build raises, the failure is counted
        (``autotune.rescale_failures``), the previous step stays installed
        and the error propagates. At world 1 that step runs no collective
        and stays usable (JAX's contract). At world > 1 its group is gone:
        `comm.backend.regroup` released it before the build (the default
        group is re-formed per epoch). The step is then abandoned and
        refuses to run, so the rank must exit for relaunch and rejoin; the
        guard lets the error propagate out of its step for that. A step
        whose group lost a member (`TrainStep.abandon`) is closed without
        any collective of that group."""
        if not hasattr(view, "members"):
            raise ValueError(
                f"rescale needs the committed MembershipView (epoch, "
                f"members, rank, world), got {view!r}: the port forms the "
                "view's process group (comm.backend.regroup)")
        world, epoch = int(view.world), int(getattr(view, "epoch", 0) or 0)
        old_ts = self.ts
        if self._build_kwargs.get("dcn") is not None:
            raise NotImplementedError(
                "AutoTuner.rescale of a hierarchical (dcn=) step is not "
                "ported yet: ROADMAP Queue 1 item 9c (the multi-slice DCN "
                "leg)")
        if world == old_ts.plan.world and epoch == old_ts.plan.epoch:
            return state
        if old_ts.fused:
            raise ValueError(
                "mode='dear-fused' is not elastic: its ring transport is "
                "bound to the group it was built on (JAX's fused step is "
                "not rescaled either)")
        tr = _telemetry.get_tracer()
        plan = F.rescale_plan(old_ts.plan, world, epoch=epoch)
        saved = None
        if state is not None:
            if old_ts.group_lost:
                raise ValueError(
                    "rescale(state=) carries the state over the old group, "
                    "which lost a member; restore from a checkpoint instead")
            saved = export_state(state, old_ts)
            if world != old_ts.world and old_ts.world > 1 and saved["comp"]:
                with torch.no_grad():
                    for named in saved["comp"].values():
                        for n, t in named.items():
                            named[n] = C.all_reduce(
                                t.to(old_ts.device),
                                old_ts.group).cpu() / old_ts.world
        if not old_ts.group_lost:
            # the old group's last collectives, before it is released
            old_ts._wait_gathers(range(len(old_ts._ag_work)))
            old_ts._wait_model_state()
        with tr.span("autotune.rescale", world=world, epoch=epoch,
                     buckets=plan.num_buckets):
            group = backend.regroup(view, device=old_ts.device, store=store)
            if group is None:   # this rank left the membership
                old_ts.abandon()
                old_ts.close()
                return None
            kw = {}
            if self.strategy == "plan":
                kw = self._live_config.build_kwargs()
                kw.pop("threshold_mb", None)   # the rescaled plan wins
            try:
                new_ts = self._build(dict(kw, group=group), plan)
            except Exception as exc:
                if tr.enabled:
                    tr.count("autotune.rescale_failures")
                    tr.event("autotune.rescale_failed", world=world,
                             epoch=epoch,
                             why=f"{type(exc).__name__}: {exc}"[:120])
                if old_ts.world > 1:
                    old_ts.abandon()   # its group was released above
                logger.error(
                    "autotune: rescale to world=%d (epoch %d) failed "
                    "(%s: %s); previous plan still installed%s",
                    world, epoch, type(exc).__name__, exc,
                    "" if old_ts.world == 1 else
                    " without its group: exit for relaunch")
                raise
            old_ts.abandon()   # its group is released: wait on nothing
            if "group" in self._build_kwargs:   # later rebuilds use it
                self._build_kwargs["group"] = group
            saved = _share_carried(saved, group)
            if saved is not None:
                state = _adopt(old_ts, new_ts, saved, self._log)
            else:
                old_ts.close()
                new_ts.init()
        self.ts = new_ts
        self.rebuilds += 1
        if tr.enabled:
            tr.count("autotune.rescales")
            tr.event("autotune.rescaled", world=world, epoch=epoch,
                     buckets=new_ts.plan.num_buckets)
        if self.tuner is not None:
            # a context change: timings of the old world are not
            # comparable (JAX autotune.py:632-637)
            self.tuner.notify_context(world=world, epoch=epoch)
        if self.strategy == "plan":
            self._trial_backup = None   # the snapshot predates the world
            self._install_cost_model()
        self._log(f"autotune: rescaled plan to world={world} (membership "
                  f"epoch {epoch}, {new_ts.plan.num_buckets} buckets)")
        return state

    # -- plan strategy -------------------------------------------------------

    def _revert_trial(self, state, metrics, why: str):
        """A live plan-space trial diverged: rebuild the last good
        configuration over the model, install the pre-trial snapshot
        (masters, optimizer and compressor state, step count, the model's
        buffers), record the trial infeasible, and hand back a FINITE loss
        (the last one the reverted state produced). The few steps run
        under the trial are discarded with it."""
        saved, old_loss = self._trial_backup
        bad = self._live_config
        self._failed(f"trial {bad.describe()} infeasible", why,
                     config=bad.describe())
        self.planner.mark_infeasible(
            bad, revert_to=self._last_good_config, why=why)
        good = self._last_good_config
        new_ts, failed = self._build_agreed(good.build_kwargs())
        if failed is not None:
            raise RuntimeError(f"autotune: the last good configuration "
                               f"{good.describe()} no longer builds "
                               f"({failed})")
        state = _adopt(self.ts, new_ts, saved, self._log)
        restore_buffers(self.model, saved["buffers"])
        self.ts = new_ts
        self._live_config = good
        self._trial_backup = None
        self._log(
            f"autotune: trial {bad.describe()} infeasible ({why}); "
            f"reverted plan AND state to {good.describe()}"
        )
        out = dict(metrics)
        out["trial_loss"] = out.get("loss")
        if old_loss is not None:
            out["loss"] = old_loss
        out["tuner_reverted"] = True
        return state, out

    def _plan_step(self, state, metrics):
        """Per-step plan-space tuning work (strategy='plan')."""
        pt = self.planner
        searching = not pt.finished   # the same on every rank
        if searching:
            # the loss fetch drains the card before the tuner samples its
            # clock, and feeds divergence detection for the live trial
            # (the loss is the mean over the ranks: every rank sees it)
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                if self._trial_backup is not None:
                    return self._revert_trial(state, metrics,
                                              "non-finite loss")
                # no live trial to blame: a genuine divergence
                return state, metrics
            self._last_finite_loss = loss
        proposal = pt.step()
        if searching:
            proposal = self._agree(proposal)
        if proposal is not None:
            # a NEW proposal means the live config survived a full
            # measurement window of finite losses: it becomes the revert
            # target and its snapshot is dropped
            self._trial_backup = None
            self._last_good_config = self._live_config
            tr = _telemetry.get_tracer()
            if tr.enabled:
                tr.count("autotune.trials")
                tr.event("autotune.proposal", config=proposal.describe())
            backup = (export_state(state, self.ts), self._last_finite_loss)
            state, failed = self._rebuild(
                state, force=proposal.key() != self._live_config.key(),
                **proposal.build_kwargs())
            if failed is None:
                self._live_config = proposal
                self._trial_backup = backup
            else:
                # a combo the surrounding build kwargs cannot express
                # (LAMB x dear-fused, clip_norm x compression, ...) is
                # structurally dead — retire the arm; anything else only
                # penalizes this threshold
                self._failed(f"rebuild for trial {proposal.describe()}",
                             failed, config=proposal.describe())
                pt.mark_infeasible(
                    proposal, revert_to=self._last_good_config,
                    fatal=failed.startswith(("ValueError:", "TypeError:")),
                    why=f"rebuild raised {failed}",
                )
        if pt.finished:
            # the adopted config is not a trial: free the snapshot (it
            # would otherwise pin a full state copy for the rest of the
            # run) and stop treating divergence as the tuner's incident
            self._trial_backup = None
            self._last_good_config = self._live_config
        return state, metrics

    # -- the step ------------------------------------------------------------

    def step(self, state, batch):
        state, metrics = self.ts.step(state, batch)
        self._host_step += 1
        if self.strategy == "plan":
            return self._plan_step(state, metrics)
        if self.strategy == "bo":
            searching = not self.tuner.finished
            if searching:
                # drain the card before the tuner samples its clock:
                # otherwise it would time the host's enqueue, not the step
                loss = float(metrics["loss"])
                if not math.isfinite(loss) \
                        and self._live_threshold != self._last_good_threshold:
                    # the active trial diverged: plan repacks are exact,
                    # so this usually means a pathological bucketization —
                    # record the trial infeasible and fall back; parameter
                    # recovery is not the tuner's job
                    state = self._trial_infeasible(
                        state, self._live_threshold, "non-finite loss"
                    )
                    return state, metrics
            proposal = self.tuner.step()
            if searching:
                proposal = self._agree(proposal)
            if proposal is not None:
                # a NEW proposal means the live threshold survived a full
                # measurement window of finite losses: only now does it
                # become the revert target
                self._last_good_threshold = self._live_threshold
                tr = _telemetry.get_tracer()
                if tr.enabled:
                    tr.count("autotune.trials")
                    tr.event("autotune.proposal",
                             threshold_mb=float(proposal))
                state, failed = self._rebuild(state,
                                              threshold_mb=float(proposal))
                if failed is None:
                    self._live_threshold = float(proposal)
                else:   # a bad proposal must not kill the tuning run
                    state = self._trial_infeasible(
                        state, float(proposal), f"rebuild raised {failed}")
        elif not self._switched and self._host_step >= self._warmup_steps:
            times = (
                self._layer_times
                if self._layer_times is not None
                else estimate_layer_backward_times(self.ts.plan)
            )
            flags = self._agree(wait_time_flags(times, self._cycle))
            self._switched = True
            tr = _telemetry.get_tracer()
            if tr.enabled:
                tr.count("autotune.trials")
                tr.event("autotune.wait_time_decision",
                         buckets=int(sum(flags)), cycle_time_s=self._cycle)
            if sum(flags) > 1:  # one bucket already == current plan
                state, failed = self._rebuild(state, flags=flags)
                if failed is not None:   # stay on the single-bucket plan
                    self._failed("wait_time split rebuild; keeping the "
                                 "all-layers bucket", failed,
                                 strategy="wait_time")
        return state, metrics
