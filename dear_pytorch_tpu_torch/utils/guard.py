"""Failure detection + recovery around the train step — the port of
``dear_pytorch_tpu/utils/guard.py``.

`GuardedTrainer` wraps a `parallel.dear.TrainStep` with:

  - **divergence detection**: the loss is fetched (``float(metrics
    ["loss"])``, the guard's only host sync on a step) and checked every
    ``check_every`` steps,
  - **rollback**: on a non-finite loss (or a raised step error) the state
    restores from the newest periodic checkpoint and training continues,
    skipping forward past the poisoned step. The restore writes into the
    live step in place (`utils.checkpoint.restore_checkpoint`), so the
    state the guard returns holds the same tensors,
  - **periodic checkpoints**: every ``checkpoint_every`` steps through
    `utils.checkpoint` (plan-fingerprinted, sha256-manifested, sync or
    async); a checkpoint step always checks its loss first,
  - **step-time accounting**: wall-clock EMA + max over check intervals.

The resilience layer plugs in as in the JAX package: a `FaultInjector`
(or ``DEAR_FAULTS``) fires NaN/exception/hang/corruption/preemption/flip
faults inside the guarded step; a `StepWatchdog` is beaten after every
step; a `PreemptionHandler`'s SIGTERM becomes a verified synchronous
emergency checkpoint (``metrics["preempted"]``); restores verify the
checksum manifest and walk back past corrupted checkpoints; at world > 1
a `resilience.cluster.ClusterCoordinator` (made automatically unless
``DEAR_CLUSTER=0``) turns every recovery decision into a consensus one —
one rank's NaN or error rolls every rank back to the same step, restores
go to the newest step verified on every host, the loss fingerprint is the
desync sentinel, and under ``DEAR_SDC`` the per-bucket fingerprints
(``metrics["sdc_fp"]``) are voted on. Telemetry counts ``guard.*``,
``cluster.*`` and ``sdc.*``; with the tracer on, every step lands in the
`observability.flight` ring (dumped on rollback), the check cadence feeds
the `observability.anomaly` detectors, and coordinated runs exchange
`observability.aggregate` digests on the health sync.

Elastic membership (JAX :259-281, :343-400, :470-620, :915-1010,
:1159-1208): with a coordinator that ``supports_membership``
(`resilience.membership.ElasticCluster`) the health sync runs at any
world (it is where a sole survivor polls rejoin requests); a committed
transition calls ``on_membership_change(view)`` BEFORE the consensus
restore (the hook — `tuning.autotune.AutoTuner.rescale` — forms the new
epoch's group and step, so the restore re-packs into the new plan), the
pipeline is resharded AFTER it, and later sidecars carry the new epoch.
In the port a rank's death also fails the survivors' dispatched step (its
collectives lose a peer), and a local error mid-step leaves the peers'
collectives to time out: with such a coordinator the step is abandoned
and the error deferred to the health sync as unhealthy, where the peer
timeout turns a death into the shrink, and with every member alive the
members re-form the epoch at the same membership
(`resilience.membership.ElasticCluster.reform`), a transition too. A SIGTERM (or an SDC quarantine) becomes a planned-shrink drain;
`resilience.membership.EvictedError` propagates (exit for relaunch); a
``streamer`` (`utils.checkpoint.CheckpointStreamer`) gets every committed
save, and emergency saves are flushed to it inside the grace window;
`elastic_resume` is a relaunched rank's re-entry.

A hierarchical step (``ts.dcn``, `comm.dcn.DcnExchanger`; JAX
guard.py:103-119, :310-345, :770-800, :904): the exchanger's ladder
state rides every checkpoint's sidecar and is re-seated with every
restore; a `comm.dcn.DcnSelfEvict` propagates (exit for relaunch and
rejoin); a failed cross-slice leg (`comm.dcn.DcnError`) after dispatch is
deferred to the health sync as unhealthy, with no re-attempt and without
abandoning the step — the step's agreement (`parallel.dear`) left every
rank of the slice at the same point, with nothing of the slice group in
flight; the committed include-set mean's checksum joins the SDC vote.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Any, Callable, Optional

from dear_pytorch_tpu_torch.observability import aggregate as _aggregate
from dear_pytorch_tpu_torch.observability import anomaly as _anomaly
from dear_pytorch_tpu_torch.observability import flight as _flight
from dear_pytorch_tpu_torch.observability import tracer as _telemetry
from dear_pytorch_tpu_torch.resilience import cluster as _cluster
from dear_pytorch_tpu_torch.resilience import inject as _inject
from dear_pytorch_tpu_torch.resilience import sdc as _sdc
from dear_pytorch_tpu_torch.utils import checkpoint as ckpt

logger = logging.getLogger("dear_pytorch_tpu_torch")

__all__ = ["DivergenceError", "GuardedTrainer", "PeerLostError"]


def _is_dcn_error(exc: BaseException) -> bool:
    """Is this a cross-slice (host DCN leg) failure? Lazy import: the
    guard must not pull the hierarchical machinery into single-level
    runs."""
    from dear_pytorch_tpu_torch.comm.dcn import DcnError

    return isinstance(exc, DcnError)


def _is_self_evict(exc: BaseException) -> bool:
    """Is this the degraded-DCN ladder's self-eviction verdict? Must NOT
    be handled as a step error: a rollback cannot fix an outbound
    partition — the rank exits for relaunch + rejoin instead."""
    from dear_pytorch_tpu_torch.comm.dcn import DcnSelfEvict

    return isinstance(exc, DcnSelfEvict)


class DivergenceError(RuntimeError):
    """Raised when training diverges and no checkpoint exists to restore."""


class PeerLostError(RuntimeError):
    """A peer never reached the coordinated health sync (hung or dead
    host); raised after the forensic dump so the job crashes for
    whole-job relaunch instead of deadlocking."""


class GuardedTrainer:
    """Wrap ``ts`` (a `parallel.dear.TrainStep`) with detection + recovery.

    Usage::

        state = ts.init()
        trainer = GuardedTrainer(ts, directory)
        for batch in batches:
            state, metrics = trainer.step(state, batch)

    ``params_template`` is accepted for the JAX package's signature and
    unused: the restore writes into the live step's tensors.
    """

    def __init__(
        self,
        ts,
        directory: str,
        params_template=None,
        *,
        check_every: int = 50,
        checkpoint_every: int = 500,
        max_recoveries: int = 3,
        max_keep: int = 3,
        on_rollback: Optional[Callable[[int, int], None]] = None,
        async_checkpoints: bool = False,
        injector: Optional[Any] = None,
        watchdog: Optional[Any] = None,
        preemption: Optional[Any] = None,
        coordinator: Optional[Any] = None,
        pipeline: Optional[Any] = None,
        on_membership_change: Optional[Callable[[Any], None]] = None,
        streamer: Optional[Any] = None,
    ):
        self.ts = ts
        self.directory = directory
        self.async_checkpoints = async_checkpoints
        self.check_every = max(int(check_every), 1)
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self.max_recoveries = max_recoveries
        self.max_keep = max(int(max_keep), 1)
        self.on_rollback = on_rollback
        # an explicit injector wins; otherwise consult DEAR_FAULTS (None
        # when unset — zero per-step overhead)
        self._injector = (injector if injector is not None
                          else _inject.FaultInjector.from_env())
        self._watchdog = watchdog
        self._preemption = preemption
        # multi-process runs get a coordinator automatically unless
        # DEAR_CLUSTER=0 keeps the crash-for-relaunch branches; the
        # namespace is the same on every rank (never the directory, which
        # is rank-specific under per-host storage)
        if (coordinator is None and ts.world > 1
                and _cluster.enabled_by_env()):
            coordinator = _cluster.ClusterCoordinator(namespace="guard")
        self._coordinator = coordinator
        # a pipeline handed to the guard has its state_dict persisted in
        # every checkpoint sidecar, restored on rollback, and resharded on
        # membership changes
        self._pipeline = pipeline
        self.on_membership_change = on_membership_change
        # the durable remote tier: every committed save is enqueued (the
        # caller owns the streamer's lifecycle; `finalize` only flushes)
        self._streamer = streamer
        self._pending_reshard = False
        # SDC sentinel: armed by DEAR_SDC on coordinated runs only — the
        # vote needs peers
        self._sdc: Optional[_sdc.SdcSentinel] = None
        if self._coordinator is not None and _sdc.sdc_enabled():
            sdc_rank = getattr(self._coordinator, "rank",
                               getattr(self._coordinator, "index", None))
            self._sdc = _sdc.SdcSentinel.from_env(rank=sdc_rank)
        self._sdc_drain = False
        #: this rank's drain was acknowledged: its peers left the group
        self._drained = False
        # run health: the flight ring (with the tracer, see `_flight`),
        # the anomaly detectors on the check cadence, and on coordinated
        # runs the digest exchange on the health sync
        self._anomaly: Optional[_anomaly.AnomalyMonitor] = None
        if (_telemetry.get_tracer().enabled
                and _anomaly.AnomalyMonitor.enabled_by_env()):
            self._anomaly = _anomaly.AnomalyMonitor.from_env(
                on_anomaly=self._on_anomaly)
        self._aggregator: Optional[_aggregate.MetricAggregator] = None
        if self._coordinated and hasattr(self._coordinator, "exchange"):
            self._aggregator = _aggregate.MetricAggregator(
                self._coordinator)
        self.merged_health: Optional[dict] = None
        self._prev_step_t: Optional[float] = None
        self._last_loss: Optional[float] = None
        self._pending_error: Optional[BaseException] = None
        #: a dispatched step of an elastic fleet raised: its group is out
        #: of step, whoever is alive (reported at the next health sync)
        self._group_failed = False
        self._peer_preempt = False
        self._preempt_handled = False
        self._preempt_saved_step: Optional[int] = None
        self.recoveries = 0          # CONSECUTIVE rollbacks without a new
        self.steps_seen = 0          # healthy checkpoint in between
        self.ema_step_s = None
        self.max_step_s = 0.0
        self._last_good_step = None
        self._last_check_t = None
        self._last_check_steps = 0
        # startup GC of crash-leftover temporary dirs, skipped once this
        # process ran an async save (its write may be in flight)
        if not ckpt.has_async_checkpointer():
            ckpt.prune_orphaned_tmp(directory)

    # -- internals -----------------------------------------------------------

    @property
    def _flight(self):
        """The process-global flight recorder, resolved per access."""
        return _flight.get_recorder()

    @property
    def _coordinated(self) -> bool:
        """True when recovery decisions go through the cluster consensus
        protocol: a coordinator over a real multi-process world, or an
        elastic membership (``supports_membership``) at ANY world — a
        sole survivor keeps its health sync, where rejoin requests are
        polled, or the fleet never grows back."""
        if self._coordinator is None:
            return False
        return (self._coordinator.process_count > 1
                or getattr(self._coordinator, "supports_membership", False))

    @property
    def _elastic(self) -> bool:
        return bool(getattr(self._coordinator, "supports_membership", False))

    @property
    def _mem_epoch(self) -> Optional[int]:
        """The elastic membership epoch (None outside elastic runs),
        stamped into every checkpoint sidecar."""
        return getattr(self._coordinator, "epoch", None)

    def _pipeline_state(self) -> Optional[dict]:
        if self._pipeline is None:
            return None
        try:
            return self._pipeline.state_dict()
        except Exception as exc:  # a stats bug must not block the save
            logger.error("guard: pipeline.state_dict() failed: %s", exc)
            return None

    def _restore_pipeline(self, step: int) -> None:
        """Resume the input pipeline at the position persisted with the
        checkpoint being restored."""
        if self._pipeline is None:
            return
        pstate = ckpt.read_pipeline_state(self.directory, step)
        if pstate is None:
            logger.warning(
                "guard: checkpoint step %d has no pipeline sidecar state; "
                "the data stream position is NOT restored", step)
            return
        try:
            self._pipeline.load_state_dict(pstate)
        except Exception as exc:  # a spec change must not kill recovery
            logger.error(
                "guard: pipeline state restore failed (%s); continuing "
                "with the live stream position", exc)

    def _reshard_pipeline(self) -> None:
        """Reassign this rank's data slice after a committed membership
        transition: the view's ``data_shard`` of ``data_world``."""
        self._pending_reshard = False
        view_fn = getattr(self._coordinator, "view", None)
        if self._pipeline is None or view_fn is None:
            return
        view = view_fn()
        shard = getattr(view, "data_shard", view.index)
        world = getattr(view, "data_world", view.world)
        try:
            self._pipeline.reshard(shard, world, epoch=view.epoch)
        except Exception as exc:
            logger.error(
                "guard: pipeline reshard to %d/%d (epoch %d) failed: %s",
                shard, world, view.epoch, exc)

    def _dcn_state(self) -> Optional[dict]:
        """The cross-slice exchanger's ladder state (error-feedback
        residual + staleness clocks) for the checkpoint sidecar — None on
        single-level schedules or when nothing is carried (the sidecar
        stays as it was without it)."""
        dcn = getattr(self.ts, "dcn", None)
        if dcn is None or not hasattr(dcn, "state_dict"):
            return None
        try:
            state = dcn.state_dict()
        except Exception as exc:  # a ladder bug must not block the save
            logger.error("guard: dcn.state_dict() failed: %s", exc)
            return None
        if not state.get("residual") and not state.get("staleness"):
            return None
        return state

    def _restore_dcn(self, step: int) -> None:
        """Re-seat the degraded-DCN error-feedback residual persisted with
        the checkpoint being restored — the deferred gradient mass belongs
        to THESE parameters; keeping the live residual across a rollback
        would double-count every skipped round the replay re-earns."""
        dcn = getattr(self.ts, "dcn", None)
        if dcn is None or not hasattr(dcn, "load_state_dict"):
            return
        try:
            dcn.load_state_dict(ckpt.read_dcn_state(self.directory, step))
        except Exception as exc:  # a sidecar bug must not kill recovery
            logger.error(
                "guard: dcn ladder state restore failed (%s); continuing "
                "with fresh (empty) residuals", exc)

    def _restore_step(self, step: int):
        """Restore one step into the live step; a checkpoint packed under
        a DIFFERENT plan (another membership epoch or world) re-packs
        through `ckpt.elastic_restore`."""
        try:
            return ckpt.restore_checkpoint(self.directory, self.ts,
                                           step=step)
        except ckpt.PlanMismatchError:
            logger.warning(
                "guard: checkpoint step %d predates the live plan; elastic "
                "re-pack restore", step)
            tr = _telemetry.get_tracer()
            if tr.enabled:
                tr.event("guard.elastic_restore", step=step,
                         epoch=self._mem_epoch or 0)
            return ckpt.elastic_restore(self.directory, self.ts, step=step)

    @property
    def _drain_on_preempt(self) -> bool:
        """Does a SIGTERM become this rank's planned-shrink drain instead
        of a fleet-wide preemption? Only with a coordinator that speaks
        the drain protocol; ``DEAR_PREEMPT_DRAIN=0`` keeps the fleet-wide
        propagation."""
        if not getattr(self._coordinator, "supports_draining", False):
            return False
        return os.environ.get("DEAR_PREEMPT_DRAIN", "").strip().lower() \
            not in ("0", "false", "no", "off")

    @property
    def _preempt_requested(self) -> bool:
        """Should this step act on a preemption? Coordinated runs act only
        once the signal has propagated through the health sync, so every
        rank performs the emergency save at the same boundary."""
        if self._coordinated:
            return self._peer_preempt
        return self._preemption is not None and self._preemption.requested

    def _save(self, state) -> bool:
        """True when the save committed (or was handed to the writer);
        False on a swallowed async failure."""
        step = int(state.step)
        try:
            ckpt.save_checkpoint(self.directory, state, self.ts,
                                 asynchronous=self.async_checkpoints,
                                 pipeline_state=self._pipeline_state(),
                                 mem_epoch=self._mem_epoch,
                                 dcn_state=self._dcn_state())
        except Exception as exc:
            if not self.async_checkpoints:
                raise
            # a PREVIOUS async write's failure surfaces at this call; the
            # state in hand is healthy — skip this save, keep retention
            logger.error("guard: async checkpoint save failed: %s", exc)
            tr = _telemetry.get_tracer()
            if tr.enabled:
                tr.count("guard.checkpoint_failures")
                tr.event("guard.checkpoint_failed", step=step,
                         error=type(exc).__name__)
            self._prune(skip_tmp_step=step)
            return False
        self._last_good_step = step
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.count("guard.checkpoints")
        # async: the save's own temporary dir is legitimately alive
        self._prune(skip_tmp_step=(self._last_good_step
                                   if self.async_checkpoints else None))
        if self._streamer is not None:
            # a queue put: the streamer's worker waits for the commit
            self._streamer.enqueue(step)
        return True

    def _prune(self, skip_tmp_step: Optional[int] = None) -> None:
        """Keep the newest ``max_keep`` checkpoints
        (`utils.checkpoint.prune_checkpoints`)."""
        ckpt.prune_checkpoints(self.directory, max_keep=self.max_keep,
                               skip_tmp_step=skip_tmp_step)

    def _restore(self, cause: Optional[BaseException] = None):
        # an async save may still be in flight: its step dir appears only
        # on commit, so wait; a FAILED in-flight write must not kill the
        # rollback itself
        try:
            ckpt.wait_for_checkpoints()
        except Exception as exc:
            logger.error(
                "guard: in-flight async checkpoint failed (%s); restoring "
                "the newest committed checkpoint instead", exc)
        tr = _telemetry.get_tracer()
        if self._coordinated:
            # consensus restore: every process contributes its locally
            # VERIFIED steps and all restore the newest step valid on
            # every host. On SHARED storage rank 0 verifies for everyone.
            if ckpt.per_host_storage() or self._coordinator.index == 0:
                local = ckpt.valid_steps(
                    self.directory, limit=self._coordinator.max_candidates)
            else:
                local = None  # defer to rank 0's verification
            epoch_before = getattr(self._coordinator, "epoch", None)
            step = self._coordinator.consensus_restore_step(local)
            if step is None:
                raise DivergenceError(
                    "no checkpoint step is verified on every host; "
                    "nothing commonly restorable (see the chained cause)"
                ) from cause
            if (epoch_before is not None
                    and getattr(self._coordinator, "epoch",
                                epoch_before) != epoch_before):
                # a SECOND failure during the restore exchange moved the
                # membership again: rebuild for the newest view before the
                # restore lands
                logger.critical(
                    "guard: membership moved during the restore exchange "
                    "(epoch %s -> %s); rebuilding for the newest view",
                    epoch_before, self._coordinator.epoch)
                self._pending_reshard = True
                if self.on_membership_change is not None:
                    self.on_membership_change(self._coordinator.view())
                if tr.enabled:
                    tr.count("guard.membership_changes")
                    tr.event("guard.membership_change",
                             epoch=self._coordinator.epoch,
                             during="restore")
            # every rank is committed to this step: a restore failure here
            # must propagate (falling back locally would desynchronize)
            state = self._restore_step(step)
            self._restore_pipeline(step)
            self._restore_dcn(step)
            ckpt.prune_future_steps(self.directory, above=step)
            logger.warning(
                "guard: consensus rollback to checkpoint step %d", step)
            if tr.enabled:
                tr.count("guard.restores")
                tr.event("guard.restore", step=step, consensus=1)
            return state, step
        if self.ts.world > 1:
            # DEAR_CLUSTER=0: every process must restore the SAME step, so
            # the newest committed one, deterministically; a failure
            # crashes for whole-job relaunch
            step = ckpt.latest_step(self.directory)
            if step is None:
                raise DivergenceError(
                    "training failed before the first checkpoint; nothing "
                    "to restore (see the chained cause)") from cause
            state = ckpt.restore_checkpoint(self.directory, self.ts,
                                            step=step)
            self._restore_pipeline(step)
            self._restore_dcn(step)
            logger.warning("guard: rolled back to checkpoint step %d", step)
            return state, step
        # single process: walk newest -> oldest past corrupted payloads;
        # a restore that still fails falls back to the next older step
        last_exc: Optional[BaseException] = cause
        failed_steps: list = []
        step = ckpt.latest_valid_step(self.directory)
        while step is not None:
            try:
                state = self._restore_step(step)
            except Exception as exc:
                logger.error(
                    "guard: restore of checkpoint step %d failed (%s: %s); "
                    "falling back to the previous checkpoint",
                    step, type(exc).__name__, exc)
                if tr.enabled:
                    tr.count("guard.ckpt_fallbacks")
                    tr.event("guard.ckpt_fallback", step=step,
                             error=type(exc).__name__)
                failed_steps.append(step)
                last_exc = exc
                step = ckpt.latest_valid_step(self.directory, below=step)
                continue
            self._restore_pipeline(step)
            self._restore_dcn(step)
            ckpt.prune_future_steps(self.directory, above=step)
            logger.warning("guard: rolled back to checkpoint step %d", step)
            if tr.enabled:
                tr.count("guard.restores")
                tr.event("guard.restore", step=step)
            return state, step
        if not failed_steps:
            raise DivergenceError(
                "training failed before the first checkpoint; nothing to "
                "restore (see the chained cause; if it is a NaN loss, "
                "lower the lr or reduce checkpoint_every)") from cause
        raise DivergenceError(
            f"no restorable checkpoint under {self.directory}: steps "
            f"{failed_steps} failed to restore (newest failure chained)"
        ) from last_exc

    def _check(self, metrics) -> bool:
        # the guard's one host sync on a step, at the check cadence
        loss = float(metrics["loss"])
        self._last_loss = loss
        return math.isfinite(loss)

    def _on_anomaly(self, kind: str, detail: dict) -> None:
        """Escalation hook for the online detectors: always logged; with
        ``DEAR_HEALTH_KICK=1`` an anomaly also triggers the watchdog's
        forensic dump."""
        logger.warning("guard: health anomaly %s: %s", kind, detail)
        if (self._watchdog is not None
                and os.environ.get("DEAR_HEALTH_KICK", "").strip().lower()
                in ("1", "true", "yes", "on")):
            self._watchdog.kick(
                f"health anomaly: {kind}",
                **{k: v for k, v in detail.items()
                   if isinstance(v, (int, float, str))})

    def _health_tick(self, tr, per_step_s: Optional[float]) -> None:
        """Per-check-interval run-health work: feed the anomaly detectors.
        The JAX guard also samples the span stream's clock here and feeds
        the ``prom:``/``stream:`` exporters (dtrace.py, export.py); both
        are ROADMAP Queue 1 item 12, and nothing in the port can switch
        them on: the port's tracer refuses those sinks."""
        if self._anomaly is not None:
            self._anomaly.observe(
                step=self.steps_seen, step_time_s=per_step_s,
                loss=self._last_loss,
                counters=tr.counters() if tr.enabled else None)

    def _attempt(self, state, batch, tr):
        """Run one step attempt and its cadence bookkeeping (shared by the
        normal and the coordinated deferred-error paths, so every rank
        reaches the consensus sync at the same attempt number)."""
        if self._injector is not None:
            flip = self._injector.flip_bucket_for(self.steps_seen + 1)
            if flip is not None:
                # silent corruption of the state ENTERING this step, so
                # this step's fingerprint reflects it; the deterministic
                # fault reproduces on the post-rollback replay
                self.ts.wait_snapshot()
                state, used, idx = _inject.flip_state_bucket(
                    state, flip, plan=getattr(self.ts, "plan", None),
                    rank=self.ts.rank)
                if tr.enabled:
                    tr.count("faults.sdc_flips")
                if used is not None:
                    logger.warning(
                        "guard: injected SDC bit-flip at attempt %d — "
                        "bucket %d element %d",
                        self.steps_seen + 1, used, idx)
        new_state, metrics = self.ts.step(state, batch)
        self.steps_seen += 1
        is_ckpt = self.steps_seen % self.checkpoint_every == 0
        is_check = self.steps_seen % self.check_every == 0 or is_ckpt
        # a checkpoint step ALWAYS verifies first
        healthy = not is_check or self._check(metrics)
        if is_check and not healthy and tr.enabled:
            tr.count("guard.nan_detected")
        return new_state, metrics, is_ckpt, is_check, healthy

    # -- public --------------------------------------------------------------

    def step(self, state, batch):
        """One guarded step. May return a ROLLED-BACK state instead of the
        stepped one when divergence or a step error is detected; a handled
        preemption sets ``metrics["preempted"]`` (exit the loop)."""
        error: Optional[BaseException] = None
        tr = _telemetry.get_tracer()
        fl = self._flight
        self._last_loss = None
        step_dt: Optional[float] = None
        if fl.enabled:
            now0 = time.perf_counter()
            if self._prev_step_t is not None:
                step_dt = now0 - self._prev_step_t
            self._prev_step_t = now0
        dispatched = False
        try:
            if self._injector is not None:
                # faults fire INSIDE the guarded region
                attempt = self.steps_seen + 1
                self._injector.before_step(attempt, directory=self.directory)
                batch = self._injector.poison_batch(attempt, batch)
            dispatched = True
            new_state, metrics, is_ckpt, is_check, healthy = \
                self._attempt(state, batch, tr)
        except (FloatingPointError, RuntimeError) as exc:
            if _is_self_evict(exc):
                # the degraded-DCN ladder's last rung: the fleet's
                # replica-identical participation view says THIS slice is
                # unmerged past the staleness budget. A rollback cannot fix
                # an outbound partition — re-raise so the rank exits like
                # an `EvictedError` (supervisor relaunch → hydrate →
                # slice-gated rejoin), while the survivors' membership sync
                # books the slice loss. Every rank of the slice reaches the
                # same verdict (the step's agreement, parallel.dear).
                if tr.enabled:
                    tr.count("guard.step_errors")
                    tr.event("guard.step_error", error=type(exc).__name__)
                logger.error(
                    "guard: DCN ladder escalated to self-eviction: %s — "
                    "exiting for relaunch + rejoin", exc)
                raise
            if self._coordinated and dispatched and _is_dcn_error(exc):
                # hierarchical schedule: the CROSS-SLICE leg failed (dead
                # slice, DCN partition, dropped publish). The step's
                # agreement raised it on every rank of this slice before
                # any of them updated, so nothing of the slice group is in
                # flight: the step is NOT abandoned, and the error defers
                # straight to the coordinated sync as UNHEALTHY. No
                # re-attempt: retrying would burn another full peer
                # deadline against a slice the membership layer is about
                # to remove. The attempt counts, as on the elastic branch
                # below, so every member reaches the sync at the same one.
                if tr.enabled:
                    tr.count("guard.step_errors")
                    tr.event("guard.step_error", error=type(exc).__name__)
                logger.error(
                    "guard: cross-slice (DCN) leg failed: %s — deferring "
                    "to the coordinated health sync", exc)
                self._pending_error = exc
                self.steps_seen += 1
                healthy, new_state, metrics, error = False, None, None, exc
                is_ckpt, is_check = False, True
            elif self._coordinated and dispatched and self._elastic:
                # an elastic fleet: a peer's death fails this rank's
                # dispatched step (a collective lost its peer; the group's
                # timeout bounds it, comm.backend.regroup), and so does a
                # local error mid-step, which leaves the peers' collectives
                # to time out. Either way the group is out of step: the
                # step is abandoned (nothing of its group is waited on
                # again) and the error deferred to the health sync as
                # UNHEALTHY, as JAX's cross-slice leg does. There the peer
                # timeout turns a death into a shrink, and with every
                # member alive the members re-form the epoch
                # (ElasticCluster.reform); the transition builds the step
                # on the new group. The attempt counts, so every member
                # reaches the sync at the same attempt.
                if tr.enabled:
                    tr.count("guard.step_errors")
                    tr.event("guard.step_error", error=type(exc).__name__)
                logger.error(
                    "guard: dispatched step raised %s: %s — deferring to "
                    "the elastic health sync", type(exc).__name__, exc)
                self._pending_error = exc
                self._group_failed = True
                self.ts.abandon()
                self.steps_seen += 1
                healthy, new_state, metrics, error = False, None, None, exc
                is_ckpt, is_check = False, True
            elif self._coordinated:
                # a LOCAL failure must not fork the SPMD program: raised
                # before the step dispatched, this rank still runs the
                # real step (peers' collectives need it) and defers the
                # verdict to the health sync; raised DURING the step, it
                # cannot be papered over
                if tr.enabled:
                    tr.count("guard.step_errors")
                    tr.event("guard.step_error", error=type(exc).__name__)
                if dispatched:
                    logger.error(
                        "guard: dispatched step raised %s: %s — cannot "
                        "stay in lockstep; crashing for whole-job relaunch",
                        type(exc).__name__, exc)
                    raise
                logger.error(
                    "guard: step raised %s: %s (deferred to the "
                    "coordinated health sync)", type(exc).__name__, exc)
                self._pending_error = exc
                if self._injector is not None:
                    # a co-scheduled batch fault must still be consumed
                    try:
                        batch = self._injector.poison_batch(
                            self.steps_seen + 1, batch)
                    except _inject.InjectedFault:
                        pass
                new_state, metrics, is_ckpt, is_check, healthy = \
                    self._attempt(state, batch, tr)
            elif self.ts.world > 1:
                # DEAR_CLUSTER=0: a local rollback would desynchronize the
                # replicas; crash for whole-job relaunch
                raise
            else:
                logger.error("guard: step raised %s: %s",
                             type(exc).__name__, exc)
                if tr.enabled:
                    tr.count("guard.step_errors")
                    tr.event("guard.step_error", error=type(exc).__name__)
                healthy, new_state, metrics, error = False, None, None, exc
                is_check = is_ckpt = False

        if fl.enabled:
            fl.record(self.steps_seen, step_time_s=step_dt,
                      loss=self._last_loss, checked=int(is_check))

        per_step_s: Optional[float] = None
        if is_check and healthy:
            now = time.perf_counter()
            interval = self.steps_seen - self._last_check_steps
            if self._last_check_t is not None and interval > 0:
                per_step = (now - self._last_check_t) / interval
                per_step_s = per_step
                if (self.ema_step_s is not None
                        and per_step > 10 * self.ema_step_s):
                    logger.warning(
                        "guard: %.2fs/step over the last interval (ema "
                        "%.3fs) — possible hung collective; last "
                        "checkpointed step: %s",
                        per_step, self.ema_step_s, self._last_good_step)
                self.ema_step_s = (
                    per_step if self.ema_step_s is None
                    else 0.9 * self.ema_step_s + 0.1 * per_step)
                self.max_step_s = max(self.max_step_s, per_step)
            self._last_check_t = now
            self._last_check_steps = self.steps_seen

        if self._coordinated and is_check:
            if not self._health_sync(healthy, metrics, tr):
                if error is None:
                    error = self._pending_error
                healthy = False
            self._pending_error = None
            self._group_failed = False

        if is_check:
            self._health_tick(tr, per_step_s)

        if not healthy:
            return self._rollback(error, fl, tr)

        if (is_ckpt and not self._sdc_drain and not self._drained
                and self._save(new_state)):
            # persisted healthy progress: a future rollback is a NEW
            # incident; a FAILED async save must not reset the count
            self.recoveries = 0
        if self._preempt_requested and not self._preempt_handled:
            saved = self._emergency_save(new_state, metrics)
            self._preempt_handled = True
            self._preempt_saved_step = saved
            metrics = dict(metrics)
            metrics["preempted"] = True
            if saved is not None:
                metrics["preempt_checkpoint_step"] = saved
        elif self._preempt_handled:
            metrics = dict(metrics)
            metrics["preempted"] = True
            if self._preempt_saved_step is not None:
                metrics["preempt_checkpoint_step"] = self._preempt_saved_step
        if self._watchdog is not None:
            self._watchdog.beat(step=self.steps_seen,
                                last_good_step=self._last_good_step)
        return new_state, metrics

    def _health_sync(self, healthy, metrics, tr) -> bool:
        """The per-check-interval consensus point: any-rank-unhealthy, the
        loss fingerprint (the desync sentinel), the SDC fingerprints,
        preemption propagation and — on an elastic fleet — the drain
        announcement and the membership transitions, in ONE bounded
        exchange. Returns the verdict's ``ok``."""
        local_ok = healthy and self._pending_error is None
        fp = ""
        if healthy and metrics is not None:
            fp = _cluster.ClusterCoordinator.fingerprint(
                metrics["loss"].detach().cpu().numpy())
        sfp = ""
        if self._sdc is not None and healthy and metrics is not None:
            words = metrics.get("sdc_fp")
            # a hierarchical step's committed cross-slice mean is voted on
            # too: the exchanger's checksum of it joins the fingerprint
            dcn = getattr(self.ts, "dcn", None)
            extra = getattr(dcn, "last_mean_fp", "") if dcn else ""
            if words is not None or extra:
                # the tiny per-bucket vector, fetched at check cadence
                sfp = self._sdc.local_fingerprint(
                    None if words is None else words.detach().cpu().numpy(),
                    extra)
        pre_req = (self._preemption is not None
                   and self._preemption.requested
                   and not self._preempt_handled)
        # an elastic fleet turns a SIGTERM (or this host's SDC quarantine)
        # into this rank's planned shrink; DEAR_PREEMPT_DRAIN=0 keeps the
        # fleet-wide propagation. Only a coordinator that speaks the drain
        # protocol is passed ``draining=`` (a fixed-world one only fences
        # the quarantined host's saves)
        drain = (pre_req and self._drain_on_preempt
                 or self._sdc_drain and getattr(
                     self._coordinator, "supports_draining", False))
        sync_kwargs = dict(ok=local_ok, fingerprint=fp, step=self.steps_seen,
                           preempted=pre_req and not drain)
        if self._sdc is not None:
            sync_kwargs["sdc_fingerprint"] = sfp
            sync_kwargs["host"] = self._sdc.host
        if drain:
            sync_kwargs["draining"] = True
        if self._group_failed:
            sync_kwargs["group_failed"] = True
        try:
            verdict = self._coordinator.health_check(**sync_kwargs)
            membership_changed = bool(
                getattr(verdict, "membership_changed", False))
            if (self._aggregator is not None and not membership_changed
                    and not getattr(verdict, "self_draining", False)):
                # one lockstep digest exchange per health sync; skipped
                # across a transition (the member set just changed) and by
                # a drainer (the survivors never join it)
                self.merged_health = self._aggregator.exchange()
        except _cluster.PeerTimeout:
            # dead-peer detection: forensics through the watchdog, then
            # crash for relaunch
            if self._watchdog is not None:
                self._watchdog.kick(
                    "cluster peer timeout", step=self.steps_seen,
                    last_good_step=self._last_good_step)
            if self._pending_error is not None:
                raise PeerLostError(
                    "a peer never reached the coordinated health sync; "
                    "crashing for whole-job relaunch"
                ) from self._pending_error
            raise
        if verdict.any_preempted:
            self._peer_preempt = True
        if self._sdc is not None:
            hosts_by_rank = {int(r): h
                             for r, h in getattr(verdict, "hosts", ()) if h}
            acts = self._sdc.note_votes(
                getattr(verdict, "sdc_suspects", ()), hosts_by_rank,
                step=self.steps_seen,
                voted=getattr(verdict, "sdc_voted", False))
            if acts["opened"]:
                logger.critical(
                    "guard: SDC case opened against host(s) %s at step %d "
                    "— the coordinated rollback is the replay arbiter",
                    acts["opened"], self.steps_seen)
            if acts["struck"]:
                logger.warning(
                    "guard: SDC replay came back clean for host(s) %s — "
                    "transient fault, strike recorded", acts["struck"])
            if acts["convicted"]:
                logger.critical(
                    "guard: SDC conviction — host(s) %s quarantined in the "
                    "ledger", acts["convicted"])
            if self._sdc.drain_requested and not self._sdc_drain:
                # THIS host was convicted: fence checkpoint saves and
                # announce a planned-shrink drain at the next sync
                self._sdc_drain = True
                logger.critical(
                    "guard: host %s is quarantined — draining via planned "
                    "shrink; checkpoint saves fenced", self._sdc.host)
        if getattr(verdict, "self_draining", False) and self._sdc_drain:
            # the survivors committed the quarantine drain without me: no
            # emergency save (this host's state is the suspect copy)
            raise _sdc.SdcQuarantined(
                f"host {self._sdc.host} is quarantined in the SDC ledger; "
                "planned-shrink drain committed — exiting for backfill on "
                "a fresh host")
        if getattr(verdict, "self_draining", False):
            # the fleet acknowledged my drain and commits the shrink
            # without me: emergency-save and exit inside the grace window
            self._peer_preempt = True
            self._drained = True
            rem = (self._preemption.remaining()
                   if self._preemption is not None else None)
            logger.warning(
                "guard: drain acknowledged at step %d — planned shrink "
                "committed by the survivors (grace remaining: %s)",
                self.steps_seen,
                "unknown" if rem is None else f"{rem:.1f}s")
        if membership_changed:
            # a committed transition: the hook rebuilds the step for the
            # new members BEFORE the restore (the re-pack lands in the new
            # plan), the pipeline is resharded after it, and every member
            # rolls back to the newest step valid on all of them (the
            # verdict is never ok)
            self._pending_reshard = True
            if tr.enabled:
                tr.count("guard.membership_changes")
                tr.event(
                    "guard.membership_change",
                    epoch=getattr(verdict, "epoch", -1),
                    lost=",".join(map(str, getattr(verdict, "lost", ()))),
                    admitted=",".join(
                        map(str, getattr(verdict, "admitted", ()))))
            logger.critical(
                "guard: membership transition at step %d — epoch %s, "
                "members %s (lost %s, admitted %s); coordinated rollback "
                "+ reshard", self.steps_seen, getattr(verdict, "epoch", "?"),
                list(getattr(verdict, "members", ())),
                list(getattr(verdict, "lost", ())),
                list(getattr(verdict, "admitted", ())))
            if self.on_membership_change is not None:
                self.on_membership_change(self._coordinator.view())
        return verdict.ok

    def _rollback(self, error, fl, tr):
        self.recoveries += 1
        if self.recoveries > self.max_recoveries:
            raise DivergenceError(
                f"diverged {self.recoveries} consecutive times "
                f"(max_recoveries={self.max_recoveries})") from error
        if fl.enabled:
            dump = fl.dump()
            logger.warning(
                "guard: flight ring at rollback (%d records): %s",
                len(dump["records"]), json.dumps(dump))
            if tr.enabled:
                tr.count("guard.flight_dumps")
                tr.event("guard.flight_dump", records=len(dump["records"]))
        restored, at_step = self._restore(cause=error)
        # futures were just pruned: the restored step IS the newest
        # durable checkpoint now
        self._last_good_step = at_step
        self._last_check_t = None
        self._prev_step_t = None
        if self._pending_reshard:
            # after the restore: the sidecar re-seated the stream at the
            # checkpointed position, the reshard reassigns the slice
            self._reshard_pipeline()
        if tr.enabled:
            tr.count("guard.rollbacks")
            tr.count("guard.steps_skipped")  # the bad batch is skipped
            tr.event("guard.rollback", recoveries=self.recoveries,
                     restored_step=at_step)
        if self.on_rollback is not None:
            self.on_rollback(self.recoveries, at_step)
        if self._watchdog is not None:
            self._watchdog.beat(step=self.steps_seen,
                                last_good_step=at_step)
        out = {"loss": float("nan"), "rolled_back": True}
        if self._preempt_requested and not self._preempt_handled:
            # SIGTERM during an unhealthy stretch: the restored state IS
            # the newest durable checkpoint
            self._preempt_handled = True
            self._preempt_saved_step = at_step
            logger.warning(
                "guard: preemption during rollback — durable step is the "
                "restored checkpoint %d", at_step)
        if self._preempt_handled:
            out["preempted"] = True
            if self._preempt_saved_step is not None:
                out["preempt_checkpoint_step"] = self._preempt_saved_step
        return restored, out

    def elastic_resume(self, context: Optional[dict] = None):
        """Re-entry of a relaunched rank just admitted through
        `resilience.membership.ElasticCluster.rejoin`: the survivors are
        inside their membership-change rollback, so this runs the SAME
        consensus restore from this side (this rank's verified steps take
        part), re-seats and reshards the pipeline, and aligns the attempt
        cadence with the fleet through the admission ack's
        ``steps_seen``. Returns ``(state, step)``."""
        if context:
            self.steps_seen = int(context.get("steps_seen",
                                              self.steps_seen))
        self._last_check_steps = self.steps_seen
        self._last_check_t = None
        self._prev_step_t = None
        state, step = self._restore()
        self._reshard_pipeline()
        self._last_good_step = step
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.event("guard.elastic_resume", step=step,
                     steps_seen=self.steps_seen,
                     epoch=self._mem_epoch or 0)
        logger.warning(
            "guard: elastic resume at checkpoint step %d (attempt cadence "
            "%d, membership epoch %s)", step, self.steps_seen,
            self._mem_epoch)
        return state, step

    def _stream_emergency(self, step: int) -> None:
        """Push an emergency save to the remote tier inside the grace
        budget: enqueue (off the upload cadence), then flush bounded by
        what remains of the SIGTERM->SIGKILL window."""
        if self._streamer is None:
            return
        rem = (self._preemption.remaining()
               if self._preemption is not None else None)
        budget = 10.0 if rem is None else max(min(rem - 1.0, 10.0), 0.5)
        self._streamer.enqueue(step, force=True)
        if not self._streamer.flush(budget):
            logger.error(
                "guard: emergency upload of step %d did not finish inside "
                "the %.1fs grace budget; the remote tier keeps the "
                "previous upload", step, budget)

    def _emergency_save(self, state, metrics) -> Optional[int]:
        """Preemption checkpoint: synchronous, verified, at the current
        step. Returns the persisted step (None when the state could not be
        verified or the save failed)."""
        tr = _telemetry.get_tracer()
        rem = (self._preemption.remaining()
               if self._preemption is not None else None)
        if rem is not None:
            logger.warning(
                "guard: emergency save starting with %.1fs of the "
                "preemption grace window remaining", rem)
        try:
            healthy = self._check(metrics)
        except Exception as exc:
            logger.error("guard: preemption-save loss check failed: %s", exc)
            healthy = False
        if not healthy:
            logger.error(
                "guard: preemption save SKIPPED (non-finite loss); newest "
                "durable step stays %s", self._last_good_step)
            return None
        step = int(state.step)
        if self._drained and self.ts.world > 1:
            # the survivors left this rank's group when they committed the
            # drain; a save at world > 1 is a collective (the per-host
            # blob gathers every shard, shared storage commits behind a
            # barrier), so the newest durable step is the last periodic
            # one (JAX's drainer holds the whole state and saves it here)
            logger.warning(
                "guard: drained at step %d; the peers left the group, so "
                "the newest durable step stays %s", step,
                self._last_good_step)
            if tr.enabled:
                tr.count("guard.preempt_saves")
                tr.event("guard.preempt_save", step=self._last_good_step
                         if self._last_good_step is not None else -1)
            if self._last_good_step is not None:
                self._stream_emergency(self._last_good_step)
            return self._last_good_step
        if step == self._last_good_step:
            if not self.async_checkpoints:
                logger.warning(
                    "guard: preemption at step %d — already checkpointed",
                    step)
                if tr.enabled:
                    tr.count("guard.preempt_saves")
                    tr.event("guard.preempt_save", step=step)
                self._stream_emergency(step)
                return step
            # the newest async save may still be uncommitted: make it
            # durable before claiming it as the resume point
            try:
                ckpt.wait_for_checkpoints()
            except Exception as exc:
                logger.error(
                    "guard: in-flight async save failed during preemption "
                    "(%s); writing a fresh synchronous checkpoint", exc)
            else:
                ckpt.write_manifest(self.directory, step)
                logger.warning(
                    "guard: preemption at step %d — async checkpoint "
                    "committed and manifested", step)
                if tr.enabled:
                    tr.count("guard.preempt_saves")
                    tr.event("guard.preempt_save", step=step)
                self._stream_emergency(step)
                return step
        else:
            try:
                ckpt.wait_for_checkpoints()   # don't race an async save
            except Exception as exc:
                logger.error(
                    "guard: in-flight async save failed during preemption "
                    "(%s); writing a fresh synchronous checkpoint", exc)
        try:
            ckpt.save_checkpoint(self.directory, state, self.ts,
                                 asynchronous=False,
                                 pipeline_state=self._pipeline_state(),
                                 mem_epoch=self._mem_epoch,
                                 dcn_state=self._dcn_state())
        except Exception as exc:
            # the grace window must still end in a clean preempted exit
            logger.error(
                "guard: preemption save FAILED (%s: %s); newest durable "
                "step stays %s", type(exc).__name__, exc,
                self._last_good_step)
            if tr.enabled:
                tr.count("guard.checkpoint_failures")
                tr.event("guard.checkpoint_failed", step=step,
                         error=type(exc).__name__)
            return None
        self._last_good_step = step
        self._prune()
        logger.warning("guard: preemption checkpoint committed at step %d",
                       step)
        if tr.enabled:
            tr.count("guard.preempt_saves")
            tr.event("guard.preempt_save", step=step)
        self._stream_emergency(step)
        return step

    def finalize(self) -> None:
        """Wait for in-flight async checkpoint writes and surface their
        errors; backfill the newest async save's checksum manifest. Call
        when training ends (or use the trainer as a context manager)."""
        ckpt.wait_for_checkpoints()
        if self.async_checkpoints and self._last_good_step is not None:
            ckpt.write_manifest(self.directory, self._last_good_step)
        if self._streamer is not None and not self._streamer.flush(30.0):
            logger.error(
                "guard: remote-tier uploads still pending at finalize; the "
                "newest local checkpoint may not be durable remotely")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.finalize()
        else:
            # already failing: don't let a deferred write error mask it
            try:
                self.finalize()
            except Exception:
                logger.exception("guard: finalize failed during unwind")
