"""Shared elastic-worker harness — the port of the JAX package's
``tests/elastic_harness.py``. It lives in the package because the port's
chaos drill (`scripts.chaos_check --elastic/--autoscale`), its tests and
``chip_smoke.py``'s elastic phase all drive the same scenario — a
supervised rank that may SIGKILL itself, survivors that transition
through the guard's membership machinery, and a relaunched rank that
re-enters through rejoin — with different models and verdicts. The
protocol-shaped pieces they must agree on live here, in exactly one
place:

  - `attach_elastic` — the membership-transition hook (the rescale —
    the new epoch's process group, plan and train step — and the step
    swap) every elastic worker wires the same way;
  - `reenter` — the relaunched rank's re-entry sequence (sidecar epoch →
    `rejoin` → rescale → `elastic_resume`);
  - `run_loop` / `run_autoscale_loop` — the kill/step/target loops with
    the idle cadence that keeps the member sync polling for rejoin
    requests.

Imports nothing heavy at module level.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Callable, Optional, Tuple


def attach_elastic(guard, tuner) -> Callable:
    """Wire the guard's membership-transition hook: rescale for the
    committed view (`AutoTuner.rescale`: the epoch's process group, the
    epoch-stamped plan, a new train step) and swap the guard's train step
    BEFORE the consensus restore, so the elastic re-pack lands in the
    rescaled plan. Returns the hook (already attached)."""
    def on_change(view):
        tuner.rescale(view)
        guard.ts = tuner.ts
    guard.on_membership_change = on_change
    return on_change


def reenter(cluster, tuner, guard, ckpt_dir: str, hydrate_store=None):
    """Relaunched-rank re-entry: present the newest sidecar's membership
    epoch as "last known", wait for admission, rescale the plan for the
    admitted view, and consensus-restore through `elastic_resume`.
    Returns ``(state, resumed_at_step, last_epoch)``.

    A **scale-from-zero** rank (brand-new scale-up spawn, or a host whose
    disk was lost with it) has no local checkpoints to contribute to the
    consensus restore; with ``hydrate_store`` (an object store holding a
    fleet replica's uploads) it first materializes the newest uploaded
    step locally (`restore_from_object_store`, sha256-reverified), so its
    consensus view intersects the survivors' at that step. A rank that
    was down a LONG time hydrates too — its local newest is far behind
    the fleet, and since the consensus restores the newest step valid on
    EVERY member, rejoining with the stale view alone would drag every
    survivor back to it (observed: a drained rank's backfill rolled a
    200-step fleet back to step 18). Hydration caps the fleet's loss at
    the upload lag instead of the rejoiner's downtime."""
    from dear_pytorch_tpu_torch.utils import checkpoint as ckpt

    steps = ckpt.valid_steps(ckpt_dir)
    if hydrate_store is not None:
        remote = ckpt.remote_steps(hydrate_store)
        if remote and (not steps or remote[0] > steps[0]):
            hydrated = ckpt.restore_from_object_store(
                hydrate_store, ckpt_dir, step=remote[0])
            if hydrated is not None:
                steps = ckpt.valid_steps(ckpt_dir)
    last_epoch = ckpt.read_mem_epoch(ckpt_dir, steps[0]) if steps else None
    view, context = cluster.rejoin(last_epoch)
    tuner.rescale(view)
    guard.ts = tuner.ts
    state, at_step = guard.elastic_resume(context)
    return state, at_step, last_epoch


def run_loop(
    cluster,
    guard,
    pipe,
    state,
    batch_at: Callable[[int], object],
    tracer,
    *,
    rejoining: bool,
    kill: Optional[Tuple[int, int]] = None,
    post: int = 4,
    t_target: Optional[int] = None,
    no_kill_target: Optional[int] = None,
    deadline_s: float = 300.0,
    idle_s: float = 0.1,
):
    """The elastic training loop every worker runs after setup. The
    scheduled victim SIGKILLs itself before attempt ``kill[1]``;
    survivors keep stepping (transitions happen inside ``guard.step``)
    until ``post`` lockstep steps after the relaunch's admission
    (``cluster.rejoins`` observed); a rejoiner enters with ``t_target``
    already set by `reenter`'s caller. With no kill scheduled the loop
    runs to ``no_kill_target`` attempts. The idle sleep keeps the member
    sync cadence slow enough that the leader's rejoin poll isn't racing
    hundreds of checkpoints past the rejoiner's view. Returns
    ``(state, metrics)``; raises `TimeoutError` if the target is never
    reached within ``deadline_s``."""
    kill_rank, kill_at = kill if kill is not None else (None, None)
    deadline = time.monotonic() + deadline_s
    m = {}
    while True:
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"rank {cluster.rank} never reached its target "
                f"(epoch {cluster.epoch})")
        i = guard.steps_seen
        if not rejoining and kill_rank == cluster.rank and i + 1 == kill_at:
            os.kill(os.getpid(), signal.SIGKILL)  # a lost host, abruptly
        pipe.next()  # the guarded input stream advances once per step
        state, m = guard.step(state, batch_at(i))
        if kill_rank is None:
            t_target = no_kill_target
        elif (t_target is None
                and tracer.counters().get("cluster.rejoins", 0) >= 1):
            t_target = guard.steps_seen + post  # admission landed HERE
        if t_target is not None and guard.steps_seen >= t_target:
            return state, m
        if t_target is None:
            time.sleep(idle_s)


def run_autoscale_loop(
    cluster,
    guard,
    pipe,
    state,
    batch_at: Callable[[int], object],
    *,
    rejoining: bool,
    target_epoch: int,
    post: int = 3,
    kill: Optional[Tuple[int, int, int]] = None,
    deadline_s: float = 300.0,
    idle_s: float = 0.1,
):
    """The autoscaling worker loop (`scripts.chaos_check --autoscale`).

    Differences from `run_loop`: termination is **epoch-driven** —
    membership epochs commit inside the lockstep health sync, so every
    member observes ``cluster.epoch >= target_epoch`` at the SAME attempt
    and the ``post``-step runout stays lockstep without any counter
    heuristics (a rejoiner admitted at the target epoch anchors on the
    admission ack's cadence instead). ``kill`` is
    ``(rank, after_epoch, extra_steps)``: the victim SIGKILLs itself
    ``extra_steps`` attempts after it first observes ``after_epoch``. A
    ``preempted`` metric (the supervisor's SIGTERM drain → planned
    shrink → emergency save) exits the loop cleanly — the policy
    backfills the rank, which re-enters through `reenter`."""
    kill_rank, kill_epoch, kill_extra = kill if kill else (None, None, 0)
    kill_at = None
    deadline = time.monotonic() + deadline_s
    t_target = (guard.steps_seen + post
                if rejoining and cluster.epoch >= target_epoch else None)
    m = {}
    while True:
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"rank {cluster.rank} never reached epoch {target_epoch} "
                f"(at epoch {cluster.epoch})")
        i = guard.steps_seen
        if not rejoining and kill_rank == cluster.rank:
            if kill_at is None and cluster.epoch >= kill_epoch:
                kill_at = i + 1 + kill_extra
            if kill_at is not None and i + 1 == kill_at:
                os.kill(os.getpid(), signal.SIGKILL)  # abrupt host loss
        pipe.next()  # the guarded input stream advances once per step
        state, m = guard.step(state, batch_at(i))
        if m.get("preempted"):
            return state, m  # drained: clean exit inside the grace window
        if t_target is None and cluster.epoch >= target_epoch:
            t_target = guard.steps_seen + post
        if t_target is not None and guard.steps_seen >= t_target:
            return state, m
        if t_target is None:
            time.sleep(idle_s)
