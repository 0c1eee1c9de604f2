"""Capacity-driven supervisor scale policy — the port of
``dear_pytorch_tpu/resilience/scale.py``, a copy with its imports
retargeted.

`launch/supervisor.py` keeps dead ranks alive; this module decides how
many ranks there should BE. A `ScalePolicy` consumes:

  - **external capacity hints** — a watched JSON file (``--capacity-file``
    / ``DEAR_CAPACITY_FILE``), the env-contract stand-in for a spot-pool
    or cluster-autoscaler API::

        {"target_world": 3}              # scale the fleet to 3 ranks
        {"target_world": 3, "drain": [1]}  # ...and SIGTERM-drain rank 1

    A drained rank gets the platform-shaped exit: SIGTERM, the
    `resilience.preempt` grace window (``DEAR_PREEMPT_GRACE_S``), a
    **planned** membership shrink announced through the elastic health
    sync (`resilience.membership` ``draining=True``) — then the policy
    backfills it while capacity still wants the larger world.

  - **run-health verdicts** — `observability.anomaly` anomaly kinds fed
    via `note_anomaly` (the supervisor forwards what its workers export):
    a burst of anomalies vetoes scale-UP decisions until the fleet is
    quiet again (growing a sick fleet just spreads the sickness).

Decisions carry **hysteresis**: a hint must hold stable for
``hysteresis_s`` before it is acted on, and successive decisions are
spaced by at least the same dwell — a flapping spot pool cannot thrash
the membership through admit/evict churn (each transition costs a
consensus epoch + plan rescale + rollback window). Every acted-on
decision counts ``supervisor.policy_decisions`` and lands in
``decisions`` for gates to assert on.

Pure host-side stdlib (no jax): importable by the jax-free supervisor
parent process.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import List, NamedTuple, Optional, Tuple

from dear_pytorch_tpu_torch.observability import tracer as _telemetry

logger = logging.getLogger("dear_pytorch_tpu_torch")

__all__ = ["CapacityHint", "ScaleDecision", "ScalePolicy",
           "read_capacity_file", "CAPACITY_FILE_ENV", "HYSTERESIS_ENV"]

#: The watched capacity-hint file (the spot-pool API stand-in).
CAPACITY_FILE_ENV = "DEAR_CAPACITY_FILE"
#: Seconds a hint must hold (and decisions must be spaced by).
HYSTERESIS_ENV = "DEAR_SCALE_HYSTERESIS_S"


class CapacityHint(NamedTuple):
    """One parsed capacity-file observation."""

    target_world: Optional[int]   # desired fleet size (None = no opinion)
    drain: Tuple[int, ...]        # ranks the pool wants SIGTERM-drained
    raw: dict


class ScaleDecision(NamedTuple):
    """One acted-on policy decision (what the supervisor should do NOW)."""

    kind: str                     # "scale_up" | "scale_down" | "drain"
    target_world: int
    ranks: Tuple[int, ...] = ()   # drain victims (drain/scale_down)
    count: int = 0                # ranks to add (scale_up)


def read_capacity_file(path: Optional[str]) -> Optional[CapacityHint]:
    """Tolerant read of the capacity-hint JSON (None when absent or torn
    mid-write — the next poll sees the committed value)."""
    if not path:
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    target = doc.get("target_world")
    drain = doc.get("drain") or ()
    try:
        target = None if target is None else int(target)
        drain = tuple(sorted(int(r) for r in drain))
    except (TypeError, ValueError):
        return None
    return CapacityHint(target_world=target, drain=drain, raw=doc)


class ScalePolicy:
    """Hysteresis-gated scale decisions from capacity hints + health.

    Drive `decide` on the supervisor's poll cadence with the live fleet
    state; it returns at most one `ScaleDecision` per call (None = hold).
    The policy is deliberately stateful-but-replayable: ``decisions``
    records everything acted on, in order.
    """

    def __init__(
        self,
        *,
        capacity_file: Optional[str] = None,
        min_world: int = 1,
        max_world: Optional[int] = None,
        hysteresis_s: Optional[float] = None,
        anomaly_veto_s: float = 10.0,
        clock=time.monotonic,
    ):
        if capacity_file is None:
            capacity_file = os.environ.get(CAPACITY_FILE_ENV, "") or None
        self.capacity_file = capacity_file
        self.min_world = max(int(min_world), 1)
        self.max_world = None if max_world is None else int(max_world)
        if hysteresis_s is None:
            raw = os.environ.get(HYSTERESIS_ENV, "").strip()
            hysteresis_s = float(raw) if raw else 5.0
        self.hysteresis_s = float(hysteresis_s)
        self.anomaly_veto_s = float(anomaly_veto_s)
        self._clock = clock
        self.decisions: List[ScaleDecision] = []
        self._hint_value: Optional[int] = None
        self._hint_since: Optional[float] = None
        self._last_decision_t: Optional[float] = None
        self._last_anomaly_t: Optional[float] = None
        self._drained: set = set()   # drain hints already acted on

    # -- inputs --------------------------------------------------------------

    def note_anomaly(self, kind: str = "", detail: Optional[dict] = None,
                     ) -> None:
        """Feed one `observability.anomaly` verdict (the supervisor
        forwards worker-exported ``health.*`` events): scale-UP is vetoed
        while the fleet is within ``anomaly_veto_s`` of an anomaly."""
        del kind, detail
        self._last_anomaly_t = self._clock()

    def _anomaly_vetoed(self, now: float) -> bool:
        return (self._last_anomaly_t is not None
                and now - self._last_anomaly_t < self.anomaly_veto_s)

    # -- the decision --------------------------------------------------------

    def _clamp(self, world: int) -> int:
        world = max(world, self.min_world)
        if self.max_world is not None:
            world = min(world, self.max_world)
        return world

    def _record(self, decision: ScaleDecision, now: float) -> ScaleDecision:
        self._last_decision_t = now
        self.decisions.append(decision)
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.count("supervisor.policy_decisions")
            tr.event("supervisor.policy_decision", kind=decision.kind,
                     target_world=decision.target_world,
                     ranks=",".join(map(str, decision.ranks)),
                     count=decision.count)
        logger.warning("scale policy: %s -> world %d (ranks %s, +%d)",
                       decision.kind, decision.target_world,
                       list(decision.ranks), decision.count)
        return decision

    def decide(self, *, live_world: int, live_ranks: Tuple[int, ...] = (),
               draining: Tuple[int, ...] = (), quarantined: int = 0,
               ) -> Optional[ScaleDecision]:
        """One policy tick. ``live_world`` counts running ranks (draining
        included), ``draining`` the ranks already being drained, and
        ``quarantined`` the hosts held in the SDC quarantine ledger
        (`resilience.sdc`): each one shrinks the usable pool, so the
        capacity hint is capped — asking a spot pool for machines the SDC
        sentinel has impounded just thrashes admit/evict churn against
        hosts that will be refused a seat. Returns the single action the
        supervisor should take now, or None."""
        now = self._clock()
        hint = read_capacity_file(self.capacity_file)
        if hint is None:
            return None
        # the acted-on-drain latch is EDGE-triggered on the hint: it
        # persists while the file keeps listing the rank (a stale file
        # must not re-drain the backfill forever), and clears once the
        # rank drops out of the list — so a pool that reclaims the same
        # rank again later (remove, then re-add) is honored, instead of
        # being ignored for the policy's lifetime
        self._drained &= set(hint.drain)
        # explicit drain requests: acted on once per listing,
        # hysteresis-free (a spot reclaim is a deadline, not a preference)
        victims = tuple(r for r in hint.drain
                        if r in live_ranks and r not in draining
                        and r not in self._drained)
        if victims:
            self._drained.update(victims)
            return self._record(ScaleDecision(
                kind="drain", target_world=self._clamp(
                    hint.target_world if hint.target_world is not None
                    else live_world),
                ranks=victims), now)
        if hint.target_world is None:
            return None
        target = self._clamp(hint.target_world)
        # quarantined hosts are out of the pool until probation readmits
        # them: cap the usable world BEFORE hysteresis, so the capped
        # value is what must hold stable (a readmission mid-dwell simply
        # restarts the clock at the larger target)
        if quarantined > 0:
            ceiling = (self.max_world if self.max_world is not None
                       else target) - int(quarantined)
            capped = max(min(target, ceiling), self.min_world)
            if capped < target:
                logger.warning(
                    "scale policy: target %d capped to %d — %d host(s) "
                    "quarantined in the SDC ledger", target, capped,
                    quarantined)
                target = capped
        # hysteresis leg 1: the hint must hold stable
        if target != self._hint_value:
            self._hint_value, self._hint_since = target, now
            return None
        since = self._hint_since if self._hint_since is not None else now
        if now - since < self.hysteresis_s:
            return None
        # hysteresis leg 2: dwell between acted-on decisions
        if (self._last_decision_t is not None
                and now - self._last_decision_t < self.hysteresis_s):
            return None
        # a draining rank still COUNTS until it exits: its replacement is
        # backfilled after the clean drain (stable rank identity), not
        # pre-spawned next to it (which would mint a spurious new rank)
        effective = live_world
        if target > effective:
            if self._anomaly_vetoed(now):
                logger.warning(
                    "scale policy: scale-up to %d vetoed — fleet reported "
                    "a health anomaly within %.0fs", target,
                    self.anomaly_veto_s)
                return None
            return self._record(ScaleDecision(
                kind="scale_up", target_world=target,
                count=target - effective), now)
        if target < effective:
            # capacity-down without an explicit victim list: drain the
            # highest live ranks (newest capacity first — LIFO keeps the
            # low stable ranks, and the leader, in place)
            victims = tuple(sorted(
                (r for r in live_ranks if r not in draining),
                reverse=True)[: effective - target])
            if not victims:
                return None
            self._drained.update(victims)
            return self._record(ScaleDecision(
                kind="scale_down", target_world=target, ranks=victims), now)
        return None
