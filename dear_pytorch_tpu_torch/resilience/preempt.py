"""Preemption handling: turn SIGTERM into a checkpointed, resumable exit —
the port of ``dear_pytorch_tpu/resilience/preempt.py``.

TPU pods get maintenance-preempted with a grace window; the reference
simply dies (whole-job retry by its batch driver, losing everything since
the last manual save). `PreemptionHandler` installs a SIGTERM handler that
*only sets a flag* — signal-safe, no I/O in the handler — and the training
loop (`utils.guard.GuardedTrainer.step` checks it every step) performs a
synchronous emergency save through `utils.checkpoint` at the next step
boundary, then surfaces ``preempted=True`` so the loop can exit cleanly.
A relaunch resumes from that save: zero loss of progress inside one
checkpoint interval.

The handler chains to any previously-installed SIGTERM handler on exit
(context-manager protocol restores it), and `resilience.inject`'s
``preempt`` fault delivers a real ``os.kill(getpid(), SIGTERM)`` so this
path is exercised in CI, not just in production.

Elastic runs route preemption through the epoch machinery: the signal
records the membership epoch it landed under (``epoch_at_signal``), the
flag propagates to every *current member* via the epoch-scoped health
sync (`resilience.membership.ElasticCluster.health_check`'s
``any_preempted``), and the cooperative emergency save is stamped with
that epoch in its checkpoint sidecar (`utils.checkpoint`'s
``mem_epoch``) — which is exactly the "last known epoch" a relaunched
rank later presents to the rejoin protocol.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Optional

logger = logging.getLogger("dear_pytorch_tpu_torch")

__all__ = ["PreemptionHandler", "GRACE_ENV"]

#: Known SIGTERM-to-SIGKILL grace window in seconds (spot/preemptible
#: platforms publish one — e.g. 30s on GCE spot, 120s on TPU maintenance).
#: When set, the handler stamps a wall-clock **deadline** at signal time;
#: `remaining()` is the budget the emergency save and the planned-shrink
#: announcement (`resilience.membership` ``draining=True``) must fit in —
#: the loop budgets against it instead of racing the kill blind.
GRACE_ENV = "DEAR_PREEMPT_GRACE_S"


class PreemptionHandler:
    """Flag-setting signal handler; install via ``with`` (or `install` /
    `restore`). Thread-safe to poll from any thread; signals are only
    *delivered* to the main thread, which is where `install` must run."""

    def __init__(self, signals=(signal.SIGTERM,),
                 grace_s: Optional[float] = None):
        self._signals = tuple(signals)
        self._prev: dict = {}
        self._event = threading.Event()
        self.count = 0
        self._installed = False
        #: membership epoch the (first) signal landed under — None until a
        #: signal arrives, and on non-elastic runs
        self.epoch_at_signal: Optional[int] = None
        #: resolved at install() time, NEVER in the handler: a module
        #: import inside a signal handler can block on the import lock
        #: (or observe a half-initialized module) — the handler may only
        #: call this pre-bound function (a weakref read)
        self._epoch_fn = None
        #: the platform's SIGTERM->SIGKILL grace window: explicit arg wins,
        #: else DEAR_PREEMPT_GRACE_S, else unknown (None). Resolved HERE —
        #: not in the handler — so the signal path stays allocation-free.
        if grace_s is None:
            raw = os.environ.get(GRACE_ENV, "").strip()
            grace_s = float(raw) if raw else None
        self.grace_s = grace_s
        #: monotonic deadline stamped by the (first) signal; None until it
        #: arrives or when no grace window is configured
        self.deadline_monotonic: Optional[float] = None

    # -- signal plumbing -----------------------------------------------------

    def _on_signal(self, signum, frame) -> None:  # noqa: ARG002
        self.count += 1
        if self.deadline_monotonic is None and self.grace_s is not None:
            # stamp BEFORE setting the flag: a poller that sees
            # `requested` must be able to read a coherent deadline
            self.deadline_monotonic = time.monotonic() + self.grace_s
        self._event.set()
        if self.epoch_at_signal is None and self._epoch_fn is not None:
            try:
                self.epoch_at_signal = self._epoch_fn()
            except Exception:
                self.epoch_at_signal = None
        # no I/O here beyond logging: the actual save happens at the next
        # step boundary, on the training thread, where device state is
        # coherent
        logger.warning(
            "preempt: received signal %d (count %d, membership epoch %s, "
            "grace %s); emergency checkpoint at the next step boundary",
            signum, self.count, self.epoch_at_signal,
            "unknown" if self.grace_s is None else f"{self.grace_s:.0f}s",
        )

    def install(self) -> "PreemptionHandler":
        if not self._installed:
            try:
                from dear_pytorch_tpu_torch.resilience.membership import (
                    current_epoch,
                )

                self._epoch_fn = current_epoch
            except Exception:
                self._epoch_fn = None
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._on_signal)
            self._installed = True
        return self

    def restore(self) -> None:
        if self._installed:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._prev.clear()
            self._installed = False

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.restore()

    # -- loop-facing surface -------------------------------------------------

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def remaining(self) -> Optional[float]:
        """Seconds left in the platform's grace window (never negative);
        None when no signal has arrived or no `DEAR_PREEMPT_GRACE_S` /
        ``grace_s`` budget is configured. The emergency-save path logs it
        and a drain announcement can size its sync wait against it."""
        if self.deadline_monotonic is None:
            return None
        return max(self.deadline_monotonic - time.monotonic(), 0.0)

    def clear(self) -> None:
        """Acknowledge a handled preemption (tests; multi-phase loops that
        checkpoint and keep going until the platform actually kills them).
        The grace deadline re-arms with the next signal."""
        self._event.clear()
        self.deadline_monotonic = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)
