"""Step watchdog: detect a hung training step and say where it hung — the
port of ``dear_pytorch_tpu/resilience/watchdog.py``.

`utils.guard.GuardedTrainer` can only *log* a slow interval after the step
returns — a truly hung collective (tunnel drop, wedged device RPC, a
deadlocked host thread) never returns, and the reference's answer was an
operator watching mpirun output (SURVEY.md §5). `StepWatchdog` is a
daemon thread fed per-step heartbeats; when no beat arrives within the
deadline it

  1. snapshots the telemetry tracer's OPEN spans (what the host was inside
     of — `observability.tracer.Tracer.live_spans`) and the flight
     recorder's ring (`observability.flight` — the last N steps of
     context, with the redacted DEAR_* environment),
  2. dumps every Python thread's stack via ``faulthandler``,
  3. emits a ``watchdog.timeout`` telemetry event + counter, and
  4. invokes ``on_timeout(report)`` — by default logging the last-good
     step and hard-exiting (``os._exit``), which fires even while the main
     thread is stuck inside a C call a signal handler could never
     interrupt.

Heartbeats carry arbitrary context (``beat(step=n, last_good_step=k)``)
that lands in the report, so the abort message names the last checkpointed
step a relaunch will resume from. ``pause()`` disarms between phases
(deliberate idle is not a hang).
"""

from __future__ import annotations

import faulthandler
import logging
import os
import sys
import threading
import time
from types import MappingProxyType
from typing import Callable, Mapping, NamedTuple, Optional, Sequence

from dear_pytorch_tpu_torch.observability import tracer as _telemetry

logger = logging.getLogger("dear_pytorch_tpu_torch")

__all__ = ["WatchdogReport", "StepWatchdog"]


class WatchdogReport(NamedTuple):
    """What the watchdog knew when it fired."""

    name: str
    waited_s: float          # time since the last heartbeat
    deadline_s: float
    beat_info: dict          # kwargs of the last beat (step, last_good_step)
    live_spans: list         # open tracer spans at firing time
    process_index: int = 0   # which rank's dump this is (multi-host logs)
    faults: str = ""         # active DEAR_FAULTS schedule, if any
    # immutable defaults: NamedTuple defaults are class-level shared
    # instances, so a mutable [] / {} here would let one report's edits
    # leak into every later default-constructed report
    flight: Sequence = ()           # flight ring (last N step records)
    env: Mapping = MappingProxyType({})  # redacted DEAR_* env context
    mem_epoch: Optional[int] = None  # elastic membership epoch at firing
    #                                  time (None outside elastic runs)


def _process_index() -> int:
    """This process's rank for dump headers (the shared tolerant lookup:
    the watchdog must never crash while reporting a crash)."""
    return _telemetry.process_index()


def _active_faults() -> str:
    from dear_pytorch_tpu_torch.resilience.inject import FAULT_ENV

    return os.environ.get(FAULT_ENV, "").strip()


class StepWatchdog:
    """Deadline on the gap between heartbeats; see the module docstring.

    Usage::

        with StepWatchdog(deadline_s=300) as dog:
            for batch in batches:
                state, m = trainer.step(state, batch)
                dog.beat(step=trainer.steps_seen,
                         last_good_step=trainer._last_good_step)

    The deadline only arms at the first ``beat()`` (startup compile time
    does not count against it unless you beat before it). ``on_timeout``
    replaces the default abort — after a custom handler runs, the watchdog
    pauses itself until the next beat, so one hang fires once.
    """

    def __init__(
        self,
        deadline_s: float,
        *,
        on_timeout: Optional[Callable[[WatchdogReport], None]] = None,
        poll_s: Optional[float] = None,
        dump_stacks: bool = True,
        exit_code: int = 13,
        name: str = "watchdog",
    ):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.name = name
        self._on_timeout = on_timeout
        self._dump_stacks = dump_stacks
        self._exit_code = exit_code
        self._poll_s = (max(min(self.deadline_s / 4.0, 1.0), 0.01)
                        if poll_s is None else float(poll_s))
        self._lock = threading.Lock()
        self._last_beat: Optional[float] = None  # None = paused/unarmed
        self._beat_info: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = 0
        self.kicked = 0
        self.last_report: Optional[WatchdogReport] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "StepWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name=f"dear-{self.name}", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(self._poll_s * 4, 1.0))
            self._thread = None

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- heartbeats ----------------------------------------------------------

    def beat(self, **info) -> None:
        """Record a heartbeat; ``info`` lands in a later report verbatim."""
        with self._lock:
            self._last_beat = time.monotonic()
            if info:
                self._beat_info = info

    def pause(self) -> None:
        """Disarm until the next `beat` (idle between phases is not a
        hang)."""
        with self._lock:
            self._last_beat = None

    # -- the poll thread -----------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            with self._lock:
                last, info = self._last_beat, dict(self._beat_info)
            if last is None:
                continue
            waited = time.monotonic() - last
            if waited <= self.deadline_s:
                continue
            self._fire(waited, info)

    def _make_report(self, waited: float, info: dict) -> WatchdogReport:
        from dear_pytorch_tpu_torch.observability import flight as _flight
        from dear_pytorch_tpu_torch.observability import redaction as _redaction

        tr = _telemetry.get_tracer()
        live = tr.live_spans() if tr.enabled else []
        # tolerant context gathering: the watchdog must never crash while
        # reporting a crash — e.g. a typo'd DEAR_FLIGHT raises ValueError
        # on FIRST recorder resolution, which may well happen right here
        try:
            ring = _flight.get_recorder().records()
        except Exception:
            ring = []
        try:
            env = _redaction.redact_env()
        except Exception:
            env = {}
        try:
            from dear_pytorch_tpu_torch.resilience import (
                membership as _membership)

            mem_epoch = _membership.current_epoch()
        except Exception:
            mem_epoch = None
        return WatchdogReport(
            name=self.name, waited_s=waited, deadline_s=self.deadline_s,
            beat_info=info, live_spans=live,
            process_index=_process_index(), faults=_active_faults(),
            flight=ring, env=env, mem_epoch=mem_epoch,
        )

    def _dump(self, report: WatchdogReport, cause: str) -> None:
        """The forensic dump, correlatable across ranks: the header names
        this process's rank and the active fault schedule, so interleaved
        multi-host hang logs can be lined up by rank and replayed."""
        if not self._dump_stacks:
            return
        epoch = ("" if report.mem_epoch is None
                 else f" epoch={report.mem_epoch}")
        sys.stderr.write(
            f"\n+++ {report.name} [rank {report.process_index}]{epoch} "
            f"faults={report.faults or '-'}: {cause} — thread stacks "
            "follow +++\n"
        )
        faulthandler.dump_traceback(file=sys.stderr)
        if report.flight:
            # the last N steps of context (flight ring): what the run was
            # doing, step by step, before it hung. One JSON line so
            # multi-rank logs stay machine-separable; env context is
            # already redacted by _make_report.
            import json

            sys.stderr.write(
                f"+++ {report.name} [rank {report.process_index}] flight "
                f"ring ({len(report.flight)} records) +++\n"
            )
            sys.stderr.write(json.dumps(
                {"flight": list(report.flight),
                 "env": dict(report.env)}) + "\n")
        sys.stderr.flush()

    def _fire(self, waited: float, info: dict) -> None:
        tr = _telemetry.get_tracer()
        report = self._make_report(waited, info)
        live = report.live_spans
        self.fired += 1
        self.last_report = report
        if tr.enabled:
            tr.count("watchdog.timeouts")
            tr.event("watchdog.timeout", waited_s=round(waited, 3),
                     deadline_s=self.deadline_s,
                     rank=report.process_index,
                     open_spans=";".join(s["name"] for s in live)[:200],
                     **{k: v for k, v in info.items()
                        if isinstance(v, (int, float, str))})
        logger.critical(
            "%s [rank %d]: no heartbeat for %.1fs (deadline %.1fs); last "
            "beat: %s; open telemetry spans: %s; active faults: %s",
            self.name, report.process_index, waited, self.deadline_s,
            info or "never detailed",
            [s["name"] for s in live] or "none (telemetry off?)",
            report.faults or "none",
        )
        self._dump(report, "hung step")
        # one hang fires once; a later beat re-arms
        with self._lock:
            self._last_beat = None
        if self._on_timeout is not None:
            self._on_timeout(report)
        else:
            last_good = info.get("last_good_step")
            logger.critical(
                "%s: aborting; resume from checkpoint step %s",
                self.name, last_good if last_good is not None else "<none>",
            )
            os._exit(self._exit_code)

    def kick(self, reason: str, **info) -> WatchdogReport:
        """Produce the forensic dump IMMEDIATELY, without waiting for the
        heartbeat deadline and without the default abort — the cluster
        layer calls this when a bounded consensus exchange times out
        (dead-peer detection), just before degrading to a crash, so the
        hang evidence (open spans, every thread's stack, rank, fault
        schedule) lands in the log first. Returns the report; never
        exits."""
        with self._lock:
            merged = {**self._beat_info, **info}
        report = self._make_report(0.0, merged)
        self.kicked += 1
        self.last_report = report
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.count("watchdog.kicks")
            tr.event("watchdog.kick", reason=reason,
                     rank=report.process_index,
                     **{k: v for k, v in merged.items()
                        if isinstance(v, (int, float, str))})
        logger.critical(
            "%s [rank %d]: kicked (%s); last beat: %s; active faults: %s",
            self.name, report.process_index, reason,
            merged or "never detailed", report.faults or "none",
        )
        self._dump(report, reason)
        return report
