"""Per-step flight recorder: the last N steps of context, always on.

The port of ``dear_pytorch_tpu/observability/flight.py``, its imports retargeted
onto the port's tracer.

Chrome traces and JSONL event logs answer "what happened" only after a
human opens them; a hung collective or a guard rollback needs the answer
*in the failure report itself*. The flight recorder is a fixed-size ring
of per-step records — step number, wall-clock cadence, step time, checked
loss, telemetry-counter deltas, the live-span fingerprint, and the fusion
plan epoch — cheap enough to stay enabled in production (one dict of
deltas per step, zero I/O, bounded memory) and dumped whenever something
goes wrong:

  - `resilience.watchdog.StepWatchdog` attaches the ring tail to its
    forensic report (so a hang names the exact steps leading up to it),
  - `utils.guard.GuardedTrainer` dumps it on every rollback,
  - `observability.aggregate` summarizes the ring head into the per-rank
    digest that rides the cluster health exchange.

The cost contract mirrors the tracer's (docs/OBSERVABILITY.md):
``get_recorder()`` is a module-dict lookup, ``.enabled`` a class-attribute
read, and instrumented sites gate on it —

    fl = get_recorder()
    if fl.enabled:
        fl.record(step, step_time_s=dt, loss=loss)

so a disabled recorder costs two lookups per step
(`scripts/check_telemetry_overhead.py` asserts the budget). Enablement
follows the tracer by default: the ring is live whenever ``DEAR_TELEMETRY``
is, ``DEAR_FLIGHT=0`` forces it off, and ``DEAR_FLIGHT=<capacity>`` (or
``1``) forces it on — flight recording alone never allocates a tracer.

Stdlib-only at module level; the tracer and redaction imports resolve
lazily so the hot-path modules stay loadable standalone (no torch).
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Callable, Optional

__all__ = [
    "FLIGHT_ENV", "FlightRecorder", "NullFlightRecorder",
    "get_recorder", "set_recorder", "configure", "disable",
    "set_epoch_provider",
]

# Membership-epoch stamping: the resilience layer (which imports
# observability, never the reverse) registers a zero-arg callable here;
# every subsequent flight row carries its value as ``mem_epoch``, so a
# forensic dump shows WHICH membership the failing steps ran under
# (`resilience.membership.ElasticCluster` registers `current_epoch`).
_epoch_provider: Optional[Callable[[], Optional[int]]] = None


def set_epoch_provider(fn: Optional[Callable[[], Optional[int]]]) -> None:
    global _epoch_provider
    _epoch_provider = fn


def _membership_epoch() -> Optional[int]:
    if _epoch_provider is None:
        return None
    try:
        return _epoch_provider()
    except Exception:  # forensics must never crash the step path
        return None

#: falsy ('0'/'false'/'no'/'off') -> disabled; '1'/'true'/'yes'/'on' ->
#: enabled at the default capacity; an integer >= 2 -> enabled with that
#: ring capacity; unset/'' -> enabled iff the telemetry tracer is.
FLIGHT_ENV = "DEAR_FLIGHT"
DEFAULT_CAPACITY = 64


def _global_tracer():
    # lazy: keeps this module importable without the package (and without
    # torch) for the standalone overhead probe
    from dear_pytorch_tpu_torch.observability import tracer as T

    return T.get_tracer()


class FlightRecorder:
    """Bounded ring of per-step records; thread-safe (the watchdog thread
    reads while the train thread writes)."""

    enabled = True

    def __init__(self, capacity: int = DEFAULT_CAPACITY, *,
                 clock: Callable[[], float] = time.perf_counter,
                 tracer=None):
        self.capacity = max(int(capacity), 2)
        self._clock = clock
        self._t0 = clock()
        self._tracer = tracer  # None -> the process-global tracer, lazily
        self._lock = threading.Lock()
        self._ring: list[dict] = [None] * self.capacity  # type: ignore
        self._next = 0
        self.recorded = 0          # total records ever written
        self._last_ctr: dict[str, float] = {}

    # -- writing -------------------------------------------------------------

    def record(self, step: int, *, step_time_s: Optional[float] = None,
               loss: Optional[float] = None,
               plan_epoch: Optional[int] = None, **extra) -> None:
        """Append one step record. Counter deltas are computed against the
        PREVIOUS record (only changed counters are kept, so a record stays
        small no matter how many counters exist); the live-span fingerprint
        names what the host was inside of at record time."""
        tr = self._tracer if self._tracer is not None else _global_tracer()
        delta: dict[str, float] = {}
        spans = ""
        if tr.enabled:
            ctr = tr.counters()
            last = self._last_ctr
            delta = {k: round(v - last.get(k, 0), 6)
                     for k, v in ctr.items() if v != last.get(k, 0)}
            self._last_ctr = ctr
            spans = ";".join(s["name"] for s in tr.live_spans())
            if plan_epoch is None:
                # plan/bucket epoch: which fusion plan generation this
                # step ran under (initial builds + tuner rebuilds)
                epoch = ctr.get("dear.plan_builds", 0) + ctr.get(
                    "autotune.rebuilds", 0)
                plan_epoch = int(epoch) if epoch else None
        rec = {
            "step": int(step),
            "t_s": round(self._clock() - self._t0, 6),
        }
        if step_time_s is not None:
            rec["step_time_s"] = round(float(step_time_s), 6)
        if loss is not None:
            # strict-JSON safe: a NaN loss is exactly what a rollback dump
            # carries, and bare NaN tokens break downstream parsers
            loss = float(loss)
            rec["loss"] = loss if math.isfinite(loss) else repr(loss)
        if plan_epoch is not None:
            rec["plan_epoch"] = int(plan_epoch)
        mem_epoch = _membership_epoch()
        if mem_epoch is not None:
            rec["mem_epoch"] = int(mem_epoch)
        if delta:
            rec["counters_delta"] = delta
        if spans:
            rec["live_spans"] = spans
        if extra:
            rec.update(extra)
        with self._lock:
            self._ring[self._next] = rec
            self._next = (self._next + 1) % self.capacity
            self.recorded += 1

    # -- reading -------------------------------------------------------------

    def records(self) -> list[dict]:
        """Ring contents oldest -> newest (shallow copies)."""
        with self._lock:
            if self.recorded < self.capacity:
                live = self._ring[: self._next]
            else:
                live = self._ring[self._next:] + self._ring[: self._next]
            return [dict(r) for r in live if r is not None]

    def head(self) -> Optional[dict]:
        """The newest record (None when nothing recorded yet)."""
        with self._lock:
            if self.recorded == 0:
                return None
            return dict(self._ring[(self._next - 1) % self.capacity])

    def step_time_stats(self) -> dict:
        """Quantiles of the ring's recorded step times (empty dict when no
        record carried one) — the per-rank digest the cluster aggregation
        exchanges."""
        times = sorted(r["step_time_s"] for r in self.records()
                       if "step_time_s" in r)
        if not times:
            return {}
        n = len(times)

        def q(p: float) -> float:
            return times[min(int(p * n), n - 1)]

        return {
            "n": n,
            "p50_s": round(q(0.50), 6),
            "p90_s": round(q(0.90), 6),
            "max_s": round(times[-1], 6),
            "mean_s": round(sum(times) / n, 6),
        }

    def dump(self, *, env: bool = True) -> dict:
        """JSON-safe forensic dump: the full ring plus (redacted) DEAR_*
        environment context — what the watchdog report and the guard's
        rollback log ship."""
        out = {
            "capacity": self.capacity,
            "recorded": self.recorded,
            "records": self.records(),
        }
        if env:
            from dear_pytorch_tpu_torch.observability import redaction

            out["env"] = redaction.redact_env()
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity  # type: ignore
            self._next = 0
            self.recorded = 0
            self._last_ctr = {}


class NullFlightRecorder:
    """Disabled recorder: every operation is a no-op."""

    enabled = False
    capacity = 0
    recorded = 0

    def record(self, step, **kw) -> None:  # noqa: ARG002
        pass

    def records(self) -> list:
        return []

    def head(self):
        return None

    def step_time_stats(self) -> dict:
        return {}

    def dump(self, *, env: bool = True) -> dict:  # noqa: ARG002
        return {"capacity": 0, "recorded": 0, "records": []}

    def clear(self) -> None:
        pass


_NULL_RECORDER = NullFlightRecorder()
_recorder: Optional[object] = None
#: True when the cached decision merely mirrored tracer enablement
#: (``DEAR_FLIGHT`` unset) — get_recorder() then keeps following the
#: tracer, so `tracer.configure()`/`disable()` AFTER the first resolution
#: still bring the ring up/down in step with telemetry.
_auto_follow = False
_config_lock = threading.Lock()


def get_recorder():
    """The process-global flight recorder (a `NullFlightRecorder` when
    disabled). First call resolves ``DEAR_FLIGHT`` / tracer enablement;
    afterwards this is one module-dict lookup (plus, for the env-unset
    follow-the-tracer case, one enabled-flag compare)."""
    fl = _recorder
    if fl is None:
        return _configure_from_env()
    if _auto_follow and fl.enabled != _global_tracer().enabled:
        return _configure_from_env(refresh=True)
    return fl


def set_recorder(recorder) -> None:
    global _recorder, _auto_follow
    with _config_lock:
        _recorder = recorder
        _auto_follow = False


def configure(capacity: int = DEFAULT_CAPACITY, **kw) -> FlightRecorder:
    """Install a live recorder process-globally and return it."""
    fl = FlightRecorder(capacity, **kw)
    set_recorder(fl)
    return fl


def disable() -> None:
    set_recorder(_NULL_RECORDER)


def _configure_from_env(refresh: bool = False):
    global _recorder, _auto_follow
    with _config_lock:
        if _recorder is not None and not refresh:
            return _recorder
        raw = os.environ.get(FLIGHT_ENV, "").strip().lower()
        _auto_follow = not raw
        if raw in ("0", "false", "no", "off"):
            _auto_follow = False
            _recorder = _NULL_RECORDER
            return _recorder
        capacity = DEFAULT_CAPACITY
        force = bool(raw)
        if raw.isdigit():  # "1" -> on at default; >=2 -> explicit capacity
            capacity = max(int(raw), 2) if int(raw) >= 2 else capacity
        elif raw and raw not in ("true", "yes", "on"):
            # strict, like DEAR_TELEMETRY: a typo'd capacity ('16k',
            # '-5') must not silently come up as a 64-record ring
            raise ValueError(
                f"{FLIGHT_ENV}={raw!r}: use 0/1/true/false or a ring "
                "capacity integer >= 2")
        if force or _global_tracer().enabled:
            _recorder = FlightRecorder(capacity)
        else:
            _recorder = _NULL_RECORDER
        return _recorder
