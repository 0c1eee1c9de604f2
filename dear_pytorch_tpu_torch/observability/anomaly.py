"""Online run-health anomaly detection + the offline bench-regression gate.

The port of ``dear_pytorch_tpu/observability/anomaly.py``, its imports retargeted
onto the port's tracer.

The telemetry layer records what happened; this module decides whether it
is *wrong*, while the run is alive:

  - **step-time spike** — EWMA mean/variance of the checked per-step wall
    time; a sample more than ``z_threshold`` deviations above the mean
    (with a relative floor, so a dead-quiet baseline cannot make noise
    infinitely significant) raises ``health.step_time_spike``.
  - **loss spike / plateau** — a non-finite or EWMA-outlier loss raises
    ``health.loss_spike``; a window whose relative loss range collapses
    below ``plateau_rel`` raises ``health.loss_plateau`` (fired once per
    plateau, re-armed when the loss moves again).
  - **input-pipeline stall** — any growth in the runtime pipeline's stall
    counters (``pipeline.stall_timeouts`` / ``pipeline.stalls``) between
    observations raises ``health.input_stall``.
  - **MFU drop** — achieved MFU falling more than ``mfu_drop_frac`` below
    the best of the rolling window raises ``health.mfu_drop``.

Every detection increments its ``health.*`` counter and the roll-up
``health.anomalies``, emits one tracer event, and invokes the optional
``on_anomaly(kind, detail)`` hook — which is how a caller escalates:
`utils.guard.GuardedTrainer` kicks the step watchdog's forensic dump when
``DEAR_HEALTH_KICK=1``, and an autotuner harness can call
``Tuner.mark_infeasible`` to poison the active trial.

The **bench-regression gate** (`compare_bench`, CLI:
``scripts/bench_gate.py``) is the same idea offline: compare a fresh
`bench.py` contract JSON against a pinned baseline and fail on any
``> tolerance`` throughput regression — turning the BENCH_r*.json history
from a human-read artifact into an automated check.

Stdlib-only (no torch): detectors run on host scalars the caller already
fetched; nothing here touches devices.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

__all__ = [
    "Ewma", "AnomalyMonitor", "bench_metrics", "compare_bench",
]


class Ewma:
    """Exponentially-weighted mean/variance with a z-score query."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self.mean: Optional[float] = None
        self.var = 0.0
        self.n = 0

    def update(self, x: float) -> None:
        self.n += 1
        if self.mean is None:
            self.mean = x
            return
        d = x - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)

    def z(self, x: float, *, rel_floor: float = 0.05) -> float:
        """Deviations of ``x`` above the mean. The std floor
        (``rel_floor × |mean|``) keeps a near-constant baseline from
        flagging measurement noise as infinitely significant."""
        if self.mean is None:
            return 0.0
        std = math.sqrt(max(self.var, 0.0))
        floor = max(abs(self.mean) * rel_floor, 1e-12)
        return (x - self.mean) / max(std, floor)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    return float(raw) if raw else default


class AnomalyMonitor:
    """Online detectors over the values the guard/runner already holds.

    Call ``observe(step=..., step_time_s=..., loss=..., counters=...,
    mfu=...)`` on the check cadence; every argument is optional — a
    detector without its input simply stays quiet. Returns the list of
    anomaly kinds detected at this observation.
    """

    STALL_COUNTERS = ("pipeline.stall_timeouts", "pipeline.stalls")

    def __init__(
        self,
        *,
        z_threshold: float = 4.0,
        warmup: int = 8,
        ewma_alpha: float = 0.2,
        plateau_window: int = 24,
        plateau_rel: float = 1e-4,
        mfu_drop_frac: float = 0.25,
        mfu_window: int = 16,
        on_anomaly: Optional[Callable[[str, dict], None]] = None,
        tracer=None,
    ):
        self.z_threshold = float(z_threshold)
        self.warmup = max(int(warmup), 1)
        self.plateau_window = max(int(plateau_window), 2)
        self.plateau_rel = float(plateau_rel)
        self.mfu_drop_frac = float(mfu_drop_frac)
        self.mfu_window = max(int(mfu_window), 2)
        self.on_anomaly = on_anomaly
        self._tracer = tracer
        self._step_time = Ewma(ewma_alpha)
        self._loss = Ewma(ewma_alpha)
        self._losses: list[float] = []
        self._mfus: list[float] = []
        self._plateau_armed = True
        self._last_stalls: Optional[float] = None
        self.anomalies: list[dict] = []   # every detection, for reports

    @classmethod
    def from_env(cls, **overrides) -> "AnomalyMonitor":
        """Thresholds from ``DEAR_HEALTH_*`` env knobs (see
        docs/OBSERVABILITY.md); explicit keyword overrides win."""
        kw = dict(
            z_threshold=_env_float("DEAR_HEALTH_Z", 4.0),
            warmup=int(_env_float("DEAR_HEALTH_WARMUP", 8)),
            plateau_window=int(_env_float("DEAR_HEALTH_PLATEAU_STEPS", 24)),
            plateau_rel=_env_float("DEAR_HEALTH_PLATEAU_REL", 1e-4),
            mfu_drop_frac=_env_float("DEAR_HEALTH_MFU_DROP", 0.25),
        )
        kw.update(overrides)
        return cls(**kw)

    @staticmethod
    def enabled_by_env() -> bool:
        """Anomaly detection is opt-out (`DEAR_HEALTH=0` disables); it
        only ever runs where telemetry is already enabled."""
        return os.environ.get("DEAR_HEALTH", "").strip().lower() not in (
            "0", "false", "no", "off")

    # -- internals -----------------------------------------------------------

    def _tr(self):
        if self._tracer is not None:
            return self._tracer
        from dear_pytorch_tpu_torch.observability import tracer as T

        return T.get_tracer()

    def _raise(self, kind: str, step: Optional[int], **detail) -> str:
        record = {"kind": kind, "step": step, **detail}
        self.anomalies.append(record)
        tr = self._tr()
        if tr.enabled:
            tr.count(f"health.{kind}")
            tr.count("health.anomalies")
            tr.event(f"health.{kind}", step=-1 if step is None else step,
                     **{k: v for k, v in detail.items()
                        if isinstance(v, (int, float, str))})
        if self.on_anomaly is not None:
            self.on_anomaly(kind, record)
        return kind

    # -- detectors -----------------------------------------------------------

    def observe(
        self,
        *,
        step: Optional[int] = None,
        step_time_s: Optional[float] = None,
        loss: Optional[float] = None,
        counters: Optional[dict] = None,
        mfu: Optional[float] = None,
    ) -> list[str]:
        found: list[str] = []
        if step_time_s is not None:
            st = self._step_time
            if (st.n >= self.warmup
                    and st.z(step_time_s) > self.z_threshold):
                found.append(self._raise(
                    "step_time_spike", step,
                    step_time_s=round(step_time_s, 6),
                    ewma_s=round(st.mean, 6)))
            st.update(step_time_s)
        if loss is not None:
            if not math.isfinite(loss):
                found.append(self._raise("loss_spike", step,
                                         loss=repr(loss)))
            else:
                lo = self._loss
                if lo.n >= self.warmup and lo.z(loss) > self.z_threshold:
                    found.append(self._raise(
                        "loss_spike", step, loss=round(loss, 6),
                        ewma=round(lo.mean, 6)))
                lo.update(loss)
                self._losses.append(loss)
                del self._losses[: -self.plateau_window]
                if len(self._losses) == self.plateau_window:
                    span = max(self._losses) - min(self._losses)
                    scale = max(abs(self._losses[-1]), 1e-12)
                    if span / scale < self.plateau_rel:
                        if self._plateau_armed:
                            self._plateau_armed = False
                            found.append(self._raise(
                                "loss_plateau", step,
                                window=self.plateau_window,
                                rel_range=round(span / scale, 9)))
                    else:
                        self._plateau_armed = True
        if counters is not None:
            stalls = sum(counters.get(k, 0) for k in self.STALL_COUNTERS)
            if self._last_stalls is not None and stalls > self._last_stalls:
                found.append(self._raise(
                    "input_stall", step,
                    new_stalls=stalls - self._last_stalls))
            self._last_stalls = stalls
        if mfu is not None and mfu > 0:
            if self._mfus:
                best = max(self._mfus)
                if mfu < best * (1 - self.mfu_drop_frac):
                    found.append(self._raise(
                        "mfu_drop", step, mfu=round(mfu, 4),
                        window_best=round(best, 4)))
            self._mfus.append(mfu)
            del self._mfus[: -self.mfu_window]
        return found


# ---------------------------------------------------------------------------
# offline: the bench-regression gate
# ---------------------------------------------------------------------------


def bench_metrics(doc: dict) -> dict[str, float]:
    """Flatten a bench JSON into ``{metric: value}``.

    Accepts either the raw `bench.py` contract line (``{"metric", "value",
    "extra_metrics": [...]}``) or the driver's ``BENCH_r*.json`` record
    shape (``{"parsed": {...}}``). Entries that errored (no numeric value)
    are skipped — an absent metric is reported by `compare_bench` as
    missing, never silently compared."""
    if not isinstance(doc, dict):
        raise ValueError(f"bench JSON must be an object, got {type(doc)}")
    parsed = doc.get("parsed") if isinstance(doc.get("parsed"), dict) else doc
    out: dict[str, float] = {}
    for entry in [parsed] + list(parsed.get("extra_metrics") or []):
        if not isinstance(entry, dict):
            continue
        name, value = entry.get("metric"), entry.get("value")
        if isinstance(name, str) and isinstance(value, (int, float)) \
                and value > 0:
            out[name] = float(value)
    return out


def compare_bench(baseline: dict, run: dict, *,
                  tolerance: float = 0.05) -> dict:
    """Compare two bench JSONs metric-by-metric (throughput: higher is
    better). A metric regresses when ``run < baseline × (1 − tolerance)``.

    Returns a JSON-safe verdict::

        {"ok": bool, "tolerance": t,
         "regressions":  [{"metric", "baseline", "run", "ratio"}],
         "improvements": [...], "parity": [...],
         "missing": [metrics in baseline absent from the run],
         "new": [metrics in the run absent from the baseline]}

    Missing metrics make the verdict NOT ok: a benchmark that silently
    stopped reporting is a regression of the harness, not parity.
    """
    base = bench_metrics(baseline)
    fresh = bench_metrics(run)
    if not base:
        raise ValueError("baseline JSON carries no usable metrics")
    verdict: dict = {"ok": True, "tolerance": tolerance, "regressions": [],
                     "improvements": [], "parity": [], "missing": [],
                     "new": sorted(set(fresh) - set(base))}
    for name in sorted(base):
        if name not in fresh:
            verdict["missing"].append(name)
            verdict["ok"] = False
            continue
        ratio = fresh[name] / base[name]
        row = {"metric": name, "baseline": base[name], "run": fresh[name],
               "ratio": round(ratio, 4)}
        if ratio < 1 - tolerance:
            verdict["regressions"].append(row)
            verdict["ok"] = False
        elif ratio > 1 + tolerance:
            verdict["improvements"].append(row)
        else:
            verdict["parity"].append(row)
    return verdict
