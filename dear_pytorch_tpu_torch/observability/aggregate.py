"""Cluster-wide metric aggregation over the host-level exchange cadence.

The port of ``dear_pytorch_tpu/observability/aggregate.py``, its imports retargeted
onto the port's tracer.

Per-process telemetry answers "is MY rank healthy"; the questions that
kill multi-host runs — *which* rank is slow, is the fleet's counter mix
skewed, did one host stop making progress — need a merged view. This
module piggybacks a compact per-rank digest onto the same host-level
coordination cadence `resilience.cluster.ClusterCoordinator` already runs
(the guard's check interval), deliberately HOST-level only: it works
wherever the process group bootstraps, with no device collective.

  digest  (`local_digest`)   — step-time quantiles from the flight ring,
          selected counter totals, and the flight-ring head (newest step,
          loss, step time). Compact by construction: counters are
          prefix-filtered and capped so the JSON stays inside the
          allgather transport's fixed per-rank slot. Also carries the
          rank's wall-vs-monotonic clock offset (``clk``) — the fleet
          trace collector's alignment sample (docs/OBSERVABILITY.md).
  merge   (`merge_digests`)  — per-rank table + summed counters + straggler
          detection: the rank whose p50 step time exceeds the fleet median
          by more than ``skew_threshold`` (``DEAR_STRAGGLER_SKEW``). The
          merged snapshot carries ``straggler_rank`` / ``straggler_skew``;
          detection raises ``cluster.straggler_detected`` and one
          ``cluster.straggler`` event.
  cadence (`MetricAggregator.exchange`) — one lockstep exchange per call;
          every rank computes the same merged snapshot, rank 0's is the
          authoritative copy exporters stream out.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

__all__ = [
    "DIGEST_COUNTER_PREFIXES", "SKEW_ENV", "local_digest", "merge_digests",
    "MetricAggregator",
]

#: Counters worth shipping cross-host on every interval (byte-budgeted:
#: the allgather transport gives each rank a fixed 2 KB slot).
DIGEST_COUNTER_PREFIXES = (
    "health.", "guard.", "cluster.", "watchdog.", "faults.", "retry.",
    "pipeline.", "dear.steps", "autotune.",
)
MAX_DIGEST_COUNTERS = 40
#: Hard byte ceiling for one serialized digest — below the allgather
#: transport's fixed per-rank slot (2048 incl. a 4-byte length header),
#: which RAISES on oversize; a monitoring payload must never be able to
#: crash the exchange. Enforced by trimming, not trusting the count cap.
MAX_DIGEST_BYTES = 1800

#: Straggler verdict threshold: slowest rank's p50 step time over the
#: fleet median p50. 1.5 = "half again slower than typical".
SKEW_ENV = "DEAR_STRAGGLER_SKEW"
DEFAULT_SKEW_THRESHOLD = 1.5


def _compact(x: float) -> float:
    return round(float(x), 6)


def local_digest(*, rank: Optional[int] = None, recorder=None,
                 tracer=None) -> dict:
    """This rank's compact health digest (JSON-safe, slot-budgeted)."""
    from dear_pytorch_tpu_torch.observability import flight as _flight
    from dear_pytorch_tpu_torch.observability import tracer as _tracer

    if recorder is None:
        recorder = _flight.get_recorder()
    if tracer is None:
        tracer = _tracer.get_tracer()
    if rank is None:
        rank = _tracer.process_index()
    ctr = {}
    if tracer.enabled:
        for name, value in tracer.counters().items():
            if name.startswith(DIGEST_COUNTER_PREFIXES):
                ctr[name] = _compact(value)
        if len(ctr) > MAX_DIGEST_COUNTERS:
            ctr = dict(sorted(ctr.items())[:MAX_DIGEST_COUNTERS])
    digest = {"rank": int(rank), "ctr": ctr}
    # wall-minus-monotonic clock offset, sampled on the SAME lockstep
    # cadence the exchange rides: the trace collector
    # (`observability.dtrace.merge_streams`) medians these to clock-align
    # per-rank span streams into one fleet timeline. ~20 bytes, always
    # under the slot budget.
    digest["clk"] = round(time.time() - time.monotonic(), 6)
    stats = recorder.step_time_stats()
    if stats:
        digest["st"] = stats
    head = recorder.head()
    if head is not None:
        digest["head"] = {k: head[k] for k in
                          ("step", "step_time_s", "loss", "t_s")
                          if k in head}
    return _fit_digest(digest)


def _size(digest: dict) -> int:
    return len(json.dumps(digest, separators=(",", ":")).encode("utf-8"))


def _fit_digest(digest: dict) -> dict:
    """Trim ``digest`` under `MAX_DIGEST_BYTES`. Per-rank trimming is
    safe: a digest is this rank's own data, not a collective contract —
    the merge handles heterogeneous dicts; what must hold is only that
    every rank still CALLS the exchange (and an oversize payload would
    instead RAISE in the allgather transport, stranding peers)."""
    if _size(digest) <= MAX_DIGEST_BYTES:
        return digest
    ctr = digest.get("ctr", {})
    while ctr and _size(digest) > MAX_DIGEST_BYTES:
        # drop the tail half of the (name-sorted) counters until it fits
        for k in sorted(ctr)[max(len(ctr) // 2, 1) - 1:]:
            del ctr[k]
    for field in ("head", "st"):
        if _size(digest) <= MAX_DIGEST_BYTES:
            break
        digest.pop(field, None)
    return digest


def merge_digests(digests: Sequence[dict], *,
                  skew_threshold: Optional[float] = None) -> dict:
    """Fold per-rank digests into one cluster snapshot (pure function of
    the gathered views, so every rank computes the identical merge)."""
    if skew_threshold is None:
        skew_threshold = float(os.environ.get(SKEW_ENV, "")
                               or DEFAULT_SKEW_THRESHOLD)
    per_rank: dict[int, dict] = {}
    counters: dict[str, float] = {}
    p50s: list[tuple[int, float]] = []
    for d in digests:
        if not isinstance(d, dict) or "rank" not in d:
            continue
        rank = int(d["rank"])
        per_rank[rank] = {k: v for k, v in d.items() if k != "rank"}
        for name, value in (d.get("ctr") or {}).items():
            counters[name] = counters.get(name, 0) + value
        p50 = (d.get("st") or {}).get("p50_s")
        if p50:
            p50s.append((rank, float(p50)))
    merged: dict = {
        "world": len(per_rank),
        "per_rank": per_rank,
        "counters": {k: _compact(v) for k, v in sorted(counters.items())},
        "straggler_rank": None,
        "straggler_skew": None,
        "skew_threshold": skew_threshold,
    }
    if len(p50s) >= 2:
        times = sorted(v for _, v in p50s)
        mid = len(times) // 2
        # true median (middle pair averaged for even counts): at world=2
        # the upper-middle pick would make the slowest rank its own
        # reference and the skew identically 1.0
        median = (times[mid] if len(times) % 2
                  else (times[mid - 1] + times[mid]) / 2)
        slow_rank, slowest = max(p50s, key=lambda rv: rv[1])
        merged["step_time"] = {"median_p50_s": _compact(median),
                               "max_p50_s": _compact(slowest),
                               "slowest_rank": slow_rank}
        if median > 0:
            skew = slowest / median
            merged["straggler_skew"] = _compact(skew)
            if skew >= skew_threshold:
                merged["straggler_rank"] = slow_rank
    return merged


class MetricAggregator:
    """One lockstep digest exchange per call, over a coordinator.

    The coordinator is any `resilience.cluster.ClusterCoordinator`-shaped
    object (``exchange(tag, payload) -> list[str]``, ``index``,
    ``process_count``); the guard passes its own, so aggregation rides the
    exact cadence (and bounded deadline) of the health checks. ALL ranks
    must call `exchange` in the same order — the guard's check-interval
    discipline guarantees that, and the exchange runs even when telemetry
    is locally disabled (an empty digest) so the cadence can never desync
    across ranks with different env configurations.
    """

    TAG = "metrics"

    def __init__(self, coordinator, *,
                 skew_threshold: Optional[float] = None):
        self._coordinator = coordinator
        self.skew_threshold = skew_threshold
        self.last_merged: Optional[dict] = None

    @property
    def index(self) -> int:
        return self._coordinator.index

    def exchange(self, digest: Optional[dict] = None) -> dict:
        """Gather every rank's digest and return the merged snapshot
        (identical on every rank; rank 0's copy is authoritative for
        export). Raises `resilience.cluster.PeerTimeout` like any other
        coordinated exchange — callers treat it as a dead peer."""
        from dear_pytorch_tpu_torch.observability import tracer as _tracer

        if digest is None:
            digest = local_digest(rank=self._coordinator.index)
        views = self._coordinator.exchange(
            self.TAG, json.dumps(digest, separators=(",", ":")))
        merged = merge_digests(
            [json.loads(v) for v in views if v],
            skew_threshold=self.skew_threshold)
        self.last_merged = merged
        tr = _tracer.get_tracer()
        if tr.enabled:
            tr.count("cluster.metric_exchanges")
            if merged["straggler_rank"] is not None:
                tr.count("cluster.straggler_detected")
                tr.event("cluster.straggler",
                         rank=merged["straggler_rank"],
                         skew=merged["straggler_skew"])
        return merged
