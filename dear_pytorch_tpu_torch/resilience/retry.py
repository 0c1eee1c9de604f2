"""Retry/backoff for transient host-side failures — the port of
``dear_pytorch_tpu/resilience/retry.py``, on the port's tracer; the jitter
streams, delays and messages are the JAX module's, for the same rank,
label and policy.

The reference has no retry anywhere (SURVEY.md §5: CHECK macros abort the
process; its batch driver retries at whole-job granularity). The host-side
I/O this framework does — checkpoint sidecar writes on shared filesystems,
ring-buffer batch fetches racing a slow producer — fails transiently in
ways a bounded, deterministic retry absorbs for free. Device-side faults
are explicitly OUT of scope: a failed collective or a NaN loss is
`utils.guard.GuardedTrainer`'s job (rollback), not a retry's (the same
poisoned input would fail again; the guard is ROADMAP Queue 1 item 9).

Backoff uses **decorrelated jitter** (AWS-style:
``delay = uniform(base, prev_delay * 3)``, capped): a fixed exponential
schedule synchronizes retry storms — every rank that hits the same dead
peer or flaky NFS server at the same step retries at the same instants,
hammering the recovering resource in lockstep. The jitter stream is
*deterministically seeded* per (process rank, call label), so recovery
paths stay byte-reproducible under test while different ranks decorrelate
from each other. ``jitter=False`` restores the legacy fixed exponential.

Two independent budgets bound a retry loop: ``attempts`` (how many tries)
and ``max_elapsed_s`` (total wall time — attempts alone let a slow
failing call, e.g. a 30 s NFS timeout per try, burn minutes before the
giveup; the elapsed cap stops retrying once the next sleep would cross
it, regardless of attempts remaining).

Telemetry (when enabled): counters ``retry.calls`` (guarded call sites
entered), ``retry.attempts`` (every attempt, first tries included —
``attempts - calls`` is the absorbed-failure volume a dashboard alerts
on), ``retry.retries`` (re-attempts after an absorbed failure) and
``retry.giveups`` (every attempt failed or the elapsed budget ran out),
plus one ``retry.attempt_failed`` event per absorbed failure — so retries
surface in the telemetry JSON blocks instead of vanishing into a log.
"""

from __future__ import annotations

import functools
import hashlib
import logging
import random
import time
from typing import Callable, Optional, Tuple, Type

from dear_pytorch_tpu_torch.observability import tracer as _telemetry

logger = logging.getLogger("dear_pytorch_tpu_torch")

__all__ = ["RetryError", "retry_call", "retryable"]


class RetryError(RuntimeError):
    """Every attempt failed; the last attempt's exception is the cause."""


def _jitter_rng(label: str) -> random.Random:
    """Deterministically seeded jitter stream: stable per (process rank,
    call label) — reproducible runs, decorrelated ranks. Hash-based (not
    ``hash()``, which is salted per process) so two runs of the same rank
    draw identical schedules."""
    rank = _telemetry.process_index()
    digest = hashlib.sha256(f"{rank}:{label}".encode()).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


def retry_call(
    fn: Callable,
    *args,
    attempts: int = 3,
    base_delay_s: float = 0.05,
    max_delay_s: float = 2.0,
    backoff: Optional[float] = None,
    max_elapsed_s: Optional[float] = None,
    jitter: bool = True,
    retry_on: Tuple[Type[BaseException], ...] = (OSError, TimeoutError),
    name: Optional[str] = None,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``, retrying on ``retry_on`` exceptions.

    Up to ``attempts`` total attempts. With ``jitter=True`` (default) the
    backoff is decorrelated: ``delay = uniform(base_delay_s, 3 * prev)``
    capped at ``max_delay_s``, drawn from a per-(rank, label) seeded
    stream — reproducible within a rank, desynchronized across ranks.
    ``jitter=False`` keeps the legacy deterministic exponential
    (``base_delay_s * backoff**k``, ``backoff`` defaulting to 2.0) — and
    so does EXPLICITLY passing ``backoff``: a caller that tuned the
    exponential factor wants that schedule, not a jitter stream that
    would silently ignore it. ``max_elapsed_s`` additionally caps
    the TOTAL wall time: once the budget is spent — or the next sleep
    would cross it — the loop gives up even with attempts remaining.
    An exception outside ``retry_on`` propagates immediately — only
    plausibly-transient failures are retried. When every attempt fails,
    raises `RetryError` chained to the last failure (the original
    exception stays inspectable via ``__cause__``).
    """
    attempts = max(int(attempts), 1)
    label = name or getattr(fn, "__qualname__", repr(fn))
    if backoff is None:
        backoff = 2.0
    else:
        jitter = False  # an explicit exponential factor selects the
        #                 legacy schedule outright
    rng = _jitter_rng(label) if jitter else None
    tr = _telemetry.get_tracer()
    if tr.enabled:
        tr.count("retry.calls")
    start = time.monotonic()
    last: Optional[BaseException] = None
    prev_delay = base_delay_s
    exhausted_reason = f"after {attempts} attempts"
    for attempt in range(1, attempts + 1):
        try:
            if tr.enabled:
                tr.count("retry.attempts")
            return fn(*args, **kwargs)
        except retry_on as exc:
            last = exc
            if attempt == attempts:
                break
            if rng is not None:
                delay = min(rng.uniform(base_delay_s,
                                        max(prev_delay, base_delay_s) * 3),
                            max_delay_s)
            else:
                delay = min(base_delay_s * backoff ** (attempt - 1),
                            max_delay_s)
            prev_delay = delay
            if max_elapsed_s is not None:
                elapsed = time.monotonic() - start
                if elapsed + delay >= max_elapsed_s:
                    exhausted_reason = (
                        f"after {attempt} attempts "
                        f"({elapsed:.3f}s elapsed, budget "
                        f"{max_elapsed_s:.3f}s)"
                    )
                    break
            logger.warning(
                "retry: %s attempt %d/%d failed (%s: %s); retrying in %.3fs",
                label, attempt, attempts, type(exc).__name__, exc, delay,
            )
            if tr.enabled:
                tr.count("retry.retries")
                # the guarded call's label travels as `call` (`name` is
                # the event's own name in the Tracer.event signature)
                tr.event("retry.attempt_failed", call=label, attempt=attempt,
                         error=type(exc).__name__, delay_s=delay)
            if on_retry is not None:
                on_retry(attempt, exc)
            if delay > 0:
                sleep(delay)
    if tr.enabled:
        tr.count("retry.giveups")
    raise RetryError(
        f"{label} failed {exhausted_reason} "
        f"(last: {type(last).__name__}: {last})"
    ) from last


def retryable(**policy):
    """Decorator form of `retry_call` — ``@retryable(attempts=5)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return retry_call(fn, *args, name=fn.__qualname__,
                              **policy, **kwargs)

        return wrapped

    return deco
