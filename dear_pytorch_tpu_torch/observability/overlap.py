"""Leg-time prediction, step timing and the interconnect fit — the part of
``dear_pytorch_tpu/observability/overlap.py`` that the tuners read.

  - `predict_leg_times`: the unoverlapped seconds of each accounting row
    (`counters.plan_comm_accounting`) under an α-β fit;
  - `measure_step_time`: mean seconds per train step, one host sync
    closing the timed window;
  - `fit_interconnect`: (α, β) of ring all-gather traffic over the group,
    from a `utils.profiling.CommunicationProfiler` sweep.

The JAX module's overlap audit (``audit_train_step``,
``hlo_collective_stats``) reads XLA's scheduled HLO; its rebuild from
``torch.profiler`` timelines is ROADMAP Queue 1 item 8's remainder.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from dear_pytorch_tpu_torch.observability import counters as CTR

__all__ = ["fit_interconnect", "measure_step_time", "predict_leg_times"]


def predict_leg_times(
    acct: CTR.CommAccounting, alpha: float, beta: float,
    *, dcn_alpha: Optional[float] = None, dcn_beta: Optional[float] = None,
) -> list[float]:
    """Predicted unoverlapped seconds for each accounting row, consistent
    with `perf_model.allgather_perf_model`: ring legs cost
    ``(world-1)·α + β·wire_bytes`` (RS and AG each run world-1 rounds of
    1/world of the payload; all-reduce's wire bytes already carry the 2×),
    root legs (reduce/broadcast) cost ``α + β·payload``.

    The multi-node 'dcn' rows are priced with their own (``dcn_alpha``,
    ``dcn_beta``) fit, ``messages·α_dcn + β_dcn·wire``; with no such fit
    they fall back to the intra-node one."""
    w = acct.world
    a_d = alpha if dcn_alpha is None else float(dcn_alpha)
    b_d = beta if dcn_beta is None else float(dcn_beta)
    times = []
    for row in acct.rows:
        if row.leg == "dcn":
            times.append(row.messages * a_d + b_d * row.wire_bytes)
        elif w <= 1:
            times.append(0.0)
        elif row.leg in ("reduce_scatter", "all_gather"):
            times.append((w - 1) * alpha + beta * row.wire_bytes)
        elif row.leg == "all_reduce":
            times.append(2 * (w - 1) * alpha + beta * row.wire_bytes)
        else:  # reduce / broadcast: one full-payload transfer each
            times.append(alpha + beta * row.payload_bytes)
    return times


def measure_step_time(ts, state, batch, *, steps: int = 10,
                      warmup: int = 3) -> tuple[float, object]:
    """Mean wall seconds per `ts.step` call. Returns ``(secs, state)`` —
    the state threads through. One host fetch of the loss closes the
    warmup and one the timed window (a per-step sync would charge the
    host's enqueue latency to every step)."""
    metrics = None
    for _ in range(warmup):
        state, metrics = ts.step(state, batch)
    if metrics is not None:
        float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = ts.step(state, batch)
    float(metrics["loss"])
    return (time.perf_counter() - t0) / steps, state


def fit_interconnect(group=None, *, sizes: Optional[Sequence[int]] = None,
                     repeats: int = 5, warmup: int = 2,
                     device=None) -> tuple[float, float]:
    """Measured (α, β) for ring all-gather traffic over ``group`` (default
    `comm.backend.group()`) via `utils.profiling.CommunicationProfiler` —
    a small default sweep; every rank of the group must call it."""
    from dear_pytorch_tpu_torch.observability import costmodel as CM
    from dear_pytorch_tpu_torch.utils.profiling import CommunicationProfiler

    prof = CommunicationProfiler(group, collective="all_gather",
                                 device=device)
    if sizes is None:
        sizes = [2 ** k for k in range(12, 19, 2)]
    sizes_bytes, times = prof.benchmark(sizes=sizes, repeats=repeats,
                                        warmup=warmup)
    return CM.fit_allgather_sweep(prof.world, sizes_bytes, times)
