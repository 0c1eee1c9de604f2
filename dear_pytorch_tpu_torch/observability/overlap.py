"""The overlap-efficiency auditor — the port of
``dear_pytorch_tpu/observability/overlap.py``: was the collective actually
hidden?

DeAR's value claim is that reduce-scatter hides under backprop and
all-gather hides under the next forward — yet throughput alone cannot say
whether a schedule won because it overlapped communication or because it
did less of it. This module joins three measurements:

  1. static schedule accounting (`counters.plan_comm_accounting`) — how
     many bytes each bucket's collective legs move per step,
  2. a measured α-β interconnect fit (`fit_interconnect`) — what those
     bytes cost in seconds when nothing overlaps,
  3. measured step time (`measure_step_time`) and measured compute time
     (``dear``'s ``exclude_parts`` ablation, as `report.main` measures
     it),

into one report per schedule mode (`audit_train_step`, JAX's arithmetic):

  serial_step   = compute + comm          (nothing overlaps)
  ideal_step    = max(compute, comm)      (everything overlaps)
  exposed_comm  = clip(measured - compute, 0, comm)
  hidden_comm   = comm - exposed_comm
  overlap_efficiency = (serial - measured) / (serial - ideal)  in [0, 1]

so 1.0 means the schedule hid everything the hardware allowed and 0.0
means it serialized. Per-bucket exposed/hidden attribution is
proportional to each leg's predicted α-β time — the measurement is
whole-step, so the split is a model-weighted attribution, not a
per-bucket measurement.

JAX's cross-check rides on XLA's HLO (``hlo_collective_stats``: the share
of compute ops with no dependency path to or from each collective — a
STRUCTURAL metric of the compiled program). Eager PyTorch has no program
to read, so the port's cross-check is a MEASUREMENT instead: the report's
``timeline`` field (`measure_timeline`) traces a few steps with
``torch.profiler`` and gives, for each bucket and leg, the collective's
span (the NCCL or ring kernel on the card; gloo's host-staged span where
ranks share a card or run on the CPU) and the share of that span that
overlaps compute (the card's other kernels, or the main thread's ops on
the CPU). Where the JAX number says what a scheduler COULD hide, the
port's says what this run DID hide.

Also here: `predict_leg_times` (the unoverlapped seconds of each
accounting row under an α-β fit) and `measure_step_time`, which the tuners
read.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

from dear_pytorch_tpu_torch.observability import counters as CTR

__all__ = ["BucketLegReport", "OverlapReport", "audit_train_step",
           "fit_dcn", "fit_interconnect", "measure_step_time",
           "measure_timeline",
           "predict_leg_times", "timeline_from_events"]


@dataclasses.dataclass(frozen=True)
class BucketLegReport:
    """One bucket collective leg: bytes, predicted cost, attribution."""

    bucket: int
    leg: str
    payload_bytes: int
    wire_bytes: float
    pred_time_s: float
    exposed_s: Optional[float]   # None when no measured step time was given
    hidden_s: Optional[float]


@dataclasses.dataclass(frozen=True)
class OverlapReport:
    """Overlap-efficiency audit of one schedule mode."""

    mode: str
    world: int
    num_buckets: int
    alpha: float
    beta: float
    compute_time_s: Optional[float]
    comm_time_s: float
    measured_step_s: Optional[float]
    ideal_step_s: Optional[float]
    serial_step_s: Optional[float]
    exposed_comm_s: Optional[float]
    hidden_comm_s: Optional[float]
    overlap_efficiency: Optional[float]
    flops_per_step: Optional[float]
    legs: tuple
    timeline: Optional[dict] = None   # measured (None when not traced)
    model_note: Optional[str] = None  # set when measurement defies the model

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["legs"] = [dataclasses.asdict(leg) for leg in self.legs]
        return d


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


def audit_train_step(
    ts,
    state=None,
    batch=None,
    *,
    alpha: float,
    beta: float,
    mode: str = "dear",
    measured_step_s: Optional[float] = None,
    compute_time_s: Optional[float] = None,
    comm_itemsize: int = 4,
    gather_itemsize: Optional[int] = None,
    flops_per_step: Optional[float] = None,
    peak_flops: Optional[float] = None,
    timeline: Optional[dict] = None,
) -> OverlapReport:
    """Audit one built `TrainStep` (`parallel.dear.build_train_step`), with
    JAX's arithmetic (JAX overlap.py:183).

    ``alpha``/``beta`` come from `fit_interconnect` over the step's group
    (or a synthetic model in tests). ``compute_time_s`` is the
    communication-free step time — measure it with ``dear``'s
    ``exclude_parts`` ablation (what `report.main` does); without it, the
    FLOPs of a step (``flops_per_step``, e.g. `benchmarks.runner.
    step_flops`) over the device's peak (``peak_flops``) stand in, and
    with neither the exposure split is None, not guessed. ``timeline``: a
    `measure_timeline` result to carry. ``state`` and ``batch`` are JAX's
    arguments for lowering the step; nothing is lowered here."""
    del state, batch
    acct = CTR.plan_comm_accounting(
        ts.plan, mode=mode, comm_itemsize=comm_itemsize,
        gather_itemsize=gather_itemsize,
    )
    leg_times = predict_leg_times(acct, alpha, beta)
    comm_time = sum(leg_times)
    flops = flops_per_step
    if compute_time_s is None and flops and peak_flops:
        compute_time_s = flops / peak_flops

    ideal = serial = exposed = hidden = eff = None
    note = None
    if compute_time_s is not None:
        ideal = max(compute_time_s, comm_time)
        serial = compute_time_s + comm_time
        if measured_step_s is not None:
            exposed = min(max(measured_step_s - compute_time_s, 0.0),
                          comm_time)
            hidden = comm_time - exposed
            if serial > ideal:
                eff = (serial - measured_step_s) / (serial - ideal)
                eff = min(max(eff, 0.0), 1.0)
            else:
                # no communication (or no compute) to hide: the schedule
                # trivially achieves the ideal
                eff = 1.0 if comm_time == 0.0 else 0.0
            if measured_step_s < 0.95 * ideal:
                note = (
                    "measured step beat the modeled ideal: the alpha-beta "
                    "fit overestimates in-program collectives (expected on "
                    "CPU emulation, where the fit pays per-dispatch "
                    "overhead the compiled step amortizes) — treat the "
                    "efficiency as saturated, and the per-bucket split as "
                    "model-weighted only"
                )
            elif measured_step_s > serial:
                note = (
                    "measured step exceeds the serial model: compute or "
                    "comm is underestimated (efficiency clipped to 0)"
                )

    legs = []
    for row, t in zip(acct.rows, leg_times):
        if exposed is not None and comm_time > 0:
            leg_exposed = exposed * (t / comm_time)
            leg_hidden = t - leg_exposed
        else:
            leg_exposed = leg_hidden = None
        legs.append(BucketLegReport(
            bucket=row.bucket, leg=row.leg,
            payload_bytes=row.payload_bytes, wire_bytes=row.wire_bytes,
            pred_time_s=t,
            exposed_s=leg_exposed, hidden_s=leg_hidden,
        ))

    return OverlapReport(
        mode=mode, world=acct.world, num_buckets=acct.num_buckets,
        alpha=alpha, beta=beta,
        compute_time_s=compute_time_s, comm_time_s=comm_time,
        measured_step_s=measured_step_s,
        ideal_step_s=ideal, serial_step_s=serial,
        exposed_comm_s=exposed, hidden_comm_s=hidden,
        overlap_efficiency=eff, flops_per_step=flops,
        legs=tuple(legs), timeline=timeline, model_note=note,
    )


#: collective leg by a substring of a traced collective's name: NCCL
#: kernels (``ncclDevKernel_ReduceScatter_...``), the ring kernels
#: (``ring_rs_*``, ``ring_ag_*``) and gloo's host spans (``gloo:*``)
_LEG_BY_NAME = (("reducescatter", "reduce_scatter"),
                ("reduce_scatter", "reduce_scatter"),
                ("ring_rs", "reduce_scatter"),
                ("allgather", "all_gather"), ("all_gather", "all_gather"),
                ("ring_ag", "all_gather"),
                ("allreduce", "all_reduce"), ("all_reduce", "all_reduce"),
                ("broadcast", "broadcast"), ("reduce", "reduce"))


def _leg_of(name: str) -> Optional[str]:
    low = name.lower()
    if not ("nccl" in low or low.startswith("gloo:") or "ring_rs" in low
            or "ring_ag" in low):
        return None
    return next((leg for key, leg in _LEG_BY_NAME if key in low), "other")


def _union(intervals) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(a: float, b: float, union) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in union)


def timeline_from_events(events, *, num_buckets: int, steps: int,
                         on_device: bool) -> dict:
    """The ``timeline`` of `measure_timeline` from ``torch.profiler``
    events (objects with ``name``, ``device_type``, ``thread`` and
    ``time_range``) of ``steps`` steps. Collectives: NCCL and ring kernels
    on the card, gloo's spans on its threads; compute: the card's other
    kernels (``on_device``), else the main thread's ``aten::`` ops. Each
    leg's spans, in start order, split into ``steps`` equal runs; in a
    run the first ``num_buckets`` are the buckets in the schedule's issue
    order — reduce-scatters and all-reduces descending (the order the
    backward completes a module-order plan), gathers ascending — and any
    more (the loss's mean, the model state's gather) are left out of the
    buckets. gloo's spans take the legs of the ``c10d::`` calls the main
    thread issued (gloo runs a reduce-scatter as an all-reduce): in
    order when as many were issued, else each the last call issued before
    it began that no span took (the host-staged collectives of ranks that
    share a card, which block). Spans include waits for the peers."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    threads = [e.thread for e in events if e.name.startswith("aten::")
               and e.device_type != cuda]
    main = max(set(threads), key=threads.count) if threads else None
    # gloo runs some collectives as others (a reduce-scatter as an
    # all-reduce): its spans, in order, take the legs of the c10d calls
    # the main thread issued, in order, when the two lists match
    gloo = sorted((e for e in events if e.name.startswith("gloo:")),
                  key=lambda e: e.time_range.start)
    issued = sorted((e for e in events if e.name.startswith("c10d::")
                     and e.thread == main), key=lambda e: e.time_range.start)
    if gloo and len(gloo) != len(issued):
        # other counts (a call gloo runs as none, or as several): each span
        # takes the last call issued before it starts that no span took
        pairs, used = [], set()
        for g in gloo:
            before = [i for i, c in enumerate(issued) if i not in used
                      and c.time_range.start <= g.time_range.start]
            if before:
                used.add(before[-1])
                pairs.append((g, issued[before[-1]]))
    else:
        pairs = list(zip(gloo, issued))
    gloo_leg = {id(g): next((leg for key, leg in _LEG_BY_NAME
                             if key in c.name.lower()), "other")
                for g, c in pairs}
    colls: dict = {}
    compute = []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        is_kernel = e.device_type == cuda
        leg = gloo_leg.get(id(e)) or _leg_of(e.name)
        if leg is not None and (is_kernel or e.name.startswith("gloo:")):
            colls.setdefault(leg, []).append((a, b))
        elif on_device and is_kernel and "memcpy" not in e.name.lower() \
                and "memset" not in e.name.lower():
            compute.append((a, b))
        elif not on_device and e.thread == main \
                and e.name.startswith("aten::"):
            compute.append((a, b))
    union = _union(compute)
    legs, buckets = {}, []
    tot_span = tot_cov = 0.0
    for leg, spans in sorted(colls.items()):
        spans.sort()
        span = sum(b - a for a, b in spans) / 1e6
        cov = sum(_covered(a, b, union) for a, b in spans) / 1e6
        tot_span, tot_cov = tot_span + span, tot_cov + cov
        legs[leg] = {"count_per_step": len(spans) / steps,
                     "span_s_per_step": span / steps,
                     "overlap_share": cov / span if span > 0 else None}
        per = len(spans) // steps if len(spans) % steps == 0 else 0
        if leg == "other" or per < num_buckets:
            continue
        order = (list(range(num_buckets)) if leg == "all_gather"
                 else list(range(num_buckets - 1, -1, -1)))
        for i, g in enumerate(order):
            mine = [spans[s * per + i] for s in range(steps)]
            sp = sum(b - a for a, b in mine)
            cv = sum(_covered(a, b, union) for a, b in mine)
            buckets.append({"bucket": g, "leg": leg,
                            "span_s": sp / steps / 1e6,
                            "overlap_share": cv / sp if sp > 0 else None})
    buckets.sort(key=lambda r: (r["bucket"], r["leg"]))
    return {"steps": steps,
            "source": ("kernels on the card" if on_device
                       else "host spans (gloo)"),
            "compute_s_per_step": sum(b - a for a, b in union) / 1e6 / steps,
            "collective_s_per_step": tot_span / steps,
            "overlap_share": tot_cov / tot_span if tot_span > 0 else None,
            "legs": legs, "buckets": buckets}


def measure_timeline(ts, state, batch, *, steps: int = 2):
    """Trace ``steps`` calls of ``ts.step`` with ``torch.profiler`` (the
    card's kernels too on the card) and return ``(timeline, state)``: the
    collectives' spans per bucket and leg and the share of each that
    overlaps compute (`timeline_from_events`). Where ranks share a card,
    the collectives are gloo's host-staged spans against the card's
    kernels. Every rank of the step's group must call it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = ts.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    from dear_pytorch_tpu_torch.comm import backend

    with profile(activities=acts) as prof:
        backend.barrier()        # the ranks' profilers start at other times
        for _ in range(steps):
            state, metrics = ts.step(state, batch)
        float(metrics["loss"])
        if on_card:
            torch.cuda.synchronize()
    events = list(prof.events())
    on_device = on_card and any(
        e.device_type == torch.autograd.DeviceType.CUDA for e in events)
    return timeline_from_events(events, num_buckets=ts.plan.num_buckets,
                                steps=steps, on_device=on_device), state


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


def fit_dcn(samples: Sequence[tuple[float, float]],
            *, min_samples: int = 4) -> tuple[float, float]:
    """(α, β) for the cross-slice DCN level — `costmodel.fit_dcn` (the
    one α-β waist); kept at the JAX package's `overlap.fit_dcn` path."""
    from dear_pytorch_tpu_torch.observability import costmodel as CM

    return CM.fit_dcn(samples, min_samples=min_samples)
