"""Per-bucket communication accounting, derived statically from a FusionPlan
— the port of ``dear_pytorch_tpu/observability/counters.py``.

The reference could only count communication by intercepting NCCL calls;
here the schedule is plan metadata (`ops.fusion.FusionPlan` + the mode),
so bytes-per-step is computable exactly, before the first step runs:

  - `plan_comm_accounting(plan, mode=...)` — per-bucket payload and
    estimated wire bytes for each collective leg of the chosen schedule.
  - `CommAccounting.totals(steps)` — cumulative bytes after N steps,
    joined with the runtime counters (steps, rebuilds, compiles, tuner
    trials) the instrumented call sites feed into the global tracer.

Payload vs wire: *payload* is the flat padded buffer each collective
carries (``padded_size × itemsize``). *wire* is the ring-algorithm
estimate of bytes a single device actually moves on the interconnect:
reduce-scatter and all-gather each move ``(world-1)/world × payload``; a
ring all-reduce moves twice that; reduce+broadcast is modeled as two full
payload transfers (the root link is the bottleneck). These match the
α-β models in `utils.perf_model`, so the overlap auditor's predicted
times and this module's byte counts can never drift apart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from dear_pytorch_tpu_torch.ops import fusion as F

__all__ = ["BucketCommRow", "CommAccounting", "MODE_LEGS",
           "plan_comm_accounting"]

#: collective legs per schedule mode (the JAX package's table; the port's
#: `parallel.dear` runs the same legs per bucket)
MODE_LEGS = {
    "dear": ("reduce_scatter", "all_gather"),
    # dear-fused moves the same legs, executed by the ring kernels
    # (ops/collective_matmul.py) instead of library collectives — identical
    # payload/wire accounting, so the auditor's exposed-vs-hidden split is
    # directly comparable against 'dear'
    "dear-fused": ("reduce_scatter", "all_gather"),
    "fsdp": ("reduce_scatter", "all_gather"),
    "rsag": ("reduce_scatter", "all_gather"),
    "bytescheduler": ("reduce_scatter", "all_gather"),
    "allreduce": ("all_reduce",),
    "rb": ("reduce", "broadcast"),
}


def _wire_factor(leg: str, world: int) -> float:
    """Ring-estimate fraction of the payload one device moves for ``leg``."""
    if world <= 1:
        return 0.0
    ring = (world - 1) / world
    return {
        "reduce_scatter": ring,
        "all_gather": ring,
        "all_reduce": 2.0 * ring,   # RS + AG decomposition
        "reduce": 1.0,              # root receives the full payload
        "broadcast": 1.0,           # root sends the full payload
    }[leg]


@dataclasses.dataclass(frozen=True)
class BucketCommRow:
    """One bucket's per-step communication, one row per collective leg."""

    bucket: int
    leg: str                 # 'reduce_scatter' | 'all_gather' | 'dcn' | ...
    tensors: int             # parameters fused into this bucket
    elements: int            # unpadded element count
    padded_elements: int
    payload_bytes: int       # padded_size × itemsize of the comm dtype
    wire_bytes: float        # ring estimate of per-device interconnect bytes
    #: number of point-to-point transfers this leg issues per step —
    #: 1 for in-program collectives (their per-round α is modeled from
    #: ``world`` in `overlap.predict_leg_times`); for the host-level
    #: 'dcn' leg it is ``ceil(payload/partition) × (num_slices-1)``,
    #: the per-message α count of the chunked cross-slice exchange
    messages: int = 1


@dataclasses.dataclass(frozen=True)
class CommAccounting:
    """Static per-step schedule accounting + runtime-counter join."""

    mode: str
    world: int
    num_buckets: int
    rows: tuple[BucketCommRow, ...]

    @property
    def payload_bytes_per_step(self) -> int:
        return sum(r.payload_bytes for r in self.rows)

    @property
    def wire_bytes_per_step(self) -> float:
        return sum(r.wire_bytes for r in self.rows)

    def leg_bytes_per_step(self, leg: str) -> int:
        return sum(r.payload_bytes for r in self.rows if r.leg == leg)

    def totals(self, steps: Optional[int] = None,
               runtime_counters: Optional[dict] = None) -> dict:
        """JSON-safe cumulative accounting.

        ``steps`` defaults to the global tracer's ``dear.steps`` counter
        (what `parallel/dear.py` increments); ``runtime_counters``
        defaults to the global tracer's snapshot, folding in rebuild /
        compile / tuner-trial counts.
        """
        if runtime_counters is None:
            from dear_pytorch_tpu_torch.observability import tracer as T

            runtime_counters = T.get_tracer().counters()
        if steps is None:
            steps = int(runtime_counters.get("dear.steps", 0))
        per_leg = {}
        for r in self.rows:
            leg = per_leg.setdefault(r.leg, {"payload_bytes": 0,
                                             "wire_bytes": 0.0})
            leg["payload_bytes"] += r.payload_bytes * steps
            leg["wire_bytes"] += r.wire_bytes * steps
        return {
            "mode": self.mode,
            "world": self.world,
            "num_buckets": self.num_buckets,
            "steps": steps,
            "payload_bytes_per_step": self.payload_bytes_per_step,
            "wire_bytes_per_step": round(self.wire_bytes_per_step, 1),
            "per_leg": per_leg,
            "plan_rebuilds": int(runtime_counters.get(
                "autotune.rebuilds", 0)),
            "compiles": int(runtime_counters.get("dear.compiles", 0)),
            "tuner_trials": int(runtime_counters.get(
                "autotune.trials", 0)),
        }

    def as_dicts(self) -> list[dict]:
        return [dataclasses.asdict(r) for r in self.rows]


def plan_comm_accounting(
    plan: F.FusionPlan,
    *,
    mode: str = "dear",
    comm_itemsize: int = 4,
    gather_itemsize: Optional[int] = None,
    compressor: Optional[str] = None,
    density: float = 1.0,
    num_slices: int = 1,
    dcn_partition_mb: Optional[float] = None,
) -> CommAccounting:
    """Static communication accounting for ``plan`` under ``mode``.

    ``comm_itemsize`` is the gradient-leg dtype size in bytes
    (``comm_dtype`` — 2 for bf16); ``gather_itemsize`` the parameter
    all-gather leg's (``gather_dtype``, 'dear'/'fsdp' only; defaults to
    ``comm_itemsize``). ``compressor``/``density`` scale the GRADIENT
    leg's bytes by `ops.compression.wire_ratio` (the parameter all-gather
    stays dense): the payload shrinks to the compressed wire format, and
    the wire estimate becomes gather-shaped — compressed reductions
    all-gather every peer's payload ((world-1) x payload per device)
    instead of moving 1/world ring chunks. At ``world=1`` every wire
    estimate is 0 — the collectives are local copies.

    ``num_slices > 1`` accounts the HIERARCHICAL (multi-slice) dear
    schedule: the in-program legs above run over the intra-slice axis
    (``plan.world`` is the intra-node world), and every bucket
    additionally crosses the slice boundary once per step on the
    host-level DCN leg — each slice publishes its reduced partial
    (``payload`` bytes out) and fetches the other ``num_slices-1``
    partials, in
    ``dcn_partition_mb``-sized chunks (`ops.fusion.chunk_bounds` — the
    per-level bucket partition). The row's ``wire_bytes`` is the
    per-slice total moved (out + in) and ``messages`` the per-message α
    count, which `overlap.predict_leg_times` prices with the DCN-level
    α-β fit when one is given (link-aware, FlexLink-style).
    """
    if mode not in MODE_LEGS:
        raise ValueError(f"mode must be one of {sorted(MODE_LEGS)}, "
                         f"got {mode!r}")
    gather_itemsize = (comm_itemsize if gather_itemsize is None
                      else gather_itemsize)
    compressed = compressor not in (None, "none")
    if compressed:
        from dear_pytorch_tpu_torch.ops import compression as Z

        # the compressed path casts the bucket to the master dtype before
        # compressing (parallel/dear.py: gin = gbuf.float()) — its payload
        # values never travel in comm_dtype, so price them at the buffer
        # itemsize or the wire bytes under-count whenever a caller
        # combines compressor with a narrower comm_dtype
        comp_itemsize = (plan.leaves[0].dtype.itemsize
                         if plan.leaves else 4)

    rows = []
    for b in plan.buckets:
        for leg in MODE_LEGS[mode]:
            itemsize = (gather_itemsize if leg == "all_gather"
                        and mode in ("dear", "dear-fused", "fsdp")
                        else comm_itemsize)
            payload = b.padded_size * itemsize
            wire = payload * _wire_factor(leg, plan.world)
            if compressed and leg in ("reduce_scatter", "all_reduce"):
                ratio = Z.wire_ratio(
                    compressor, b.padded_size, density, comp_itemsize)
                payload = int(round(b.padded_size * comp_itemsize * ratio))
                wire = float(payload * max(plan.world - 1, 0))
            rows.append(BucketCommRow(
                bucket=b.index,
                leg=leg,
                tensors=len(b.leaf_ids),
                elements=b.size,
                padded_elements=b.padded_size,
                payload_bytes=payload,
                wire_bytes=wire,
            ))
        if num_slices > 1:
            # the cross-slice gradient exchange travels in the BUFFER
            # dtype (the host leg averages reduced f32 partials; see
            # comm/dcn.py) — price it at the leaf itemsize, not the
            # intra-slice comm_dtype
            dcn_itemsize = (plan.leaves[0].dtype.itemsize
                            if plan.leaves else 4)
            payload = b.padded_size * dcn_itemsize
            chunks = len(F.chunk_bounds(
                b.padded_size, dcn_itemsize, dcn_partition_mb))
            rows.append(BucketCommRow(
                bucket=b.index,
                leg="dcn",
                tensors=len(b.leaf_ids),
                elements=b.size,
                padded_elements=b.padded_size,
                payload_bytes=payload,
                wire_bytes=float(payload * num_slices),  # 1 out + (S-1) in
                messages=chunks * (num_slices - 1),
            ))
    return CommAccounting(mode=mode, world=plan.world,
                          num_buckets=plan.num_buckets, rows=tuple(rows))
