"""Render overlap audits and telemetry summaries; runnable entry point —
the port of ``dear_pytorch_tpu/observability/report.py``.

``python -m dear_pytorch_tpu_torch.observability.report`` builds a
bucketed MLP train step per schedule mode at ``--world`` ranks (spawned as
the sweep driver spawns a cell's: the launcher variables of
`comm.backend`; on the card by default, where ranks beyond the card count
share it over gloo, or ``--device cpu``), measures (a) per-mode step time
(`overlap.measure_step_time`), (b) communication-free compute time via the
``dear`` schedule's ``exclude_parts`` ablation, (c) a live α-β
interconnect fit (`overlap.fit_interconnect`) and (d) a ``torch.profiler``
timeline of each mode's steps (`overlap.measure_timeline`: where JAX
printed its HLO's structural overlappability, the port prints measured
overlap), then prints the per-mode overlap-efficiency report — ideal vs
measured step time, exposed vs hidden communication per bucket — and
optionally writes the same content as JSON (rank 0).

The render functions are JAX's, dict for dict (`render_text` with the
timeline in place of the HLO line).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
import torch
from torch import nn

from dear_pytorch_tpu_torch.observability.overlap import OverlapReport

__all__ = ["main", "render_comparison", "render_fleet_trace",
           "render_telemetry", "render_text"]

_MS = 1e3


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GB"


def _opt_ms(v: Optional[float]) -> str:
    return "n/a" if v is None else f"{v * _MS:.3f} ms"


def render_text(rep: OverlapReport) -> str:
    """Human-readable overlap audit: headline ratios, then the bucket
    table, then the measured timeline's overlap shares."""
    lines = [
        f"== overlap audit: mode={rep.mode} "
        f"(world={rep.world}, {rep.num_buckets} buckets) ==",
        f"  interconnect fit: alpha={rep.alpha:.3e} s  "
        f"beta={rep.beta:.3e} s/B"
        + (f"  flops/step={rep.flops_per_step:.3e}"
           if rep.flops_per_step else ""),
        f"  compute {_opt_ms(rep.compute_time_s)}   "
        f"comm(unoverlapped) {_opt_ms(rep.comm_time_s)}   "
        f"measured {_opt_ms(rep.measured_step_s)}",
        f"  serial {_opt_ms(rep.serial_step_s)}   "
        f"ideal {_opt_ms(rep.ideal_step_s)}   "
        + (f"overlap efficiency {rep.overlap_efficiency * 100:.1f}%"
           if rep.overlap_efficiency is not None
           else "overlap efficiency n/a"),
        f"  exposed comm {_opt_ms(rep.exposed_comm_s)}   "
        f"hidden comm {_opt_ms(rep.hidden_comm_s)}",
        "  bucket  leg             payload      pred     exposed    hidden",
    ]
    for leg in rep.legs:
        lines.append(
            f"  {leg.bucket:>6}  {leg.leg:<14}  "
            f"{_fmt_bytes(leg.payload_bytes):>9}  "
            f"{_opt_ms(leg.pred_time_s):>9}  "
            f"{_opt_ms(leg.exposed_s):>9}  {_opt_ms(leg.hidden_s):>9}"
        )
    tl = rep.timeline
    if tl:
        share = tl.get("overlap_share")
        lines.append(
            f"  timeline ({tl['steps']} traced steps, {tl['source']}): "
            f"collectives {_opt_ms(tl['collective_s_per_step'])}/step, "
            f"compute {_opt_ms(tl['compute_s_per_step'])}/step, "
            "overlapped " + ("n/a" if share is None
                             else f"{share * 100:.1f}%"))
        for leg, v in sorted(tl.get("legs", {}).items()):
            lines.append(
                f"    {leg:<14} x{v['count_per_step']:g}/step  "
                f"{_opt_ms(v['span_s_per_step'])}/step  overlapped "
                + ("n/a" if v["overlap_share"] is None
                   else f"{v['overlap_share'] * 100:.1f}%"))
        for b in tl.get("buckets", []):
            lines.append(
                f"    bucket {b['bucket']:>3} {b['leg']:<14} "
                f"{_opt_ms(b['span_s'])}  overlapped "
                + ("n/a" if b["overlap_share"] is None
                   else f"{b['overlap_share'] * 100:.1f}%"))
    if rep.model_note:
        lines.append(f"  NOTE: {rep.model_note}")
    return "\n".join(lines)


def render_comparison(reports: dict[str, OverlapReport]) -> str:
    """One-line-per-mode summary table — the "*why* they differ" view."""
    lines = [
        "== mode comparison ==",
        "  mode           measured     comm    exposed    hidden   overlap",
    ]
    for mode, r in reports.items():
        eff = ("n/a" if r.overlap_efficiency is None
               else f"{r.overlap_efficiency * 100:.0f}%")
        lines.append(
            f"  {mode:<13} {_opt_ms(r.measured_step_s):>9} "
            f"{_opt_ms(r.comm_time_s):>9} {_opt_ms(r.exposed_comm_s):>9} "
            f"{_opt_ms(r.hidden_comm_s):>9} {eff:>8}"
        )
    return "\n".join(lines)


def render_telemetry(snap: dict) -> str:
    """Counters + per-span aggregates from `observability.snapshot()`."""
    lines = [f"== telemetry (enabled={snap.get('enabled')}) =="]
    for k, v in sorted(snap.get("counters", {}).items()):
        lines.append(f"  counter {k} = {v:g}")
    for name, agg in sorted(snap.get("spans", {}).items()):
        lines.append(
            f"  span {name}: x{agg['count']}  "
            f"total {agg['total_us'] / 1e3:.3f} ms"
        )
    return "\n".join(lines)


def _opt_s(v: Optional[float]) -> str:
    return "n/a" if v is None else f"{v * _MS:.2f} ms"


def render_fleet_trace(attr: dict, *, max_steps: int = 8,
                       max_requests: int = 8) -> str:
    """Human-readable critical-path attribution over a merged fleet
    timeline (`critical_path.critical_path` output): the fleet step-time
    quantiles and exposed-comm fraction, the per-step straggler table,
    and the per-request hop breakdown."""
    steps = attr.get("steps") or {}
    reqs = attr.get("requests") or {}
    ssum = steps.get("summary") or {}
    rsum = reqs.get("summary") or {}
    lines = ["== fleet trace: critical path =="]
    if ssum.get("n_steps"):
        lines.append(
            f"  steps: {ssum['n_steps']}   "
            f"p50 {_opt_s(ssum.get('step_p50_s'))}   "
            f"p99 {_opt_s(ssum.get('step_p99_s'))}   "
            f"exposed-comm frac "
            + ("n/a" if ssum.get("exposed_frac") is None
               else f"{ssum['exposed_frac'] * 100:.1f}%")
            + f"   rollbacks {ssum.get('rollbacks', 0)}")
        hist = ssum.get("stragglers") or {}
        if hist:
            top = sorted(hist.items(), key=lambda kv: -kv[1])
            lines.append("  stragglers: " + ", ".join(
                f"rank {r} x{n}" for r, n in top[:6]))
        lines.append(
            "  epoch  step    step_s   straggler   exposed    hidden"
            "   longest leg")
        rows = steps.get("steps") or []
        for row in rows[:max_steps]:
            srank = row.get("straggler")
            leg = (row.get("ranks") or {}).get(str(srank), {}) \
                .get("longest_leg") or {}
            lines.append(
                f"  {row['mem_epoch']:>5}  {row['step']:>4}  "
                f"{_opt_s(row.get('step_s')):>8}  {str(srank):>9}  "
                f"{_opt_s(row.get('exposed_comm_s')):>8}  "
                f"{_opt_s(row.get('hidden_comm_s')):>8}   "
                + (f"{leg.get('name')} {_opt_s(leg.get('dur_s'))}"
                   if leg else "n/a"))
        if len(rows) > max_steps:
            lines.append(f"  ... {len(rows) - max_steps} more steps")
    if rsum.get("n_requests"):
        lines.append(
            f"  requests: {rsum['n_requests']}   "
            f"service p50 {_opt_s(rsum.get('service_p50_s'))}   "
            f"p99 {_opt_s(rsum.get('service_p99_s'))}   "
            f"redispatched {rsum.get('redispatched', 0)}   "
            f"multi-incarnation {rsum.get('multi_incarnation', 0)}")
        lines.append(
            "  request            service     queue   prefill    decode"
            "  hops  incarnations")
        rows = reqs.get("requests") or []
        for r in rows[:max_requests]:
            rid = str(r.get("request_id") or r.get("trace_id"))[:16]
            lines.append(
                f"  {rid:<16} {_opt_s(r.get('service_s')):>9} "
                f"{_opt_s(r.get('queue_s')):>9} "
                f"{_opt_s(r.get('prefill_s')):>9} "
                f"{_opt_s(r.get('decode_s')):>9}  "
                f"{len(r.get('hops') or []):>4}  "
                f"{len(r.get('incarnations') or [])}"
                + ("  (redispatched)" if r.get("redispatches") else ""))
        if len(rows) > max_requests:
            lines.append(f"  ... {len(rows) - max_requests} more requests")
    if len(lines) == 1:
        lines.append("  (no attributable spans in the timeline)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# entry point: the audit of the schedule modes at --world ranks
# ---------------------------------------------------------------------------


class _MLP(nn.Module):
    """JAX report's ``_mlp``: ``n_layers`` tanh layers ``width -> width``,
    weights standard normal x 0.1 (numpy, seeded), biases zero."""

    def __init__(self, n_layers: int, width: int, device, seed: int = 0):
        super().__init__()
        rng = np.random.default_rng(seed)
        for i in range(n_layers):
            w = rng.standard_normal((width, width)).astype(np.float32) * 0.1
            self.register_parameter(f"l{i:02d}_w", nn.Parameter(
                torch.from_numpy(w).to(device)))
            self.register_parameter(f"l{i:02d}_b", nn.Parameter(
                torch.zeros(width, device=device)))
        self.n_layers = n_layers

    @property
    def device(self):
        return self.l00_w.device

    def forward(self, x):
        for i in range(self.n_layers):
            x = torch.tanh(x @ getattr(self, f"l{i:02d}_w")
                           + getattr(self, f"l{i:02d}_b"))
        return x


def _mlp_loss(m, b):
    return torch.mean((m(b["x"]) - b["y"]) ** 2)


def _build_parser():
    ap = argparse.ArgumentParser(
        description="overlap-efficiency audit of the schedule modes")
    ap.add_argument("--modes", default="dear,allreduce",
                    help="comma list of schedule modes to audit")
    ap.add_argument("--world", type=int, default=8,
                    help="ranks (spawned processes)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32,
                    help="global batch (split over the ranks)")
    ap.add_argument("--steps", type=int, default=10,
                    help="timed steps per mode")
    ap.add_argument("--json", default=None,
                    help="also write the full report as JSON here")
    ap.add_argument("--no-timeline", "--no-hlo", dest="no_timeline",
                    action="store_true",
                    help="skip the traced timeline (faster; --no-hlo is "
                         "the JAX CLI's name)")
    ap.add_argument("--device", type=str, default=None,
                    help="the card by default; 'cpu' audits gloo ranks")
    return ap


def _spawn(argv, world: int) -> int:
    """Run this CLI as ``world`` ranks; rank 0's output is echoed."""
    from dear_pytorch_tpu_torch.benchmarks.driver import run_cell

    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "report.log")
        cmd = [sys.executable, "-m", "dear_pytorch_tpu_torch.observability."
               "report", *argv]
        codes = run_cell(cmd, world, log, timeout=3600.0)
        out = open(log).read()
        print(out, end="", flush=True)
        bad = [r for r, c in enumerate(codes) if c != 0]
        for r in bad[1:] if bad[:1] == [0] else bad:
            print(f"--- rank {r} (exit {codes[r]}):\n"
                  + open(os.path.join(tmp, f"report.rank{r}.log")).read(),
                  file=sys.stderr)
        return 0 if not bad else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _build_parser().parse_args(argv)
    from dear_pytorch_tpu_torch._device import resolve_device
    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.parallel.dear import MODES

    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    bad = [m for m in modes if m not in MODES]
    if bad or args.world < 1 or args.batch % args.world:
        raise SystemExit(f"report: modes {bad} not in {MODES}, or "
                         f"--batch {args.batch} not split over --world "
                         f"{args.world}" if bad else
                         f"report: --batch {args.batch} must split over "
                         f"--world {args.world} >= 1")
    launched = backend.launched_size()
    if launched == 1 and args.world > 1:
        return _spawn(argv, args.world)
    if launched != args.world:
        raise SystemExit(f"report: launched as {launched} ranks, but "
                         f"--world {args.world}")
    resolve_device(args.device)          # raises without a card
    try:
        return _audit(args, modes)
    finally:
        backend.shutdown()


def _audit(args, modes) -> int:
    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.observability import overlap as OV
    from dear_pytorch_tpu_torch.observability import tracer as T
    from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd
    from dear_pytorch_tpu_torch.parallel.dear import build_train_step

    if os.environ.get(T.TELEMETRY_ENV) is None:
        T.configure()  # in-memory: the phase breakdown below needs spans
    group = backend.init(args.device)
    dev, world, rank = backend.device(), backend.size(), backend.rank()

    def say(s: str) -> None:
        if rank == 0:
            print(s, flush=True)

    per = args.batch // world
    batch = {"x": torch.zeros((per, args.width), device=dev),
             "y": torch.zeros((per, args.width), device=dev)}

    def build(mode: str, **kw):
        return build_train_step(
            _mlp_loss, _MLP(args.layers, args.width, dev), group=group,
            device=dev, mode=mode, nearby_layers=1,
            optimizer=fused_sgd(lr=0.01, momentum=0.9), **kw)

    say(f"fitting interconnect alpha-beta over {world} rank(s) "
        f"({group.name()} on {dev.type}) ...")
    alpha, beta = OV.fit_interconnect(group, device=dev)

    # communication-free compute time: the 'dear' schedule's ablation
    # switches (reference exclude_parts) — a measured number, not a model
    ts_compute = build("dear", exclude_parts=("reducescatter", "allgather"))
    compute_s, _ = OV.measure_step_time(
        ts_compute, ts_compute.init(), batch, steps=args.steps)
    ts_compute.close()
    say(f"compute-only step (exclude_parts ablation): "
        f"{compute_s * _MS:.3f} ms")

    reports: dict = {}
    for mode in modes:
        ts = build(mode)
        measured, state = OV.measure_step_time(ts, ts.init(), batch,
                                               steps=args.steps)
        timeline = None
        if not args.no_timeline:
            timeline, state = OV.measure_timeline(ts, state, batch)
        reports[mode] = OV.audit_train_step(
            ts, state, batch, alpha=alpha, beta=beta, mode=mode,
            measured_step_s=measured, compute_time_s=compute_s,
            timeline=timeline)
        ts.close()
        say(render_text(reports[mode]))

    if len(reports) > 1:
        say(render_comparison(reports))
    snap = T.snapshot()
    say(render_telemetry(snap))

    if args.json and rank == 0:
        payload = {
            "world": world,
            "alpha": alpha,
            "beta": beta,
            "compute_time_s": compute_s,
            "modes": {m: r.to_dict() for m, r in reports.items()},
            "telemetry": snap,
        }
        d = os.path.dirname(os.path.abspath(args.json))
        os.makedirs(d, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
