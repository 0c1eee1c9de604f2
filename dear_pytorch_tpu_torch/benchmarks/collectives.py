"""Collective microbenchmark CLI — GB/s per collective vs message size;
the port of ``dear_pytorch_tpu/benchmarks/collectives.py``.

The reference measures its collectives with mpirun-driven loops printing
size/time/bandwidth tables (`reduce`/`perf_benchmarks`,
common/comm_core/tests/test_comm.py:85-120,148-177). This sweeps the
port's `comm.collectives` ops over the process group (NCCL with one card
per rank, gloo on the CPU or where ranks share a card), each size timed by
`utils.profiling.CommunicationProfiler`, plus the fitted α-β model the
MG-WFBP planner consumes. Every rank runs it; rank 0 prints.

Example (one rank on the card; ``--device cpu`` for a gloo group, and the
launcher variables of `comm.backend` for more ranks):
  python -m dear_pytorch_tpu_torch.benchmarks.collectives \\
      --sizes-log2 10:21:2

Bandwidth columns:
  bw     = payload bytes / time (what the reference prints)
  busbw  = ring bus bandwidth, bw × 2(n-1)/n for all-reduce-family ops and
           bw × (n-1)/n for RS/AG — comparable across world sizes.
"""

from __future__ import annotations

import argparse
import json

import torch

from dear_pytorch_tpu_torch._device import resolve_device
from dear_pytorch_tpu_torch.benchmarks import runner
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.utils import perf_model
from dear_pytorch_tpu_torch.utils.profiling import CommunicationProfiler

COLLECTIVES = ("all_reduce", "reduce_scatter", "all_gather",
               "all_reduce_rsag")
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="collective microbenchmarks over the process group",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--collectives", type=str, default=",".join(COLLECTIVES),
                   help="comma list from " + "/".join(COLLECTIVES))
    p.add_argument("--sizes-log2", type=str, default="10:27:2",
                   help="element-count sweep as log2 start:stop:step")
    p.add_argument("--dtype", type=str, default="f32",
                   choices=sorted(_DTYPES))
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--json", type=str, default=None,
                   help="dump the sweep + alpha-beta fits to this file")
    p.add_argument("--device", type=str, default=None,
                   help="the card by default; 'cpu' sweeps a gloo group")
    return p


def _bus_factor(name: str, world: int) -> float:
    if world <= 1:
        return 1.0
    if name in ("all_reduce", "all_reduce_rsag"):
        return 2.0 * (world - 1) / world
    return (world - 1) / world  # reduce_scatter / all_gather


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    try:
        lo, hi, step = (int(v) for v in args.sizes_log2.split(":"))
    except ValueError:
        raise SystemExit(f"--sizes-log2 {args.sizes_log2!r}: want lo:hi:step")
    if step < 1 or hi <= lo or lo < 0:
        raise SystemExit(
            f"--sizes-log2 {args.sizes_log2!r}: want 0 <= lo < hi, step >= 1"
        )
    sizes = [2 ** k for k in range(lo, hi, step)]
    names = [c.strip() for c in args.collectives.split(",") if c.strip()]
    for c in names:
        if c not in COLLECTIVES:
            raise SystemExit(f"unknown collective {c!r}")
    resolve_device(args.device)          # raises without a card
    group = backend.init(args.device)
    world = backend.size()

    runner.log(f"world: {world} {runner.device_name()}(s) "
               f"({group.name()}), dtype {args.dtype}, "
               f"{args.repeats} repeats")
    out = {"world": world, "dtype": args.dtype, "backend": group.name(),
           "collectives": {}}
    for name in names:
        prof = CommunicationProfiler(group, collective=name,
                                     dtype=_DTYPES[args.dtype])
        sizes_bytes, times = prof.benchmark(
            sizes, repeats=args.repeats, warmup=args.warmup
        )
        alpha, beta = perf_model.fit_alpha_beta(sizes_bytes, times)
        runner.log(f"\n[{name}]  fitted alpha={alpha * 1e6:.1f} us  "
                   f"beta={beta * 1e9:.3f} ns/B"
                   + (f"  ({1 / beta / 1e9:.2f} GB/s asymptotic)"
                      if beta > 0 else ""))
        runner.log(f"  {'bytes':>12} {'time':>10} {'bw GB/s':>9} "
                   f"{'busbw GB/s':>10}")
        rows = []
        for nbytes, t in zip(sizes_bytes, times):
            bw = nbytes / t / 1e9 if t > 0 else float("inf")
            busbw = bw * _bus_factor(name, world)
            runner.log(f"  {nbytes:>12d} {t * 1e6:>8.1f}us {bw:>9.3f} "
                       f"{busbw:>10.3f}")
            rows.append({"bytes": nbytes, "time_s": t, "bw_gbs": bw,
                         "busbw_gbs": busbw})
        out["collectives"][name] = {
            "alpha_s": alpha, "beta_s_per_byte": beta, "rows": rows,
        }
    if args.json and backend.rank() == 0:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
    backend.shutdown()
