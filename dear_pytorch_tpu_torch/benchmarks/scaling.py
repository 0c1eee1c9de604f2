"""Scaling-efficiency sweep: one CLI run, one throughput point per world —
the port of ``dear_pytorch_tpu/benchmarks/scaling.py``.

The reference measures scaling by re-running `benchmarks.py` per
``nworkers`` over mpirun hostfiles (configs/cluster{8..64}). JAX loops
over sub-meshes of one process; here the CLI is launched as the largest
world (the launcher variables of `comm.backend`, one process per rank),
and world k trains on ``dist.new_group(range(k))`` inside it while the
ranks at and above k sit idle until the next world. Efficiency is the
per-rank throughput retention relative to the smallest world (weak
scaling: the per-rank batch is fixed, the reference's protocol).

Example (one rank on the card; ``--device cpu`` and the launcher
variables for a gloo world of several ranks):
  python -m dear_pytorch_tpu_torch.benchmarks.scaling --model resnet50 \\
      --worlds 1

Prints one ``Total img/sec ...`` line per world (the driver's scrape
format) plus a final ``Scaling efficiency`` summary and an optional
``--json`` dump.
"""

from __future__ import annotations

import argparse
import json
import warnings

import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch._device import resolve_device
from dear_pytorch_tpu_torch.benchmarks import imagenet, runner
from dear_pytorch_tpu_torch.comm import backend


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="scaling-efficiency sweep (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--model", type=str, default="resnet50")
    p.add_argument("--stem", type=str, default="conv7",
                   choices=["conv7", "s2d"])
    p.add_argument("--worlds", type=str, default=None,
                   help="comma list of rank counts (default: powers of "
                        "two up to the launched world)")
    p.add_argument("--json", type=str, default=None,
                   help="write {world: img_per_sec_per_device} plus "
                        "efficiencies to this file")
    runner.add_common_args(p)
    return p


def _parse_worlds(spec, ndev: int) -> list[int]:
    if spec:
        worlds = sorted({int(w) for w in spec.split(",") if w.strip()})
    else:
        worlds, k = [], 1
        while k <= ndev:
            worlds.append(k)
            k *= 2
    bad = [w for w in worlds if w < 1 or w > ndev]
    if bad:
        raise SystemExit(f"--worlds {bad} out of range (1..{ndev} devices)")
    return worlds


def _sweep(args, worlds, metrics_log) -> dict:
    """{world: img/s/rank} for each world; every rank joins every
    world's group, the ranks below k train in it."""
    dev, rank = backend.device(), backend.rank()
    per_dev: dict[int, float] = {}
    for k in worlds:
        sub = dist.new_group(list(range(k)))
        if rank < k:
            (model, loss_fn, batch, _spec, _layout, _size,
             global_bs) = imagenet.setup_cnn(args, k, dev)
            runner.log(f"--- world {k}: global batch {global_bs} ---")
            if metrics_log is not None:
                metrics_log.log(event="world_start", world=k)
            res = runner.train_timed(
                args, model, batch, loss_fn, group=sub, unit="img",
                header=[], metrics=metrics_log)
            per_dev[k] = res.per_device_mean
            res.train_step.close()
            del res, model, batch
            dist.destroy_process_group(sub)
        backend.barrier()
    return per_dev


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    # accepted-but-inactive options (config_from_args convention): the
    # sweep measures the fixed-batch protocol only
    if args.pipeline != "none":
        warnings.warn("--pipeline is ignored by the scaling sweep "
                      "(fixed-batch protocol)")
        args.pipeline = "none"
    if args.mfu or args.profile_dir:
        warnings.warn("--mfu/--profile-dir are ignored by the scaling sweep")
        args.mfu, args.profile_dir = False, None
    if getattr(args, "scan_steps", 1) > 1:
        warnings.warn("--scan-steps is ignored by the scaling sweep")
        args.scan_steps = 1
    worlds = _parse_worlds(args.worlds, backend.launched_size())
    resolve_device(args.device)          # raises without a card
    backend.init(args.device)
    if backend.device().type == "cuda":
        torch.backends.cudnn.benchmark = True

    metrics_log = runner.metrics_from_args(args)
    try:
        per_dev = _sweep(args, worlds, metrics_log)
    finally:
        if metrics_log is not None:
            metrics_log.close()

    out = {"model": args.model, "mode": args.mode,
           "batch_size_per_device": args.batch_size}
    if backend.rank() != 0:
        return out
    base_world = worlds[0]
    eff = {k: per_dev[k] / per_dev[base_world] for k in worlds}
    runner.log("")
    runner.log(f"Weak scaling vs {base_world} device(s) "
               f"[{args.model}, bs {args.batch_size}/device, {args.mode}]:")
    for k in worlds:
        runner.log(f"  {k:4d} device(s): {per_dev[k]:9.1f} img/s/device  "
                   f"efficiency {100 * eff[k]:5.1f}%")
    runner.log(f"Scaling efficiency ({base_world}->{worlds[-1]} devices): "
               f"{100 * eff[worlds[-1]]:.1f}%")
    out.update(per_device_img_sec=per_dev, efficiency=eff)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
    backend.shutdown()
