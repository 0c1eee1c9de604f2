"""Shared benchmark runner — the port of what
``dear_pytorch_tpu/benchmarks/runner.py`` gives the GPT CLI: the
reference's measurement protocol (``num_warmup_batches`` untimed steps,
then ``num_iters`` timed runs of ``num_batches_per_iter`` steps, a
throughput per run and the mean ± 1.96σ), the common flags, and the flags
-> `DearConfig` mapping.

Only the flags the port carries are registered: an unported flag of the
JAX CLI (``--compressor``, ``--pipeline``, ``--scan-steps``, ...) is an
argparse error, not silently ignored; ``--mode`` other than ``dear`` and
``dear-fused``, and ``--optimizer lamb``, raise ``NotImplementedError``
when the step is built.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from dear_pytorch_tpu_torch.comm import backend

__all__ = ["BenchResult", "add_common_args", "config_from_args",
           "device_name", "log", "run_timed"]


@dataclasses.dataclass
class BenchResult:
    unit: str                  # 'sen' (sequences) here
    device: str                # 'GPU' or 'CPU'
    world: int
    per_device_mean: float
    per_device_conf: float     # 1.96 sigma
    iter_time_mean: float      # seconds per step
    iter_time_conf: float
    per_iter: list = dataclasses.field(default_factory=list)
    #: seconds per step of each timed run
    iter_times: list = dataclasses.field(default_factory=list)

    @property
    def total_mean(self) -> float:
        return self.world * self.per_device_mean

    @property
    def total_conf(self) -> float:
        return self.world * self.per_device_conf


def log(s: str, nl: bool = True) -> None:
    """Rank-0 printing."""
    if backend.rank() != 0:
        return
    print(s, end="\n" if nl else "", flush=True)


def device_name(device: Optional[torch.device] = None) -> str:
    dev = device or backend.device()
    return {"cuda": "GPU", "cpu": "CPU"}.get(dev.type, dev.type.upper())


def run_timed(step_fn: Callable[[], Any], *, batch_size: int,
              num_warmup_batches: int = 10, num_batches_per_iter: int = 10,
              num_iters: int = 5, unit: str = "sen",
              sync: Optional[Callable[[], None]] = None,
              world: Optional[int] = None, device: Optional[str] = None
              ) -> BenchResult:
    """The warmup + timed-iteration protocol around ``step_fn`` (one
    training step, enqueued asynchronously on the card); ``sync`` blocks
    until the enqueued work is done (pass one: on the card,
    ``torch.cuda.synchronize``)."""
    dev = device or device_name()
    world = backend.size() if world is None else world
    log("Running warmup...")
    for _ in range(num_warmup_batches):
        step_fn()
    if sync is not None:
        sync()
    log("Running benchmark...")
    per_iter, iter_times = [], []
    for x in range(num_iters):
        t0 = time.perf_counter()
        for _ in range(num_batches_per_iter):
            step_fn()
        if sync is not None:
            sync()
        dt = time.perf_counter() - t0
        thr = batch_size * num_batches_per_iter / dt
        log(f"Iter #{x}: {thr:.1f} {unit}/sec per {dev}")
        per_iter.append(thr)
        iter_times.append(dt / num_batches_per_iter)
    res = BenchResult(
        unit=unit, device=dev, world=world,
        per_device_mean=float(np.mean(per_iter)),
        per_device_conf=float(1.96 * np.std(per_iter)),
        iter_time_mean=float(np.mean(iter_times)),
        iter_time_conf=float(1.96 * np.std(iter_times)),
        per_iter=per_iter, iter_times=iter_times)
    log(f"Iteration time: {res.iter_time_mean:.3f} +-{res.iter_time_conf:.3f}")
    log(f"{unit.capitalize()}/sec per {dev}: "
        f"{res.per_device_mean:.1f} +-{res.per_device_conf:.1f}")
    log(f"Total {unit}/sec on {res.world} {dev}(s): "
        f"{res.total_mean:.1f} +-{res.total_conf:.1f}")
    return res


def add_common_args(parser) -> None:
    """The flags of the JAX CLIs that the port carries."""
    parser.add_argument("--fp16", action="store_true", default=False,
                        help="bfloat16 compute; gradients travel in bf16")
    parser.add_argument("--batch-size", type=int, default=32,
                        help="input batch size PER RANK")
    parser.add_argument("--num-warmup-batches", type=int, default=10)
    parser.add_argument("--num-batches-per-iter", type=int, default=10)
    parser.add_argument("--num-iters", type=int, default=5)
    parser.add_argument("--mode", type=str, default="dear",
                        choices=["dear", "dear-fused", "allreduce", "rsag",
                                 "rb", "bytescheduler", "fsdp"],
                        help="communication schedule ('dear' and "
                             "'dear-fused' are ported; the others raise)")
    parser.add_argument("--threshold", type=float, default=25.0,
                        help="tensor-fusion threshold in MB; <= 0: one "
                             "bucket")
    parser.add_argument("--nearby-layers", type=int, default=None,
                        help="fuse every k layers instead of by threshold")
    parser.add_argument("--accum-steps", type=int, default=1,
                        help="gradient accumulation microbatches per step")
    parser.add_argument("--base-lr", type=float, default=0.01)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--optimizer", type=str, default="sgd",
                        choices=["sgd", "adamw", "lamb"],
                        help="shard optimizer (lamb is not ported yet)")
    parser.add_argument("--clip-norm", type=float, default=None,
                        help="clip gradients to this global L2 norm")
    parser.add_argument("--lr-schedule", type=str, default=None,
                        choices=["linear", "cosine", "multistep"])
    parser.add_argument("--warmup-steps", type=int, default=0)
    parser.add_argument("--total-steps", type=int, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="the card by default; 'cpu' runs the plain "
                             "PyTorch path over a gloo group")


def config_from_args(args, *, world: Optional[int] = None):
    """CLI args -> `DearConfig` (``DEAR_*`` variables fill the rest). With
    ``--fp16`` gradients travel in bf16, and the gathers travel in bf16
    only when world > 1 (at world 1 there is no gather traffic to halve,
    and the pre-gather cast is pure overhead: the JAX package's rule)."""
    from dear_pytorch_tpu_torch.config import DearConfig

    return DearConfig.from_env(
        mode=args.mode,
        threshold_mb=args.threshold if args.threshold > 0 else None,
        nearby_layers=args.nearby_layers,
        optimizer_name=args.optimizer,
        lr=args.base_lr,
        momentum=args.momentum,
        clip_norm=args.clip_norm,
        **{k: v for k, v in {
            "lr_schedule": args.lr_schedule,
            "warmup_steps": args.warmup_steps,
            "total_steps": args.total_steps,
        }.items() if v},
        comm_dtype=torch.bfloat16 if args.fp16 else None,
        gather_dtype=(torch.bfloat16 if args.fp16 and world != 1
                      and args.mode == "dear" else None),
        rng_seed=42,
        accum_steps=args.accum_steps,
    )
