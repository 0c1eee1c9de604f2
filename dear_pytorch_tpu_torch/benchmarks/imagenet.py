"""Synthetic CNN training benchmark — the port of
``dear_pytorch_tpu/benchmarks/imagenet.py`` for the ResNets: a ResNet
trained with the DeAR schedule (`parallel.dear`) on one fixed seeded batch
of fake ImageNet data, printing images/s.

Example (on the card; ``--device cpu`` runs the plain PyTorch path):
  python -m dear_pytorch_tpu_torch.benchmarks.imagenet \\
      --model resnet50 --batch-size 64 --fp16 --mode dear --threshold 25

Each process drives one device; several processes form one data-parallel
group through the launcher variables of `comm.backend`, every rank draws
the same global batch and trains on its own slice. The BatchNorm running
statistics are the step's model state, averaged over the ranks once per
step. On the card the CLI sets ``torch.backends.cudnn.benchmark`` (cuDNN
picks each conv's algorithm by timing it at the first call of each shape,
during the warmup). The JAX CLI's ``--pipeline``, ``--scan-steps``,
``--mgwfbp`` and ``--mfu`` are not ported (argparse errors).
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch

from dear_pytorch_tpu_torch import models
from dear_pytorch_tpu_torch._device import resolve_device
from dear_pytorch_tpu_torch.api import broadcast_parameters
from dear_pytorch_tpu_torch.benchmarks import runner
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.models import data
from dear_pytorch_tpu_torch.parallel.dear import build_train_step

IMAGE_SIZE = 224


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Synthetic CNN Benchmark (PyTorch port); on the card "
                    "it sets torch.backends.cudnn.benchmark",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model", type=str, default="resnet50",
                   help=f"one of {models.cnn_names()}")
    p.add_argument("--stem", type=str, default="conv7",
                   choices=["conv7", "s2d"],
                   help="ResNet stem: 's2d' = the space-to-depth stem, the "
                        "exact repack of the 7x7/s2 conv (models/resnet.py)")
    runner.add_common_args(p)
    return p


def main(argv=None, on_step: Optional[Callable] = None
         ) -> runner.BenchResult:
    """Run the benchmark; returns the `runner.BenchResult` with the
    per-step losses (floats, read once after the run) as ``.losses``, the
    train step as ``.train_step`` (the model is its ``.model``), its last
    state as ``.state`` and this rank's batch as ``.batch``.
    ``on_step(train_step, state, metrics)`` is called after every step
    (warmup included)."""
    args = build_parser().parse_args(argv)
    if args.model.lower() not in models.cnn_names():
        raise SystemExit(f"--model {args.model}: the port's CNNs are "
                         f"{models.cnn_names()} (the rest of the zoo: "
                         "ROADMAP Queue 1 item 5b)")
    resolve_device(args.device)          # raises without a card
    group = backend.init(args.device)    # "cuda" or None: this rank's card
    dev = backend.device()
    world, rank = backend.size(), backend.rank()
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True

    dtype = torch.bfloat16 if args.fp16 else torch.float32
    model = models.get_model(args.model, dtype=dtype, device=dev,
                             stem=args.stem, seed=0)
    broadcast_parameters(model, group=group)   # parameters and buffers

    global_bs = args.batch_size * world
    batch = data.synthetic_image_batch(0, global_bs, image_size=IMAGE_SIZE,
                                       dtype=dtype, device=dev)
    batch = {k: v[rank * args.batch_size:(rank + 1) * args.batch_size]
             for k, v in batch.items()}

    def loss_fn(m, b, generator):   # no dropout in a ResNet
        del generator
        return data.softmax_xent(m(b["image"]), b["label"])

    dear_cfg = runner.config_from_args(args, world=world)
    ts = build_train_step(loss_fn, model, group=group,
                          threshold_mb=dear_cfg.threshold_mb,
                          nearby_layers=dear_cfg.nearby_layers,
                          flags=dear_cfg.flags, device=dev,
                          **dear_cfg.build_kwargs())
    holder = {"state": ts.init(), "losses": []}

    runner.log(f"Model: {args.model} (stem {args.stem})")
    runner.log(f"BF16: {args.fp16}")
    runner.log(f"Batch size: {args.batch_size} (per rank), {global_bs} "
               "global")
    runner.log(f"Number of {runner.device_name(dev)}s: {world}")
    runner.log(f"Schedule: {args.mode}; fusion: {ts.plan.num_buckets} "
               "bucket(s)")

    def step_fn():
        holder["state"], metrics = ts.step(holder["state"], batch)
        holder["losses"].append(metrics["loss"])
        if on_step is not None:
            on_step(ts, holder["state"], metrics)

    sync = torch.cuda.synchronize if dev.type == "cuda" else None
    result = runner.run_timed(
        step_fn, batch_size=args.batch_size,
        num_warmup_batches=args.num_warmup_batches,
        num_batches_per_iter=args.num_batches_per_iter,
        num_iters=args.num_iters, unit="img", sync=sync, world=world,
        device=runner.device_name(dev))
    result.losses = [float(x) for x in holder["losses"]]
    result.train_step, result.state, result.batch = ts, holder["state"], batch
    return result


if __name__ == "__main__":
    main().train_step.close()   # dear-fused: after every rank's last call
    backend.shutdown()
