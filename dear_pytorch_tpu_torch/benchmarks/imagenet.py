"""Synthetic CNN training benchmark — the port of
``dear_pytorch_tpu/benchmarks/imagenet.py`` for the ResNets and the vision
transformers (``vit_s16``, ``vit_b16``): the model trained with the DeAR
schedule (`parallel.dear`) on one fixed seeded batch of fake ImageNet data,
printing images/s.

Example (on the card; ``--device cpu`` runs the plain PyTorch path):
  python -m dear_pytorch_tpu_torch.benchmarks.imagenet \\
      --model resnet50 --batch-size 64 --fp16 --mode dear --threshold 25

Each process drives one device; several processes form one data-parallel
group through the launcher variables of `comm.backend`, every rank draws
the same global batch and trains on its own slice. The BatchNorm running
statistics are the step's model state, averaged over the ranks once per
step (a ViT has none). On the card the CLI sets
``torch.backends.cudnn.benchmark`` (cuDNN picks each conv's algorithm by
timing it at the first call of each shape, during the warmup). ``--mfu``
counts one step's FLOPs (`runner.step_flops`) and logs the MFU. The JAX
CLI's ``--pipeline``, ``--scan-steps`` and ``--mgwfbp`` are not ported
(argparse errors).
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch

from dear_pytorch_tpu_torch import models
from dear_pytorch_tpu_torch._device import resolve_device
from dear_pytorch_tpu_torch.benchmarks import runner
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.models import data

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
    dev, world = backend.device(), backend.size()
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True

    dtype = torch.bfloat16 if args.fp16 else torch.float32
    vit = args.model.lower().startswith("vit")
    model = models.get_model(args.model, dtype=dtype, device=dev, seed=0,
                             **({} if vit else {"stem": args.stem}))
    global_bs = args.batch_size * world
    batch = data.synthetic_image_batch(0, global_bs, image_size=IMAGE_SIZE,
                                       dtype=dtype, device=dev)

    def loss_fn(m, b, generator):
        # a ResNet has no dropout; a ViT's dropout is off (rate 0) unless
        # its config says otherwise, as the JAX CLI's train=True runs it
        logits = (m(b["image"], train=True, generator=generator) if vit
                  else m(b["image"]))
        return data.softmax_xent(logits, b["label"])

    return runner.train_timed(
        args, model, batch, loss_fn, group=group, unit="img",
        on_step=on_step, header=[
            f"Model: {args.model}" + ("" if vit else f" (stem {args.stem})"),
            f"BF16: {args.fp16}",
            f"Batch size: {args.batch_size} (per rank), {global_bs} global"])


if __name__ == "__main__":
    main().train_step.close()   # dear-fused: after every rank's last call
    backend.shutdown()
