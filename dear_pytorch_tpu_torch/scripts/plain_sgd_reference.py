"""An image model of the zoo trained with plain ``torch.optim.SGD`` on the
ImageNet CLI's setup, as an independent reference for the CLI's
``--mode dear`` run at one rank: the same seeded model (``seed=0``) and
fixed batch (``synthetic_image_batch(0, B)``, MNIST's for ``mnistnet``),
the same dropout masks (the DeAR step's per-step generator for the CLI's
``rng_seed`` 42, rank 0, one microbatch), SGD lr 0.01 momentum 0.9, and
with ``--fp16`` bf16 compute and gradients rounded to bf16 before the
update (the CLI's ``comm_dtype``):

  python3 -m dear_pytorch_tpu_torch.scripts.plain_sgd_reference \\
      --model vgg16 --batch-size 64 --steps 20 --fp16 [--device cpu]

It prints the per-step training losses and, at init and every 5th step,
the loss on the batch without dropout (BatchNorm on the batch's
statistics, as in training). ``--fp32-grads`` keeps the gradients in
fp32.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dear_pytorch_tpu_torch import models
from dear_pytorch_tpu_torch._device import resolve_device
from dear_pytorch_tpu_torch.benchmarks.imagenet import (
    _DROPOUT_PREFIXES, IMAGE_SIZES,
)
from dear_pytorch_tpu_torch.models.data import (
    softmax_xent, synthetic_image_batch, synthetic_mnist_batch,
)

#: the CLI's ``rng_seed`` (`benchmarks.runner`)
RNG_SEED = 42


def step_generator(step: int, device) -> torch.Generator:
    """The DeAR step's dropout generator for ``step`` at rank 0, one
    microbatch (`parallel.dear.TrainStep._generator`)."""
    seed = np.random.SeedSequence([RNG_SEED, step, 0, 0]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(
        int(seed) & (2**63 - 1))


def main(argv=None) -> tuple:
    """Returns (the training losses, the dropout-free losses at init and
    every 5th step)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="vgg16")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--fp16", action="store_true")
    p.add_argument("--fp32-grads", action="store_true")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    name = args.model.lower()
    dt = torch.bfloat16 if args.fp16 else torch.float32
    model = models.get_model(name, dtype=dt, device=dev, seed=0)
    batch = (synthetic_mnist_batch(0, args.batch_size, device=dev)
             if name == "mnistnet" else synthetic_image_batch(
                 0, args.batch_size, image_size=IMAGE_SIZES.get(name, 224),
                 dtype=dt, device=dev))
    dropout = name.startswith(_DROPOUT_PREFIXES)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)

    def clean_loss() -> float:
        with torch.no_grad():
            return float(softmax_xent(model(batch["image"]),
                                      batch["label"]))

    losses, clean = [], [clean_loss()]
    for step in range(args.steps):
        logits = (model(batch["image"], train=True,
                        generator=step_generator(step, dev))
                  if dropout else model(batch["image"]))
        loss = softmax_xent(logits, batch["label"])
        loss.backward()
        if args.fp16 and not args.fp32_grads:
            for q in model.parameters():
                q.grad = q.grad.bfloat16().float()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
        if (step + 1) % 5 == 0:
            clean.append(clean_loss())
    grads = "fp32" if args.fp32_grads or not args.fp16 else "bf16"
    print(f"plain SGD {name} (B={args.batch_size}, {dt}, {grads} "
          f"gradients) losses {[round(x, 4) for x in losses]}")
    print(f"plain SGD {name} loss without dropout at steps "
          f"{list(range(0, args.steps + 1, 5))}: "
          f"{[round(x, 4) for x in clean]}")
    return losses, clean


if __name__ == "__main__":
    main()
