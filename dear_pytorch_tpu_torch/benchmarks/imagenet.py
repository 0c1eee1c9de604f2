"""Synthetic CNN training benchmark — the port of
``dear_pytorch_tpu/benchmarks/imagenet.py`` for every image model of the
zoo (the ResNets, DenseNets, Inception-v4, the VGGs, the vision
transformers and the MNIST convnet): the model trained with the DeAR
schedule (`parallel.dear`) on one fixed seeded batch of fake data, printing
images/s. The image is 224² (299² for ``inceptionv4``; ``mnistnet`` trains
on `models.data.synthetic_mnist_batch`, 28² grayscale), as in the JAX
CLI.

Example (on the card; ``--device cpu`` runs the plain PyTorch path):
  python -m dear_pytorch_tpu_torch.benchmarks.imagenet \\
      --model resnet50 --batch-size 64 --fp16 --mode dear --threshold 25

Each process drives one device; several processes form one data-parallel
group through the launcher variables of `comm.backend`, every rank draws
the same global batch and trains on its own slice. The BatchNorm running
statistics are the step's model state, averaged over the ranks once per
step (a ViT, a VGG and the MNIST net have none). The models with dropout
(VGG, MnistNet, a ViT with a rate) draw its masks from the step's
generator, as the JAX CLI's ``rngs={"dropout": rng}``. ``--stem`` applies
to the ResNets only. On the card the CLI sets
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

#: the image side by model (the JAX CLI's rule); 224 for the rest
IMAGE_SIZES = {"inceptionv4": 299, "mnistnet": 28}
#: the models whose forward takes ``train=`` and ``generator=`` (dropout)
_DROPOUT_PREFIXES = ("vit", "vgg", "mnistnet")


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
                        "exact repack of the 7x7/s2 conv (models/resnet.py); "
                        "ResNets only")
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
    name = args.model.lower()
    if name not in models.cnn_names():
        raise SystemExit(f"--model {args.model}: the port's CNNs are "
                         f"{models.cnn_names()}")
    resnet = name.startswith("resnet")
    if args.stem != "conv7" and not resnet:
        raise SystemExit("--stem s2d applies to ResNet models only")
    resolve_device(args.device)          # raises without a card
    group = backend.init(args.device)    # "cuda" or None: this rank's card
    dev, world = backend.device(), backend.size()
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True

    dtype = torch.bfloat16 if args.fp16 else torch.float32
    model = models.get_model(args.model, dtype=dtype, device=dev, seed=0,
                             **({"stem": args.stem} if resnet else {}))
    global_bs = args.batch_size * world
    if name == "mnistnet":
        batch = data.synthetic_mnist_batch(0, global_bs, device=dev)
    else:
        batch = data.synthetic_image_batch(
            0, global_bs, image_size=IMAGE_SIZES.get(name, 224),
            dtype=dtype, device=dev)
    dropout = name.startswith(_DROPOUT_PREFIXES)

    def loss_fn(m, b, generator):
        # dropout from the step's generator (a ViT's rate is 0 unless its
        # config says otherwise); the BN models have none
        logits = (m(b["image"], train=True, generator=generator) if dropout
                  else m(b["image"]))
        # MnistNet's log-probabilities too: log_softmax is idempotent
        return data.softmax_xent(logits, b["label"])

    return runner.train_timed(
        args, model, batch, loss_fn, group=group, unit="img",
        on_step=on_step, header=[
            f"Model: {args.model}" + (f" (stem {args.stem})" if resnet
                                      else ""),
            f"BF16: {args.fp16}",
            f"Batch size: {args.batch_size} (per rank), {global_bs} global"])


if __name__ == "__main__":
    main().train_step.close()   # dear-fused: after every rank's last call
    backend.shutdown()
