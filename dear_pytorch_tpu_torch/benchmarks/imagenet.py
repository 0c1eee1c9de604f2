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
counts one step's FLOPs (`runner.step_flops`) and logs the MFU.
``--autotune {bo,wait_time,plan}``, ``--tune-steps``, ``--mgwfbp`` and
``--scan-steps`` are the JAX CLI's (`runner.build_stepper`,
`runner.make_step_source`), and so are ``--pipeline``, ``--profile-dir``
and ``--metrics-file`` (`runner.make_batch_source`): a streamed batch is
the JAX CLI's ``image_spec`` / ``mnist_spec`` of the global batch, NHWC on
the host, permuted to the models' NCHW on the card (a channels-last view,
which the ResNets take without a copy). `setup_cnn` builds the model,
batch and loss for one world; the scaling sweep calls it per world.
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


def _nhwc_to_nchw(batch: dict) -> dict:
    """A streamed batch's images (NHWC, the pipeline's layout) as the
    models' NCHW: a view, channels-last in memory."""
    return dict(batch, image=batch["image"].permute(0, 3, 1, 2))


def _check_model(args) -> tuple:
    """``(name, is a ResNet)`` of ``--model``, refusing what the CLI does
    not run (the JAX CLI's rules and messages)."""
    name = args.model.lower()
    if name not in models.cnn_names():
        raise SystemExit(f"--model {args.model}: the port's CNNs are "
                         f"{models.cnn_names()}")
    resnet = name.startswith("resnet")
    if getattr(args, "stem", "conv7") != "conv7" and not resnet:
        raise SystemExit("--stem s2d applies to ResNet models only")
    return name, resnet


def setup_cnn(args, world: int, device):
    """Model, fake data and loss of a CNN benchmark at ``world`` ranks (JAX
    imagenet.py:42). Returns ``(model, loss_fn, batch, spec, layout,
    image_size, global_bs)``: the global constant batch on ``device``, the
    input pipeline's spec of the same global batch and its map to the
    model's layout. Shared by the throughput CLI and the scaling sweep
    (`benchmarks.scaling`), which calls it once per world."""
    from dear_pytorch_tpu_torch.runtime import pipeline as RP

    name, resnet = _check_model(args)
    dtype = torch.bfloat16 if args.fp16 else torch.float32
    model = models.get_model(args.model, dtype=dtype, device=device, seed=0,
                             **({"stem": args.stem} if resnet else {}))
    image_size = IMAGE_SIZES.get(name, 224)
    global_bs = args.batch_size * world
    if name == "mnistnet":
        batch = data.synthetic_mnist_batch(0, global_bs, device=device)
        spec = RP.mnist_spec(global_bs)
    else:
        batch = data.synthetic_image_batch(
            0, global_bs, image_size=image_size, dtype=dtype, device=device)
        spec = RP.image_spec(global_bs, image_size=image_size)
    dropout = name.startswith(_DROPOUT_PREFIXES)

    def loss_fn(m, b, generator):
        # dropout from the step's generator (a ViT's rate is 0 unless its
        # config says otherwise); the BN models have none
        logits = (m(b["image"], train=True, generator=generator) if dropout
                  else m(b["image"]))
        # MnistNet's log-probabilities too: log_softmax is idempotent
        return data.softmax_xent(logits, b["label"])

    return (model, loss_fn, batch, spec, _nhwc_to_nchw, image_size,
            global_bs)


def main(argv=None, on_step: Optional[Callable] = None
         ) -> runner.BenchResult:
    """Run the benchmark; returns the `runner.BenchResult` with the
    per-step losses (floats, read once after the run) as ``.losses``, the
    train step as ``.train_step`` (the model is its ``.model``), its last
    state as ``.state``, this rank's constant batch as ``.batch`` and the
    input pipeline as ``.pipeline``. ``on_step(train_step, state,
    metrics)`` is called after every step (warmup included)."""
    args = build_parser().parse_args(argv)
    runner.validate_scan_steps(args)     # refuse before building
    _, resnet = _check_model(args)
    resolve_device(args.device)          # raises without a card
    group = backend.init(args.device)    # "cuda" or None: this rank's card
    dev, world = backend.device(), backend.size()
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True

    (model, loss_fn, batch, spec, layout, _size,
     global_bs) = setup_cnn(args, world, dev)
    return runner.train_timed(
        args, model, batch, loss_fn, group=group, unit="img",
        on_step=on_step, spec=spec, layout=layout, header=[
            f"Model: {args.model}" + (f" (stem {args.stem})" if resnet
                                      else ""),
            f"BF16: {args.fp16}",
            f"Batch size: {args.batch_size} (per rank), {global_bs} global"])


if __name__ == "__main__":
    main().train_step.close()   # dear-fused: after every rank's last call
    backend.shutdown()
