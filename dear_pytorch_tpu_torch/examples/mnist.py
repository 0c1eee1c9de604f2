"""The framework's hello world in PyTorch — the port of ``examples/mnist.py``.

It walks the JAX example's path: join the process group, build the model
(`models.mnist.MnistNet`), wrap training in the DeAR schedule
(`parallel.dear.build_train_step`, ``mode="dear"``, the fused SGD shard
optimizer) with rank 0's start state broadcast, then train with a
per-epoch evaluation on the held-out split whose accuracy is averaged over
the ranks. Each process walks its own shard of every epoch's permutation
(`models.data.ShardedSampler`, torch's ``DistributedSampler`` semantics)
and trains on ``--batch-size / world`` of it per step; dropout draws its
masks from the step's generator (``rng_seed`` 1234).

The data (``--data real``, the default) are the real handwritten digits
bundled with scikit-learn (`models.data.load_real_digits`: 8x8 digits
resized to 28x28, a seeded train/test split); without scikit-learn that
raises ``ImportError`` — nothing falls back on its own. ``--data
synthetic`` trains on deterministic class-template images instead.

Run (on the card; ``--device cpu`` runs the plain PyTorch path):
  python -m dear_pytorch_tpu_torch.examples.mnist --epochs 3 --batch-size 64

``--checkpoint-dir`` and ``--resume`` wait for the port's checkpoints and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from dear_pytorch_tpu_torch._device import resolve_device
from dear_pytorch_tpu_torch.api import broadcast_parameters, world_info
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import collectives as C
from dear_pytorch_tpu_torch.models.data import ShardedSampler
from dear_pytorch_tpu_torch.models.mnist import MnistNet
from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd
from dear_pytorch_tpu_torch.parallel.dear import build_train_step


def synthetic_mnist(n: int, seed: int = 0):
    """Deterministic class-template images, the JAX example's: ``(images
    [n, 28, 28, 1] float32, labels [n] int64)``. The 10 templates are
    fixed (seed 42), so train and test share their classes; ``seed``
    varies the draw."""
    templates = np.random.default_rng(42).normal(
        0.0, 1.0, size=(10, 28, 28, 1)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    images = templates[labels] + rng.normal(
        0.0, 0.8, size=(n, 28, 28, 1)).astype(np.float32)
    return images, labels


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MNIST example (PyTorch port)")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=64,
                   help="GLOBAL batch size (split over the ranks)")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.5)
    p.add_argument("--threshold", type=float, default=25.0,
                   help="fusion threshold MB")
    p.add_argument("--mode", type=str, default="dear",
                   choices=["dear", "allreduce", "rsag", "rb"],
                   help="schedule ('dear' is ported; the others raise)")
    p.add_argument("--data", type=str, default="real",
                   choices=["real", "synthetic"],
                   help="'real': scikit-learn's bundled handwritten-digit "
                        "corpus; 'synthetic': class-template stand-in")
    p.add_argument("--train-size", type=int, default=4096,
                   help="synthetic-data sample count (real data uses the "
                        "corpus' own split)")
    p.add_argument("--test-size", type=int, default=1024)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="the card by default; 'cpu' runs the plain "
                        "PyTorch path over a gloo group")
    return p


def main(argv=None) -> float:
    """Train; returns the last held-out accuracy (averaged over ranks)."""
    args = build_parser().parse_args(argv)
    if args.checkpoint_dir or args.resume:
        raise NotImplementedError(
            "--checkpoint-dir / --resume: the port's checkpoints are not "
            "ported yet (ROADMAP Queue 1 item 9)")
    resolve_device(args.device)          # raises without a card
    group = backend.init(args.device)
    dev, world, rank = backend.device(), backend.size(), backend.rank()
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} must divide by "
                         f"{world} ranks")

    def log(s):
        if rank == 0:
            print(s, flush=True)

    log(f"world: {world_info()}")
    if args.data == "real":
        from dear_pytorch_tpu_torch.models.data import load_real_digits

        tx, ty, ex, ey = load_real_digits()
    else:
        tx, ty = synthetic_mnist(args.train_size, seed=0)
        ex, ey = synthetic_mnist(args.test_size, seed=1)

    def tensors(x, y):      # NHWC numpy -> NCHW on the device
        return (torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))).to(dev),
            torch.from_numpy(np.asarray(y, np.int64)).to(dev))

    train_x, train_y = tensors(tx, ty)
    test_x, test_y = tensors(ex, ey)

    model = MnistNet(device=dev, seed=0)
    broadcast_parameters(model, group=group)

    def loss_fn(m, batch, generator):
        x, y = batch
        logp = m(x, train=True, generator=generator)
        return -logp.gather(1, y[:, None]).mean()   # NLL on log_softmax

    ts = build_train_step(loss_fn, model, group=group, device=dev,
                          mode=args.mode, threshold_mb=args.threshold,
                          optimizer=fused_sgd(lr=args.lr,
                                              momentum=args.momentum),
                          rng_seed=1234)
    state = ts.init()

    def evaluate() -> float:
        correct = torch.zeros((), device=dev)
        with torch.no_grad():
            for i in range(0, len(test_x), 256):
                pred = model(test_x[i:i + 256]).argmax(dim=-1)
                correct += (pred == test_y[i:i + 256]).sum()
        # the ranks' accuracies averaged (the reference's hvd.allreduce)
        return float(C.all_reduce_mean(correct / len(test_x), group))

    sampler = ShardedSampler(len(train_x), world, rank, seed=1234)
    proc_batch = args.batch_size // world
    steps_per_epoch = sampler.shard_len // proc_batch
    if steps_per_epoch == 0:
        raise SystemExit(
            f"--batch-size {args.batch_size} needs {proc_batch} samples "
            f"per rank but this dataset yields only {sampler.shard_len}; "
            "lower --batch-size")
    acc = evaluate()
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        order = torch.from_numpy(sampler.epoch_indices(epoch)).to(dev)
        losses = []
        for s in range(steps_per_epoch):
            idx = order[s * proc_batch:(s + 1) * proc_batch]
            state, metrics = ts.step(state, (train_x[idx], train_y[idx]))
            losses.append(metrics["loss"])
        epoch_loss = float(torch.stack(losses).mean())
        acc = evaluate()
        log(f"epoch {epoch}: loss {epoch_loss:.4f}, test acc {acc:.4f}, "
            f"{time.perf_counter() - t0:.1f}s")
    ts.close()
    return acc


if __name__ == "__main__":
    code = 0 if main() > 0.5 else 1
    backend.shutdown()
    sys.exit(code)
