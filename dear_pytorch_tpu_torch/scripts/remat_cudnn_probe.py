"""Does a ``remat="full"`` recompute reproduce its forward on the card?
Two measurements on one card:

1. Convs at ResNet-50's input shapes (bf16, channels-last): each run on
   the main thread, then on a new thread (as a recompute runs on
   autograd's device thread), at B = 64 with cuDNN's benchmark mode off
   and at B = 32 with it on (other shapes, so that each pass starts with
   no cached pick); how many of the outputs differ.
2. ResNet-50 trained 3 steps at one rank (bf16, B = 64, 224², ``mode
   dear``, the ImageNet CLI's model, batch and SGD) with ``remat="full"``
   and without, cuDNN deterministic with its benchmark mode off, and
   with cuDNN off: the largest difference over the largest |value| of
   the losses, of the BN buffers and of the gathered parameters after
   the last step.

  python3 -m dear_pytorch_tpu_torch.scripts.remat_cudnn_probe
"""

from __future__ import annotations

import subprocess
import threading

import torch

from dear_pytorch_tpu_torch import models
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.models.data import (
    softmax_xent, synthetic_image_batch,
)
from dear_pytorch_tpu_torch.ops import fused_sgd
from dear_pytorch_tpu_torch.parallel.dear import build_train_step

#: (channels, side, kernel, stride) of ResNet-50's conv inputs
SHAPES = [(3, 224, 7, 2), (64, 56, 1, 1), (64, 56, 3, 1), (256, 56, 1, 1),
          (128, 56, 3, 2), (128, 28, 3, 1), (256, 14, 3, 1),
          (1024, 14, 1, 1), (512, 7, 3, 1)]
B, STEPS = 64, 3


def conv_threads(benchmark: bool, n: int) -> int:
    """How many of `SHAPES`' convs at batch ``n`` give another output on
    a new thread than on the main thread."""
    torch.backends.cudnn.benchmark = benchmark
    gen = torch.Generator(device="cuda").manual_seed(0)
    differ = 0
    for c, side, k, stride in SHAPES:
        x = torch.randn(n, c, side, side, device="cuda", generator=gen)
        w = 0.05 * torch.randn(c, c, k, k, device="cuda", generator=gen)
        x, w = (t.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last) for t in (x, w))

        def conv(out, key):
            out[key] = torch.nn.functional.conv2d(x, w, stride=stride,
                                                  padding=k // 2)

        out: dict = {}
        conv(out, "main")
        t = threading.Thread(target=conv, args=(out, "thread"))
        t.start()
        t.join()
        torch.cuda.synchronize()
        differ += not torch.equal(out["main"], out["thread"])
    return differ


def train(remat, group) -> tuple:
    """3 steps; the losses, the buffers and the gathered parameters."""
    model = models.get_model("resnet50", dtype=torch.bfloat16,
                             device="cuda", seed=0)
    batch = synthetic_image_batch(0, B, image_size=224,
                                  dtype=torch.bfloat16, device="cuda")
    ts = build_train_step(
        lambda m, b: softmax_xent(m(b["image"]), b["label"]), model,
        optimizer=fused_sgd.fused_sgd(lr=0.01, momentum=0.9), group=group,
        device="cuda", threshold_mb=25.0, comm_dtype=torch.bfloat16,
        remat=remat)
    state, losses = ts.init(), []
    for _ in range(STEPS):
        state, metrics = ts.step(state, batch)
        losses.append(float(metrics["loss"]))
    bufs = {n: b.detach().clone() for n, b in model.named_buffers()}
    params = ts.gather_params(state)
    ts.close()
    return losses, bufs, params


def apart(a: dict, b: dict) -> float:
    return max(float((a[n].float() - x.float()).abs().max())
               / max(float(x.float().abs().max()), 1e-30)
               for n, x in b.items())


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    for benchmark, n in ((False, B), (True, B // 2)):
        print(f"cuDNN benchmark {'on' if benchmark else 'off'}, B = {n}: "
              f"{conv_threads(benchmark, n)} of {len(SHAPES)} convs differ "
              "between the main thread and a new one")
    torch.backends.cudnn.benchmark = False
    group = backend.init("cuda")
    for enabled in (True, False):
        torch.backends.cudnn.enabled = enabled
        (l0, b0, p0), (l1, b1, p1) = (train(r, group) for r in (None,
                                                                 "full"))
        loss = max(abs(a - b) / abs(b) for a, b in zip(l1, l0))
        how = "on (deterministic, benchmark off)" if enabled else "off"
        print(f"cuDNN {how}: remat against none after {STEPS} steps, "
              f"largest difference over the largest |value|: losses "
              f"{loss:.3e}, "
              f"BN buffers {apart(b1, b0):.3e}, parameters "
              f"{apart(p1, p0):.3e}")
    backend.shutdown()


if __name__ == "__main__":
    main()
