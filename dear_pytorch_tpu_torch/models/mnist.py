"""The MNIST convnet in PyTorch — the port of
``dear_pytorch_tpu/models/mnist.py`` (conv 10 x 5x5, conv 20 x 5x5 with
channel dropout, fc 50 with dropout, fc 10, log-softmax): the user-facing
example's model.

The numerics follow the flax model it is held against. Its layers name no
dtype, so flax computes them in the promoted dtype of input and fp32
parameters, fp32: the input is rounded to ``dtype`` and every layer then
runs in fp32, and the output is the fp32 ``log_softmax``. The convs are
VALID, the pools 2x2/2. The channel dropout has ``Dropout2d`` semantics
(flax's ``broadcast_dims=(1, 2)`` on NHWC: whole feature maps drop); the
masks come from an explicit ``torch.Generator``. The flatten is in flax's
(H, W, C) order, so ``fc1`` holds flax's kernel transposed. Module names
are flax's (``conv1``, ``conv2``, ``fc1``, ``fc2``). Images are NCHW
``[N, 1, 28, 28]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dear_pytorch_tpu_torch._device import resolve_device
from dear_pytorch_tpu_torch.models.bert import dropout
from dear_pytorch_tpu_torch.models.resnet import flax_init_

__all__ = ["MnistNet"]

_DROPOUT = 0.5


class MnistNet(nn.Module):
    """The example's convnet on ``device`` (the card unless the caller says
    otherwise; no card and no device raises), seeded from ``seed`` with
    flax's initialisers (`models.resnet.flax_init_`). ``forward(x,
    train=False, generator=None)`` returns fp32 log-probabilities ``[N,
    10]``; ``train=True`` turns both dropouts on, with masks from
    ``generator``."""

    def __init__(self, *, dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 10, 5, device=dev)
        self.conv2 = nn.Conv2d(10, 20, 5, device=dev)
        self.fc1 = nn.Linear(320, 50, device=dev)
        self.fc2 = nn.Linear(50, 10, device=dev)
        flax_init_(self, seed)

    @property
    def device(self) -> torch.device:
        return self.fc2.weight.device

    def forward(self, x, train: bool = False, generator=None):
        if train and generator is None:
            raise ValueError("dropout in training mode needs a "
                             "torch.Generator (generator=)")
        gen = generator if train else None
        # fp32 parameters: a bf16 model rounds its input, then runs fp32
        x = x.to(self.dtype).float()
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = self.conv2(x)
        if gen is not None:     # whole [N, C] maps drop
            keep = torch.rand(x.shape[:2] + (1, 1), generator=gen,
                              device=x.device) < 1.0 - _DROPOUT
            x = torch.where(keep, x / (1.0 - _DROPOUT), torch.zeros((),
                            device=x.device))
        x = F.max_pool2d(F.relu(x), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flax's HWC
        x = F.relu(self.fc1(x))
        if gen is not None:
            x = dropout(x, _DROPOUT, gen)
        return F.log_softmax(self.fc2(x), dim=-1)
