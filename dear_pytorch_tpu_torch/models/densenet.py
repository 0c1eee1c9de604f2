"""DenseNet in PyTorch — the port of ``dear_pytorch_tpu/models/densenet.py``
(DenseNet-121/169/201, torchvision's widths: growth 32, 64 stem features).

The numerics follow the flax model it is held against, with the port's
ResNet layers (`models.resnet.Conv2d`, `models.resnet.BatchNorm2d`): fp32
parameters cast to the compute ``dtype`` at each conv, BatchNorm with fp32
statistics, eps 1e-5 and flax's momentum 0.9 (torch's 0.1) and the BIASED
running variance, fc in fp32 and fp32 logits. The convs are flax's SAME
convs: the 7x7 stride-2 stem pads ``(2, 3)`` on an even side (224 -> 112)
and ``(3, 3)`` on an odd one, the 3x3 convs pad 1. The stem max-pool is
3x3/2 over a ``((1, 1), (1, 1))`` -inf border; each transition ends in a
2x2/2 VALID average pool; each dense layer concatenates ``[x, y]`` on the
channel dim, flax's order.

Images are NCHW and run channels_last underneath, as the port's ResNets.
Module names are flax's (``stem_conv``, ``stem_bn``,
``block1_layer1.bn1``/``conv1``/``bn2``/``conv2``, ``transition1.bn``/
``conv``, ``final_bn``, ``fc``), so `models.convert.densenet_params_from_jax`
maps weights across mechanically. BatchNorm uses the batch's statistics in
training mode (the default) and the running ones after ``.eval()``.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dear_pytorch_tpu_torch._device import resolve_device
from dear_pytorch_tpu_torch.models.resnet import (
    BatchNorm2d, Conv2d, flax_init_,
)

__all__ = ["DenseLayer", "DenseNet", "DenseNet121", "DenseNet169",
           "DenseNet201", "TransitionLayer", "same_pad"]


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """``x`` zero-padded as flax's ``padding="SAME"`` pads a square
    ``kernel`` at ``stride`` (low side ``total // 2``, the rest high)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):        # F.pad: last dim first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class DenseLayer(nn.Module):
    """BN-ReLU-Conv1x1 (4k bottleneck) -> BN-ReLU-Conv3x3 (k), concat."""

    def __init__(self, cin: int, growth_rate: int, *, dtype, device):
        super().__init__()
        conv = partial(Conv2d, compute_dtype=dtype, device=device)
        self.bn1 = BatchNorm2d(cin, device=device)
        self.conv1 = conv(cin, 4 * growth_rate, 1)
        self.bn2 = BatchNorm2d(4 * growth_rate, device=device)
        self.conv2 = conv(4 * growth_rate, growth_rate, 3, padding=1)

    def forward(self, x):
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        return torch.cat([x, y], dim=1)


class TransitionLayer(nn.Module):
    """BN-ReLU-Conv1x1, then a 2x2/2 average pool."""

    def __init__(self, cin: int, cout: int, *, dtype, device):
        super().__init__()
        self.bn = BatchNorm2d(cin, device=device)
        self.conv = Conv2d(cin, cout, 1, compute_dtype=dtype, device=device)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.bn(x))), 2, 2)


class DenseNet(nn.Module):
    """``DenseNet(block_sizes, ...)`` on ``device`` (the card unless the
    caller says otherwise; no card and no device raises), seeded from
    ``seed`` with flax's initialisers (`models.resnet.flax_init_`).
    ``forward(x)`` takes NCHW images and returns fp32 logits ``[N,
    num_classes]``."""

    def __init__(self, block_sizes: Sequence[int], *, growth_rate: int = 32,
                 num_classes: int = 1000, num_init_features: int = 64,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.block_sizes, self.dtype = tuple(block_sizes), dtype
        self.stem_conv = Conv2d(3, num_init_features, 7, stride=2,
                                compute_dtype=dtype, device=dev)
        self.stem_bn = BatchNorm2d(num_init_features, device=dev)
        features = num_init_features
        for i, n_layers in enumerate(self.block_sizes):
            for j in range(n_layers):
                self.add_module(f"block{i + 1}_layer{j + 1}", DenseLayer(
                    features + j * growth_rate, growth_rate, dtype=dtype,
                    device=dev))
            features += n_layers * growth_rate
            if i != len(self.block_sizes) - 1:
                self.add_module(f"transition{i + 1}", TransitionLayer(
                    features, features // 2, dtype=dtype, device=dev))
                features //= 2
        self.final_bn = BatchNorm2d(features, device=dev)
        self.fc = nn.Linear(features, num_classes, device=dev)
        flax_init_(self, seed)

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    def forward(self, x):
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        x = self.stem_conv(same_pad(x, 7, 2))
        x = F.max_pool2d(F.relu(self.stem_bn(x)), 3, stride=2, padding=1)
        for i, n_layers in enumerate(self.block_sizes):
            for j in range(n_layers):
                x = getattr(self, f"block{i + 1}_layer{j + 1}")(x)
            if i != len(self.block_sizes) - 1:
                x = getattr(self, f"transition{i + 1}")(x)
        x = F.relu(self.final_bn(x)).mean(dim=(2, 3))
        return F.linear(x.float(), self.fc.weight.float(),
                        self.fc.bias.float())


DenseNet121 = partial(DenseNet, (6, 12, 24, 16))
DenseNet169 = partial(DenseNet, (6, 12, 32, 32))
DenseNet201 = partial(DenseNet, (6, 12, 48, 32))
