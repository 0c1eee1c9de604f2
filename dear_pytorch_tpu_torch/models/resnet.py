"""ResNet family in PyTorch — the port of ``dear_pytorch_tpu/models/resnet.py``
(ResNet v1.5: the stride on the bottleneck's 3x3).

The numerics follow the flax model it is held against:

  - parameters are stored in fp32 and cast to the compute ``dtype`` at each
    conv; BatchNorm's scale and bias stay fp32, its statistics and its
    normalisation run in fp32 and its output is in the compute dtype; the
    mean pool runs over H, W in the compute dtype; ``fc`` is fp32 and the
    logits are fp32 (flax's ``nn.Dense(dtype=float32)``);
  - the padding is the flax model's torch-aligned explicit padding; the
    ``s2d`` stem pads ``((2, 1), (2, 1))`` before its 4x4 conv;
  - the last BatchNorm of each block starts with scale zero; conv and fc
    kernels start lecun-normal (flax's truncated normal over fan-in), BN
    scale 1 and bias 0, drawn from an explicit ``torch.Generator``.

The module takes NCHW images and runs NHWC underneath: the input is taken to
``torch.channels_last`` once, and each conv takes its weight to
channels_last in the dtype cast it does anyway (the weights themselves stay
contiguous ``[out, in, kh, kw]``, so the DeAR step can keep them as views of
its flat bucket buffers). On the card cuDNN runs the convs.

BatchNorm (`BatchNorm2d`): in training mode ``torch.native_batch_norm``
normalises with the batch's statistics and is given no running tensors; it
returns the batch mean and inverse std, and the running buffers are updated
from those as flax updates them — ``ra = 0.9 ra + 0.1 batch`` with the
BIASED batch variance (``1 / invstd**2 - eps``), where ``nn.BatchNorm2d``
would take the unbiased one. That adds no pass over the activation. Each
rank uses its own batch's statistics (no ``SyncBatchNorm``: flax's BN here
has no ``axis_name``); the DeAR step averages the running buffers over the
ranks once per step. ``num_batches_tracked`` counts the training forwards.

Names are torchvision's (``conv1``, ``bn1``, ``layer{i}.{j}.conv{c}`` /
``bn{c}``, ``layer{i}.{j}.downsample.0`` / ``.1``, ``fc``), so the JAX
package's ``convert_resnet_from_torch`` reads the port's ``state_dict``
unchanged; the ``s2d`` stem keeps the name ``conv1`` with its
``[F, 4C, 4, 4]`` weight. `models.convert.resnet_params_from_jax` goes the
other way.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dear_pytorch_tpu_torch._device import resolve_device

__all__ = [
    "BasicBlock", "BatchNorm2d", "BottleneckBlock", "Conv2d", "ResNet",
    "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
    "repack_stem_conv7_to_s2d", "space_to_depth",
]

#: flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)`` in torch's convention
_BN_MOMENTUM, _BN_EPS = 0.1, 1e-5


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[N, C, H, W] -> [N, C*b*b, H/b, W/b]; the packed channel order is
    (row-in-block, col-in-block, channel), the JAX package's, which
    `repack_stem_conv7_to_s2d` assumes."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // block, block, w // block, block)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * block * block, h // block, w // block)


def repack_stem_conv7_to_s2d(k7):
    """Fold a [7, 7, C, F] stride-2 stem kernel (flax layout, numpy) into
    the equivalent [4, 4, 4C, F] stride-1 kernel over ``space_to_depth(x,
    2)`` input: zero-pad the 7x7 kernel to 8x8 at the front, so packed tap
    (a, bi) reads original tap 2a + bi - 1, then fold the in-block offsets
    into the channel dim. Host-side numpy, as the JAX package's."""
    k7 = np.asarray(k7)
    kh, kw, c, f = k7.shape
    if (kh, kw) != (7, 7):
        raise ValueError("the stem repack is specific to the 7x7 stride-2 "
                         f"stem, got a {kh}x{kw} kernel")
    k8 = np.zeros((8, 8, c, f), k7.dtype)
    k8[1:, 1:] = k7
    k8 = k8.reshape(4, 2, 4, 2, c, f)       # [a, bi, b, bj, c, f]
    k4 = k8.transpose(0, 2, 1, 3, 4, 5)     # [a, b, bi, bj, c, f]
    return k4.reshape(4, 4, 4 * c, f)


class Conv2d(nn.Conv2d):
    """A bias-free conv with flax's dtype rule: the fp32 weight is cast to
    ``compute_dtype`` (and to channels_last) at each call."""

    def __init__(self, cin, cout, kernel, *, stride=1, padding=0,
                 compute_dtype, device):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=False, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        w = self.weight.to(dtype=self.compute_dtype,
                           memory_format=torch.channels_last)
        return F.conv2d(x, w, None, self.stride, self.padding)


class BatchNorm2d(nn.BatchNorm2d):
    """flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``: fp32 statistics
    and normalisation, output in the input's (compute) dtype, running
    variance updated with the biased batch variance (module docstring)."""

    def __init__(self, features, *, device):
        super().__init__(features, eps=_BN_EPS, momentum=_BN_MOMENTUM,
                         device=device)

    def forward(self, x):
        # a train step may keep the parameters as bf16 views (gather_dtype)
        w, b = self.weight.float(), self.bias.float()
        if not self.training:
            return torch.native_batch_norm(
                x, w, b, self.running_mean, self.running_var, False, 0.0,
                self.eps)[0]
        y, mean, invstd = torch.native_batch_norm(x, w, b, None, None, True,
                                                  0.0, self.eps)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(invstd.pow(-2).sub_(self.eps),
                                   self.momentum)
            self.num_batches_tracked.add_(1)
        return y


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4 channels), with a 1x1 conv + BN on
    the residual when its shape changes."""

    expansion = 4

    def __init__(self, cin, filters, stride=1, *, compute_dtype, device):
        super().__init__()
        conv = partial(Conv2d, compute_dtype=compute_dtype, device=device)
        cout = filters * self.expansion
        self.conv1 = conv(cin, filters, 1)
        self.bn1 = BatchNorm2d(filters, device=device)
        self.conv2 = conv(filters, filters, 3, stride=stride, padding=1)
        self.bn2 = BatchNorm2d(filters, device=device)
        self.conv3 = conv(filters, cout, 1)
        self.bn3 = BatchNorm2d(cout, device=device)
        self.downsample = (nn.Sequential(
            conv(cin, cout, 1, stride=stride),
            BatchNorm2d(cout, device=device))
            if stride != 1 or cin != cout else None)

    @property
    def last_bn(self) -> BatchNorm2d:
        return self.bn3

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """3x3 (stride) -> 3x3 (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin, filters, stride=1, *, compute_dtype, device):
        super().__init__()
        conv = partial(Conv2d, compute_dtype=compute_dtype, device=device)
        self.conv1 = conv(cin, filters, 3, stride=stride, padding=1)
        self.bn1 = BatchNorm2d(filters, device=device)
        self.conv2 = conv(filters, filters, 3, padding=1)
        self.bn2 = BatchNorm2d(filters, device=device)
        self.downsample = (nn.Sequential(
            conv(cin, filters, 1, stride=stride),
            BatchNorm2d(filters, device=device))
            if stride != 1 or cin != filters else None)

    @property
    def last_bn(self) -> BatchNorm2d:
        return self.bn2

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``ResNet(stage_sizes, block, ...)`` on ``device`` (the card unless
    the caller says otherwise; no card and no device raises), seeded
    from ``seed``. ``forward(x)`` takes NCHW images (any float dtype) and
    returns fp32 logits ``[N, num_classes]``; BatchNorm uses the batch's
    statistics and updates its running buffers in training mode (the
    default, as the flax model's ``train=True``), the running ones after
    ``.eval()``. ``stem="s2d"``: the space-to-depth stem (input packed 2x2
    into channels, a 4x4 stride-1 conv), the same function as the 7x7
    stride-2 stem under `repack_stem_conv7_to_s2d`."""

    def __init__(self, stage_sizes: Sequence[int], block=BottleneckBlock, *,
                 num_classes: int = 1000, width: int = 64,
                 dtype: torch.dtype = torch.float32, stem: str = "conv7",
                 device=None, seed: int = 0):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        dev = resolve_device(device)
        self.stage_sizes, self.stem, self.dtype = tuple(stage_sizes), stem, \
            dtype
        if stem == "s2d":
            self.conv1 = Conv2d(12, width, 4, compute_dtype=dtype,
                                device=dev)
        else:
            self.conv1 = Conv2d(3, width, 7, stride=2, padding=3,
                                compute_dtype=dtype, device=dev)
        self.bn1 = BatchNorm2d(width, device=dev)
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            blocks = []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(cin, width * 2**i, stride,
                                    compute_dtype=dtype, device=dev))
                cin = width * 2**i * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes, device=dev)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """flax's initialisers: lecun-normal conv and fc kernels (a normal
        truncated at two standard deviations, scaled to variance 1/fan_in),
        fc bias 0, BN scale 1 (0 for each block's last BN) and bias 0, BN
        running mean 0 and variance 1."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        last = {id(m.last_bn) for m in self.modules()
                if isinstance(m, (BottleneckBlock, BasicBlock))}
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = math.prod(m.weight.shape[1:])
                # flax's variance_scaling: the std of the truncated normal
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm2d):
                m.reset_running_stats()
                m.weight.fill_(0.0 if id(m) in last else 1.0)
                m.bias.zero_()

    def forward(self, x):
        if self.stem == "s2d":
            x = F.pad(space_to_depth(x, 2), (2, 1, 2, 1))
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{i + 1}")(x)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.fc.weight.float(),
                        self.fc.bias.float())


ResNet18 = partial(ResNet, (2, 2, 2, 2), BasicBlock)
ResNet34 = partial(ResNet, (3, 4, 6, 3), BasicBlock)
ResNet50 = partial(ResNet, (3, 4, 6, 3), BottleneckBlock)
ResNet101 = partial(ResNet, (3, 4, 23, 3), BottleneckBlock)
ResNet152 = partial(ResNet, (3, 8, 36, 3), BottleneckBlock)
