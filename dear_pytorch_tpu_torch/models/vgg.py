"""VGG in PyTorch — the port of ``dear_pytorch_tpu/models/vgg.py`` (VGG-11,
-16 and -19, the plain variant: no BatchNorm).

The numerics follow the flax model it is held against: fp32 parameters
cast to the compute ``dtype`` at each conv (3x3 SAME, with bias) and at
``fc1`` and ``fc2``; ``fc3`` and the logits are fp32; 2x2/2 VALID max
pools; two ``Dropout(0.5)`` layers, whose keep masks in training mode come
from an explicit ``torch.Generator`` (held to their statistics, not to
JAX's masks).

**The flatten order.** The flax model flattens its NHWC map, so ``fc1``'s
input is in (H, W, C) order. This model takes NCHW images and flattens in
that same (H, W, C) order (``permute(0, 2, 3, 1)`` first, free on the
channels_last map it runs), so ``fc1`` holds flax's kernel transposed and
`models.convert.vgg_params_from_jax` needs no permutation. (A torchvision
checkpoint flattens (C, H, W): the JAX package's
``convert_vgg_from_torch`` documents that permutation.) ``fc1``'s input
width follows from ``image_size`` (224: 7 x 7 x 512), which flax infers at
its first call.

Module names are flax's (``conv1`` … ``conv13``, ``fc1``, ``fc2``,
``fc3``).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dear_pytorch_tpu_torch._device import resolve_device
from dear_pytorch_tpu_torch.models.bert import Dense, dropout
from dear_pytorch_tpu_torch.models.resnet import Conv2d, flax_init_

__all__ = ["CFG", "VGG", "VGG11", "VGG16", "VGG19"]

CFG = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}

_DROPOUT = 0.5


class VGG(nn.Module):
    """``VGG(cfg, ...)`` on ``device`` (the card unless the caller says
    otherwise; no card and no device raises) for NCHW images of
    ``image_size``, seeded from ``seed`` with flax's initialisers
    (`models.resnet.flax_init_`). ``forward(x, train=False,
    generator=None)`` returns fp32 logits ``[N, num_classes]``;
    ``train=True`` turns the two dropouts on, with masks from
    ``generator``."""

    def __init__(self, cfg: Sequence, *, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, image_size: int = 224,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.dtype = tuple(cfg), dtype
        cin, side, i = 3, image_size, 0
        for v in self.cfg:
            if v == "M":
                side //= 2
                continue
            i += 1
            self.add_module(f"conv{i}", Conv2d(
                cin, v, 3, padding=1, compute_dtype=dtype, device=dev,
                bias=True))
            cin = v
        if side < 1:
            raise ValueError(f"image {image_size} too small for "
                             f"{self.cfg.count('M')} pools")
        self.fc1 = Dense(side * side * cin, 4096, compute_dtype=dtype,
                         device=dev)
        self.fc2 = Dense(4096, 4096, compute_dtype=dtype, device=dev)
        self.fc3 = Dense(4096, num_classes, compute_dtype=torch.float32,
                         device=dev)
        flax_init_(self, seed)

    @property
    def device(self) -> torch.device:
        return self.fc3.weight.device

    def forward(self, x, train: bool = False, generator=None):
        if train and generator is None:
            raise ValueError("dropout in training mode needs a "
                             "torch.Generator (generator=)")
        gen = generator if train else None
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        i = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                i += 1
                x = F.relu(getattr(self, f"conv{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flax's HWC
        x = F.relu(self.fc1(x))
        if gen is not None:
            x = dropout(x, _DROPOUT, gen)
        x = F.relu(self.fc2(x))
        if gen is not None:
            x = dropout(x, _DROPOUT, gen)
        return self.fc3(x).float()


VGG11 = partial(VGG, CFG["vgg11"])
VGG16 = partial(VGG, CFG["vgg16"])
VGG19 = partial(VGG, CFG["vgg19"])
