"""Inception-v4 in PyTorch — the port of
``dear_pytorch_tpu/models/inception.py`` (Szegedy et al. 2016: stem, 4 x
Inception-A, Reduction-A, 7 x Inception-B, Reduction-B, 3 x Inception-C,
a pooled fp32 classifier; 299² inputs).

The numerics follow the flax model it is held against, with the port's
ResNet layers: fp32 parameters cast to the compute ``dtype`` at each conv,
BatchNorm with fp32 statistics, eps **1e-3** (the ResNets' is 1e-5),
flax's momentum 0.9 (torch's 0.1) and the BIASED running variance. Every
strided conv and pool is VALID; the stride-1 convs are SAME, which for the
odd kernels here is a symmetric ``k // 2`` padding per side (the 1x7 conv
pads ``(0, 3)``, the 7x1 ``(3, 0)``). The SAME 3x3/1 average pool counts
the zero border, as flax's ``avg_pool`` does (``count_include_pad=True``).
Branches concatenate on the channel dim in the JAX model's order.

Images are NCHW and run channels_last underneath, as the port's ResNets.
Module names are flax's (``stem1.conv``, ``stem1.bn``, ``mixedA1_b3c``,
``redA_b2b``, ``mixedC3_b3bb``, ``fc`` …; each `ConvBN` holds ``conv`` and
``bn``), so `models.convert.inception_params_from_jax` maps weights across
mechanically. The smallest input the VALID reductions allow is 75².
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dear_pytorch_tpu_torch._device import resolve_device
from dear_pytorch_tpu_torch.models.resnet import (
    BatchNorm2d, Conv2d, flax_init_,
)

__all__ = ["BN_EPS", "ConvBN", "InceptionV4", "avgpool_same"]

#: the flax model's ``BatchNorm(epsilon=1e-3)``
BN_EPS = 1e-3


def avgpool_same(x: torch.Tensor) -> torch.Tensor:
    """flax's ``avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")``: the
    zero border counts in every window's mean."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)          # 3x3/2 VALID


class ConvBN(nn.Module):
    """conv (no bias) -> BN -> ReLU. ``padding="SAME"`` (stride 1, odd
    kernels) pads ``k // 2`` per side, ``"VALID"`` none."""

    def __init__(self, cin: int, cout: int, kernel, *, stride: int = 1,
                 padding: str = "SAME", dtype, device):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        if padding == "SAME" and stride != 1:
            raise ValueError("a strided SAME conv is not in the model")
        pad = (kh // 2, kw // 2) if padding == "SAME" else 0
        self.conv = Conv2d(cin, cout, (kh, kw), stride=stride, padding=pad,
                           compute_dtype=dtype, device=device)
        self.bn = BatchNorm2d(cout, device=device, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class InceptionV4(nn.Module):
    """Inception-v4 on ``device`` (the card unless the caller says
    otherwise; no card and no device raises), seeded from ``seed`` with
    flax's initialisers (`models.resnet.flax_init_`). ``forward(x)`` takes
    NCHW images (299² in the benchmark, at least 75²) and returns fp32
    logits ``[N, num_classes]``."""

    def __init__(self, *, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype

        def cbr(name, cin, cout, kernel, stride=1, padding="SAME"):
            self.add_module(name, ConvBN(cin, cout, kernel, stride=stride,
                                         padding=padding, dtype=dtype,
                                         device=dev))

        # ---- stem (module order = forward order: the DeAR plan's) ------
        cbr("stem1", 3, 32, 3, 2, "VALID")
        cbr("stem2", 32, 32, 3, padding="VALID")
        cbr("stem3", 32, 64, 3)
        cbr("stem4b", 64, 96, 3, 2, "VALID")
        cbr("stem5a1", 160, 64, 1)
        cbr("stem5a2", 64, 96, 3, padding="VALID")
        cbr("stem5b1", 160, 64, 1)
        cbr("stem5b2", 64, 64, (7, 1))
        cbr("stem5b3", 64, 64, (1, 7))
        cbr("stem5b4", 64, 96, 3, padding="VALID")
        cbr("stem6a", 192, 192, 3, 2, "VALID")
        c = 384
        for i in range(4):
            n = f"mixedA{i + 1}_"
            cbr(n + "b0", c, 96, 1)
            cbr(n + "b1b", c, 96, 1)
            cbr(n + "b2a", c, 64, 1)
            cbr(n + "b2b", 64, 96, 3)
            cbr(n + "b3a", c, 64, 1)
            cbr(n + "b3b", 64, 96, 3)
            cbr(n + "b3c", 96, 96, 3)
            c = 4 * 96
        cbr("redA_b1", c, 384, 3, 2, "VALID")
        cbr("redA_b2a", c, 192, 1)
        cbr("redA_b2b", 192, 224, 3)
        cbr("redA_b2c", 224, 256, 3, 2, "VALID")
        c = c + 384 + 256
        for i in range(7):
            n = f"mixedB{i + 1}_"
            cbr(n + "b0", c, 384, 1)
            cbr(n + "b1b", c, 128, 1)
            cbr(n + "b2a", c, 192, 1)
            cbr(n + "b2b", 192, 224, (7, 1))
            cbr(n + "b2c", 224, 256, (1, 7))
            cbr(n + "b3a", c, 192, 1)
            cbr(n + "b3b", 192, 192, (1, 7))
            cbr(n + "b3c", 192, 224, (7, 1))
            cbr(n + "b3d", 224, 224, (1, 7))
            cbr(n + "b3e", 224, 256, (7, 1))
            c = 384 + 128 + 256 + 256
        cbr("redB_b1a", c, 192, 1)
        cbr("redB_b1b", 192, 192, 3, 2, "VALID")
        cbr("redB_b2a", c, 256, 1)
        cbr("redB_b2b", 256, 256, (1, 7))
        cbr("redB_b2c", 256, 320, (7, 1))
        cbr("redB_b2d", 320, 320, 3, 2, "VALID")
        c = c + 192 + 320
        for i in range(3):
            n = f"mixedC{i + 1}_"
            cbr(n + "b0", c, 256, 1)
            cbr(n + "b1b", c, 256, 1)
            cbr(n + "b2a", c, 384, 1)
            cbr(n + "b2b", 384, 256, (1, 3))
            cbr(n + "b2c", 384, 256, (3, 1))
            cbr(n + "b3a", c, 384, 1)
            cbr(n + "b3bb", 384, 448, (3, 1))
            cbr(n + "b3b", 448, 512, (1, 3))
            cbr(n + "b3c", 512, 256, (1, 3))
            cbr(n + "b3d", 512, 256, (3, 1))
            c = 6 * 256
        self.fc = nn.Linear(c, num_classes, device=dev)
        flax_init_(self, seed)

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    def forward(self, x):
        m = self._modules
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        x = m["stem3"](m["stem2"](m["stem1"](x)))
        x = torch.cat([_maxpool(x), m["stem4b"](x)], dim=1)
        b1 = m["stem5a2"](m["stem5a1"](x))
        b2 = m["stem5b4"](m["stem5b3"](m["stem5b2"](m["stem5b1"](x))))
        x = torch.cat([b1, b2], dim=1)
        x = torch.cat([m["stem6a"](x), _maxpool(x)], dim=1)
        for i in range(4):
            n = f"mixedA{i + 1}_"
            x = torch.cat([
                m[n + "b0"](x),
                m[n + "b1b"](avgpool_same(x)),
                m[n + "b2b"](m[n + "b2a"](x)),
                m[n + "b3c"](m[n + "b3b"](m[n + "b3a"](x))),
            ], dim=1)
        x = torch.cat([
            _maxpool(x),
            m["redA_b1"](x),
            m["redA_b2c"](m["redA_b2b"](m["redA_b2a"](x))),
        ], dim=1)
        for i in range(7):
            n = f"mixedB{i + 1}_"
            x = torch.cat([
                m[n + "b0"](x),
                m[n + "b1b"](avgpool_same(x)),
                m[n + "b2c"](m[n + "b2b"](m[n + "b2a"](x))),
                m[n + "b3e"](m[n + "b3d"](m[n + "b3c"](m[n + "b3b"](
                    m[n + "b3a"](x))))),
            ], dim=1)
        x = torch.cat([
            _maxpool(x),
            m["redB_b1b"](m["redB_b1a"](x)),
            m["redB_b2d"](m["redB_b2c"](m["redB_b2b"](m["redB_b2a"](x)))),
        ], dim=1)
        for i in range(3):
            n = f"mixedC{i + 1}_"
            b2 = m[n + "b2a"](x)
            b3 = m[n + "b3b"](m[n + "b3bb"](m[n + "b3a"](x)))
            x = torch.cat([
                m[n + "b0"](x),
                m[n + "b1b"](avgpool_same(x)),
                m[n + "b2b"](b2),
                m[n + "b2c"](b2),
                m[n + "b3c"](b3),
                m[n + "b3d"](b3),
            ], dim=1)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.fc.weight.float(),
                        self.fc.bias.float())
