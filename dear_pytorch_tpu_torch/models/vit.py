"""Vision Transformer (ViT) in PyTorch — the port of
``dear_pytorch_tpu/models/vit.py``: patchify by a strided conv, prepend a
learned [CLS] token, add learned position embeddings, a pre-LN encoder,
classify from the [CLS] representation.

The numerics follow the flax model it is held against: parameters are
stored in fp32 and every op casts its inputs and parameters to ``dtype``;
LayerNorm is flax's default (eps 1e-6, fp32 statistics); GELU is the tanh
approximation (flax's default); the ``patch_embed`` conv is VALID with
stride ``patch``; ``cls_token`` starts at zeros and ``pos_embed`` at
normal(0.02), the conv and dense weights lecun-normal (flax's truncated
normal over fan-in), biases zeros; the ``head`` is an fp32 dense layer and
the logits are fp32. The attention core is `models.bert.
dot_product_attention` by default, as in the JAX package (197 tokens at
224² fit no flash block there).

Images are NCHW, as the port's ResNets take them (the flax model takes
NHWC). The position table's length follows from ``image_size`` (224 by
default: 196 patches and the [CLS] token), which flax infers at its first
call. Module names are flax's (``patch_embed``, ``block1.attn.query``,
``block1.mlp_in``, ``ln_final``, ``head`` …), so
`models.convert.vit_params_from_jax` maps weights across mechanically.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dear_pytorch_tpu_torch._device import resolve_device
from dear_pytorch_tpu_torch.models.bert import (
    Dense, LayerNorm, dot_product_attention, dropout,
)

__all__ = ["ViTB16", "ViTS16", "VisionTransformer", "VitBlock",
           "VitSelfAttention"]

#: flax ``nn.LayerNorm``'s default epsilon (torch's is 1e-5)
LN_EPS = 1e-6


class VitSelfAttention(nn.Module):
    """Multi-head self-attention over ``[B, S, E]`` tokens, no mask."""

    def __init__(self, hidden: int, num_heads: int, *, dtype, dropout_rate,
                 attention_impl: Callable, device):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} not divisible by {num_heads}")
        self.num_heads, self.dtype = num_heads, dtype
        self.dropout_rate, self.attention_impl = dropout_rate, attention_impl
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Dense(hidden, hidden, compute_dtype=dtype,
                                      device=device))

    def forward(self, x, generator=None):
        B, S, E = x.shape
        q, k, v = (m(x).view(B, S, self.num_heads, E // self.num_heads)
                   for m in (self.query, self.key, self.value))
        rate = self.dropout_rate if generator is not None else 0.0
        ctx = self.attention_impl(q, k, v, None, dropout_rate=rate,
                                  generator=generator, dtype=self.dtype)
        return self.out(ctx.reshape(B, S, E))


class VitBlock(nn.Module):
    """Pre-LN encoder block: x + MHA(LN(x)); x + MLP(LN(x))."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int, *, dtype,
                 dropout_rate, attention_impl: Callable, device):
        super().__init__()
        self.dropout_rate = dropout_rate

        def norm():
            return LayerNorm(hidden, eps=LN_EPS, compute_dtype=dtype,
                             device=device)

        self.ln1 = norm()
        self.attn = VitSelfAttention(hidden, num_heads, dtype=dtype,
                                     dropout_rate=dropout_rate,
                                     attention_impl=attention_impl,
                                     device=device)
        self.ln2 = norm()
        self.mlp_in = Dense(hidden, mlp_dim, compute_dtype=dtype,
                            device=device)
        self.mlp_out = Dense(mlp_dim, hidden, compute_dtype=dtype,
                             device=device)

    def forward(self, x, generator=None):
        h = self.attn(self.ln1(x), generator)
        if generator is not None:
            h = dropout(h, self.dropout_rate, generator)
        x = x + h
        h = self.mlp_out(F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh"))
        if generator is not None:
            h = dropout(h, self.dropout_rate, generator)
        return x + h


class VisionTransformer(nn.Module):
    """ViT classifier over NCHW images of ``image_size`` (divisible by
    ``patch``), on ``device`` (the card unless the caller says otherwise;
    no card and no device raises), seeded from ``seed``. ``forward(x,
    train=False, generator=None)`` returns fp32 logits ``[B,
    num_classes]``; ``train=True`` turns the dropouts on (masks from
    ``generator``) when ``dropout_rate > 0``."""

    def __init__(self, *, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072, patch: int = 16,
                 num_classes: int = 1000, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: Optional[Callable] = None,
                 image_size: int = 224, device=None, seed: int = 0):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image {image_size} not divisible by patch "
                             f"{patch}")
        dev = resolve_device(device)
        self.hidden_size, self.patch, self.dtype = hidden_size, patch, dtype
        self.num_layers, self.dropout_rate = num_layers, dropout_rate
        self.image_size = image_size
        impl = attention_impl or dot_product_attention
        tokens = (image_size // patch) ** 2 + 1
        self.cls_token = nn.Parameter(
            torch.zeros(1, 1, hidden_size, device=dev))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, tokens, hidden_size, device=dev))
        self.patch_embed = nn.Conv2d(3, hidden_size, patch, stride=patch,
                                     device=dev)
        for i in range(num_layers):
            self.add_module(f"block{i + 1}", VitBlock(
                hidden_size, num_heads, mlp_dim, dtype=dtype,
                dropout_rate=dropout_rate, attention_impl=impl, device=dev))
        self.ln_final = LayerNorm(hidden_size, eps=LN_EPS, compute_dtype=dtype,
                                  device=dev)
        self.head = Dense(hidden_size, num_classes,
                          compute_dtype=torch.float32, device=dev)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.cls_token.device

    @property
    def blocks(self) -> list:
        return [getattr(self, f"block{i + 1}")
                for i in range(self.num_layers)]

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """flax's initialisers: lecun-normal conv and dense kernels (a
        normal truncated at two standard deviations, scaled to variance
        1/fan_in), zero biases, LayerNorm 1 / 0, ``cls_token`` 0 and
        ``pos_embed`` normal(0.02)."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = math.prod(m.weight.shape[1:])
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
                m.bias.zero_()
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=g)

    def forward(self, x, train: bool = False, generator=None):
        B, _, H, W = x.shape
        if H % self.patch or W % self.patch:
            raise ValueError(f"image {H}x{W} not divisible by patch "
                             f"{self.patch}")
        if train and self.dropout_rate and generator is None:
            raise ValueError("dropout in training mode needs a "
                             "torch.Generator (generator=)")
        gen = generator if train and self.dropout_rate else None
        dt = self.dtype
        w = self.patch_embed.weight
        x = F.conv2d(x.to(dt), w.to(dt), self.patch_embed.bias.to(dt),
                     stride=self.patch)
        x = x.flatten(2).transpose(1, 2)                    # [B, S, E]
        cls = self.cls_token.to(dt).expand(B, 1, self.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        if gen is not None:
            x = dropout(x, self.dropout_rate, gen)
        for block in self.blocks:
            x = block(x, gen)
        x = self.ln_final(x)
        return self.head(x[:, 0]).float()


def ViTS16(*, dtype=torch.float32, **kw) -> VisionTransformer:
    """ViT-Small/16: 384h x 12L x 6 heads."""
    kw = {"hidden_size": 384, "num_layers": 12, "num_heads": 6,
          "mlp_dim": 1536, **kw}
    return VisionTransformer(dtype=dtype, **kw)


def ViTB16(*, dtype=torch.float32, **kw) -> VisionTransformer:
    """ViT-Base/16: 768h x 12L x 12 heads."""
    kw = {"hidden_size": 768, "num_layers": 12, "num_heads": 12,
          "mlp_dim": 3072, **kw}
    return VisionTransformer(dtype=dtype, **kw)
