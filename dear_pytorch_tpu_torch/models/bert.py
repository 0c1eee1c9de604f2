"""BERT — in this slice only the dense attention core, which the ring KV
cache's chunked prefill and its dense decode attend use, and `ProjDense`,
the projection hook GPT's blocks share with it. The rest of the model
(``BertForPreTraining``, its decode path) waits for a later slice.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn


def dot_product_attention(q, k, v, mask, *, dtype=torch.float32):
    """One softmax(QKᵀ)V per layer, batched over (batch, heads). Shapes:
    q/k/v ``[B, S, H, D]``; ``mask`` additive, broadcastable to
    ``[B, H, Sq, Sk]``, or None. Scores are scaled by ``1/sqrt(D)`` in the
    inputs' dtype, the softmax runs in fp32 and is cast back to ``dtype``.
    No attention dropout: that is the training slice's work."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class ProjDense(nn.Linear):
    """A dense projection with an injectable matmul impl — the port of the
    JAX package's ``models/bert.py::ProjDense`` (:69). It holds the SAME
    parameters as the port's ``Dense`` (``weight [out, in]``, ``bias
    [out]``: torch's layout, fp32), so plans, checkpoints and
    `models.convert.gpt_params_from_jax` are unchanged. ``forward``
    flattens the input to 2-D and calls ``impl(x2d [M, in], kernel2d [in,
    out], bias1d [out], compute_dtype) -> y2d``, the contract
    `ops.collective_matmul.make_ring_projection_impl` implements; the impl
    applies the dtype promotion itself."""

    def __init__(self, in_features, out_features, *, impl: Callable,
                 compute_dtype, device):
        super().__init__(in_features, out_features, device=device)
        self.impl = impl
        self.compute_dtype = compute_dtype

    def forward(self, x):
        y = self.impl(x.reshape(-1, self.in_features), self.weight.t(),
                      self.bias, self.compute_dtype)
        return y.reshape(x.shape[:-1] + (self.out_features,))
