"""BERT — in this slice only the dense attention core, which the ring KV
cache's chunked prefill and its dense decode attend use. The rest of the
model (``BertForPreTraining``, its decode path) waits for a later slice.
"""

from __future__ import annotations

import math

import torch


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
