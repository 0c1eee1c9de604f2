"""Synthetic benchmark data — the port of ``synthetic_gpt_batch``,
``synthetic_image_batch``, ``synthetic_bert_batch`` and ``softmax_xent`` from
``dear_pytorch_tpu/models/data.py``. The port draws from an explicit
``torch.Generator`` (the JAX package draws from a PRNG key, so the two give
different values for one seed; the tests feed both packages one numpy batch
instead). Images are NCHW here, NHWC there."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dear_pytorch_tpu_torch._device import resolve_device

__all__ = ["softmax_xent", "synthetic_bert_batch", "synthetic_gpt_batch",
           "synthetic_image_batch"]


def synthetic_gpt_batch(generator: torch.Generator, batch_size: int,
                        seq_len: int = 1024, vocab_size: int = 50257) -> dict:
    """``{"input_ids": [batch_size, seq_len] int64}`` on the generator's
    device: token ids only — the LM loss shifts them for its targets."""
    ids = torch.randint(0, vocab_size, (batch_size, seq_len),
                        generator=generator, device=generator.device)
    return {"input_ids": ids}


def _generator(generator, device) -> torch.Generator:
    """``generator`` itself, or a new one seeded with the int ``generator``
    on ``device`` (the card unless the caller says otherwise; no card
    raises)."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(generator))


def synthetic_bert_batch(generator, batch_size: int, seq_len: int = 64,
                         vocab_size: int = 30522,
                         masked_fraction: float = 0.15, *,
                         device=None) -> dict:
    """A random BERT pre-training batch with the JAX package's fields and
    dtypes (all int32): random ``input_ids`` ``[B, S]``, ``token_type_ids``
    0, a full ``attention_mask``, ``masked_lm_labels`` a random id where a
    uniform draw is below ``masked_fraction`` and -1 (the loss's
    ignore_index) elsewhere, and random binary ``next_sentence_labels``
    ``[B]``. ``generator`` as `synthetic_image_batch`'s."""
    generator = _generator(generator, device)
    dev = generator.device
    shape = (batch_size, seq_len)

    def ids(high, size):
        return torch.randint(0, high, size, generator=generator,
                             device=dev).to(torch.int32)

    input_ids = ids(vocab_size, shape)
    is_masked = torch.rand(shape, generator=generator,
                           device=dev) < masked_fraction
    mlm_labels = torch.where(is_masked, ids(vocab_size, shape),
                             torch.full(shape, -1, dtype=torch.int32,
                                        device=dev))
    return {
        "input_ids": input_ids,
        "token_type_ids": torch.zeros(shape, dtype=torch.int32, device=dev),
        "attention_mask": torch.ones(shape, dtype=torch.int32, device=dev),
        "masked_lm_labels": mlm_labels,
        "next_sentence_labels": ids(2, (batch_size,)),
    }


def synthetic_image_batch(generator, batch_size: int,
                          image_size: int = 224, num_classes: int = 1000,
                          dtype=torch.float32, *, device=None) -> dict:
    """A fake ImageNet batch ``{"image": [B, 3, H, W] standard normal in
    dtype, "label": [B] int64}``. ``generator``: a ``torch.Generator``
    (the batch lies on its device), or an int seed for a new generator on
    ``device`` (the card unless the caller says otherwise; no card
    raises)."""
    generator = _generator(generator, device)
    dev = generator.device
    images = torch.randn((batch_size, 3, image_size, image_size),
                         generator=generator, device=dev).to(dtype)
    labels = torch.randint(0, num_classes, (batch_size,),
                           generator=generator, device=dev)
    return {"image": images, "label": labels}


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy in fp32 (the CNN benchmarks' criterion)."""
    return F.cross_entropy(logits.float(), labels)
