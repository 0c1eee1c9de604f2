"""Synthetic benchmark data — the port of ``synthetic_gpt_batch`` from
``dear_pytorch_tpu/models/data.py``: random token ids, drawn from an
explicit ``torch.Generator`` (the JAX package draws them from a PRNG key,
so the two give different ids for one seed; the tests feed both packages
one numpy batch instead)."""

from __future__ import annotations

import torch

__all__ = ["synthetic_gpt_batch"]


def synthetic_gpt_batch(generator: torch.Generator, batch_size: int,
                        seq_len: int = 1024, vocab_size: int = 50257) -> dict:
    """``{"input_ids": [batch_size, seq_len] int64}`` on the generator's
    device: token ids only — the LM loss shifts them for its targets."""
    ids = torch.randint(0, vocab_size, (batch_size, seq_len),
                        generator=generator, device=generator.device)
    return {"input_ids": ids}
