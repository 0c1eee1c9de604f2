"""Model zoo of the port. This slice carries the GPT-2 family for serving;
the rest of the zoo follows with the training slices."""

from __future__ import annotations

import dataclasses

import torch

from dear_pytorch_tpu_torch.models.gpt import (  # noqa: F401
    GPT2_LARGE,
    GPT2_MEDIUM,
    GPT2_SMALL,
    GptConfig,
    GptLmHeadModel,
    generate,
)

_GPT_REGISTRY: dict[str, GptConfig] = {
    "gpt2": GPT2_SMALL,
    "gpt2_medium": GPT2_MEDIUM,
    "gpt2_large": GPT2_LARGE,
}


def get_model(name: str, *, dtype=torch.float32, device=None, **kwargs):
    """``GptLmHeadModel`` for a registered name, built on ``device`` (the
    card by default). Raises KeyError with the valid names otherwise."""
    key = name.lower()
    if key not in _GPT_REGISTRY:
        raise KeyError(f"unknown model {name!r}; GPT: {sorted(_GPT_REGISTRY)}")
    cfg = dataclasses.replace(_GPT_REGISTRY[key], dtype=dtype)
    return GptLmHeadModel(cfg, device=device, **kwargs)
