"""Model zoo of the port — the port of ``dear_pytorch_tpu/models/__init__.py``
for the GPT-2 family. The CNNs and BERT come with the models slice (ROADMAP
Queue 1 item 5); their names raise ``KeyError`` saying so."""

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
    gpt_lm_loss,
)

_GPT_REGISTRY: dict = {
    "gpt2": GPT2_SMALL,
    "gpt2_medium": GPT2_MEDIUM,
    "gpt2_large": GPT2_LARGE,
}

#: the JAX package's CNN and BERT names, not ported yet
_UNPORTED = (
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "densenet121", "densenet169", "densenet201", "inceptionv4", "vgg11",
    "vgg16", "vgg19", "mnistnet", "vit_s16", "vit_b16", "bert_base", "bert",
    "bert_large",
)


def gpt_names() -> list:
    return sorted(_GPT_REGISTRY)


def gpt_config(name: str, *, dtype=torch.float32) -> GptConfig:
    """The registered config of ``name`` in compute ``dtype``. Raises
    KeyError with the valid names otherwise."""
    key = name.lower()
    if key in _UNPORTED:
        raise KeyError(
            f"model {name!r} is not ported yet: the CNNs and BERT come with "
            f"the models slice (ROADMAP Queue 1 item 5); GPT: {gpt_names()}")
    if key not in _GPT_REGISTRY:
        raise KeyError(f"unknown model {name!r}; GPT: {gpt_names()}")
    return dataclasses.replace(_GPT_REGISTRY[key], dtype=dtype)


def get_model(name: str, *, dtype=torch.float32, device=None, **kwargs):
    """``GptLmHeadModel`` for a registered name, built on ``device`` (the
    card by default)."""
    return GptLmHeadModel(gpt_config(name, dtype=dtype), device=device,
                          **kwargs)


def dropout_free(cfg):
    """``cfg`` with every ``*dropout*`` probability zeroed (the CLIs'
    ``--dropout0``)."""
    zeros = {f.name: 0.0 for f in dataclasses.fields(cfg)
             if "dropout" in f.name}
    return dataclasses.replace(cfg, **zeros)
