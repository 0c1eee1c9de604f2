"""Model zoo of the port — the port of ``dear_pytorch_tpu/models/__init__.py``
for the GPT-2 family and the ResNets. The other CNNs, BERT, ViT and MNIST
come with the rest of the zoo (ROADMAP Queue 1 item 5b); their names raise
``KeyError`` saying so."""

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
from dear_pytorch_tpu_torch.models.resnet import (  # noqa: F401
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)

_CNN_REGISTRY: dict = {
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "resnet152": ResNet152,
}

_GPT_REGISTRY: dict = {
    "gpt2": GPT2_SMALL,
    "gpt2_medium": GPT2_MEDIUM,
    "gpt2_large": GPT2_LARGE,
}

#: the JAX package's model names not ported yet
_UNPORTED = (
    "densenet121", "densenet169", "densenet201", "inceptionv4", "vgg11",
    "vgg16", "vgg19", "mnistnet", "vit_s16", "vit_b16", "bert_base", "bert",
    "bert_large",
)


def cnn_names() -> list:
    return sorted(_CNN_REGISTRY)


def gpt_names() -> list:
    return sorted(_GPT_REGISTRY)


def _check_ported(key: str, name: str) -> None:
    if key in _UNPORTED:
        raise KeyError(
            f"model {name!r} is not ported yet: the rest of the zoo comes "
            f"with the models slice (ROADMAP Queue 1 item 5b); CNNs: "
            f"{cnn_names()}, GPT: {gpt_names()}")


def gpt_config(name: str, *, dtype=torch.float32) -> GptConfig:
    """The registered config of ``name`` in compute ``dtype``. Raises
    KeyError with the valid names otherwise."""
    key = name.lower()
    _check_ported(key, name)
    if key not in _GPT_REGISTRY:
        raise KeyError(f"unknown model {name!r}; GPT: {gpt_names()}")
    return dataclasses.replace(_GPT_REGISTRY[key], dtype=dtype)


def get_model(name: str, *, dtype=torch.float32, device=None, **kwargs):
    """A registered model built on ``device`` (the card by default): a
    `models.resnet.ResNet` for a CNN name (``kwargs`` such as ``stem=``,
    ``num_classes=``, ``seed=`` go to it), else ``GptLmHeadModel``."""
    key = name.lower()
    _check_ported(key, name)
    if key in _CNN_REGISTRY:
        return _CNN_REGISTRY[key](dtype=dtype, device=device, **kwargs)
    if key not in _GPT_REGISTRY:
        raise KeyError(f"unknown model {name!r}; CNNs: {cnn_names()}, "
                       f"GPT: {gpt_names()}")
    return GptLmHeadModel(gpt_config(name, dtype=dtype), device=device,
                          **kwargs)


def dropout_free(cfg):
    """``cfg`` with every ``*dropout*`` probability zeroed (the CLIs'
    ``--dropout0``)."""
    zeros = {f.name: 0.0 for f in dataclasses.fields(cfg)
             if "dropout" in f.name}
    return dataclasses.replace(cfg, **zeros)
