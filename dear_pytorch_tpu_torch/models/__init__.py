"""Model zoo of the port — the port of ``dear_pytorch_tpu/models/__init__.py``
for the GPT-2 family, the ResNets, ViT and BERT. DenseNet, VGG, Inception
and MNIST come with the rest of the zoo (ROADMAP Queue 1 item 5b); their
names raise ``KeyError`` saying so."""

from __future__ import annotations

import dataclasses

import torch

from dear_pytorch_tpu_torch.models.bert import (  # noqa: F401
    BERT_BASE,
    BERT_LARGE,
    BertConfig,
    BertForPreTraining,
    bert_pretraining_loss,
)
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
from dear_pytorch_tpu_torch.models.vit import ViTB16, ViTS16  # noqa: F401

_CNN_REGISTRY: dict = {
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "resnet152": ResNet152,
    # the vision transformers run through the image CLI like any CNN
    "vit_s16": ViTS16,
    "vit_b16": ViTB16,
}

_BERT_REGISTRY: dict = {
    "bert_base": BERT_BASE,
    "bert": BERT_LARGE,       # the reference calls BERT-Large just "bert"
    "bert_large": BERT_LARGE,
}

_GPT_REGISTRY: dict = {
    "gpt2": GPT2_SMALL,
    "gpt2_medium": GPT2_MEDIUM,
    "gpt2_large": GPT2_LARGE,
}

#: the JAX package's model names not ported yet
_UNPORTED = (
    "densenet121", "densenet169", "densenet201", "inceptionv4", "vgg11",
    "vgg16", "vgg19", "mnistnet",
)


def cnn_names() -> list:
    return sorted(_CNN_REGISTRY)


def bert_names() -> list:
    return sorted(_BERT_REGISTRY)


def gpt_names() -> list:
    return sorted(_GPT_REGISTRY)


def is_bert(name: str) -> bool:
    return name.lower() in _BERT_REGISTRY


def _names() -> str:
    return (f"CNNs: {cnn_names()}, BERT: {bert_names()}, "
            f"GPT: {gpt_names()}")


def _check_ported(key: str, name: str) -> None:
    if key in _UNPORTED:
        raise KeyError(
            f"model {name!r} is not ported yet: the rest of the zoo comes "
            f"with the models slice (ROADMAP Queue 1 item 5b); {_names()}")


def _config(registry: dict, name: str, dtype):
    key = name.lower()
    _check_ported(key, name)
    if key not in registry:
        raise KeyError(f"unknown model {name!r}; {_names()}")
    return dataclasses.replace(registry[key], dtype=dtype)


def gpt_config(name: str, *, dtype=torch.float32):
    """The registered GPT config of ``name`` in compute ``dtype``. Raises
    KeyError with the valid names otherwise."""
    return _config(_GPT_REGISTRY, name, dtype)


def bert_config(name: str, *, dtype=torch.float32):
    """The registered BERT config of ``name`` in compute ``dtype``."""
    return _config(_BERT_REGISTRY, name, dtype)


def get_model(name: str, *, dtype=torch.float32, device=None, **kwargs):
    """A registered model built on ``device`` (the card by default): a
    `models.resnet.ResNet` or `models.vit.VisionTransformer` for a CNN name
    (``kwargs`` such as ``stem=``, ``num_classes=``, ``seed=`` go to it),
    `BertForPreTraining` for a BERT name, else ``GptLmHeadModel``."""
    key = name.lower()
    _check_ported(key, name)
    if key in _CNN_REGISTRY:
        return _CNN_REGISTRY[key](dtype=dtype, device=device, **kwargs)
    if key in _BERT_REGISTRY:
        return BertForPreTraining(bert_config(name, dtype=dtype),
                                  device=device, **kwargs)
    return GptLmHeadModel(gpt_config(name, dtype=dtype), device=device,
                          **kwargs)


def dropout_free(cfg):
    """``cfg`` with every ``*dropout*`` probability zeroed (the CLIs'
    ``--dropout0``)."""
    zeros = {f.name: 0.0 for f in dataclasses.fields(cfg)
             if "dropout" in f.name}
    return dataclasses.replace(cfg, **zeros)
