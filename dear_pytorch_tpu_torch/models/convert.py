"""Carry weights across from the JAX package's flax layout.

No checkpoint is downloaded: the tests initialise the flax model from a
seed and carry its parameters here, so the two packages compute the same
function on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bert_params_from_jax", "gpt_params_from_jax",
           "resnet_params_from_jax", "vit_params_from_jax"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _ln(sd, name, leaf) -> None:
    """A flax norm's ``scale`` and ``bias`` as torch's ``weight``, ``bias``."""
    sd[name + ".weight"] = _t(leaf["scale"])
    sd[name + ".bias"] = _t(leaf["bias"])


def _dense(sd, name, leaf, in_features=None) -> None:
    """A flax (``DenseGeneral``) kernel, its input axes first, as torch's
    ``[out, in]`` weight; its bias flattened."""
    k = _t(leaf["kernel"])
    in_features = in_features or k.shape[0]
    sd[name + ".weight"] = k.reshape(in_features, -1).T
    sd[name + ".bias"] = _t(leaf["bias"]).reshape(-1)


def gpt_params_from_jax(params, cfg) -> dict:
    """Flax ``GptLmHeadModel`` params (a nested mapping of numpy arrays)
    -> a ``state_dict`` for the port's `models.gpt.GptLmHeadModel(cfg)`.

    The flax tree is ``wte.embedding [Vp, H]``, ``wpe.embedding``,
    ``ln_f.{scale,bias}`` and per layer ``h_i``: ``ln_1``/``ln_2``,
    ``query``/``key``/``value`` (kernel ``[H, nh, d]``, bias ``[nh, d]``),
    ``output`` (kernel ``[nh, d, H]``) and ``mlp_in``/``mlp_out`` (kernel
    ``[in, out]``). The port keeps flax's module names; flax's ``[in, out]``
    kernels become torch's ``[out, in]`` weights."""
    H = cfg.hidden_size
    sd = {"wte.weight": _t(params["wte"]["embedding"]),
          "wpe.weight": _t(params["wpe"]["embedding"])}
    _ln(sd, "ln_f", params["ln_f"])
    for i in range(cfg.num_hidden_layers):
        blk, pre = params[f"h_{i}"], f"h_{i}."
        for ln in ("ln_1", "ln_2"):
            _ln(sd, pre + ln, blk[ln])
        for name in ("query", "key", "value", "mlp_in", "mlp_out"):
            _dense(sd, pre + name, blk[name])
        _dense(sd, pre + "output", blk["output"], H)
    return {k: v.contiguous() for k, v in sd.items()}


def resnet_params_from_jax(params, batch_stats, *, stage_sizes,
                           stem: str = "conv7") -> dict:
    """Flax ``ResNet`` params and ``batch_stats`` (nested mappings of numpy
    arrays) -> a ``state_dict`` for the port's `models.resnet.ResNet` of
    the same ``stage_sizes`` and ``stem``: the inverse of the JAX package's
    ``convert_resnet_from_torch``.

    Flax's NHWC conv kernels ``[kh, kw, in, out]`` become torch's ``[out,
    in, kh, kw]`` weights (the ``s2d`` stem's ``[4, 4, 4C, F]`` kernel is
    the ``[F, 4C, 4, 4]`` weight as it is: no un-repack); BatchNorm's
    ``scale``/``bias`` and ``mean``/``var`` become ``weight``/``bias`` and
    ``running_mean``/``running_var``, with ``num_batches_tracked`` 0 (flax
    keeps no count); the fc kernel ``[in, out]`` is transposed. Flax's
    ``stage{i}_block{j}`` and ``downsample_conv``/``downsample_bn`` are
    torchvision's ``layer{i}.{j-1}`` and ``downsample.0``/``.1``; basic or
    bottleneck follows from the params (a ``conv3``)."""
    if stem not in ("conv7", "s2d"):
        raise ValueError(f"unknown stem {stem!r}")
    k = np.shape(params["stem_conv"]["kernel"])
    if k[0] != (4 if stem == "s2d" else 7):
        raise ValueError(f"a {k[0]}x{k[1]} stem kernel is not the "
                         f"{stem!r} stem's")

    sd: dict = {}

    def conv(name, leaf):
        sd[name + ".weight"] = _t(leaf["kernel"]).permute(3, 2, 0, 1)

    def bn(name, leaf, stats):
        _ln(sd, name, leaf)
        sd[name + ".running_mean"] = _t(stats["mean"])
        sd[name + ".running_var"] = _t(stats["var"])
        sd[name + ".num_batches_tracked"] = torch.tensor(0)

    conv("conv1", params["stem_conv"])
    bn("bn1", params["stem_bn"], batch_stats["stem_bn"])
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            blk_p = params[f"stage{i + 1}_block{j + 1}"]
            blk_s = batch_stats[f"stage{i + 1}_block{j + 1}"]
            pre = f"layer{i + 1}.{j}."
            for c in (1, 2, 3) if "conv3" in blk_p else (1, 2):
                conv(pre + f"conv{c}", blk_p[f"conv{c}"])
                bn(pre + f"bn{c}", blk_p[f"bn{c}"], blk_s[f"bn{c}"])
            if "downsample_conv" in blk_p:
                conv(pre + "downsample.0", blk_p["downsample_conv"])
                bn(pre + "downsample.1", blk_p["downsample_bn"],
                   blk_s["downsample_bn"])
    _dense(sd, "fc", params["fc"])
    return {k: v.contiguous() for k, v in sd.items()}


def bert_params_from_jax(params, cfg) -> dict:
    """Flax ``BertForPreTraining`` params (a nested mapping of numpy arrays)
    -> a ``state_dict`` for the port's `models.bert.BertForPreTraining(cfg)`.

    The flax tree is the three embeddings (``embedding [n, h]``),
    ``embeddings_ln``, per layer ``layer_i``: ``attention.{query,key,value}``
    (kernel ``[h, nh, d]``, bias ``[nh, d]``), ``attention.output`` (kernel
    ``[nh, d, h]``), ``attention_ln``, ``intermediate``, ``output``,
    ``output_ln``; then ``mlm_transform``, ``mlm_ln``, ``mlm_bias``,
    ``pooler`` and ``nsp_classifier``. The port keeps flax's names; flax's
    ``[in, out]`` kernels become torch's ``[out, in]`` weights."""
    h = cfg.hidden_size
    sd = {f"{n}.weight": _t(params[n]["embedding"])
          for n in ("word_embeddings", "position_embeddings",
                    "token_type_embeddings")}
    _ln(sd, "embeddings_ln", params["embeddings_ln"])
    for i in range(cfg.num_hidden_layers):
        blk, pre = params[f"layer_{i}"], f"layer_{i}."
        att = blk["attention"]
        for name in ("query", "key", "value"):
            _dense(sd, pre + "attention." + name, att[name])
        _dense(sd, pre + "attention.output", att["output"], h)
        for name in ("intermediate", "output"):
            _dense(sd, pre + name, blk[name])
        for name in ("attention_ln", "output_ln"):
            _ln(sd, pre + name, blk[name])
    for name in ("mlm_transform", "pooler", "nsp_classifier"):
        _dense(sd, name, params[name])
    _ln(sd, "mlm_ln", params["mlm_ln"])
    sd["mlm_bias"] = _t(params["mlm_bias"])
    return {k: v.contiguous() for k, v in sd.items()}


def vit_params_from_jax(params) -> dict:
    """Flax ``VisionTransformer`` params (a nested mapping of numpy arrays)
    -> a ``state_dict`` for the port's `models.vit.VisionTransformer` of
    the same widths, depth and image size.

    The ``patch_embed`` kernel ``[p, p, 3, E]`` (NHWC) becomes torch's
    ``[E, 3, p, p]`` weight; ``cls_token`` and ``pos_embed`` are copied;
    per block ``block{i}``: ``ln1``, ``attn.{query,key,value,out}``,
    ``ln2``, ``mlp_in``, ``mlp_out`` (kernels ``[in, out]`` transposed);
    then ``ln_final`` and ``head``."""
    sd = {"patch_embed.weight":
          _t(params["patch_embed"]["kernel"]).permute(3, 2, 0, 1),
          "patch_embed.bias": _t(params["patch_embed"]["bias"]),
          "cls_token": _t(params["cls_token"]),
          "pos_embed": _t(params["pos_embed"])}
    blocks = sorted((k for k in params if k.startswith("block")),
                    key=lambda k: int(k[len("block"):]))
    for name in blocks:
        blk = params[name]
        for ln in ("ln1", "ln2"):
            _ln(sd, f"{name}.{ln}", blk[ln])
        for proj in ("query", "key", "value", "out"):
            _dense(sd, f"{name}.attn.{proj}", blk["attn"][proj])
        for proj in ("mlp_in", "mlp_out"):
            _dense(sd, f"{name}.{proj}", blk[proj])
    _ln(sd, "ln_final", params["ln_final"])
    _dense(sd, "head", params["head"])
    return {k: v.contiguous() for k, v in sd.items()}
