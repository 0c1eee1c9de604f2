"""Carry weights across from the JAX package's flax layout.

No checkpoint is downloaded: the tests initialise the flax model from a
seed and carry its parameters here, so the two packages compute the same
function on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gpt_params_from_jax", "resnet_params_from_jax"]


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

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {
        "wte.weight": t(params["wte"]["embedding"]),
        "wpe.weight": t(params["wpe"]["embedding"]),
        "ln_f.weight": t(params["ln_f"]["scale"]),
        "ln_f.bias": t(params["ln_f"]["bias"]),
    }
    for i in range(cfg.num_hidden_layers):
        blk, pre = params[f"h_{i}"], f"h_{i}."
        for ln in ("ln_1", "ln_2"):
            sd[pre + ln + ".weight"] = t(blk[ln]["scale"])
            sd[pre + ln + ".bias"] = t(blk[ln]["bias"])
        for name in ("query", "key", "value"):
            sd[pre + name + ".weight"] = t(blk[name]["kernel"]).reshape(H, H).T
            sd[pre + name + ".bias"] = t(blk[name]["bias"]).reshape(H)
        sd[pre + "output.weight"] = t(blk["output"]["kernel"]).reshape(H, H).T
        sd[pre + "output.bias"] = t(blk["output"]["bias"])
        for name in ("mlp_in", "mlp_out"):
            sd[pre + name + ".weight"] = t(blk[name]["kernel"]).T
            sd[pre + name + ".bias"] = t(blk[name]["bias"])
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

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd: dict = {}

    def conv(name, leaf):
        sd[name + ".weight"] = t(leaf["kernel"]).permute(3, 2, 0, 1)

    def bn(name, leaf, stats):
        sd[name + ".weight"] = t(leaf["scale"])
        sd[name + ".bias"] = t(leaf["bias"])
        sd[name + ".running_mean"] = t(stats["mean"])
        sd[name + ".running_var"] = t(stats["var"])
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
    sd["fc.weight"] = t(params["fc"]["kernel"]).T
    sd["fc.bias"] = t(params["fc"]["bias"])
    return {k: v.contiguous() for k, v in sd.items()}
