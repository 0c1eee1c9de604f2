"""Carry weights across from the JAX package's flax layout.

No checkpoint is downloaded: the tests initialise the flax model from a
seed and carry its parameters here, so the two packages compute the same
function on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gpt_params_from_jax"]


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
