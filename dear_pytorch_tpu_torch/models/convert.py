"""Carry weights across from the JAX package's flax layout, and to and
from HuggingFace ``transformers`` checkpoints.

No checkpoint is downloaded: the tests initialise the flax model from a
seed and carry its parameters here, so the two packages compute the same
function on the same inputs.

The HF converters (the port of the JAX package's ``config_from_hf``,
``convert_bert_from_torch``, ``bert_to_torch_state_dict``,
``gpt_config_from_hf``, ``convert_gpt2_from_torch`` and
``gpt2_to_torch_state_dict``) map a ``BertForPreTraining`` or
``GPT2LMHeadModel`` ``state_dict`` straight to the port's modules and
back: both sides are torch, so a ``Linear`` weight carries over as it is,
GPT-2's ``Conv1D`` ``[in, out]`` weights are transposed and its fused
``c_attn`` split into query, key and value. The vocab is padded to the
port's multiple of 8 with zero embedding rows (BERT's padded decoder-bias
entries are -1e9, so padded ids vanish from every softmax); the export
strips the padding. The configs are read from an HF config object or a
plain dict, so nothing here imports ``transformers``. Forward parity
holds against HF models whose activation is ``gelu_new`` (the port's
tanh GELU).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from dear_pytorch_tpu_torch.models.bert import BertConfig
from dear_pytorch_tpu_torch.models.gpt import GptConfig

__all__ = ["bert_params_from_jax", "bert_to_torch_state_dict",
           "config_from_hf", "convert_bert_from_torch",
           "convert_gpt2_from_torch", "densenet_params_from_jax",
           "gpt2_to_torch_state_dict", "gpt_config_from_hf",
           "gpt_params_from_jax", "inception_params_from_jax",
           "mnist_params_from_jax", "resnet_params_from_jax",
           "vgg_params_from_jax", "vit_params_from_jax"]


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


def _cnn_params_from_jax(params, batch_stats=None) -> dict:
    """A flax CNN's params (and ``batch_stats``) -> a ``state_dict`` for
    the port's model of the same layout and names: the flax module path
    joined by dots is the port's module name. A leaf with a 4-D
    ``kernel`` ``[kh, kw, in, out]`` is a conv (torch's ``[out, in, kh,
    kw]`` weight), a 2-D one a dense layer (transposed); a ``bias`` rides
    along; a leaf with a ``scale`` is a BatchNorm, its ``mean``/``var``
    from ``batch_stats`` becoming ``running_mean``/``running_var`` with
    ``num_batches_tracked`` 0 (flax keeps no count)."""
    sd: dict = {}

    def walk(tree, stats, prefix):
        if "kernel" in tree:
            k = _t(tree["kernel"])
            sd[prefix + "weight"] = (k.permute(3, 2, 0, 1) if k.dim() == 4
                                     else k.T)
            if "bias" in tree:
                sd[prefix + "bias"] = _t(tree["bias"])
        elif "scale" in tree:
            _ln(sd, prefix[:-1], tree)
            sd[prefix + "running_mean"] = _t(stats["mean"])
            sd[prefix + "running_var"] = _t(stats["var"])
            sd[prefix + "num_batches_tracked"] = torch.tensor(0)
        else:
            for name, sub in tree.items():
                walk(sub, None if stats is None else stats.get(name),
                     prefix + name + ".")

    walk(params, batch_stats, "")
    return {k: v.contiguous() for k, v in sd.items()}


def densenet_params_from_jax(params, batch_stats) -> dict:
    """Flax ``DenseNet`` params and ``batch_stats`` (nested mappings of
    numpy arrays) -> a ``state_dict`` for the port's
    `models.densenet.DenseNet` of the same block sizes: ``stem_conv``,
    ``stem_bn``, ``block{i}_layer{j}.{bn1,conv1,bn2,conv2}``,
    ``transition{i}.{bn,conv}``, ``final_bn``, ``fc`` — flax's names, its
    NHWC kernels as torch's OIHW weights, its dense kernel transposed."""
    return _cnn_params_from_jax(params, batch_stats)


def inception_params_from_jax(params, batch_stats) -> dict:
    """Flax ``InceptionV4`` params and ``batch_stats`` -> a ``state_dict``
    for the port's `models.inception.InceptionV4`: each ``ConvBN``'s
    ``conv`` and ``bn`` under flax's names (``stem1``, ``mixedA1_b0``,
    ``redB_b2d`` …), and ``fc``."""
    return _cnn_params_from_jax(params, batch_stats)


def vgg_params_from_jax(params) -> dict:
    """Flax ``VGG`` params -> a ``state_dict`` for the port's
    `models.vgg.VGG` of the same config and image size: ``conv{i}`` with
    their biases and ``fc1``-``fc3``. The port flattens in flax's (H, W, C)
    order, so ``fc1``'s kernel is transposed as it is (no permutation)."""
    return _cnn_params_from_jax(params)


def mnist_params_from_jax(params) -> dict:
    """Flax ``MnistNet`` params -> a ``state_dict`` for the port's
    `models.mnist.MnistNet` (``conv1``, ``conv2``, ``fc1``, ``fc2``; the
    port flattens in flax's order)."""
    return _cnn_params_from_jax(params)


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


# ---------------------------------------------------------------------------
# HuggingFace checkpoints
# ---------------------------------------------------------------------------


def _getter(hf_config: Any):
    if isinstance(hf_config, Mapping):
        return hf_config.get
    return lambda k, d=None: getattr(hf_config, k, d)


def _f32(t) -> torch.Tensor:
    """A tensor or array as a detached fp32 CPU tensor of its own."""
    return torch.as_tensor(np.asarray(
        t.detach().cpu() if torch.is_tensor(t) else t,
        dtype=np.float32)).clone()


def _pad_rows(t: torch.Tensor, rows: int, value: float = 0.0):
    if t.shape[0] >= rows:
        return t
    pad = torch.full((rows - t.shape[0],) + tuple(t.shape[1:]), value,
                     dtype=t.dtype)
    return torch.cat([t, pad])


def config_from_hf(hf_config: Any) -> BertConfig:
    """The port's `BertConfig` from an HF ``BertConfig`` or a plain dict
    (the reference's ``bert_config.json`` schema); the vocab is padded to
    a multiple of 8 by the config itself."""
    get = _getter(hf_config)
    return BertConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        intermediate_size=get("intermediate_size"),
        max_position_embeddings=get("max_position_embeddings"),
        type_vocab_size=get("type_vocab_size", 2),
        hidden_dropout_prob=get("hidden_dropout_prob", 0.1),
        attention_probs_dropout_prob=get("attention_probs_dropout_prob",
                                         0.1),
        layer_norm_eps=get("layer_norm_eps", 1e-12),
        initializer_range=get("initializer_range", 0.02))


#: port BERT module -> HF BertForPreTraining module, per layer ({i})
_BERT_LAYER = {
    "attention.query": "attention.self.query",
    "attention.key": "attention.self.key",
    "attention.value": "attention.self.value",
    "attention.output": "attention.output.dense",
    "attention_ln": "attention.output.LayerNorm",
    "intermediate": "intermediate.dense",
    "output": "output.dense",
    "output_ln": "output.LayerNorm",
}
_BERT_TOP = {
    "position_embeddings": "bert.embeddings.position_embeddings",
    "token_type_embeddings": "bert.embeddings.token_type_embeddings",
    "embeddings_ln": "bert.embeddings.LayerNorm",
    "mlm_transform": "cls.predictions.transform.dense",
    "mlm_ln": "cls.predictions.transform.LayerNorm",
    "pooler": "bert.pooler.dense",
    "nsp_classifier": "cls.seq_relationship",
}


def _bert_pairs(cfg: BertConfig) -> list:
    """(port name, HF name) of every weight and bias but the word
    embeddings and the decoder bias."""
    pairs = []
    for ours, hf in _BERT_TOP.items():
        leaves = ("weight",) if ours.endswith("embeddings") else \
            ("weight", "bias")
        pairs += [(f"{ours}.{x}", f"{hf}.{x}") for x in leaves]
    for i in range(cfg.num_hidden_layers):
        for ours, hf in _BERT_LAYER.items():
            pairs += [(f"layer_{i}.{ours}.{x}",
                       f"bert.encoder.layer.{i}.{hf}.{x}")
                      for x in ("weight", "bias")]
    return pairs


def convert_bert_from_torch(state_dict: Mapping[str, Any],
                            cfg: BertConfig) -> dict:
    """HF ``BertForPreTraining.state_dict()`` -> a ``state_dict`` for the
    port's `models.bert.BertForPreTraining(cfg)`: the same ``[out, in]``
    weights under the port's names, the word embeddings padded with zero
    rows to the padded vocab (the decoder is tied to them in both) and
    ``mlm_bias`` with -1e9 at the padded ids. Raises ``KeyError`` naming
    the HF entry a non-BertForPreTraining checkpoint lacks."""
    sd = {ours: _f32(state_dict[hf]) for ours, hf in _bert_pairs(cfg)}
    Vp = cfg.padded_vocab_size
    sd["word_embeddings.weight"] = _pad_rows(
        _f32(state_dict["bert.embeddings.word_embeddings.weight"]), Vp)
    sd["mlm_bias"] = _pad_rows(_f32(state_dict["cls.predictions.bias"]),
                               Vp, -1e9)
    return {k: v.contiguous() for k, v in sd.items()}


def bert_to_torch_state_dict(state_dict: Mapping[str, Any],
                             cfg: BertConfig) -> dict:
    """The inverse of `convert_bert_from_torch`: the port's BERT
    ``state_dict`` -> an HF ``BertForPreTraining`` ``state_dict`` (fp32
    CPU tensors; the padding stripped; the decoder tied to the word
    embeddings) — train here, serve on the HF stack."""
    V = cfg.vocab_size
    out = {hf: _f32(state_dict[ours]) for ours, hf in _bert_pairs(cfg)}
    wte = _f32(state_dict["word_embeddings.weight"])[:V]
    bias = _f32(state_dict["mlm_bias"])[:V]
    out["bert.embeddings.word_embeddings.weight"] = wte
    out["cls.predictions.bias"] = bias
    out["cls.predictions.decoder.weight"] = wte.clone()          # tied
    out["cls.predictions.decoder.bias"] = bias.clone()
    return out


def gpt_config_from_hf(hf_config: Any) -> GptConfig:
    """The port's `GptConfig` from an HF ``GPT2Config`` or a plain dict."""
    get = _getter(hf_config)
    h = get("n_embd")
    return GptConfig(
        vocab_size=get("vocab_size"),
        hidden_size=h,
        num_hidden_layers=get("n_layer"),
        num_attention_heads=get("n_head"),
        intermediate_size=get("n_inner") or 4 * h,
        max_position_embeddings=get("n_positions"),
        embd_dropout_prob=get("embd_pdrop", 0.1),
        hidden_dropout_prob=get("resid_pdrop", 0.1),
        attention_probs_dropout_prob=get("attn_pdrop", 0.1),
        layer_norm_eps=get("layer_norm_epsilon", 1e-5),
        initializer_range=get("initializer_range", 0.02))


def convert_gpt2_from_torch(state_dict: Mapping[str, Any],
                            cfg: GptConfig) -> dict:
    """HF ``GPT2LMHeadModel.state_dict()`` -> a ``state_dict`` for the
    port's `models.gpt.GptLmHeadModel(cfg)`. HF keeps its linear layers as
    ``Conv1D`` with ``[in, out]`` weights (transposed here to torch's
    ``[out, in]``) and fuses query, key and value into one ``c_attn`` of
    width 3H (split here). The LM head is tied to ``wte`` in both; ``wte``
    gets zero rows up to the padded vocab."""
    H = cfg.hidden_size
    sd = {"wte.weight": _pad_rows(_f32(state_dict["transformer.wte.weight"]),
                                  cfg.padded_vocab_size),
          "wpe.weight": _f32(state_dict["transformer.wpe.weight"])}
    for x in ("weight", "bias"):
        sd[f"ln_f.{x}"] = _f32(state_dict[f"transformer.ln_f.{x}"])
    for i in range(cfg.num_hidden_layers):
        hf, ours = f"transformer.h.{i}", f"h_{i}"
        for ln in ("ln_1", "ln_2"):
            for x in ("weight", "bias"):
                sd[f"{ours}.{ln}.{x}"] = _f32(state_dict[f"{hf}.{ln}.{x}"])
        w = _f32(state_dict[f"{hf}.attn.c_attn.weight"])      # [H, 3H]
        b = _f32(state_dict[f"{hf}.attn.c_attn.bias"])
        for j, name in enumerate(("query", "key", "value")):
            sd[f"{ours}.{name}.weight"] = w[:, j * H:(j + 1) * H].T
            sd[f"{ours}.{name}.bias"] = b[j * H:(j + 1) * H]
        for name, conv in (("output", "attn.c_proj"), ("mlp_in", "mlp.c_fc"),
                           ("mlp_out", "mlp.c_proj")):
            sd[f"{ours}.{name}.weight"] = _f32(
                state_dict[f"{hf}.{conv}.weight"]).T
            sd[f"{ours}.{name}.bias"] = _f32(state_dict[f"{hf}.{conv}.bias"])
    return {k: v.contiguous() for k, v in sd.items()}


def gpt2_to_torch_state_dict(state_dict: Mapping[str, Any],
                             cfg: GptConfig) -> dict:
    """The inverse of `convert_gpt2_from_torch`: the port's GPT
    ``state_dict`` -> an HF ``GPT2LMHeadModel`` ``state_dict`` (``Conv1D``
    ``[in, out]`` weights, a fused ``c_attn``, the LM head tied to
    ``wte``; the padding stripped)."""
    def t(name):
        return _f32(state_dict[name])

    wte = t("wte.weight")[:cfg.vocab_size]
    out = {"transformer.wte.weight": wte, "lm_head.weight": wte.clone(),
           "transformer.wpe.weight": t("wpe.weight")}
    for x in ("weight", "bias"):
        out[f"transformer.ln_f.{x}"] = t(f"ln_f.{x}")
    for i in range(cfg.num_hidden_layers):
        hf, ours = f"transformer.h.{i}", f"h_{i}"
        for ln in ("ln_1", "ln_2"):
            for x in ("weight", "bias"):
                out[f"{hf}.{ln}.{x}"] = t(f"{ours}.{ln}.{x}")
        out[f"{hf}.attn.c_attn.weight"] = torch.cat(
            [t(f"{ours}.{n}.weight").T for n in ("query", "key", "value")],
            dim=1).contiguous()
        out[f"{hf}.attn.c_attn.bias"] = torch.cat(
            [t(f"{ours}.{n}.bias") for n in ("query", "key", "value")])
        for name, conv in (("output", "attn.c_proj"), ("mlp_in", "mlp.c_fc"),
                           ("mlp_out", "mlp.c_proj")):
            out[f"{hf}.{conv}.weight"] = t(f"{ours}.{name}.weight").T \
                .contiguous()
            out[f"{hf}.{conv}.bias"] = t(f"{ours}.{name}.bias")
    return out
