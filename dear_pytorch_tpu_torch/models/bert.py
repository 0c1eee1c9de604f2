"""BERT for pre-training in PyTorch — the port of
``dear_pytorch_tpu/models/bert.py``: `BertConfig` with `BERT_BASE` and
`BERT_LARGE`, the dense attention core, `BertForPreTraining` (embeddings,
a post-LN encoder, the masked-LM head with its decoder tied to the word
embeddings, the next-sentence head) and `bert_pretraining_loss`. It also
holds the layers the port's transformers share: `Dense`, `LayerNorm`,
`dropout` and `ProjDense`.

The numerics follow the flax model it is held against: parameters are
stored in fp32 and every op casts its inputs and parameters to
``config.dtype``; LayerNorm statistics are fp32 (eps ``layer_norm_eps``,
1e-12); GELU is the tanh approximation; the additive mask is ``(1 - mask)
* -1e9`` in ``config.dtype`` (bf16 rounds -1e9); scores are divided by
``sqrt(head_dim)`` cast to ``config.dtype``, the softmax runs in fp32 and
is cast back; the MLM logits are ``config.dtype`` products of the tied
decoder plus the fp32 ``mlm_bias``, the NSP classifier runs in fp32, and
both heads return fp32. The module tree keeps flax's names
(``word_embeddings``, ``layer_0.attention.query``, ``layer_0.output_ln``,
``mlm_transform``, ``mlm_bias``, ``nsp_classifier`` …), so
`models.convert.bert_params_from_jax` maps weights across mechanically.

Training mode is ``forward(..., train=True, generator=g)``: the hidden
dropouts and the attention-probability dropout draw their keep masks from
the explicit ``torch.Generator`` ``g``. The bits cannot match JAX's PRNG,
so dropout is held to its statistics, not to JAX's masks.

Not in this slice (each raises ``NotImplementedError`` naming ROADMAP
Queue 1 item 5b): the decode path (``decode=True``), the causal serving
forward (``causal=True``) and ``projection_impl`` (BERT's
``--ring-projections``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dear_pytorch_tpu_torch._device import resolve_device

__all__ = [
    "BERT_BASE", "BERT_LARGE", "BertConfig", "BertForPreTraining",
    "BertLayer", "BertSelfAttention", "Dense", "LayerNorm", "ProjDense",
    "bert_pretraining_loss", "dot_product_attention", "dropout",
]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32

    @property
    def padded_vocab_size(self) -> int:
        """The vocab padded to a multiple of 8 (30522 -> 30528)."""
        return ((self.vocab_size + 7) // 8) * 8


BERT_BASE = BertConfig()
BERT_LARGE = BertConfig(hidden_size=1024, num_hidden_layers=24,
                        num_attention_heads=16, intermediate_size=4096)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP Queue 1 item 5b (BERT decode "
        "and BERT's --ring-projections)")


# ---------------------------------------------------------------------------
# the layers the port's transformers share
# ---------------------------------------------------------------------------


def dropout(x, rate: float, generator):
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    (a mask drawn from ``generator``) and scale the kept ones by
    ``1 / (1 - rate)``."""
    if rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class Dense(nn.Linear):
    """``nn.Linear`` with flax's dtype rule: fp32 parameters, inputs and
    parameters cast to ``compute_dtype`` for the product."""

    def __init__(self, in_features, out_features, *, compute_dtype, device):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics and output in ``compute_dtype``."""

    def __init__(self, size, *, eps, compute_dtype, device):
        super().__init__(size, eps=eps, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        # the weight and bias are cast too: a train step may keep them as
        # bf16 views (gather_dtype); the statistics stay fp32 either way
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(self.compute_dtype)


class ProjDense(nn.Linear):
    """A dense projection with an injectable matmul impl — the port of the
    JAX package's ``models/bert.py::ProjDense`` (:69). It holds the SAME
    parameters as the port's ``Dense`` (``weight [out, in]``, ``bias
    [out]``: torch's layout, fp32), so plans, checkpoints and
    `models.convert.gpt_params_from_jax` are unchanged. ``forward``
    flattens the input to 2-D and calls ``impl(x2d [M, in], kernel2d [in,
    out], bias1d [out], compute_dtype) -> y2d``, the contract
    `ops.collective_matmul.make_ring_projection_impl` implements; the impl
    applies the dtype promotion itself."""

    def __init__(self, in_features, out_features, *, impl: Callable,
                 compute_dtype, device):
        super().__init__(in_features, out_features, device=device)
        self.impl = impl
        self.compute_dtype = compute_dtype

    def forward(self, x):
        y = self.impl(x.reshape(-1, self.in_features), self.weight.t(),
                      self.bias, self.compute_dtype)
        return y.reshape(x.shape[:-1] + (self.out_features,))


def dot_product_attention(q, k, v, mask, *, dropout_rate=0.0, generator=None,
                          dtype=torch.float32):
    """The dense attention core: one softmax(QKᵀ)V per layer, batched over
    (batch, heads). Shapes: q/k/v ``[B, S, H, D]``; ``mask`` additive,
    broadcastable to ``[B, H, Sq, Sk]`` (the model's ``[B, 1, 1, S]``), or
    None. Scores are divided by ``sqrt(D)`` cast to ``dtype``, the softmax
    runs in fp32 and is cast back to ``dtype``; ``dropout_rate > 0`` drops
    attention probabilities with keep masks from ``generator``."""
    depth = float(torch.tensor(math.sqrt(q.shape[-1])).to(dtype))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / depth
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    if dropout_rate > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_rate
        probs = probs * keep / (1.0 - dropout_rate)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class BertSelfAttention(nn.Module):
    """Query, key and value projections, the attention core
    (``attention_impl``, the `dot_product_attention` contract) and the
    output projection. flax's ``DenseGeneral`` kernels (``[h, nh, d]``,
    output ``[nh, d, h]``) are torch ``[h, h]`` weights here."""

    def __init__(self, config: BertConfig, attention_impl: Callable,
                 device):
        super().__init__()
        self.config = config
        self.attention_impl = attention_impl
        h, dt = config.hidden_size, config.dtype
        for name in ("query", "key", "value", "output"):
            setattr(self, name, Dense(h, h, compute_dtype=dt, device=device))

    def forward(self, x, mask, generator=None):
        cfg = self.config
        B, S, h = x.shape
        nh = cfg.num_attention_heads
        q, k, v = (m(x).view(B, S, nh, h // nh)
                   for m in (self.query, self.key, self.value))
        rate = cfg.attention_probs_dropout_prob if generator is not None \
            else 0.0
        ctx = self.attention_impl(q, k, v, mask, dropout_rate=rate,
                                  generator=generator, dtype=cfg.dtype)
        return self.output(ctx.reshape(B, S, h))


class BertLayer(nn.Module):
    """Post-LN encoder layer: LN(x + attention(x)), then LN(x + MLP(x))
    with a gelu(tanh) MLP; the hidden dropouts in training mode."""

    def __init__(self, config: BertConfig, attention_impl: Callable, device):
        super().__init__()
        cfg = config
        h, dt = cfg.hidden_size, cfg.dtype
        self.config = cfg
        self.attention = BertSelfAttention(cfg, attention_impl, device)
        self.attention_ln = LayerNorm(h, eps=cfg.layer_norm_eps,
                                      compute_dtype=dt, device=device)
        self.intermediate = Dense(h, cfg.intermediate_size,
                                  compute_dtype=dt, device=device)
        self.output = Dense(cfg.intermediate_size, h, compute_dtype=dt,
                            device=device)
        self.output_ln = LayerNorm(h, eps=cfg.layer_norm_eps,
                                   compute_dtype=dt, device=device)

    def forward(self, x, mask, generator=None):
        rate = self.config.hidden_dropout_prob
        attn = self.attention(x, mask, generator)
        if generator is not None:
            attn = dropout(attn, rate, generator)
        x = self.attention_ln(x + attn)
        y = self.output(F.gelu(self.intermediate(x), approximate="tanh"))
        if generator is not None:
            y = dropout(y, rate, generator)
        return self.output_ln(x + y)


class BertForPreTraining(nn.Module):
    """Embeddings + encoder + MLM head (tied decoder) + NSP head.

    ``BertForPreTraining(cfg, device=None)`` builds the model on the CUDA
    card (``device="cpu"`` for the plain CPU path; no card and no device
    raises), with seeded weights: normal(``initializer_range``) for
    embeddings and dense weights, zeros for biases and ``mlm_bias``,
    LayerNorm 1 / 0. ``forward(input_ids, token_type_ids=None,
    attention_mask=None)`` returns ``(prediction_logits [B, S,
    padded_vocab], seq_relationship_logits [B, 2])``, both fp32.
    ``attention_impl`` replaces the dense core (the
    `dot_product_attention` contract; `ops.flash_attention.
    make_flash_attention_impl` is the flash kernels').
    """

    def __init__(self, config: BertConfig, *,
                 attention_impl: Optional[Callable] = None,
                 projection_impl: Optional[Callable] = None,
                 device=None, seed: int = 0):
        super().__init__()
        if projection_impl is not None:
            raise _unported("projection_impl")
        dev = resolve_device(device)
        cfg = self.config = config
        h, dt = cfg.hidden_size, cfg.dtype
        self.attention_impl = attention_impl or dot_product_attention
        self.word_embeddings = nn.Embedding(cfg.padded_vocab_size, h,
                                            device=dev)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                h, device=dev)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h,
                                                  device=dev)
        self.embeddings_ln = LayerNorm(h, eps=cfg.layer_norm_eps,
                                       compute_dtype=dt, device=dev)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}",
                            BertLayer(cfg, self.attention_impl, dev))
        self.mlm_transform = Dense(h, h, compute_dtype=dt, device=dev)
        self.mlm_ln = LayerNorm(h, eps=cfg.layer_norm_eps, compute_dtype=dt,
                                device=dev)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.padded_vocab_size,
                                                 device=dev))
        self.pooler = Dense(h, h, compute_dtype=dt, device=dev)
        self.nsp_classifier = Dense(h, 2, compute_dtype=torch.float32,
                                    device=dev)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.word_embeddings.weight.device

    @property
    def layers(self) -> list:
        return [getattr(self, f"layer_{i}")
                for i in range(self.config.num_hidden_layers)]

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        g = torch.Generator(device=self.device).manual_seed(seed)
        for name, p in self.named_parameters():
            owner = self.get_submodule(name.rsplit(".", 1)[0]) \
                if "." in name else self
            if isinstance(owner, LayerNorm):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, self.config.initializer_range, generator=g)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, *,
                train: bool = False, generator=None, causal: bool = False,
                decode: bool = False):
        """``train=True`` turns the dropouts on, with masks from
        ``generator`` (a ``torch.Generator`` on the model's device; required
        when any dropout rate is > 0). ``token_type_ids`` default to 0 and
        ``attention_mask`` (1 = a real token) to all ones."""
        if decode:
            raise _unported("BERT's decode path (decode=True)")
        if causal:
            raise _unported("BERT's causal serving forward (causal=True)")
        cfg = self.config
        drops = cfg.hidden_dropout_prob or cfg.attention_probs_dropout_prob
        if train and drops and generator is None:
            raise ValueError("dropout in training mode needs a "
                             "torch.Generator (generator=)")
        gen = generator if train and drops else None
        B, S = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        dt = cfg.dtype
        pos = torch.arange(S, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids).to(dt)
             + self.position_embeddings(pos).to(dt)
             + self.token_type_embeddings(token_type_ids).to(dt))
        x = self.embeddings_ln(x)
        if gen is not None:
            x = dropout(x, cfg.hidden_dropout_prob, gen)
        # the additive key mask [B, 1, 1, S] in the compute dtype
        mask = (1.0 - attention_mask[:, None, None, :].to(dt)) * torch.tensor(
            -1e9, dtype=dt, device=x.device)
        for layer in self.layers:
            x = layer(x, mask, gen)
        y = F.gelu(self.mlm_transform(x), approximate="tanh")
        y = self.mlm_ln(y)
        logits = F.linear(y, self.word_embeddings.weight.to(dt)).float() \
            + self.mlm_bias
        pooled = torch.tanh(self.pooler(x[:, 0]))
        nsp = self.nsp_classifier(pooled)
        return logits, nsp.float()


def bert_pretraining_loss(logits, nsp_logits, masked_lm_labels,
                          next_sentence_labels, ignore_index: int = -1):
    """Masked-LM + next-sentence cross-entropy, summed: the MLM term is the
    mean over the labelled positions (``!= ignore_index``; at least one
    counted), the NSP term the mean over the batch."""
    V = logits.shape[-1]
    flat_logits = logits.reshape(-1, V).float()
    flat_labels = masked_lm_labels.reshape(-1).long()
    valid = flat_labels != ignore_index
    safe = torch.where(valid, flat_labels, torch.zeros_like(flat_labels))
    logp = torch.log_softmax(flat_logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[:, None])[:, 0]
    mlm = (nll * valid).sum() / valid.sum().clamp_min(1)
    nsp_logp = torch.log_softmax(nsp_logits.float(), dim=-1)
    nsp = -torch.gather(nsp_logp, -1,
                        next_sentence_labels.reshape(-1, 1).long()).mean()
    return mlm + nsp
