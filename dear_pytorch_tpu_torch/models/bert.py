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

``causal=True`` adds the causal triangle (-1e9 above the diagonal, in
``config.dtype``) to the padding mask: the left-to-right serving forward.
Decode mode is a forward with ``cache=`` (from
`BertForPreTraining.init_cache`), as `models.gpt.GptLmHeadModel`'s: the
per-layer ``[B, L, heads, head_dim]`` ring caches of `serving.kvcache`,
updated in place; ``[B, 1]`` input is a decode tick, ``[B, C]`` with
``prefill_lengths`` a chunked-prefill tick; position ids past the table
are clamped. Its logits reproduce the causal forward's.
``config.decode_use_flash`` sends every decode tick's attention through
the Hopper flash-attention kernel (K1's split-K route).

``projection_impl`` routes each layer's query, key, value (features ``(nh,
d)`` flattened) and ``intermediate`` through `ProjDense` (the attention's
``output`` and the layer's ``output`` stay dense), as the JAX model does;
parameter names and shapes do not change.
`ops.collective_matmul.make_ring_projection_impl` is the ring collective
matmul of the CLI's ``--ring-projections``.
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
    #: decode-mode KV ring length (None = ``max_position_embeddings``)
    kv_cache_len: Optional[int] = None
    #: decode-tick attention through the flash-attention kernel (chunked
    #: prefill always uses the dense core)
    decode_use_flash: bool = False
    #: storage dtype of the decode KV cache (None = ``dtype``)
    kv_cache_dtype: Optional[torch.dtype] = None

    @property
    def padded_vocab_size(self) -> int:
        """The vocab padded to a multiple of 8 (30522 -> 30528)."""
        return ((self.vocab_size + 7) // 8) * 8

    @property
    def cache_len(self) -> int:
        return self.kv_cache_len or self.max_position_embeddings


BERT_BASE = BertConfig()
BERT_LARGE = BertConfig(hidden_size=1024, num_hidden_layers=24,
                        num_attention_heads=16, intermediate_size=4096)


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
    output ``[nh, d, h]``) are torch ``[h, h]`` weights here; with
    ``projection_impl`` the query, key and value are `ProjDense`."""

    def __init__(self, config: BertConfig, attention_impl: Callable,
                 device, projection_impl: Optional[Callable] = None):
        super().__init__()
        self.config = config
        self.attention_impl = attention_impl
        h, dt = config.hidden_size, config.dtype
        for name in ("query", "key", "value"):
            setattr(self, name, Dense(h, h, compute_dtype=dt, device=device)
                    if projection_impl is None else
                    ProjDense(h, h, impl=projection_impl, compute_dtype=dt,
                              device=device))
        self.output = Dense(h, h, compute_dtype=dt, device=device)

    def forward(self, x, mask, generator=None, cache=None, positions=None,
                valid=None, prefill_lengths=None):
        cfg = self.config
        B, S, h = x.shape
        nh = cfg.num_attention_heads
        q, k, v = (m(x).view(B, S, nh, h // nh)
                   for m in (self.query, self.key, self.value))
        if cache is not None:
            ctx = self._decode_attend(q, k, v, cache, positions, valid,
                                      prefill_lengths)
        else:
            rate = cfg.attention_probs_dropout_prob if generator is not None \
                else 0.0
            ctx = self.attention_impl(q, k, v, mask, dropout_rate=rate,
                                      generator=generator, dtype=cfg.dtype)
        return self.output(ctx.reshape(B, S, h))

    def _decode_attend(self, q, k, v, cache, positions, valid,
                       prefill_lengths):
        """Attention against this layer's ring KV cache (``cache`` =
        ``(ck, cv)``, written in place), the ring semantics of
        `models.gpt.GptBlock._decode_attend`: ``S == 1`` is the decode
        tick under the per-row slot ``valid``ity; ``S > 1`` a chunked
        prefill over the pre-chunk cache plus the chunk's own K/V."""
        from dear_pytorch_tpu_torch.serving import kvcache as KV

        cfg = self.config
        S = q.shape[1]
        ck, cv = cache
        L = ck.shape[1]
        if S > 1 and prefill_lengths is None:
            raise ValueError(
                f"decode with S={S} > 1 is a chunked prefill and needs "
                "per-row prefill_lengths")
        if S > L:
            raise ValueError(
                f"prefill chunk ({S}) exceeds the KV ring length ({L}); "
                "a chunk must not overwrite its own window")
        if S > 1:
            ctx = KV.chunk_attend(q, ck, cv, k, v, positions,
                                  prefill_lengths, dtype=cfg.dtype)
            KV.ring_write_chunk(ck, cv, positions, k, v, prefill_lengths)
            return ctx
        KV.ring_write(ck, cv, positions, k, v)
        return KV.cache_attend(q, ck, cv, valid, dtype=cfg.dtype,
                               use_flash=cfg.decode_use_flash)


class BertLayer(nn.Module):
    """Post-LN encoder layer: LN(x + attention(x)), then LN(x + MLP(x))
    with a gelu(tanh) MLP; the hidden dropouts in training mode. With
    ``projection_impl`` the MLP's ``intermediate`` is a `ProjDense`."""

    def __init__(self, config: BertConfig, attention_impl: Callable, device,
                 projection_impl: Optional[Callable] = None):
        super().__init__()
        cfg = config
        h, dt = cfg.hidden_size, cfg.dtype
        self.config = cfg
        self.attention = BertSelfAttention(cfg, attention_impl, device,
                                           projection_impl)
        self.attention_ln = LayerNorm(h, eps=cfg.layer_norm_eps,
                                      compute_dtype=dt, device=device)
        self.intermediate = (
            Dense(h, cfg.intermediate_size, compute_dtype=dt, device=device)
            if projection_impl is None else
            ProjDense(h, cfg.intermediate_size, impl=projection_impl,
                      compute_dtype=dt, device=device))
        self.output = Dense(cfg.intermediate_size, h, compute_dtype=dt,
                            device=device)
        self.output_ln = LayerNorm(h, eps=cfg.layer_norm_eps,
                                   compute_dtype=dt, device=device)

    def forward(self, x, mask, generator=None, cache=None, positions=None,
                valid=None, prefill_lengths=None):
        rate = self.config.hidden_dropout_prob
        attn = self.attention(x, mask, generator, cache, positions, valid,
                              prefill_lengths)
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
    make_flash_attention_impl` is the flash kernels'); ``projection_impl``
    the query, key, value and intermediate products (`ProjDense`).
    """

    def __init__(self, config: BertConfig, *,
                 attention_impl: Optional[Callable] = None,
                 projection_impl: Optional[Callable] = None,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        cfg = self.config = config
        h, dt = cfg.hidden_size, cfg.dtype
        self.custom_attention = attention_impl is not None
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
                            BertLayer(cfg, self.attention_impl, dev,
                                      projection_impl))
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

    def init_cache(self, batch: int) -> list:
        """Zeroed per-layer ring caches ``[(k, v), …]``, each ``[batch, L,
        heads, head_dim]`` in the cache dtype (the decode mode's
        ``cache=``)."""
        cfg = self.config
        nh = cfg.num_attention_heads
        shape = (batch, cfg.cache_len, nh, cfg.hidden_size // nh)
        dt = cfg.kv_cache_dtype or cfg.dtype
        return [tuple(torch.zeros(shape, dtype=dt, device=self.device)
                      for _ in range(2))
                for _ in range(cfg.num_hidden_layers)]

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, *,
                train: bool = False, generator=None, causal: bool = False,
                decode: bool = False, position_offset=0, cache=None,
                prefill_lengths=None, pool_fn=None):
        """``train=True`` turns the dropouts on, with masks from
        ``generator`` (a ``torch.Generator`` on the model's device; required
        when any dropout rate is > 0). ``token_type_ids`` default to 0 and
        ``attention_mask`` (1 = a real token) to all ones; position ids
        start at ``position_offset``.

        ``causal=True``: the causal triangle joins the padding mask (the
        default core only; a custom ``attention_impl`` raises, as in JAX).
        ``cache=`` (decode mode; ``decode=True`` demands it): as
        `models.gpt.GptLmHeadModel.forward` — ``position_offset`` is each
        row's global position (a scalar or ``[B]``), ``[B, 1]`` input a
        decode tick, ``[B, C]`` with ``prefill_lengths`` ``[B]`` a chunked
        prefill tick; position ids are clamped to the table.
        ``pool_fn(x)`` replaces the NSP head's ``x[:, 0]`` CLS pooling (JAX
        models/bert.py:269-277: under sequence parallelism the CLS token
        lives on sp rank 0 only, `parallel.sp.sp_cls_pool`)."""
        cfg = self.config
        decode = decode or cache is not None
        if decode and cache is None:
            raise ValueError("decode mode needs cache= (init_cache(batch))")
        if train and decode:
            raise ValueError("decode mode (cache=) is inference only")
        drops = cfg.hidden_dropout_prob or cfg.attention_probs_dropout_prob
        if train and drops and generator is None:
            raise ValueError("dropout in training mode needs a "
                             "torch.Generator (generator=)")
        gen = generator if train and drops else None
        B, S = input_ids.shape
        dev = input_ids.device
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        dt = cfg.dtype
        ar = torch.arange(S, device=dev)
        offset = torch.as_tensor(position_offset, dtype=torch.long,
                                 device=dev)
        if offset.ndim > 1:
            raise ValueError(
                "position_offset must be a scalar or per-row [B], got "
                f"shape {tuple(offset.shape)}")
        pos = (offset[:, None] if offset.ndim else offset) + ar[None, :]
        positions = valid = None
        if decode:
            # a partial final prefill chunk's padding rows must not index
            # past the position table
            pos = pos.clamp(max=cfg.max_position_embeddings - 1)
            positions = offset.expand(B) if offset.ndim == 0 else offset
            if S == 1:  # one validity mask serves every layer's attend
                from dear_pytorch_tpu_torch.serving import kvcache as KV

                valid = KV.ring_validity(positions, cfg.cache_len)
            elif prefill_lengths is not None:
                prefill_lengths = torch.as_tensor(prefill_lengths,
                                                  device=dev)
        x = (self.word_embeddings(input_ids).to(dt)
             + self.position_embeddings(pos).to(dt)
             + self.token_type_embeddings(token_type_ids).to(dt))
        x = self.embeddings_ln(x)
        if gen is not None:
            x = dropout(x, cfg.hidden_dropout_prob, gen)
        # the additive key mask [B, 1, 1, S] in the compute dtype
        mask = (1.0 - attention_mask[:, None, None, :].to(dt)) * torch.tensor(
            -1e9, dtype=dt, device=x.device)
        if causal:
            if self.custom_attention:
                raise ValueError(
                    "causal=True builds a [B, 1, S, S] mask the default "
                    "attention core broadcasts; custom attention_impl "
                    "hooks expect [B, 1, 1, S] key-padding masks")
            tri = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
            mask = mask + torch.where(tri, 0.0, -1e9).to(dt)[None, None]
        for i, layer in enumerate(self.layers):
            x = layer(x, mask, gen, *((cache[i], positions, valid,
                                       prefill_lengths) if decode else ()))
        y = F.gelu(self.mlm_transform(x), approximate="tanh")
        y = self.mlm_ln(y)
        logits = F.linear(y, self.word_embeddings.weight.to(dt)).float() \
            + self.mlm_bias
        pooled = torch.tanh(self.pooler(
            x[:, 0] if pool_fn is None else pool_fn(x)))
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
