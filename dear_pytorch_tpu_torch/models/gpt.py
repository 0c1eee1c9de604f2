"""Decoder-only causal LM (the GPT-2 family) in PyTorch — the port of
``dear_pytorch_tpu/models/gpt.py`` for training and serving.

The numerics follow the flax model it is held against: parameters are
stored in fp32 and every op casts its inputs and parameters to
``config.dtype``; LayerNorm statistics are fp32; GELU is the tanh
approximation; the LM head is tied to ``wte`` and its logits are computed
in ``config.dtype``, then cast to fp32. The module tree keeps flax's names
(``wte``, ``wpe``, ``h_0.query``, ``h_0.mlp_in``, ``ln_f`` …), so
`models.convert.gpt_params_from_jax` maps weights across mechanically.

Decode mode is a forward with ``cache=`` (from `GptLmHeadModel.init_cache`):
the per-layer ``[B, L, H, D]`` K/V tensors of the ring cache
(`serving.kvcache`), updated in place. ``[B, 1]`` input is the decode
tick; ``[B, C]`` with ``prefill_lengths`` is a chunked-prefill tick.
``config.decode_use_flash`` sends every decode-tick attention through the
Hopper flash-attention kernel.

Training mode is ``forward(input_ids, train=True, generator=g)``: flax's
three dropouts (after the embeddings, on the attention probabilities in the
dense core, and on each block's attention and MLP outputs) draw their keep
masks from the explicit ``torch.Generator`` ``g``. The bits cannot match
JAX's PRNG, so dropout is held to its statistics, not to JAX's masks.
`gpt_lm_loss` is the streamed-logsumexp next-token loss over the unpadded
vocab.

``projection_impl`` routes each block's query, key, value and ``mlp_in``
through `models.bert.ProjDense` (``output`` and ``mlp_out`` stay dense), as
the JAX model does; `ops.collective_matmul.make_ring_projection_impl` is
the ring collective matmul of ``--ring-projections``.

``config.remat`` recomputes each block in the backward (the JAX model's
``nn.remat(GptBlock)``) whenever the forward records a graph and is not a
decode; the recompute replays the block's dropout masks from
``generator`` (`ops.remat.checkpoint`). `checkpointed_causal_attention_impl`
recomputes only the dense core's probabilities, and has no dropout path.

Not ported yet (raises ``NotImplementedError``): mixture of experts
(``num_experts > 0``; ROADMAP Queue 1 item 10b, with tensor parallelism).
Sequence parallelism builds this model with an sp attention impl
(`parallel.sp.sp_gpt_model`) and per-token position offsets.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dear_pytorch_tpu_torch._device import check_model_device, resolve_device
from dear_pytorch_tpu_torch.models.bert import (  # noqa: F401
    Dense, LayerNorm, ProjDense, dropout,
)
from dear_pytorch_tpu_torch.ops import remat as R
from dear_pytorch_tpu_torch.ops.flash_attention import flash_attention
from dear_pytorch_tpu_torch.serving import kvcache as KV


@dataclasses.dataclass(frozen=True)
class GptConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    embd_dropout_prob: float = 0.1
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32
    #: mixture of experts: the training / expert-parallel slice
    num_experts: int = 0
    #: recompute each block in the backward (training; never in decode)
    remat: bool = False
    #: pad the vocab (and the tied LM head's N) to a multiple of this
    vocab_pad_multiple: int = 8
    #: decode-mode KV ring length (None = ``max_position_embeddings``)
    kv_cache_len: Optional[int] = None
    #: decode-tick attention through the flash-attention kernel (chunked
    #: prefill always uses the dense core: its per-(query, key) window mask
    #: is outside the kernel's per-row ``kv_mask`` contract)
    decode_use_flash: bool = False
    #: storage dtype of the decode KV cache (None = ``dtype``)
    kv_cache_dtype: Optional[torch.dtype] = None

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def cache_len(self) -> int:
        return self.kv_cache_len or self.max_position_embeddings


GPT2_SMALL = GptConfig()
GPT2_MEDIUM = GptConfig(hidden_size=1024, num_hidden_layers=24,
                        num_attention_heads=16, intermediate_size=4096)
GPT2_LARGE = GptConfig(hidden_size=1280, num_hidden_layers=36,
                       num_attention_heads=20, intermediate_size=5120)


def causal_dot_product_attention(q, k, v, mask, *, dropout_rate=0.0,
                                 generator=None, dtype=torch.float32):
    """Dense causal attention core (the `models.bert.dot_product_attention`
    convention; ``mask`` is an additive key mask or None — the causal
    triangle is applied here). ``dropout_rate > 0`` drops attention
    probabilities with masks from ``generator``."""
    S = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    tri = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~tri, -1e9)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    if dropout_rate > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_rate
        probs = probs * keep / (1.0 - dropout_rate)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def checkpointed_causal_attention_impl() -> Callable:
    """Dense causal attention whose probabilities are RECOMPUTED in the
    backward (a non-reentrant checkpoint over the core; the JAX model's
    gpt.py:118-144): the flash kernel's memory idea in plain ops. No
    dropout path (the mask would have to be replayed): an active rate
    raises."""

    def impl(q, k, v, mask, *, dropout_rate=0.0, generator=None,
             dtype=torch.float32):
        if generator is not None and dropout_rate > 0.0:
            raise ValueError(
                "checkpointed attention has no dropout path; set "
                "attention_probs_dropout_prob=0")
        return R.checkpoint(
            lambda q_, k_, v_: causal_dot_product_attention(
                q_, k_, v_, mask, dtype=dtype), q, k, v)

    return impl


def flash_causal_attention_impl() -> Callable:
    """Causal attention through the flash-attention kernels (forward K1,
    backward K2 and K3; full sequences, so the key mask is not used). The
    kernels have no attention-dropout path: an active rate raises."""

    def impl(q, k, v, mask, *, dropout_rate=0.0, generator=None,
             dtype=torch.float32):
        del mask, generator, dtype
        if dropout_rate > 0.0:
            raise ValueError(
                "flash attention kernel has no attention-dropout path; "
                "set attention_probs_dropout_prob=0")
        return flash_attention(q, k, v, causal=True)

    return impl


class GptBlock(nn.Module):
    """Pre-LN residual block: attention, then a gelu(tanh) MLP."""

    def __init__(self, config: GptConfig, attention_impl: Callable, device,
                 projection_impl: Optional[Callable] = None):
        super().__init__()
        cfg = config
        h, dt = cfg.hidden_size, cfg.dtype
        self.config = cfg
        self.attention_impl = attention_impl

        def dense(i, o):
            return Dense(i, o, compute_dtype=dt, device=device)

        def proj(i, o):   # the projection hook's paths: QKV and MLP-up
            if projection_impl is None:
                return dense(i, o)
            return ProjDense(i, o, impl=projection_impl, compute_dtype=dt,
                             device=device)

        def norm():
            return LayerNorm(h, eps=cfg.layer_norm_eps, compute_dtype=dt,
                             device=device)

        self.ln_1 = norm()
        self.query, self.key, self.value = proj(h, h), proj(h, h), proj(h, h)
        self.output = dense(h, h)
        self.ln_2 = norm()
        self.mlp_in = proj(h, cfg.intermediate_size)
        self.mlp_out = dense(cfg.intermediate_size, h)

    def forward(self, x, cache=None, positions=None, valid=None,
                prefill_lengths=None, generator=None):
        """``generator`` (training mode only) draws the dropout masks."""
        cfg = self.config
        B, S, h = x.shape
        nh = cfg.num_attention_heads
        train = generator is not None
        y = self.ln_1(x)
        q, k, v = (m(y).view(B, S, nh, h // nh)
                   for m in (self.query, self.key, self.value))
        if cache is None:
            rate = cfg.attention_probs_dropout_prob if train else 0.0
            ctx = self.attention_impl(q, k, v, None, dropout_rate=rate,
                                      generator=generator, dtype=cfg.dtype)
        else:
            ctx = self._decode_attend(q, k, v, cache, positions, valid,
                                      prefill_lengths)
        attn = self.output(ctx.reshape(B, S, h))
        if train:
            attn = dropout(attn, cfg.hidden_dropout_prob, generator)
        x = x + attn
        y = self.mlp_in(self.ln_2(x))
        y = self.mlp_out(F.gelu(y, approximate="tanh"))
        if train:
            y = dropout(y, cfg.hidden_dropout_prob, generator)
        return x + y

    def _decode_attend(self, q, k, v, cache, positions, valid,
                       prefill_lengths):
        """Attention against this layer's ring KV cache (``cache`` =
        ``(ck, cv)``, written in place). ``S == 1``: the decode tick, under
        the per-row slot ``valid``ity. ``S > 1``: a chunked-prefill tick —
        the queries attend the PRE-chunk cache plus the chunk's own K/V,
        then the chunk's valid prefix is written."""
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


class GptLmHeadModel(nn.Module):
    """Token + position embeddings, pre-LN blocks, final LN, tied LM head.

    ``GptLmHeadModel(cfg, device=None)`` builds the model on the CUDA card
    (``device="cpu"`` for the plain CPU path; no card and no device
    raises), with seeded weights: normal(``initializer_range``) for
    embeddings and projection weights, zeros for biases, LayerNorm 1 / 0.
    ``forward(input_ids)`` returns next-token logits
    ``[B, S, padded_vocab]`` in fp32.
    """

    def __init__(self, config: GptConfig, *,
                 attention_impl: Optional[Callable] = None,
                 projection_impl: Optional[Callable] = None,
                 device=None, seed: int = 0):
        super().__init__()
        if config.num_experts > 0:
            raise NotImplementedError(
                "num_experts > 0 (mixture of experts) is not ported yet "
                "(ROADMAP Queue 1 item 10b: TP, ring-TP decode and EP)")
        dev = resolve_device(device)
        cfg = config
        self.config = cfg
        self.attention_impl = attention_impl or causal_dot_product_attention
        self.wte = nn.Embedding(cfg.padded_vocab_size, cfg.hidden_size,
                                device=dev)
        self.wpe = nn.Embedding(cfg.max_position_embeddings,
                                cfg.hidden_size, device=dev)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"h_{i}",
                            GptBlock(cfg, self.attention_impl, dev,
                                     projection_impl))
        self.ln_f = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                              compute_dtype=cfg.dtype, device=dev)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @property
    def blocks(self) -> list:
        return [getattr(self, f"h_{i}")
                for i in range(self.config.num_hidden_layers)]

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        g = torch.Generator(device=self.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if isinstance(self.get_submodule(name.rsplit(".", 1)[0]),
                          LayerNorm):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, self.config.initializer_range, generator=g)

    def init_cache(self, batch: int) -> list:
        """Zeroed per-layer ring caches ``[(k, v), …]``, each
        ``[batch, L, heads, head_dim]`` in the cache dtype."""
        cfg = self.config
        nh = cfg.num_attention_heads
        shape = (batch, cfg.cache_len, nh, cfg.hidden_size // nh)
        dt = cfg.kv_cache_dtype or cfg.dtype
        return [tuple(torch.zeros(shape, dtype=dt, device=self.device)
                      for _ in range(2))
                for _ in range(cfg.num_hidden_layers)]

    def forward(self, input_ids, *, train: bool = False, generator=None,
                position_offset=0, cache=None, prefill_lengths=None):
        """``cache=None``: a full causal forward over ``input_ids``
        ``[B, S]`` starting at ``position_offset`` (a scalar, per-row
        ``[B]``, or per-token ``[1, S]`` / ``[B, S]``: the positions are
        ``position_offset + arange(S)``, JAX models/gpt.py:350-382).
        ``train=True`` turns the dropouts on, with masks from
        ``generator`` (a ``torch.Generator`` on the model's device;
        required when any dropout rate is > 0).

        ``cache=`` (decode mode): ``position_offset`` is each row's global
        position — a scalar or a per-row ``[B]`` tensor (a
        continuous-batching engine serves rows at independent positions);
        ``[B, 1]`` input is a decode tick; ``[B, C]`` input is a chunked
        prefill tick whose rows consume their valid prefix
        ``prefill_lengths`` ``[B]`` (0 freezes a row). Positions are
        clamped to the position table in decode mode (a partial final
        chunk's padding tokens)."""
        cfg = self.config
        drops = (cfg.embd_dropout_prob or cfg.hidden_dropout_prob
                 or cfg.attention_probs_dropout_prob)
        if train and drops and generator is None:
            raise ValueError("dropout in training mode needs a "
                             "torch.Generator (generator=)")
        if train and cache is not None:
            raise ValueError("decode mode (cache=) is inference only")
        gen = generator if train and drops else None
        B, S = input_ids.shape
        dev = input_ids.device
        ar = torch.arange(S, device=dev)
        if not isinstance(position_offset, int):
            position_offset = torch.as_tensor(position_offset)
        per_row = torch.is_tensor(position_offset) and position_offset.ndim
        if per_row:
            offset = position_offset.to(device=dev, dtype=torch.long)
            if offset.ndim == 1:
                pos = offset[:, None] + ar[None, :]
            elif offset.ndim == 2 and cache is None:
                # a per-token [1, S] or [B, S] offset (the zigzag
                # sequence-parallel layout, `parallel.sp`)
                pos = offset + ar[None, :]
            else:
                raise ValueError(
                    "position_offset must be a scalar, per-row [B] or (not "
                    "in decode mode) per-token [1 or B, S], got shape "
                    f"{tuple(position_offset.shape)}")
        else:
            offset = int(position_offset)
            pos = (ar + offset)[None, :]
        decode = cache is not None
        positions = valid = None
        if decode:
            pos = pos.clamp(max=cfg.max_position_embeddings - 1)
            positions = (offset if per_row else
                         torch.full((B,), offset, dtype=torch.long,
                                    device=dev))
            if S == 1:  # one validity mask serves every layer's attend
                valid = KV.ring_validity(positions, cfg.cache_len)
            elif prefill_lengths is not None:
                prefill_lengths = torch.as_tensor(prefill_lengths,
                                                  device=dev)
        dt = cfg.dtype
        x = self.wte(input_ids).to(dt) + self.wpe(pos).to(dt)
        if gen is not None:
            x = dropout(x, cfg.embd_dropout_prob, gen)
        remat = cfg.remat and not decode and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            if decode:
                x = block(x, cache[i], positions, valid, prefill_lengths)
            elif remat:
                x = R.checkpoint(block, x, generators=[gen], generator=gen)
            else:
                x = block(x, generator=gen)
        x = self.ln_f(x)
        return F.linear(x, self.wte.weight.to(dt)).float()


def _top_p_filter(logits, top_p: float):
    """Nucleus filtering: keep the smallest set of tokens whose cumulative
    probability reaches ``top_p`` (the most probable token always stays);
    everything else is masked to -inf."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    inside = (cum - probs) < top_p
    cutoff = torch.where(inside, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return torch.where(logits >= cutoff, logits,
                       torch.full_like(logits, float("-inf")))


@torch.no_grad()
def generate(model: GptLmHeadModel, prompt_ids, max_new_tokens: int, *,
             temperature: float = 0.0, top_p: float = 1.0,
             generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
    """Autoregressive decoding with the ring KV cache.

    The prompt prefills the cache one token per tick (the same decode path
    as sampling), then ``max_new_tokens`` tokens are chosen greedily
    (``temperature=0``) or sampled from the temperature-scaled
    categorical with ``generator``, optionally nucleus-filtered
    (``top_p < 1``). Padded vocab ids are never chosen. Runs on the card
    unless ``device`` (which must be the model's) says otherwise. Returns
    ``[B, prompt + new]`` token ids."""
    dev = check_model_device(model.device, device)
    cfg = model.config
    prompt = torch.as_tensor(prompt_ids, device=dev).long()
    B, P = prompt.shape
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    total = P + max_new_tokens
    if total > cfg.max_position_embeddings:
        raise ValueError(
            f"prompt + new tokens ({total}) exceeds the cache budget "
            f"(max_position_embeddings={cfg.max_position_embeddings})")
    cache = model.init_cache(B)
    pad_mask = torch.where(
        torch.arange(cfg.padded_vocab_size, device=dev) < cfg.vocab_size,
        0.0, -1e9)
    tokens = torch.cat(
        [prompt, prompt.new_zeros((B, max_new_tokens))], dim=1)
    for t in range(total - 1):
        logits = model(tokens[:, t:t + 1], position_offset=t, cache=cache)
        if t + 1 < P:
            continue  # the next token is the prompt's
        logits = logits[:, 0] + pad_mask
        if temperature > 0.0:
            logits = logits / temperature
            if top_p < 1.0:
                logits = _top_p_filter(logits, top_p)
            nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                    generator=generator)[:, 0]
        else:
            nxt = logits.argmax(dim=-1)
        tokens[:, t + 1] = nxt
    return tokens


def gpt_lm_loss(logits, input_ids, *, vocab_size: Optional[int] = None):
    """Next-token cross-entropy: ``logits[:, t]`` predict
    ``input_ids[:, t + 1]``. Padded vocab ids (>= ``vocab_size``) are left
    out of the softmax support, so the loss is the unpadded model's.
    Streamed as ``logsumexp(valid logits) - logit[target]``: no [B, S, V]
    log-prob tensor, and the pad excluded by slicing, not by a mask."""
    logits = logits[:, :-1]
    targets = input_ids[:, 1:].long()
    V = logits.shape[-1]
    valid = logits[..., :vocab_size] if (vocab_size is not None
                                         and vocab_size < V) else logits
    lse = torch.logsumexp(valid, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - tgt).mean()
