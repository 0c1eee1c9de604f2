"""Sequence-parallel (long-context) training — the port of
``dear_pytorch_tpu/parallel/sp.py``.

A dp x sp layout (`comm.backend.form_sp_groups`): the batch dim splits
over dp and the sequence dim over sp, ring attention (or Ulysses) runs
inside the model over the rank's sp group, and the DeAR schedule reduces
gradients over the whole group — summed over sp (partial gradients of one
shared loss), averaged over dp (`parallel.dear.build_train_step(...,
mean_axes=("dp",))`).

The helpers close the three gaps a plain model has under sequence
sharding, as in JAX:

  - position embeddings need the block's global offset
    (`sp_position_offset`; the zigzag layout a per-token one);
  - CLS pooling needs the token that lives on sp rank 0 (`sp_cls_pool`);
  - token-mean losses need global, not per-block, normalisation
    (`sp_bert_loss`, `sp_gpt_loss`).

Each loss is the JAX package's: ``loss_grad + (true_loss -
loss_grad).detach()`` (JAX's ``stop_gradient`` correction), so the value
every rank returns is the true replicated loss while each term enters the
gradient on exactly one rank. Every function takes an optional ``group``,
the sp group (default: `comm.backend.sp_group`); the loss functions
follow the port's ``loss_fn(model, batch, generator)`` contract of
`parallel.dear.build_train_step`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import collectives as C
from dear_pytorch_tpu_torch.parallel.ring_attention import (
    make_ring_attention_impl,
    make_ring_flash_attention_impl,
    make_ulysses_attention_impl,
    zigzag_positions,
    zigzag_ring_flash_attention,
)

__all__ = [
    "bert_sp_batch_specs", "make_sp_bert_loss_fn", "make_sp_gpt_loss_fn",
    "make_zigzag_attention_impl", "shard_sp_batch", "sp_bert_loss",
    "sp_bert_model", "sp_cls_pool", "sp_gpt_loss", "sp_gpt_model",
    "sp_position_offset",
]


def _group(group):
    return backend.sp_group() if group is None else group


def sp_position_offset(seq_local: int, group=None) -> int:
    """Global position of this block's first token."""
    return dist.get_rank(_group(group)) * seq_local


def sp_cls_pool(group=None) -> Callable:
    """Pool the GLOBAL first token under sequence sharding: sp rank 0
    contributes its ``x[:, 0]``, the others zeros, and a differentiable
    sum over the group (`comm.collectives.ad_psum`) gives it to every
    rank."""

    def pool(x):
        g = _group(group)
        cls = (1.0 if dist.get_rank(g) == 0 else 0.0) * x[:, 0]
        return C.ad_psum(cls.contiguous(), g)

    return pool


def _psum_nograd(x, group):
    return C.all_reduce(x.detach(), group)


def sp_bert_loss(logits, nsp_logits, masked_lm_labels, next_sentence_labels,
                 group=None, ignore_index: int = -1) -> torch.Tensor:
    """BERT pre-training criterion under sequence sharding (JAX
    sp.py:54-97). The step SUMS the ranks' partial gradients over sp, so
    every piece of the loss enters exactly one rank's graph:

      - MLM: each rank's local token NLL sum over the GLOBAL valid count
        (summed over the group, no gradient) — each token once, the
        normalisation global;
      - NSP: the pooled classifier runs on every rank (`sp_cls_pool`), but
        the term enters the graph on sp rank 0 only, so its weights'
        gradient is counted once (and the pooled cotangent reaches the
        encoder through rank 0's CLS token alone, once).

    The returned VALUE is the true loss on every rank."""
    g = _group(group)
    idx = dist.get_rank(g)
    V = logits.shape[-1]
    flat_logits = logits.reshape(-1, V).float()
    flat_labels = masked_lm_labels.reshape(-1).long()
    valid = flat_labels != ignore_index
    safe = torch.where(valid, flat_labels, torch.zeros_like(flat_labels))
    logp = torch.log_softmax(flat_logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[:, None])[:, 0]
    local_num = (nll * valid).sum()
    den = _psum_nograd(valid.sum(), g).clamp_min(1)
    nsp_logp = torch.log_softmax(nsp_logits.float(), dim=-1)
    nsp_loss = -torch.gather(
        nsp_logp, -1, next_sentence_labels.reshape(-1, 1).long()).mean()
    # JAX's where(idx == 0, nsp, 0): the other ranks' NSP term is in the
    # graph with a zero cotangent, so the pool's psum runs its backward
    # collective on every rank of the group
    loss_grad = local_num / den + torch.where(
        torch.tensor(idx == 0, device=nsp_loss.device), nsp_loss,
        torch.zeros_like(nsp_loss))
    true_loss = _psum_nograd(local_num, g) / den + nsp_loss.detach()
    return loss_grad + (true_loss - loss_grad).detach()


def bert_sp_batch_specs(batch: dict, *, dp: Optional[int] = None,
                        sp: Optional[int] = None,
                        dp_rank: Optional[int] = None,
                        sp_rank: Optional[int] = None) -> dict:
    """Which part of a GLOBAL batch this rank holds (the JAX package's
    PartitionSpecs ``P(dp, sp)`` / ``P(dp)``): ``{name: (rows, cols)}``
    slices, rows by dp index and columns (``[B, S]`` leaves; None for
    ``[B]`` leaves) by sp index. The layout defaults to
    `comm.backend.form_sp_groups`'."""
    dp = backend.dp_size() if dp is None else dp
    sp = backend.sp_size() if sp is None else sp
    dp_rank = backend.dp_rank() if dp_rank is None else dp_rank
    sp_rank = backend.sp_rank() if sp_rank is None else sp_rank
    out = {}
    for name, x in batch.items():
        rows = x.shape[0] // dp
        r = slice(dp_rank * rows, (dp_rank + 1) * rows)
        c = None
        if x.ndim >= 2:
            cols = x.shape[1] // sp
            c = slice(sp_rank * cols, (sp_rank + 1) * cols)
        out[name] = (r, c)
    return out


def shard_sp_batch(batch: dict, **layout) -> dict:
    """This rank's part of a GLOBAL batch (`bert_sp_batch_specs`), as
    contiguous tensors."""
    out = {}
    for name, (r, c) in bert_sp_batch_specs(batch, **layout).items():
        x = batch[name][r]
        out[name] = (x if c is None else x[:, c]).contiguous()
    return out


def make_sp_bert_loss_fn(model=None, *, group=None,
                         seq_local: Optional[int] = None,
                         train: bool = True) -> Callable:
    """``loss_fn(model, batch, generator=None)`` for `build_train_step` on
    a dp x sp layout: offset positions, the psum-pooled CLS, the sp-global
    criterion. The model is `sp_bert_model`'s (``model``, JAX's argument,
    is the one the step passes back)."""
    del model

    def loss_fn(m, batch, generator=None):
        ids = batch["input_ids"]
        offset = sp_position_offset(
            ids.shape[1] if seq_local is None else seq_local, group)
        logits, nsp = m(ids, batch["token_type_ids"],
                        batch["attention_mask"], train=train,
                        generator=generator, position_offset=offset,
                        pool_fn=sp_cls_pool(group))
        return sp_bert_loss(logits, nsp, batch["masked_lm_labels"],
                            batch["next_sentence_labels"], group)

    return loss_fn


def sp_gpt_loss(logits, input_ids, group=None,
                vocab_size: Optional[int] = None,
                zigzag: bool = False) -> torch.Tensor:
    """Next-token cross-entropy under sequence sharding (JAX sp.py:163).
    The shift crosses block boundaries: the last position of block i
    predicts the first token of block i + 1, so each rank sends its first
    token to its left neighbour (`comm.collectives.permute`); the global
    last position has no target. Every token's NLL enters the graph on the
    rank holding its logit, normalised by the GLOBAL target count; the
    VALUE is the true loss on every rank."""
    g = _group(group)
    world, idx = dist.get_world_size(g), dist.get_rank(g)
    B, S, Vp = logits.shape
    ids = input_ids.long()
    if zigzag:
        targets, valid = _zigzag_gpt_targets(ids, g)
    else:
        # rank i receives rank (i+1)'s first token (wrapping: the wrapped
        # value lands on the last rank's masked-out final position)
        nxt = C.permute(ids[:, 0].contiguous(),
                        [((i + 1) % world, i) for i in range(world)], g)
        targets = torch.cat([ids[:, 1:], nxt[:, None]], dim=1)
        valid = torch.ones((B, S), dtype=torch.bool, device=ids.device)
        if idx == world - 1:
            valid[:, S - 1] = False
    logits = logits.float()
    if vocab_size is not None and vocab_size < Vp:
        pad = torch.arange(Vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e9)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    local_num = (nll * valid).sum()
    den = _psum_nograd(valid.sum(), g).clamp_min(1)
    loss_grad = local_num / den
    true_loss = _psum_nograd(local_num, g) / den
    return loss_grad + (true_loss - loss_grad).detach()


def _zigzag_gpt_targets(ids, group):
    """(targets, valid) under the ZIGZAG layout (JAX sp.py:217): each rank
    holds chunks (idx, 2W-1-idx); within a chunk the targets shift by one,
    a chunk's boundary target is the next chunk's first token (all-gathered:
    2 tokens a row per rank), and only the global last position (rank 0's
    chunk 2W-1 end) has none."""
    world, idx = dist.get_world_size(group), dist.get_rank(group)
    B, S = ids.shape
    c = S // 2
    firsts = torch.stack([ids[:, 0], ids[:, c]], dim=-1).contiguous()
    # JAX's differentiable all_gather (token ids carry no gradient)
    gathered = C.ad_all_gather(firsts, group).view(world, B, 2)

    def first_of_chunk(ch):
        ch = min(ch, 2 * world - 1)   # clamp the past-the-end lookup
        dev = ch if ch < world else 2 * world - 1 - ch
        return gathered[dev, :, 0 if ch < world else 1]

    next_a = first_of_chunk(idx + 1)
    next_b = first_of_chunk(2 * world - idx)
    targets = torch.cat([ids[:, 1:c], next_a[:, None], ids[:, c + 1:],
                         next_b[:, None]], dim=1)
    valid = torch.ones((B, S), dtype=torch.bool, device=ids.device)
    if idx == 0:
        valid[:, S - 1] = False
    return targets, valid


def make_sp_gpt_loss_fn(model=None, *, vocab_size: Optional[int] = None,
                        group=None, train: bool = True,
                        zigzag: bool = False) -> Callable:
    """``loss_fn(model, batch, generator=None)`` for `build_train_step` on
    a dp x sp layout: offset positions, cross-block next-token targets. The
    model is `sp_gpt_model`'s; ``zigzag=True`` iff it runs the zigzag
    attention (positions and targets then follow the zigzag layout, the
    offset a per-token ``[1, S]`` one)."""
    del model

    def loss_fn(m, batch, generator=None):
        ids = batch["input_ids"]
        S = ids.shape[1]
        if zigzag:
            offset = (zigzag_positions(S, group)
                      - torch.arange(S))[None, :].to(ids.device)
        else:
            offset = sp_position_offset(S, group)
        logits = m(ids, train=train, generator=generator,
                   position_offset=offset)
        return sp_gpt_loss(logits, ids, group, vocab_size=vocab_size,
                           zigzag=zigzag)

    return loss_fn


def make_zigzag_attention_impl(group=None, causal: bool = True) -> Callable:
    """The model zoo's ``attention_impl`` over the load-balanced zigzag
    causal ring flash. CAUSAL ONLY and no attention-prob dropout: there is
    no correct fallback (the dense ring's causal mask assumes the
    sequential layout)."""
    if not causal:
        raise ValueError("zigzag attention is causal-only")

    def impl(q, k, v, mask, *, dropout_rate=0.0, generator=None,
             dtype=torch.float32):
        if generator is not None and dropout_rate > 0.0:
            raise ValueError(
                "zigzag attention has no attention-dropout path; set "
                "attention_probs_dropout_prob=0")
        del mask, dtype  # full sequences in the causal LM path
        return zigzag_ring_flash_attention(q, k, v, group)

    return impl


_SP_ATTENTION_IMPLS = {
    "ring": make_ring_attention_impl,
    "ring_flash": make_ring_flash_attention_impl,
    "ulysses": make_ulysses_attention_impl,
    "zigzag": make_zigzag_attention_impl,
}


def _resolve_sp_attention(flash: bool, attention: Optional[str]):
    if attention is None:
        attention = "ring_flash" if flash else "ring"
    elif flash and attention != "ring_flash":
        raise ValueError(
            f"flash=True conflicts with attention={attention!r}; pass one")
    if attention not in _SP_ATTENTION_IMPLS:
        raise ValueError(
            f"attention must be one of {sorted(_SP_ATTENTION_IMPLS)}, "
            f"got {attention!r}")
    return _SP_ATTENTION_IMPLS[attention]


def sp_gpt_model(config, group=None, *, flash: bool = False,
                 attention: Optional[str] = None, device=None,
                 seed: int = 0):
    """A `models.gpt.GptLmHeadModel` whose CAUSAL attention is
    sequence-parallel over ``group`` (default: the sp group, resolved at
    each call): the scheme choices and fallback policy of `sp_bert_model`,
    plus ``attention="zigzag"`` (batches pre-permuted with
    `ring_attention.zigzag_permutation`, the loss built with
    ``make_sp_gpt_loss_fn(..., zigzag=True)``). Its weights are the dense
    twin's of the same ``seed``."""
    from dear_pytorch_tpu_torch.models.gpt import GptLmHeadModel

    impl = _resolve_sp_attention(flash, attention)(group, causal=True)
    return GptLmHeadModel(config, attention_impl=impl, device=device,
                          seed=seed)


def sp_bert_model(config, group=None, *, flash: bool = False,
                  attention: Optional[str] = None, device=None,
                  seed: int = 0):
    """A `models.bert.BertForPreTraining` whose attention is
    sequence-parallel over ``group``: ``attention`` is ``"ring"`` (the
    default; attention dropout), ``"ring_flash"`` (the flash kernels per
    block pair; ``flash=True``) or ``"ulysses"`` (heads % sp == 0); the
    flash and Ulysses impls take the dense ring while attention-prob
    dropout is active. Its weights are the dense twin's of the same
    ``seed``."""
    from dear_pytorch_tpu_torch.models.bert import BertForPreTraining

    if attention == "zigzag":
        raise ValueError(
            "zigzag attention is causal-only (the layout balances causal "
            "skipping); BERT attention is bidirectional — use "
            "ring/ring_flash/ulysses")
    impl = _resolve_sp_attention(flash, attention)(group)
    return BertForPreTraining(config, attention_impl=impl, device=device,
                              seed=seed)
