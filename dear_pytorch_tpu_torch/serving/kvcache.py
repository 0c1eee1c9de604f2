"""Ring-buffer KV cache: the decode-path memory model of the serving stack.

The cache of each layer is a pair of ``[B, L, heads, head_dim]`` tensors
for a fixed ring length ``L``; the token at per-row global position ``p``
lives in slot ``p % L``. Validity is derived from the position alone —
slots ``< min(p + 1, L)`` hold the last ``min(p + 1, L)`` tokens — so the
cache carries no write-index state: a slot is reused by feeding its row
position 0 again, and a stale entry can never leak into attention. Once
``p >= L`` attention is a sliding window over the last ``L`` tokens.

Unlike the JAX reference, whose pure functions return new caches, the
writes here update the cache tensors IN PLACE (advanced-index
assignment). The JAX one-hot blend writes exactly ``k`` into the slot and
leaves every other slot bit-identical (all values are finite), so the
in-place write gives the same caches without reading and rewriting all
of them. The writers return the (same) tensors for symmetry.

The decode attend (``use_flash=True``) goes through the Hopper
flash-attention kernel (`ops.flash_attention`): a 1-token query over the
``L``-slot cache is its ``causal=False`` + key-validity-mask case. The
dense path is the same math through `models.bert.dot_product_attention`.
"""

from __future__ import annotations

import torch

from dear_pytorch_tpu_torch.models.bert import dot_product_attention
from dear_pytorch_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["ring_write", "ring_validity", "cache_attend",
           "ring_write_chunk", "chunk_attend"]


def ring_write(ck, cv, pos, k, v):
    """Write this step's K/V (``[B, 1, H, D]``) into ring slot ``pos % L``
    of the caches (``[B, L, H, D]``) in place; ``pos`` is the per-row
    global position ``[B]``."""
    rows = torch.arange(ck.shape[0], device=ck.device)
    slot = torch.remainder(pos, ck.shape[1])
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    return ck, cv


def ring_validity(pos, length: int):
    """Boolean ``[B, L]`` validity of each ring slot AFTER the token at
    per-row position ``pos`` was written (the current token included)."""
    slots = torch.arange(length, device=pos.device)
    return slots[None, :] < torch.clamp(pos[:, None] + 1, max=length)


def ring_write_chunk(ck, cv, pos, k, v, n_valid):
    """Write a CHUNK of K/V (``[B, C, H, D]``) into ring slots
    ``(pos + j) % L`` for each row's valid prefix ``j < n_valid``, in
    place; ``pos`` is the position of the chunk's first token ``[B]``.
    Rows with ``n_valid == 0`` keep their cache. Requires ``C <= L``, so a
    row's chunk maps to C distinct slots: the write gathers the old
    values of those slots, keeps them where ``j >= n_valid``, and writes
    all C back — one scatter, with no device-to-host sync."""
    B, C = k.shape[:2]
    j = torch.arange(C, device=ck.device)
    slots = torch.remainder(pos[:, None] + j[None, :], ck.shape[1])
    rows = torch.arange(B, device=ck.device)[:, None].expand(B, C)
    live = (j[None, :] < n_valid[:, None])[..., None, None]
    for cache, new in ((ck, k), (cv, v)):
        cache[rows, slots] = torch.where(live, new.to(cache.dtype),
                                         cache[rows, slots])
    return ck, cv


def chunk_attend(q, ck, cv, k_new, v_new, pos, n_valid, *, dtype):
    """Chunked-prefill attention: C queries ``[B, C, H, D]`` attend the
    PRE-chunk ring caches plus the chunk's own K/V, with exact per-query
    masking, so chunk logits equal the token-at-a-time logits at every
    position, including a chunk that spans the ring's wrap.

      - old slot ``s`` holds token ``t_s = pos-1 - ((pos-1-s) mod L)``;
        query ``j`` (global position ``pos+j``) may attend it iff the slot
        is populated (``s < min(pos, L)``) and the token is inside the
        window (``t_s >= pos+j-(L-1)``);
      - in-chunk token ``c`` is attendable iff ``c <= j``.

    Rows with ``n_valid == 0`` produce garbage the engine ignores. Dense
    core only: the per-(query, key) mask is outside the flash kernel's
    per-row ``kv_mask`` contract."""
    del n_valid  # the window mask needs only the chunk's start
    B, C = q.shape[:2]
    L = ck.shape[1]
    dev = q.device
    s = torch.arange(L, device=dev)[None, None, :]          # [1, 1, L]
    j = torch.arange(C, device=dev)[None, :, None]          # [1, C, 1]
    p = pos[:, None, None]                                  # [B, 1, 1]
    held = p - 1 - torch.remainder(p - 1 - s, L)            # token in slot s
    old_ok = (s < torch.clamp(p, max=L)) & (held >= p + j - (L - 1))
    c = torch.arange(C, device=dev)
    new_ok = (c[None, :, None] >= c[None, None, :]).expand(B, C, C)
    ok = torch.cat([old_ok, new_ok], dim=-1)                # [B, C, L+C]
    mask = torch.where(ok, 0.0, -1e9).to(dtype)[:, None]    # [B,1,C,L+C]
    keys = torch.cat([ck.to(dtype), k_new.to(dtype)], dim=1)
    vals = torch.cat([cv.to(dtype), v_new.to(dtype)], dim=1)
    return dot_product_attention(q, keys, vals, mask, dtype=dtype)


def cache_attend(q, ck, cv, valid, *, dtype, use_flash: bool = False):
    """One decode attention step: ``q`` ``[B, 1, H, D]`` over the ring
    caches under the slot-validity mask ``[B, L]``. ``use_flash`` routes
    through the flash-attention kernel (validity as its ``kv_mask``)."""
    if use_flash:
        # cast to the compute dtype: a reduced-precision cache must not
        # hand the kernel a mixed-dtype q/k pair (no-op when they agree)
        return flash_attention(q.to(dtype), ck.to(dtype), cv.to(dtype),
                               kv_mask=valid)
    mask = torch.where(valid, 0.0, -1e9).to(dtype)[:, None, None, :]
    return dot_product_attention(q, ck.to(dtype), cv.to(dtype), mask,
                                 dtype=dtype)
