"""Ring attention: exact attention over sequence-sharded inputs — the port
of ``dear_pytorch_tpu/parallel/ring_attention.py``.

Each rank of an sp group (`comm.backend.sp_group`, or the ``group``
passed) holds one sequence block of Q, K and V, ``[B, S_local, H, D]``; the
global sequence is the blocks in group-rank order. K/V blocks travel
around the ring (`comm.collectives.permute`, rank i to rank i + 1) while
each rank folds its Q block's attention into an online softmax; the
result is exact attention, not an approximation. All math is fp32 with
the JAX module's constants (`_NEG_BIG` floors every running max, ``1e-30``
every denominator); outputs are cast back to q's dtype.

  - `ring_attention`: dense blocks, differentiable by autograd through the
    differentiable ring shift (`comm.collectives.ad_permute`, whose
    backward is the reverse shift), with blockwise attention-probability
    dropout (one keep mask per (q-block, k-block) pair, drawn from the
    caller's ``torch.Generator``: held to its statistics, not to JAX's
    masks).
  - `ring_flash_attention` and `zigzag_ring_flash_attention`: one
    ring-level ``torch.autograd.Function`` each (the JAX module's
    ``custom_vjp``): the forward ring calls the flash kernels per block
    pair (`ops.flash_attention.flash_pair_fwd`, K1, with fp32 outputs) and
    saves ``(out, lse)``; the backward is a second ring of
    `flash_pair_dq` / `flash_pair_dkv` (K2, K3) under the global LSE, in
    which the dK/dV accumulators travel with their K/V blocks and arrive
    home after ``world`` hops. Causal pairs are pruned, not masked: with
    the sequential layout rank i runs i + 1 pairs; with the zigzag layout
    (`zigzag_permutation`) every rank runs two half pairs per hop.
  - `ulysses_attention`: two tiled all-to-alls (sequence-sharded to
    head-sharded and back) around `full_attention` per head group
    (plain matmuls, as the JAX module's einsums).

The ``make_*_attention_impl`` adapters are the model zoo's
``attention_impl`` (``impl(q, k, v, mask, *, dropout_rate, generator,
dtype)``, `models.bert.dot_product_attention`'s contract; ``mask`` the
additive ``[B, 1, 1, S_local]`` key mask or None) with the JAX fallback
policy: the flash and Ulysses impls fall back to the dense ring while
attention-probability dropout is active, and zigzag raises.

Differences from the JAX schedule that change no number: the key masks
are all-gathered over the group once per call (tiny ``[B, S_local]``
ints; JAX rotates them with K/V every hop), K and V travel as one message
per hop, and no hop is sent whose block would not be read (the forward's
last rotation back home). The flash rings start each hop's transfer
before the hop's kernels and wait for it after them, so that on NCCL a
hop can overlap its pair's kernels. On ranks that share a card over gloo
a hop goes through the host and runs synchronously (`comm.collectives`):
no hop overlaps any kernel there. A hop is one `permute` on the sp group
issued from the caller's thread, in the same order on every rank; under
the DeAR step the buckets' reduce-scatters run on the train step's own
group (another communicator), on its comm stream. ``ring_p2p_s`` adds the
host time each call spends blocked in its hops; a hop through the host
first waits for the card, untimed, so it reads the transfer and the wait
for the peer, not this rank's queued kernels. The
kernels' launches are counted by `ops.flash_attention`, by route and by
shape.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import collectives as C
from dear_pytorch_tpu_torch.ops.flash_attention import (
    flash_pair_dkv,
    flash_pair_dq,
    flash_pair_fwd,
)

__all__ = [
    "full_attention", "make_ring_attention_impl",
    "make_ring_flash_attention_impl", "make_ulysses_attention_impl",
    "reset_counts", "ring_attention", "ring_flash_attention",
    "ulysses_attention", "zigzag_permutation", "zigzag_positions",
    "zigzag_ring_flash_attention",
]

_NEG_BIG = -1e30  # finite "-inf": keeps the online-softmax alpha well-defined

#: host seconds spent blocked in the rings' hops, and the hops
ring_p2p_s = 0.0
ring_hops = 0


def reset_counts() -> None:
    """Zero `ring_p2p_s` and `ring_hops`."""
    global ring_p2p_s, ring_hops
    ring_p2p_s, ring_hops = 0.0, 0


def _group(group):
    return backend.sp_group() if group is None else group


def _ring_perm(world: int) -> list:
    return [(i, (i + 1) % world) for i in range(world)]


def _drain(x, group) -> None:
    """Wait for the card before timing a hop of ``x`` that goes through
    the host (ranks sharing a card over gloo): its copy to the host would
    wait for the stream anyway, and `ring_p2p_s` then reads the transfer
    and the wait for the peer, not the card finishing the work queued
    before it."""
    if C.on_host(x, group):
        torch.cuda.synchronize(x.device)


def _hop(x, group, perm):
    """Start one ring hop of ``x``: ``(received, work)``; `_arrive` waits."""
    global ring_hops
    ring_hops += 1
    _drain(x, group)
    t0 = time.perf_counter()
    out, work = C.permute(x, perm, group, async_op=True)
    return out, work, time.perf_counter() - t0


def _arrive(pending) -> torch.Tensor:
    global ring_p2p_s
    out, work, spent = pending
    t0 = time.perf_counter()
    if work is not None:
        work.wait()
    ring_p2p_s += spent + time.perf_counter() - t0
    return out


def _ad_hop(x, group, perm):
    """One differentiable ring hop (the backward sends the cotangent back
    the other way), its forward timed into `ring_p2p_s`."""
    global ring_hops, ring_p2p_s
    ring_hops += 1
    _drain(x, group)
    t0 = time.perf_counter()
    out = C.ad_permute(x, perm, group)
    ring_p2p_s += time.perf_counter() - t0
    return out


def _block_attend(q, k, *, scale, mask):
    """One block pair: returns (block_max [B,H,Sq], p [B,H,Sq,Sk])."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1).clamp_min(_NEG_BIG)   # fully-masked rows stay finite
    p = torch.exp(s - m[..., None])          # masked entries -> exp(-inf)=0
    return m, p


def _gather_masks(kv_mask, B, S, device, group, world):
    """``[world, B, S]`` key validity of every rank's block (int32 ones
    when ``kv_mask`` is None)."""
    if kv_mask is None:
        return torch.ones((world, B, S), dtype=torch.int32, device=device)
    local = kv_mask.to(torch.int32).contiguous()
    if world == 1:
        return local[None]
    return C.all_gather(local, group).view(world, B, S)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, *, causal: bool = False,
                   scale: Optional[float] = None,
                   kv_mask: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   dropout_rate: float = 0.0) -> torch.Tensor:
    """Exact attention for per-rank sequence blocks ``[B, S_local, H, D]``
    over the ring of ``group`` (default: this rank's sp group).
    ``causal``: a causal mask over GLOBAL positions. ``scale``: default
    ``D ** -0.5``. ``kv_mask``: key validity ``[B, S_local]`` of this
    rank's block (true or > 0 = attend). ``generator`` / ``dropout_rate``:
    attention-probability dropout, one keep mask per (q-block, k-block)
    pair: the unnormalised block probabilities feeding the output are
    dropped while the normaliser sums the undropped ones, which is
    inverted dropout on the normalised probabilities (JAX
    ring_attention.py:58-83). Differentiable. Returns q's dtype."""
    g = _group(group)
    world, idx = dist.get_world_size(g), dist.get_rank(g)
    B, S, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    dev = q.device
    qf = q.float()
    q_pos = idx * S + torch.arange(S, device=dev)
    masks = (_gather_masks(kv_mask, B, S, dev, g, world).bool()
             if kv_mask is not None else None)
    perm = _ring_perm(world)
    kv = torch.stack([k.float(), v.float()])
    m = torch.full((B, H, S), _NEG_BIG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    o = torch.zeros((B, S, H, D), dtype=torch.float32, device=dev)
    for step in range(world):
        owner = (idx - step) % world
        mask = None
        if masks is not None:
            mask = masks[owner][:, None, None, :]
        if causal:
            k_pos = owner * S + torch.arange(S, device=dev)
            cm = (k_pos[None, :] <= q_pos[:, None])[None, None]
            mask = cm if mask is None else mask & cm
        bm, p = _block_attend(qf, kv[0], scale=scale, mask=mask)
        if generator is not None and dropout_rate > 0.0:
            keep = torch.rand(p.shape, generator=generator,
                              device=dev) < 1.0 - dropout_rate
            p_out = p * keep / (1.0 - dropout_rate)
        else:
            p_out = p
        pv = torch.einsum("bhqk,bkhd->bqhd", p_out, kv[1])
        m_new = torch.maximum(m, bm)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(bm - m_new)
        l = l * alpha + p.sum(dim=-1) * beta
        o = (o * alpha.transpose(1, 2)[..., None]
             + pv * beta.transpose(1, 2)[..., None])
        m = m_new
        if step < world - 1:
            kv = _ad_hop(kv, g, perm)
    l = l.clamp_min(1e-30)                   # guard: all-masked rows
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def full_attention(q, k, v, *, causal: bool = False,
                   scale: Optional[float] = None,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-device attention (the same math, no ring): the tests'
    reference and the Ulysses per-head-group core. ``kv_mask``: key
    validity ``[B, S_k]``."""
    D = q.shape[-1]
    scale = D ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], _NEG_BIG)
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        tri = (torch.arange(Sk, device=q.device)[None, :]
               <= torch.arange(Sq, device=q.device)[:, None])
        s = s.masked_fill(~tri[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _additive_to_kv_mask(mask):
    """The models' ADDITIVE ``[B, 1, 1, S]`` masks (0 = attend, a big
    negative = masked) as boolean key validity ``[B, S]``."""
    if mask is None:
        return None
    return mask.reshape(mask.shape[0], mask.shape[-1]) > -1.0


def make_ring_attention_impl(group=None, causal: bool = False) -> Callable:
    """The model zoo's ``attention_impl`` over `ring_attention` (``group``:
    default this rank's sp group, resolved at each call); the padding
    mask is this rank's ``[B, 1, 1, S_local]`` shard; attention-prob
    dropout runs blockwise inside the ring."""

    def impl(q, k, v, mask, *, dropout_rate=0.0, generator=None,
             dtype=torch.float32):
        del dtype
        return ring_attention(q, k, v, group, causal=causal,
                              kv_mask=_additive_to_kv_mask(mask),
                              generator=generator,
                              dropout_rate=dropout_rate)

    return impl


# ---------------------------------------------------------------------------
# the flash rings: one autograd Function over a forward and a backward ring
# ---------------------------------------------------------------------------


def _pair_fwd(q, k, v, mask, scale, causal):
    return flash_pair_fwd(q, k, v, mask, scale, causal,
                          out_dtype=torch.float32)


def _pair_bwd(q, k, v, mask, do, lse, delta, scale, causal):
    dq = flash_pair_dq(q, k, v, mask, do, lse, delta, scale, causal,
                       out_dtype=torch.float32)
    dk, dv = flash_pair_dkv(q, k, v, mask, do, lse, delta, scale, causal,
                            out_dtype=torch.float32)
    return dq, dk, dv


def _seq_branch(owner: int, idx: int, causal: bool) -> str:
    """The sequential layout's pair: ``full`` (an earlier block, or any
    block when not causal), ``aligned`` (causal diagonal), ``skip``."""
    if not causal or owner < idx:
        return "full"
    return "aligned" if owner == idx else "skip"


def _zz_branch(owner: int, idx: int) -> str:
    """The zigzag layout's pair (module docstring of the JAX module's
    zigzag section): ``aligned``, ``earlier`` (half-k) or ``later``
    (half-q)."""
    if owner == idx:
        return "aligned"
    return "earlier" if owner < idx else "later"


def _fwd_pair(kind, q, kb, vb, mh, scale):
    """(o, lse) fp32 of one forward pair, full length (JAX's branch
    outputs); None for a skipped pair."""
    if kind == "skip":
        return None
    if kind in ("full", "aligned"):
        return _pair_fwd(q, kb, vb, mh, scale, kind == "aligned")
    bh, sq, d = q.shape
    c = sq // 2
    if kind == "earlier":
        return _pair_fwd(q, kb[:, :c], vb[:, :c], mh[:, :c], scale, False)
    o_h, lse_h = _pair_fwd(q[:, c:], kb, vb, mh, scale, False)
    o = torch.cat([q.new_zeros((bh, c, d), dtype=torch.float32), o_h], 1)
    lse = torch.cat([torch.full((bh, c), _NEG_BIG, dtype=torch.float32,
                                device=q.device), lse_h], 1)
    return o, lse


def _bwd_pair(kind, q, kb, vb, mh, do, lse, delta, scale, acc):
    """Add one pair's (dq, dk, dv) into ``acc`` = (dq, dk, dv) fp32."""
    dq, dk, dv = acc
    if kind == "skip":
        return
    if kind in ("full", "aligned"):
        parts = _pair_bwd(q, kb, vb, mh, do, lse, delta, scale,
                          kind == "aligned")
        for a, p in zip(acc, parts):
            a += p
        return
    c = q.shape[1] // 2
    if kind == "earlier":
        dq_c, dkh, dvh = _pair_bwd(q, kb[:, :c], vb[:, :c], mh[:, :c], do,
                                   lse, delta, scale, False)
        dq += dq_c
        dk[:, :c] += dkh
        dv[:, :c] += dvh
        return
    dq_h, dk_c, dv_c = _pair_bwd(q[:, c:], kb, vb, mh, do[:, c:],
                                 lse[:, c:], delta[:, c:], scale, False)
    dq[:, c:] += dq_h
    dk += dk_c
    dv += dv_c


def _ring_fwd_scan(q, k, v, masks, group, branch_fn, scale):
    """Forward ring: fold per-hop (o, lse) block contributions into
        out = Σ_b o_b · exp(lse_b − m*) / Σ_b exp(lse_b − m*)
    (JAX ring_attention.py:225). Returns (out in q's dtype, global lse)."""
    world, idx = dist.get_world_size(group), dist.get_rank(group)
    bh, sq, d = q.shape
    dev = q.device
    perm = _ring_perm(world)
    m = torch.full((bh, sq), _NEG_BIG, dtype=torch.float32, device=dev)
    den = torch.zeros((bh, sq), dtype=torch.float32, device=dev)
    num = torch.zeros((bh, sq, d), dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])
    for s in range(world):
        owner = (idx - s) % world
        pending = _hop(kv, group, perm) if s < world - 1 else None
        res = _fwd_pair(branch_fn(owner, idx), q, kv[0], kv[1],
                        masks[owner], scale)
        if res is None:   # a skipped pair: o = 0, lse = _NEG_BIG
            lse_b = torch.full((bh, sq), _NEG_BIG, dtype=torch.float32,
                               device=dev)
        else:
            o_b, lse_b = res
            lse_b = lse_b.clamp_min(_NEG_BIG)    # fully-masked rows finite
        m_new = torch.maximum(m, lse_b)
        w = torch.exp(lse_b - m_new)
        alpha = torch.exp(m - m_new)
        den = den * alpha + w
        num = num * alpha[..., None]
        if res is not None:
            num = num + o_b * w[..., None]
        m = m_new
        if pending is not None:
            kv = _arrive(pending)
    out = (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)
    lse = m + torch.log(den.clamp_min(1e-30))
    return out, lse


def _ring_bwd_scan(q, k, v, masks, do, out, lse, group, branch_fn, scale):
    """Backward ring (JAX ring_attention.py:265): per-hop (dq, dk, dv)
    pair contributions under the global lse and delta = rowsum(dO·O); the
    dK/dV accumulators travel with their K/V blocks and are home after
    ``world`` hops. Returns fp32 (dq, dk, dv)."""
    world, idx = dist.get_world_size(group), dist.get_rank(group)
    perm = _ring_perm(world)
    delta = (do.float() * out.float()).sum(-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                      device=k.device)
    kv = torch.stack([k, v])
    for s in range(world):
        owner = (idx - s) % world
        pending = _hop(kv, group, perm) if s < world - 1 else None
        _bwd_pair(branch_fn(owner, idx), q, kv[0], kv[1], masks[owner], do,
                  lse, delta, scale, (dq, dkv[0], dkv[1]))
        if pending is not None:
            kv = _arrive(pending)
        if world > 1:
            dkv = _arrive(_hop(dkv, group, perm))
    return dq, dkv[0], dkv[1]


class _RingFlash(torch.autograd.Function):
    """The ring-level VJP of the flash rings: forward `_ring_fwd_scan`,
    backward `_ring_bwd_scan` (JAX's ``_ring_flash`` / ``_zigzag_ring_flash``
    custom VJPs). ``masks``: ``[world, B*H, S]`` int32, not
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, masks, group, branch_fn, scale):
        out, lse = _ring_fwd_scan(q, k, v, masks, group, branch_fn, scale)
        ctx.save_for_backward(q, k, v, masks, out, lse)
        ctx.group, ctx.branch_fn, ctx.scale = group, branch_fn, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, masks, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        dq, dk, dv = _ring_bwd_scan(q, k, v, masks, do, out, lse, ctx.group,
                                    ctx.branch_fn, ctx.scale)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def _flash_ring(q, k, v, group, kv_mask, scale, branch_fn):
    """Fold ``[B, S, H, D]`` to ``[B*H, S, D]``, gather the key masks
    (repeated over heads, as the kernels index a folded batch), run the
    ring Function, unfold."""
    g = _group(group)
    world = dist.get_world_size(g)
    B, S, H, D = q.shape
    scale = D ** -0.5 if scale is None else float(scale)

    def fold(x):
        return x.transpose(1, 2).reshape(B * H, S, D)

    masks = _gather_masks(kv_mask, B, S, q.device, g, world)
    masks = masks.repeat_interleave(H, dim=1).contiguous()   # [W, B*H, S]
    o = _RingFlash.apply(fold(q), fold(k), fold(v), masks, g, branch_fn,
                         scale)
    return o.reshape(B, H, S, D).transpose(1, 2)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group=None, *, causal: bool = False,
                         scale: Optional[float] = None,
                         kv_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """`ring_attention` with the flash kernels (K1 forward, K2/K3
    backward) per block pair: the same exact math and ring schedule, the
    ``[S_local, S_local]`` scores never in memory; causal pairs of later
    blocks are skipped. No attention-probability dropout (use
    `ring_attention`). Differentiable (one ring-level autograd
    Function)."""
    return _flash_ring(q, k, v, group, kv_mask, scale,
                       partial(_seq_branch, causal=causal))


def make_ring_flash_attention_impl(group=None,
                                   causal: bool = False) -> Callable:
    """The model zoo's ``attention_impl`` over `ring_flash_attention`;
    the dense ring (`make_ring_attention_impl`) while attention-prob
    dropout is active (the kernels do not express it: semantics never
    change silently)."""
    fallback = make_ring_attention_impl(group, causal)

    def impl(q, k, v, mask, *, dropout_rate=0.0, generator=None,
             dtype=torch.float32):
        if generator is not None and dropout_rate > 0.0:
            return fallback(q, k, v, mask, dropout_rate=dropout_rate,
                            generator=generator, dtype=dtype)
        return ring_flash_attention(q, k, v, group, causal=causal,
                                    kv_mask=_additive_to_kv_mask(mask))

    return impl


def zigzag_positions(seq_local: int, group=None) -> torch.Tensor:
    """Global token positions (int64, CPU) of this rank's zigzag block:
    local order [chunk idx, chunk 2W-1-idx], chunk = ``seq_local // 2``."""
    g = _group(group)
    world, idx = dist.get_world_size(g), dist.get_rank(g)
    c = seq_local // 2
    ar = torch.arange(c)
    return torch.cat([idx * c + ar, (2 * world - 1 - idx) * c + ar])


def zigzag_permutation(seq_len: int, world: int) -> np.ndarray:
    """numpy index array p with ``x_zigzag = x[:, p]``: position j of the
    zigzag-layout sequence (the ranks' blocks concatenated in rank order)
    holds global token p[j]; invert with argsort."""
    if seq_len % (2 * world):
        raise ValueError(
            f"seq_len {seq_len} must divide by 2*world ({2 * world})")
    c = seq_len // (2 * world)
    out = []
    for d in range(world):
        out.append(np.arange(d * c, (d + 1) * c))
        out.append(np.arange((2 * world - 1 - d) * c, (2 * world - d) * c))
    return np.concatenate(out)


def zigzag_ring_flash_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, group=None, *,
                                scale: Optional[float] = None,
                                kv_mask: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Load-balanced CAUSAL ring flash attention over zigzag-layout blocks
    (inputs already in zigzag order: `zigzag_permutation`,
    `zigzag_positions`). Exact; differentiable; every rank runs two half
    pairs per hop instead of idx + 1 full pairs in all."""
    if q.shape[1] % 2:
        raise ValueError(
            f"zigzag needs an even local length, got {q.shape[1]}")
    return _flash_ring(q, k, v, group, kv_mask, scale, _zz_branch)


def make_ulysses_attention_impl(group=None,
                                causal: bool = False) -> Callable:
    """The model zoo's ``attention_impl`` over `ulysses_attention` (two
    all-to-alls; heads % sp == 0). The local key-padding mask is
    all-gathered over the group once (tiny ``[B, S_local]`` ints) so each
    head group's full attention sees global validity. The dense ring while
    attention-prob dropout is active (the flash impl's policy)."""
    fallback = make_ring_attention_impl(group, causal)

    def impl(q, k, v, mask, *, dropout_rate=0.0, generator=None,
             dtype=torch.float32):
        if generator is not None and dropout_rate > 0.0:
            return fallback(q, k, v, mask, dropout_rate=dropout_rate,
                            generator=generator, dtype=dtype)
        g = _group(group)
        kw = {}
        local = _additive_to_kv_mask(mask)
        if local is not None:
            world = dist.get_world_size(g)
            B, S = local.shape
            kw["kv_mask"] = _gather_masks(local, B, S, q.device, g, world) \
                .permute(1, 0, 2).reshape(B, world * S).bool()
        return ulysses_attention(
            q, k, v, g, causal=causal,
            attn_fn=partial(full_attention, causal=causal, **kw))

    return impl


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group=None, *, causal: bool = False,
                      scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism (Jacobs et al., 2023): a
    tiled all-to-all from sequence-sharded ``[B, S/P, H, D]`` to
    head-sharded ``[B, S, H/P, D]``, full attention per head group
    (``attn_fn``, default `full_attention`), and the all-to-all back.
    Differentiable through `comm.collectives.ad_all_to_all`."""
    g = _group(group)
    world = dist.get_world_size(g)
    H = q.shape[2]
    if H % world:
        raise ValueError(f"heads ({H}) must divide by axis size ({world})")
    qh, kh, vh = (C.ad_all_to_all(x, 2, 1, g) for x in (q, k, v))
    attn = attn_fn or partial(full_attention, causal=causal, scale=scale)
    return C.ad_all_to_all(attn(qh, kh, vh), 1, 2, g)
