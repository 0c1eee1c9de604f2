#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dear_pytorch_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card (Hopper):

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, so any failure exits
non-zero and no result line is printed):

  1. require CUDA; print the card's name and power limit; turn TF32 off;
  2. build every kernel of the serving and training paths from ``csrc/``
     with nvcc, one process per source, all started together (flash_fwd,
     flash_bwd, fused_update, ring, ring_matmul, overhead_probe);
  3. hold each kernel against its plain PyTorch version on the card:
     - K1, the flash-attention forward (decode and causal-prefill shapes,
       ragged lengths, an all-masked row; fp32 within 2e-5 — summation
       order — and bf16 within 2e-2 — output rounding; fp32 outputs and
       lse of bf16 inputs within 2e-5 and 2e-4);
     - K2 and K3, the backward's dQ and dK/dV (the training shape
       [4, 1024, 12, 64] causal, a holey mask, ragged S = 13 and 136, an
       all-masked row; the largest error over the largest |plain value|,
       at most 1e-4 in fp32 — summation order over up to 1024 keys — and
       2e-2 in bf16 — output rounding), and autograd through K1+K2+K3
       against autograd through the plain forward;
     - the shard update (the K5 epilogue): bitwise, SGD (momentum, its
       first and second step; nesterov with weight decay) and AdamW, on a
       ragged shard and a 25 MB one, bf16 and fp32 gradients, with and
       without a clip scale;
     - K4 (ring all-gather) and the K5 ring (reduce-scatter + update) on a
       one-process `LocalRing`, bitwise against their stacked plain
       versions: W = 2, 4, 8, a ragged shard and a 25 MB bucket's shard,
       fp32 and bf16, SGD momentum (two steps), nesterov + weight decay,
       AdamW with an lr schedule; and every shard size of the training
       run's plan at W = 2;
     - K6, K7 and K8 (the ring collective matmul: forward, dx, dw) on a
       `LocalRing` against their stacked plain versions, within
       `_CM_RTOL` of the largest plain value (8e-3 for bf16 outputs, 1e-5
       for fp32, TF32 off): W = 2, 4, 8 on ragged and aligned shapes, fp32
       and bf16, and the main path's M = 8192, K = 768, N = 768 and 3072
       in bf16 at W = 2;
     - K9, the overhead probe's ``2x + 1``: bitwise against its plain
       version and against ``torch.add(one, x, alpha=2.0)`` at grids of 16
       x (1024, 512), 2048 x (8, 512) and 33 x (8, 512), with infinities,
       overflow, signed zeros and subnormals among the inputs;
     and again at the main paths' own shapes in phases 5 and 6: K1 at
     decode B = 4 and train [16, 1024, 12, 64] bf16 causal, K2 and K3 at
     the train shape, the shard update at every shard size of the training
     run's plan with its optimizer; the kernels line reports the largest
     error of all of these;
  4. serve GPT-2 small at full width (random weights from a seed) through
     `DecodeEngine` with ``decode_use_flash=True`` — fp32 at
     ``prefill_chunk`` 1 and 16, then bf16 — and check that every request
     finishes, that the flash kernel ran 12 times per decode tick, and that
     the fp32 tokens equal the port's own greedy `generate` (a divergence
     is accepted only at a near-tie: top-2 logit gap < 1e-3);
  5. train GPT-2 small at full width through the port's training CLI
     (``benchmarks/gpt.py --fp16 --flash-attention --dropout0``, batch 16,
     S = 1024, the DeAR schedule over a one-rank NCCL group) for 20 steps:
     the losses are finite and fall, and every step launches K1, K2 and K3
     12 times each and one shard update, reduce-scatter and all-gather per
     bucket; then one fp32 step with the flash kernels against one with
     the dense attention core (2 layers, batch 2), and 3 steps with the
     CLI's default dropout;
  5b. train it at world 2 as two processes sharing the card (this script
     with ``--train-rank R --out DIR --mode M``; the ``DEAR_*`` launcher
     variables, a ``file://`` store, card ``r % device_count``), 8
     sequences per rank, 20 steps, with ``--mode dear-fused`` (every
     step on each rank: K1–K3 12 times each, K4 and the K5 ring once per
     bucket, no separate update), again with ``--mode dear-fused
     --ring-projections`` (each rank first holds K6–K8 against their plain
     versions on its own IPC ring at the main path's shapes; then every
     step also launches K6, K7 and K8 48 times each) and with ``--mode
     dear``: losses finite, falling and equal on both ranks, both ranks'
     gathered parameters bitwise equal, dear-fused's step-20 loss within
     `_FUSED_VS_DEAR_RTOL` of dear's and the ring-projection run's within
     `_RP_VS_FUSED_RTOL` of dear-fused's; a rank's failure fails the run;
  5c. run the overhead probe as a user runs it on the card
     (``dear_pytorch_tpu_torch.scripts.overhead_probe``, `probe.main`):
     both sections in this process (K9 at its two granularities, 2 x 41
     launches; K4 and the K5 ring at 65536 and 1024 elements on a two-rank
     `LocalRing`, 22 launches each), then its kernel section again as two
     processes sharing the card (this script with ``--probe-rank R --out
     DIR``; the launcher variables, the IPC `Ring`, 12 launches each per
     rank); prints each ring call's time on both transports and the
     difference, the cost of pairing a call across two contexts;
  6. trace steady bf16 decode ticks and training steps with
     ``torch.profiler`` (device ops, busy time and idle share, the top
     device ops of a step); time each kernel, its plain version and
     PyTorch's own call where one computes the same function (SDPA, its
     backward and ``torch.optim.SGD(fused=True)``: yardsticks the port
     never calls; none for the K5 ring on one card) at the main
     path's shapes, beside the card's bound — K4 and the K5 ring per
     bucket and K6–K8 per call on a two-rank `LocalRing` (K6–K8 beside
     one cuBLAS call computing the same function for both ranks), K9 at
     both granularities beside ``torch.add(one, x, alpha=2.0)``; step
     time p50/p99, tokens/s and MFU, and the two-rank steps' p50/p99 and
     tokens/s.

``python3 chip_smoke.py --kernels-only`` runs phases 1–3 and stops without
a result line. In a full run the line before the last lists the kernels
as JSON; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import dear_pytorch_tpu_torch.ops.collective_matmul as CM
import dear_pytorch_tpu_torch.ops.flash_attention as FA
import dear_pytorch_tpu_torch.ops.fused_sgd as FS
import dear_pytorch_tpu_torch.ops.overhead_probe as OP
from dear_pytorch_tpu_torch.benchmarks import gpt as train_cli
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm.ring import LocalRing, Ring
from dear_pytorch_tpu_torch.models import dropout_free, gpt_config
from dear_pytorch_tpu_torch.models.data import synthetic_gpt_batch
from dear_pytorch_tpu_torch.models.gpt import (
    GPT2_SMALL, GptLmHeadModel, flash_causal_attention_impl, generate,
    gpt_lm_loss,
)
from dear_pytorch_tpu_torch.ops import _build
from dear_pytorch_tpu_torch.ops import fusion as FU
from dear_pytorch_tpu_torch.ops.schedules import warmup_cosine
from dear_pytorch_tpu_torch.parallel.dear import build_train_step
from dear_pytorch_tpu_torch.scripts import overhead_probe as probe
from dear_pytorch_tpu_torch.serving.engine import DecodeEngine

# the card's peak rates (NVIDIA data sheets, dense)
_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
_SLOTS, _H, _D, _L = 4, 12, 64, 1024
_DEV = "cuda"
_ROOT = Path(__file__).resolve().parent


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------


def _case(gen, B, Sq, Sk, dtype, causal, lengths=None, holey=False, D=None):
    dev = _DEV
    D = D or _D
    q = torch.randn(B, Sq, _H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Sk, _H, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Sk, _H, D, generator=gen, device=dev).to(dtype)
    ar = torch.arange(Sk, device=dev)
    if lengths is not None:
        mask = ar[None, :] < torch.tensor(lengths, device=dev)[:, None]
    elif holey:
        mask = torch.rand(B, Sk, generator=gen, device=dev) > 0.3
    else:
        mask = torch.ones(B, Sk, dtype=torch.bool, device=dev)
    return q, k, v, mask.to(torch.int32)


def check_kernel() -> float:
    """Every case through `flash_attention` ([B,S,H,D] strides, o) and
    `flash_pair_fwd` (folded [BH,S,D], o and lse); returns the largest
    |o - o_plain|."""
    gen = torch.Generator(device=_DEV).manual_seed(0)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        cases += [
            (f"decode {dt}", _case(gen, _SLOTS, 1, _L, dt, False,
                                   lengths=[1, 137, 600, 1024]), False),
            (f"all-masked row {dt}", _case(gen, _SLOTS, 1, _L, dt, False,
                                           lengths=[0, 5, 1024, 0]), False),
            (f"causal prefill {dt}", _case(gen, 2, 1024, 1024, dt, True),
             True),
            (f"ragged causal S=13 {dt}",
             _case(gen, 2, 13, 13, dt, True, holey=True), True),
            (f"ragged S=136 {dt}",
             _case(gen, 2, 136, 136, dt, False, holey=True), False),
        ]
    worst = 0.0
    for name, (q, k, v, mask), causal in cases:
        dt = q.dtype
        ref32, ref_lse = FA.flash_attention_reference(
            q, k, v, causal=causal, kv_mask=mask, out_dtype=torch.float32)
        ref_o = ref32.to(dt)
        o = FA.flash_attention(q, k, v, causal=causal, kv_mask=mask)

        def fold(x):
            return x.transpose(1, 2).reshape(-1, x.shape[1], _D)

        po, lse = FA.flash_pair_fwd(
            fold(q), fold(k), fold(v),
            mask.repeat_interleave(_H, dim=0), None, causal,
            out_dtype=torch.float32)
        torch.cuda.synchronize()
        err_o = float((o.float() - ref_o.float()).abs().max())
        ref_po = ref32.transpose(1, 2).reshape(po.shape)
        err_po = float((po - ref_po).abs().max())
        err_lse = float((lse - ref_lse.reshape(lse.shape)).abs().max())
        print(f"kernel check {name}: max|o-plain| {err_o:.3e} "
              f"max|o_f32-plain| {err_po:.3e} max|lse-plain| {err_lse:.3e}")
        _check(o.dtype == dt and po.dtype == torch.float32,
               f"{name}: output dtypes {o.dtype}, {po.dtype}")
        _check(err_o <= tol[dt] and err_po <= tol[torch.float32]
               and err_lse <= tol[torch.float32] * 10,
               f"{name}: kernel disagrees with its plain version")
        _check(bool(torch.isfinite(o.float()).all()), f"{name}: non-finite")
        if name.startswith("all-masked"):
            dead = mask.sum(dim=1) == 0
            _check(bool((o[dead] == 0).all()), "all-masked row: o != 0")
            lse_rows = lse.view(_SLOTS, _H)[dead]
            _check(bool((lse_rows == -1e30).all()),
                   "all-masked row: lse != -1e30")
        worst = max(worst, err_o)
    return worst


def _fold(x):
    """[B, S, H, D] -> [B*H, S, D] (a copy)."""
    return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[-1])


def _bwd_operands(gen, B, S, dtype, causal, lengths=None, holey=False,
                  D=None):
    """q, k, v, dO, mask and the forward's fp32 lse and delta = rowsum(dO *
    O), all [B, S, H, D] / [B, S] / [B, H, S]."""
    q, k, v, mask = _case(gen, B, S, S, dtype, causal, lengths, holey, D)
    do = torch.randn(q.shape, generator=gen, device=_DEV).to(dtype)
    o, lse = FA.flash_attention_reference(q, k, v, causal=causal,
                                          kv_mask=mask,
                                          out_dtype=torch.float32)
    delta = (do.float() * o).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, mask, lse, delta


def _rel(got, ref) -> tuple:
    """(max |got - ref|, that over max(1, max |ref|))."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / max(1.0, float(ref.float().abs().max()))


def check_bwd_kernels() -> tuple:
    """K2 (dQ) and K3 (dK, dV) against their plain versions through the
    folded `flash_pair_dq` / `flash_pair_dkv`, then autograd through
    `flash_attention` (K1 forward, K2 and K3 backward) against autograd
    through the plain forward at the [B, S, H, D] layout the model uses.
    Returns the largest absolute error of dQ and of dK/dV."""
    gen = torch.Generator(device=_DEV).manual_seed(2)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        cases += [
            (f"train causal B=4 S=1024 {dt}",
             _bwd_operands(gen, 4, 1024, dt, True), True),
            (f"holey S=256 {dt}",
             _bwd_operands(gen, 2, 256, dt, False, holey=True), False),
            (f"ragged causal S=13 {dt}",
             _bwd_operands(gen, 2, 13, dt, True, holey=True), True),
            (f"ragged S=136 {dt}",
             _bwd_operands(gen, 2, 136, dt, False, holey=True), False),
            (f"all-masked row S=136 {dt}",
             _bwd_operands(gen, 2, 136, dt, False, lengths=[0, 100]), False),
            # the D <= 128 instances, and a D that no warp width divides
            (f"D=128 causal S=200 {dt}",
             _bwd_operands(gen, 2, 200, dt, True, holey=True, D=128), True),
            (f"D=40 S=77 {dt}",
             _bwd_operands(gen, 2, 77, dt, False, holey=True, D=40), False),
        ]
    worst = {"dq": 0.0, "dkv": 0.0}
    for name, (q, k, v, do, mask, lse, delta), causal in cases:
        dt = q.dtype
        scale = q.shape[-1] ** -0.5
        args = (_fold(q), _fold(k), _fold(v), mask.repeat_interleave(_H, 0),
                _fold(do), lse.reshape(-1, lse.shape[-1]),
                delta.reshape(-1, delta.shape[-1]), scale, causal)
        dq = FA.flash_pair_dq(*args)
        dk, dv = FA.flash_pair_dkv(*args)
        ref_dq = FA.flash_pair_dq_reference(*args)
        ref_dk, ref_dv = FA.flash_pair_dkv_reference(*args)
        torch.cuda.synchronize()
        errs = {"dq": _rel(dq, ref_dq), "dk": _rel(dk, ref_dk),
                "dv": _rel(dv, ref_dv)}
        print(f"backward kernel check {name}: " + ", ".join(
            f"max|{n}-plain| {a:.3e} (rel {r:.3e})"
            for n, (a, r) in errs.items()))
        for n, out in (("dq", dq), ("dk", dk), ("dv", dv)):
            _check(out.dtype == dt, f"{name}: {n} dtype {out.dtype}")
            _check(bool(torch.isfinite(out.float()).all()),
                   f"{name}: {n} not finite")
            _check(errs[n][1] <= tol[dt],
                   f"{name}: {n} disagrees with its plain version")
        if name.startswith("all-masked"):
            dead = (mask.sum(1) == 0).repeat_interleave(_H, 0)
            _check(bool((dq[dead] == 0).all() and (dk[dead] == 0).all()
                        and (dv[dead] == 0).all()),
                   "all-masked row: a gradient is not 0")
        worst["dq"] = max(worst["dq"], errs["dq"][0])
        worst["dkv"] = max(worst["dkv"], errs["dk"][0], errs["dv"][0])

    # autograd through K1+K2+K3 against autograd through the plain forward
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, mask = _case(gen, 4, 1024, 1024, dt, True)
        w = torch.randn(q.shape, generator=gen, device=_DEV).to(dt)
        grads = []
        for fn in (FA.flash_attention, lambda *a, **kw:
                   FA.flash_attention_reference(*a, **kw)[0]):
            xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            o = fn(*xs, causal=True)
            grads.append(torch.autograd.grad(o, xs, w))
        torch.cuda.synchronize()
        errs = [_rel(g, r) for g, r in zip(*grads)]
        print(f"autograd check causal B=4 S=1024 {dt}: " + ", ".join(
            f"max|d{n}-plain| {a:.3e} (rel {r:.3e})"
            for n, (a, r) in zip("qkv", errs)))
        _check(all(r <= tol[dt] for _, r in errs),
               f"autograd {dt}: flash gradients disagree with the plain "
               "forward's")
    return worst["dq"], worst["dkv"]


def _ulps(a, b) -> int:
    """The largest distance in units in the last place between two fp32
    (or bf16) tensors of one sign pattern (0 when bitwise equal)."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    ia = a.contiguous().view(view).long()
    ib = b.contiguous().view(view).long()
    return int((ia - ib).abs().max()) if a.numel() else 0


def check_update_kernel() -> float:
    """The shard update (K5's epilogue) against `fused_update_reference`
    on the card, bitwise for SGD; AdamW's ulp distance is printed and must
    be 0 as well (both run the same IEEE operations in the same order).
    Returns the largest absolute difference (0.0)."""
    gen = torch.Generator(device=_DEV).manual_seed(3)
    opts = [
        ("sgd", FS.fused_sgd(lr=0.01)),
        ("sgd momentum", FS.fused_sgd(lr=0.01, momentum=0.9)),
        ("nesterov wd", FS.fused_sgd(lr=0.01, momentum=0.9, nesterov=True,
                                     weight_decay=1e-4)),
        ("adamw", FS.fused_adamw(lr=1e-3, weight_decay=0.01)),
    ]
    worst = 0.0
    n_cases = 0
    for n in (1_000_003, 25 * 2**20 // 4):     # ragged, one 25 MB bucket
        for gdt in (torch.bfloat16, torch.float32):
            for mean_world, clip in ((1, None), (2, 0.37)):
                for name, opt in opts:
                    worst = max(worst, _update_pair(
                        f"{name} n={n} {gdt} clip={clip}", opt, n, gdt,
                        mean_world, clip, gen))
                    n_cases += 2
    print(f"update kernel check: {n_cases} cases (SGD, momentum first and "
          "second step, nesterov + wd, AdamW; n = 1000003 and 6553600; "
          "bf16 and fp32 grads; clip 0.37 at mean_world 2) bitwise equal "
          "to the plain version")
    return worst


def _update_pair(name, opt, n, gdt, mean_world, clip, gen) -> float:
    """Two steps (the first and second) of the kernel and of its plain
    version from one start on ``n`` elements; raises unless every state
    tensor is bitwise equal after each step. Returns the largest absolute
    difference (0.0)."""
    clip_t = (None if clip is None else
              torch.tensor(clip, dtype=torch.float32, device=_DEV))
    p0 = torch.randn(n, generator=gen, device=_DEV)
    pk, pr = p0.clone(), p0.clone()
    sk, sr = opt.init(pk), opt.init(pr)
    worst = 0.0
    for step in range(2):
        rs = torch.randn(n, generator=gen, device=_DEV).to(gdt)
        scal = opt.scalars(sr, mean_world, step)
        FS.fused_update_reference(opt, rs, sr, pr, scal, clip_t)
        opt.update(rs, sk, pk, mean_world=mean_world, clip_scale=clip_t,
                   step=step)
        for key, val in sk.items():    # host bookkeeping
            if not torch.is_tensor(val):
                sr[key] = val
        pairs = [(pk, pr)] + [(sk[key], sr[key]) for key in sk
                              if torch.is_tensor(sk[key])]
        torch.cuda.synchronize()
        ulps = max(_ulps(a, b) for a, b in pairs)
        diff = max(float((a - b).abs().max()) for a, b in pairs)
        if ulps:
            print(f"update check {name} step {step}: {ulps} ulp, "
                  f"max |diff| {diff:.3e}")
        _check(ulps == 0, f"update {name}: not bitwise equal to its plain "
               "version")
        worst = max(worst, diff)
    return worst


def check_update_main_path(ts) -> float:
    """The shard update at every shard size of the training run's plan,
    with the run's own optimizer, bf16 gradients and one rank: bitwise
    equal to the plain version after the first and the second step.
    Returns the largest absolute difference (0.0)."""
    gen = torch.Generator(device=_DEV).manual_seed(7)
    sizes = sorted({b.shard_size for b in ts.plan.buckets})
    worst = max(_update_pair(f"main path n={n}", ts.optimizer, n,
                             torch.bfloat16, 1, None, gen) for n in sizes)
    print(f"update kernel check main path: {len(sizes)} shard sizes of the "
          f"plan ({sizes[0]} to {sizes[-1]}), {ts.optimizer}, bf16 "
          "grads, first and second step: bitwise equal to the plain version")
    return worst


def _ring_ulps(pairs) -> tuple:
    """(largest ulp distance, largest |a - b|) over pairs of tensors."""
    return (max(_ulps(a, b) for a, b in pairs),
            max(float((a.float() - b.float()).abs().max()) for a, b in pairs))


def _ring_ag_pair(name, ring, n, dt, gen) -> float:
    """K4 on ``ring`` against `ring_all_gather_stacked`: bitwise, or
    raise. Returns the largest absolute difference (0.0)."""
    shards = torch.randn(ring.world, n, generator=gen, device=_DEV).to(dt)
    got = CM.ring_all_gather(shards, ring)
    ref = CM.ring_all_gather_stacked(shards)
    torch.cuda.synchronize()
    ulps, diff = _ring_ulps([(got, ref)])
    _check(ulps == 0, f"ring all-gather {name}: {ulps} ulp from its plain "
           "version")
    return diff


def _ring_rs_pair(name, ring, n, gdt, opt, gen, steps=2) -> float:
    """K5 ring on ``ring`` against `fused_reduce_scatter_update_stacked`
    from one start, ``steps`` calls (the momentum's first and second):
    every parameter and state tensor bitwise equal after each, or raise.
    Returns the largest absolute difference (0.0)."""
    world = ring.world
    p0 = torch.randn(world, n, generator=gen, device=_DEV)
    pk, pr = p0.clone(), p0.clone()
    sk = [opt.init(pk[i]) for i in range(world)]
    sr = [opt.init(pr[i]) for i in range(world)]
    worst = 0.0
    for step in range(steps):
        g = torch.randn(world, world * n, generator=gen, device=_DEV).to(gdt)
        CM.fused_reduce_scatter_update(g, pk, sk, opt, ring,
                                       mean_world=world, step=step + 3)
        CM.fused_reduce_scatter_update_stacked(g, pr, sr, opt,
                                               mean_world=world,
                                               step=step + 3)
        pairs = [(pk, pr)] + [(a[k], b[k]) for a, b in zip(sk, sr)
                              for k in a if torch.is_tensor(a[k])]
        torch.cuda.synchronize()
        ulps, diff = _ring_ulps(pairs)
        _check(ulps == 0, f"ring reduce-scatter {name} step {step}: {ulps} "
               "ulp from its plain version")
        worst = max(worst, diff)
    return worst


_RING_OPTS = (
    ("sgd momentum", FS.fused_sgd(lr=0.01, momentum=0.9)),
    ("nesterov wd", FS.fused_sgd(lr=0.01, momentum=0.9, nesterov=True,
                                 weight_decay=1e-4)),
    ("adamw cosine", FS.fused_adamw(lr=warmup_cosine(1e-3, 2, 10),
                                    weight_decay=0.01)),
)


def _plan_shard_sizes(world: int) -> list:
    """The distinct shard sizes of the training run's plan (GPT-2 small,
    25 MB buckets) at ``world`` ranks."""
    cfg = dropout_free(gpt_config("gpt2", dtype=torch.bfloat16))
    plan = FU.make_plan(GptLmHeadModel(cfg, device=_DEV), world,
                        threshold_mb=25.0)
    return sorted({b.shard_size for b in plan.buckets})


def check_ring_kernels() -> tuple:
    """K4 and K5 ring on a `LocalRing` against their stacked plain versions,
    bitwise: at W = 2, 4 and 8 on a ragged shard and a 25 MB bucket's
    shard, fp32 and bf16, SGD momentum (first and second step), nesterov
    with weight decay and AdamW with an lr schedule (the step scalar); and
    at W = 2 at every shard size of the training run's plan (fp32 and bf16
    gathers; bf16 gradients with the run's optimizer). Returns the largest
    absolute difference of each (0.0)."""
    gen = torch.Generator(device=_DEV).manual_seed(8)
    ag = rs = 0.0
    n_ag = n_rs = 0
    for world in (2, 4, 8):
        sizes = (100_003, 25 * 2**20 // 4 // world)
        ring = LocalRing(world, _DEV, max(sizes))
        for n in sizes:
            for dt in (torch.float32, torch.bfloat16):
                tag = f"W={world} n={n} {dt}"
                ag = max(ag, _ring_ag_pair(tag, ring, n, dt, gen))
                n_ag += 1
                for oname, opt in _RING_OPTS:
                    rs = max(rs, _ring_rs_pair(f"{tag} {oname}", ring, n, dt,
                                               opt, gen))
                    n_rs += 1
        ring.close()
    plan = _plan_shard_sizes(2)
    ring = LocalRing(2, _DEV, max(plan))
    main_opt = FS.fused_sgd(lr=0.01, momentum=0.9)
    for n in plan:
        for dt in (torch.float32, torch.bfloat16):
            ag = max(ag, _ring_ag_pair(f"plan W=2 n={n} {dt}", ring, n, dt,
                                       gen))
            n_ag += 1
        rs = max(rs, _ring_rs_pair(f"plan W=2 n={n} bf16", ring, n,
                                   torch.bfloat16, main_opt, gen))
        n_rs += 1
    ring.close()
    print(f"ring kernel check: K4 {n_ag} cases, K5 ring {n_rs} cases (two "
          "steps each) at W = 2, 4, 8 (n = 100003 and a 25 MB bucket's "
          f"shard; fp32 and bf16; SGD momentum, nesterov + wd, AdamW with "
          f"a cosine lr) and the plan's {len(plan)} shard sizes at W = 2 "
          f"({plan[0]} to {plan[-1]}): 0 ulp from the plain versions")
    return ag, rs


#: the ring matmul (K6, K7, K8) against its plain version: largest error
#: over the largest |plain value| — bf16 outputs round to 2^-8 relative
#: (one ulp is 3.9e-3; two roundings of sums that differ only in their
#: order are at most one ulp apart), fp32 only sums in another order
_CM_RTOL = {torch.bfloat16: 8e-3, torch.float32: 1e-5}
#: the main path's ring-matmul shapes at W = 2: M = 8 x 1024 tokens per
#: rank, K = 768 (kc = 384), N = 768 (query, key, value) or 3072 (mlp_in)
_CM_MAIN = ((8 * 1024, 384, 768), (8 * 1024, 384, 3072))


def _cm_operands(world, m, kc, n, dt, gen, device=None):
    """Every rank's x [W, M, W*kc], weight shard [W, kc, N] and dy [W, M,
    N] on the card, scaled so that outputs stay O(1)."""
    dev = device or _DEV
    return (torch.randn(world, m, world * kc, generator=gen, device=dev)
            .to(dt),
            (torch.randn(world, kc, n, generator=gen, device=dev)
             / (world * kc) ** 0.5).to(dt),
            (torch.randn(world, m, n, generator=gen, device=dev)
             / m ** 0.5).to(dt))


def _cm_pairs(x, ws, dy, ring, rank=None):
    """[(name, kernel output, plain output)] of K6, K7, K8 on ``ring`` (the
    stacked operands on a `LocalRing`; row ``rank`` of them on a `Ring`)
    against the stacked plain versions."""
    pick = (lambda t: t) if rank is None else (lambda t: t[rank].contiguous())
    got = (CM.ring_matmul(pick(x), pick(ws), ring),
           CM.ring_matmul_dx(pick(dy), pick(ws), ring),
           CM.ring_matmul_dw(pick(x), pick(dy), ring))
    ref = (CM.ring_matmul_stacked(x, ws), CM.ring_matmul_dx_stacked(dy, ws),
           CM.ring_matmul_dw_stacked(x, dy))
    if rank is not None:
        ref = tuple(r[rank] for r in ref)
    return list(zip(("cm_fwd", "cm_dx", "cm_dw"), got, ref))


def _cm_hold(tag, pairs, worst) -> None:
    """Hold each kernel output within `_CM_RTOL` of its plain version;
    fold the largest absolute errors into ``worst``."""
    torch.cuda.synchronize()
    for name, got, ref in pairs:
        _check(bool(torch.isfinite(got).all()), f"{name} {tag}: not finite")
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        rel = err / max(scale, 1e-30)
        _check(rel <= _CM_RTOL[got.dtype], f"{name} {tag}: error {err:.3e} "
               f"= {rel:.3e} of max |plain| {scale:.3e} (limit "
               f"{_CM_RTOL[got.dtype]:g})")
        worst[name] = max(worst.get(name, 0.0), err)


def check_ring_matmul_kernels() -> dict:
    """K6, K7 and K8 on a `LocalRing` against their stacked plain versions
    (`_CM_RTOL`): at W = 2, 4 and 8 on ragged shapes (M, kc and N multiples
    of no tile; fp32 and bf16) and on shapes the 16-byte path takes, and at
    W = 2 at the main path's own shapes (`_CM_MAIN`, bf16), two calls in a
    row (the second reuses the slots behind the first's credits). Returns
    the largest absolute error of each."""
    gen = torch.Generator(device=_DEV).manual_seed(12)
    worst: dict = {}
    cases = 0
    for world in (2, 4, 8):
        shapes = ((37, 5, 19), (200, 24, 72))
        ring = LocalRing(world, _DEV, 1,
                         cm_elems=max(kc * n for _, kc, n in shapes))
        for m, kc, n in shapes:
            for dt in (torch.float32, torch.bfloat16):
                ops = _cm_operands(world, m, kc, n, dt, gen)
                _cm_hold(f"W={world} M={m} kc={kc} N={n} {dt}",
                         _cm_pairs(*ops, ring), worst)
                cases += 1
        ring.close()
    ring = LocalRing(2, _DEV, 1, cm_elems=max(kc * n for _, kc, n in _CM_MAIN))
    for m, kc, n in _CM_MAIN:
        for call in range(2):
            ops = _cm_operands(2, m, kc, n, torch.bfloat16, gen)
            _cm_hold(f"main W=2 M={m} K={2 * kc} N={n} call {call}",
                     _cm_pairs(*ops, ring), worst)
            cases += 1
    ring.close()
    print(f"ring matmul check: K6, K7, K8 in {cases} cases each (W = 2, 4, "
          "8 on ragged and aligned shapes, fp32 and bf16; the main path's "
          "M=8192 K=768 N=768 and 3072 bf16 at W = 2, twice each): largest "
          "errors " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (limits {_CM_RTOL[torch.bfloat16]:g} bf16, "
          f"{_CM_RTOL[torch.float32]:g} fp32, of max |plain|)")
    return worst


#: K9's grids: the probe's two granularities over 16384 rows, and a third
_K9_GRIDS = probe.GRANULARITIES + ((33, 8),)


def check_overhead_probe_kernel() -> float:
    """K9 (the probe's ``2x + 1``) against its plain version and against
    one PyTorch call computing the same function (``torch.add(one, x,
    alpha=2.0)``), bitwise, at `_K9_GRIDS`: random fp32 rows with infinities,
    values that overflow when doubled, signed zeros and subnormals. Returns
    the largest absolute difference (0.0)."""
    gen = torch.Generator(device=_DEV).manual_seed(15)
    one = torch.ones((), device=_DEV)
    for nblocks, rpb in _K9_GRIDS:
        x = torch.randn(nblocks * rpb, OP.WIDTH, generator=gen, device=_DEV)
        x[0, :6] = torch.tensor([float("inf"), float("-inf"), 3.0e38, -0.0,
                                 1e-42, -1.5])
        got = OP.affine_probe(x, rpb)
        plain = OP.affine_probe_plain(x)
        library = torch.add(one, x, alpha=2.0)
        torch.cuda.synchronize()
        for name, ref in (("its plain version", plain),
                          ("torch.add(one, x, alpha=2.0)", library)):
            _check(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
                   f"overhead probe kernel at grid {nblocks} x ({rpb}, 512) "
                   f"is not bitwise equal to {name}")
    print(f"overhead probe kernel check: grids {list(_K9_GRIDS)} of (rows, "
          "512) fp32: bitwise equal to the plain version and to "
          "torch.add(one, x, alpha=2.0)")
    return 0.0


# ---------------------------------------------------------------------------
# phase 4: serve GPT-2 small through DecodeEngine
# ---------------------------------------------------------------------------


def _requests():
    rs = np.random.RandomState(0)
    lens = (5, 17, 33, 64, 97, 128, 160, 200, 11, 150)
    return [(list(rs.randint(0, GPT2_SMALL.vocab_size, n)),
             int(rs.randint(16, 33))) for n in lens]


def serve(model, reqs, chunk):
    """All requests through a 4-slot engine, admitted as slots free.
    Returns (tokens per request, engine, wall seconds)."""
    eng = DecodeEngine(model, slots=_SLOTS, prefill_chunk=chunk, device=_DEV)
    pending, done = list(range(len(reqs))), {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while pending or eng.active:
        while pending and eng.free:
            i = pending.pop(0)
            eng.submit(reqs[i][0], reqs[i][1], request_id=i)
        for fin in eng.tick():
            done[fin.request_id] = fin.tokens
    wall = time.perf_counter() - t0
    _check(sorted(done) == list(range(len(reqs))),
           f"chunk {chunk}: not every request finished")
    for i, toks in done.items():
        _check(len(toks) == reqs[i][1]
               and all(0 <= t < GPT2_SMALL.vocab_size for t in toks),
               f"chunk {chunk}: request {i} gave {toks}")
    return done, eng, wall


def _near_tie_gap(model, prompt, ref, at):
    """Top-2 gap of the reference's logits where it chose ref[at]."""
    seq = torch.tensor([prompt + ref[:at]], device=_DEV)
    with torch.no_grad():
        logits = model(seq)[0, -1, :GPT2_SMALL.vocab_size]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def check_serving():
    cfg = dataclasses.replace(GPT2_SMALL, kv_cache_len=_L,
                              decode_use_flash=True)
    model = GptLmHeadModel(cfg, device=_DEV, seed=0)
    model16 = GptLmHeadModel(dataclasses.replace(cfg, dtype=torch.bfloat16),
                             device=_DEV, seed=0)
    print(f"GPT-2 small: {sum(p.numel() for p in model.parameters())} "
          f"params, {cfg.num_hidden_layers} layers, hidden "
          f"{cfg.hidden_size}, vocab {cfg.vocab_size} (padded "
          f"{cfg.padded_vocab_size}), ring {_L}, slots {_SLOTS}")
    reqs = _requests()
    t0 = time.perf_counter()
    refs = [generate(model, [p], n, device=_DEV)[0, len(p):].tolist()
            for p, n in reqs]
    print(f"reference generate (fp32, batch 1): "
          f"{time.perf_counter() - t0:.1f} s")

    FA.flash_fwd_launches = 0          # the main path starts here
    runs = [("fp32", 1, *serve(model, reqs, 1)),
            ("fp32", 16, *serve(model, reqs, 16)),
            ("bf16", 16, *serve(model16, reqs, 16))]
    launches = FA.flash_fwd_launches   # ... and ends here
    decode_ticks = sum(eng.decode_steps for *_, eng, _ in runs)
    print(f"main path: {decode_ticks} decode ticks, "
          f"{sum(eng.prefill_steps for *_, eng, _ in runs)} prefill ticks, "
          f"flash_fwd launches {launches}")
    _check(launches > 0 and launches == cfg.num_hidden_layers * decode_ticks,
           f"flash_fwd launched {launches} times for {decode_ticks} decode "
           "ticks")

    for dt, chunk, done, eng, wall in runs:
        new = sum(len(t) for t in done.values())
        g = eng.phase_gauges()
        print(f"serve {dt} chunk {chunk}: {len(done)} requests, {new} new "
              f"tokens in {wall:.3f} s ({new / wall:.1f} tok/s), decode tick "
              f"p50 {g['serve.decode_tick_ms_p50']} ms p99 "
              f"{g['serve.decode_tick_ms_p99']} ms, decode ticks "
              f"{eng.decode_steps}, prefill ticks {eng.prefill_steps}")
        if dt != "fp32":
            continue
        for i, (prompt, _) in enumerate(reqs):
            got, ref = done[i], refs[i]
            if got == ref:
                continue
            at = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
            gap = _near_tie_gap(model, prompt, ref, at)
            print(f"  request {i}: diverges from generate at token {at}, "
                  f"reference top-2 gap {gap:.3e}")
            _check(gap < 1e-3, f"request {i}: engine tokens differ from "
                   "generate away from a near-tie")
    return launches, runs


# ---------------------------------------------------------------------------
# phase 5: train GPT-2 small through the training CLI
# ---------------------------------------------------------------------------

_TRAIN_ARGS = ["--model", "gpt2", "--fp16", "--flash-attention",
               "--dropout0", "--batch-size", "16", "--sequence-len", "1024",
               "--base-lr", "0.01", "--momentum", "0.9", "--threshold", "25",
               "--num-warmup-batches", "5", "--num-batches-per-iter", "5",
               "--num-iters", "3"]
_TRAIN_WARMUP = 5


def _train_counts(ts) -> dict:
    return {"flash_fwd": FA.flash_fwd_launches,
            "flash_bwd_dq": FA.flash_bwd_dq_launches,
            "flash_bwd_dkv": FA.flash_bwd_dkv_launches,
            "fused_update": FS.fused_update_launches,
            "rs": ts.rs_launches, "ag": ts.ag_launches,
            "update": ts.update_launches}


def train_gpt2():
    """20 steps of ``benchmarks/gpt.py`` (the main training path), every
    step's launches checked: K1, K2 and K3 12 times each (one per layer),
    one shard update, reduce-scatter and all-gather per bucket. Returns
    (result, launches, step times in ms of the timed steps)."""
    cfg = GPT2_SMALL
    FA.flash_fwd_launches = FA.flash_bwd_dq_launches = 0  # the main
    FA.flash_bwd_dkv_launches = FS.fused_update_launches = 0  # path starts
    marks, prev = [], {}

    def on_step(ts, state, metrics):
        del state, metrics
        now = _train_counts(ts)
        nb = ts.plan.num_buckets
        before = prev or {k: 0 for k in now} | {"ag": nb}   # init's gathers
        want = {"flash_fwd": cfg.num_hidden_layers,
                "flash_bwd_dq": cfg.num_hidden_layers,
                "flash_bwd_dkv": cfg.num_hidden_layers,
                "fused_update": nb, "rs": nb, "ag": nb, "update": nb}
        got = {k: now[k] - before[k] for k in now}
        _check(got == want, f"train step {len(marks) + 1}: launches {got}, "
               f"expected {want}")
        prev.update(now)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    res = train_cli.main(_TRAIN_ARGS + ["--device", _DEV],
                         on_step=on_step)
    launches = _train_counts(res.train_step)      # ... and ends here
    losses = res.losses
    print(f"train losses: {[round(x, 4) for x in losses]}")
    _check(len(losses) == 20 and all(np.isfinite(losses)),
           f"train: losses {losses}")
    _check(losses[-1] < losses[0], "train: the loss did not fall")
    step_ms = [a.elapsed_time(b) for a, b in
               zip(marks[_TRAIN_WARMUP - 1:-1], marks[_TRAIN_WARMUP:])]
    print(f"main path (train): 20 steps, {res.train_step.plan.num_buckets} "
          f"buckets, launches {launches}")
    return res, launches, step_ms


def _loss_fn(m, b):
    return gpt_lm_loss(m(b["input_ids"], train=True), b["input_ids"],
                       vocab_size=GPT2_SMALL.vocab_size)


def check_flash_step_vs_dense():
    """One fp32 step at full width, 2 layers, batch 2: the flash kernels
    (K1, K2, K3) against the dense attention core. The updated parameters
    agree within 1e-5 and the gradients they imply, (p0 - p1) / lr, within
    1e-3 of the largest gradient."""
    cfg = dataclasses.replace(dropout_free(GPT2_SMALL), num_hidden_layers=2)
    batch = synthetic_gpt_batch(
        torch.Generator(device=_DEV).manual_seed(4), 2, 1024,
        cfg.vocab_size)
    lr = 0.01
    runs = []
    for impl in (flash_causal_attention_impl(), None):
        model = GptLmHeadModel(cfg, attention_impl=impl, device=_DEV, seed=0)
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        ts = build_train_step(_loss_fn, model, device=_DEV,
                              optimizer=FS.fused_sgd(lr=lr, momentum=0.9))
        state, metrics = ts.step(ts.init(), batch)
        runs.append((float(metrics["loss"]), ts.gather_params(state), p0))
    (lf, pf, p0), (ld, pd, _) = runs
    p_err = max(float((pf[n] - pd[n]).abs().max()) for n in pf)
    g_max = max(float((p0[n] - pd[n]).abs().max()) / lr for n in pd)
    g_err = max(float((pf[n] - pd[n]).abs().max()) / lr for n in pf)
    print(f"fp32 step, flash vs dense (2 layers, B=2, S=1024): loss "
          f"{lf:.6f} vs {ld:.6f}, max |param diff| {p_err:.3e}, implied "
          f"gradients {g_err:.3e} of max {g_max:.3e}")
    _check(abs(lf - ld) <= 1e-5 * abs(ld), "flash vs dense: losses differ")
    _check(p_err <= 1e-5 and g_err <= 1e-3 * g_max,
           "flash vs dense: the updated parameters differ")


def train_with_dropout():
    """3 steps through the CLI with its default dropout (the kernel rule
    zeroes the attention-probs dropout; embedding and hidden dropout draw
    from the step's generator), 2 layers, batch 4."""
    res = train_cli.main(["--fp16", "--flash-attention",
                          "--num-hidden-layers", "2", "--batch-size", "4",
                          "--sequence-len", "1024", "--num-warmup-batches",
                          "0", "--num-batches-per-iter", "3",
                          "--num-iters", "1", "--device", _DEV])
    print(f"train with dropout (2 layers, B=4): losses "
          f"{[round(x, 4) for x in res.losses]}")
    _check(len(res.losses) == 3 and all(np.isfinite(res.losses)),
           "train with dropout: a loss is not finite")


# ---------------------------------------------------------------------------
# phase 5b: two ranks on one card, mode dear-fused against dear
# ---------------------------------------------------------------------------

#: per-rank batch 8: 16 sequences of 1024 per step over the two ranks
_TWO_RANK_ARGS = ["--model", "gpt2", "--fp16", "--flash-attention",
                  "--dropout0", "--batch-size", "8", "--sequence-len",
                  "1024", "--base-lr", "0.01", "--momentum", "0.9",
                  "--threshold", "25", "--num-warmup-batches", "5",
                  "--num-batches-per-iter", "5", "--num-iters", "3"]
#: the step-20 loss of dear-fused against dear (relative): JAX's "fp32
#: ~1e-5 rel" (docs/KERNELS.md:119-124) widened for bf16 — the dear run
#: rounds each reduced gradient to bf16 (2^-9 relative), the ring keeps
#: the sum in fp32, and bf16 compute carries that into the loss
_FUSED_VS_DEAR_RTOL = 1e-3


#: the two-rank runs: name -> the training CLI's mode flags
_TWO_RANK_MODES = {
    "dear-fused": ["--mode", "dear-fused"],
    "dear": ["--mode", "dear"],
    "ring-projections": ["--mode", "dear-fused", "--ring-projections"],
}
#: the step-20 loss with ring projections against dear-fused without
#: (relative): slice 3's limit, kept — K6-K8 sum bf16 products in fp32 in
#: another order than cuBLAS, which bf16 compute carries into the loss
_RP_VS_FUSED_RTOL = 1e-3


def _two_rank_counts(ts) -> dict:
    return {"flash_fwd": FA.flash_fwd_launches,
            "flash_bwd_dq": FA.flash_bwd_dq_launches,
            "flash_bwd_dkv": FA.flash_bwd_dkv_launches,
            "fused_update": FS.fused_update_launches,
            "ring_ag": CM.ring_ag_launches, "ring_rs": CM.ring_rs_launches,
            "cm_fwd": CM.cm_fwd_launches, "cm_dx": CM.cm_dx_launches,
            "cm_dw": CM.cm_dw_launches,
            "rs": ts.rs_launches, "ag": ts.ag_launches,
            "update": ts.update_launches}


def check_ring_matmul_two_ranks(rank: int) -> dict:
    """K6, K7 and K8 on the main path's own transport — the two processes'
    IPC `Ring` — against the stacked plain versions at the main path's
    shapes (`_CM_MAIN`, bf16), two calls each: both ranks draw both ranks'
    operands from one seed, each feeds its own row to the kernels and
    holds its outputs to `_CM_RTOL` of the plain versions' row. Returns
    the largest absolute error of each."""
    world = 2
    group = backend.init(_DEV)
    dev = backend.device()
    ring = Ring(group, dev, 1, cm_elems=max(kc * n for _, kc, n in _CM_MAIN))
    gen = torch.Generator(device=dev).manual_seed(14)
    worst: dict = {}
    for m, kc, n in _CM_MAIN:
        for call in range(2):
            ops = _cm_operands(world, m, kc, n, torch.bfloat16, gen, dev)
            _cm_hold(f"rank {rank} IPC ring M={m} K={world * kc} N={n} "
                     f"call {call}", _cm_pairs(*ops, ring, rank=rank), worst)
    ring.close()
    print(f"rank {rank}: IPC ring matmul check at the main path's shapes: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def check_ring_two_ranks(rank: int) -> tuple:
    """K4 and K5 ring on the main path's own transport — the two
    processes' IPC `Ring`, two contexts time-slicing the card, sys-scope
    flags — against the stacked plain versions, bitwise, at every shard
    size of the training run's plan: one K4 call in fp32 and one in bf16,
    and two K5 ring calls (bf16 gradients, the run's SGD momentum: its
    first and second step). Both ranks draw the stacked ``[2, ...]``
    inputs of both ranks from one seed on the card, so each holds its
    peer's input as the gathered one; each feeds its own row to the
    kernel and holds its output against the stacked plain version's row.
    Returns the largest absolute differences (0.0)."""
    world = 2
    group = backend.init(_DEV)
    dev = backend.device()
    sizes = _plan_shard_sizes(world)
    ring = Ring(group, dev, max(sizes))
    gen = torch.Generator(device=dev).manual_seed(11)
    opt = FS.fused_sgd(lr=0.01, momentum=0.9)
    ag = rs = 0.0
    for n in sizes:
        for dt in (torch.float32, torch.bfloat16):
            shards = torch.randn(world, n, generator=gen, device=dev).to(dt)
            got = CM.ring_all_gather(shards[rank].contiguous(), ring)
            ref = CM.ring_all_gather_stacked(shards)[rank]
            torch.cuda.synchronize(dev)
            ulps, diff = _ring_ulps([(got, ref)])
            _check(ulps == 0, f"rank {rank} IPC ring all-gather n={n} {dt}: "
                   f"{ulps} ulp from its plain version")
            ag = max(ag, diff)
        p0 = torch.randn(world, n, generator=gen, device=dev)
        pk, pr = p0[rank].clone(), p0.clone()
        sk = opt.init(pk)
        sr = [opt.init(pr[i]) for i in range(world)]
        for step in range(2):
            g = torch.randn(world, world * n, generator=gen,
                            device=dev).bfloat16()
            CM.fused_reduce_scatter_update(g[rank].contiguous(), pk, sk, opt,
                                           ring, mean_world=world, step=step)
            CM.fused_reduce_scatter_update_stacked(g, pr, sr, opt,
                                                   mean_world=world,
                                                   step=step)
            pairs = [(pk, pr[rank])] + [(sk[k], sr[rank][k]) for k in sk
                                        if torch.is_tensor(sk[k])]
            torch.cuda.synchronize(dev)
            ulps, diff = _ring_ulps(pairs)
            _check(ulps == 0, f"rank {rank} IPC ring reduce-scatter n={n} "
                   f"step {step}: {ulps} ulp from its plain version")
            rs = max(rs, diff)
    ring.close()
    print(f"rank {rank}: IPC ring check: K4 fp32 and bf16, K5 ring bf16 "
          f"(two steps) at the plan's {len(sizes)} shard sizes ({sizes[0]} "
          f"to {sizes[-1]}): 0 ulp from the plain versions")
    return ag, rs


def rank_worker(rank: int, out: Path, mode: str) -> None:
    """One of the two ranks (a process of its own, on card ``rank %
    device_count``): in dear-fused, first `check_ring_two_ranks`, with ring
    projections `check_ring_matmul_two_ranks` (their launches are not the
    main path's); then 20 steps of the training CLI in ``mode`` (a key of
    `_TWO_RANK_MODES`) over a gloo group that meets at a FileStore in
    ``out``, every step's launches checked; in both dear-fused modes, a
    ``torch.profiler`` trace of 3 more steps (both ranks; their ring calls
    pair up); then the gathered parameters' digest, the losses, the
    launches, the step times and the trace into ``out/rank<r>.json``."""
    os.environ.update(
        DEAR_NUM_PROCESSES="2", DEAR_PROCESS_ID=str(rank),
        DEAR_COORDINATOR_ADDRESS=f"file://{out}/store",
        DEAR_LOCAL_RANK=str(rank), DEAR_LOCAL_SIZE="2")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ring_errs = check_ring_two_ranks(rank) if mode == "dear-fused" else None
    rp = mode == "ring-projections"
    cm_errs = check_ring_matmul_two_ranks(rank) if rp else None
    layers = GPT2_SMALL.num_hidden_layers
    FA.flash_fwd_launches = FA.flash_bwd_dq_launches = 0   # the main path
    FA.flash_bwd_dkv_launches = FS.fused_update_launches = 0   # starts
    CM.ring_ag_launches = CM.ring_rs_launches = 0
    CM.cm_fwd_launches = CM.cm_dx_launches = CM.cm_dw_launches = 0
    marks, prev = [], {}
    fused = mode != "dear"
    n_cm = 4 * layers if rp else 0     # query, key, value, mlp_in

    def on_step(ts, state, metrics):
        del state, metrics
        now = _two_rank_counts(ts)
        nb = ts.plan.num_buckets
        before = prev or {k: 0 for k in now} | {
            "ag": nb, "ring_ag": nb if fused else 0}   # init's gathers
        want = {"flash_fwd": layers, "flash_bwd_dq": layers,
                "flash_bwd_dkv": layers, "rs": nb, "ag": nb, "update": nb,
                "fused_update": 0 if fused else nb,
                "ring_ag": nb if fused else 0, "ring_rs": nb if fused else 0,
                "cm_fwd": n_cm, "cm_dx": n_cm, "cm_dw": n_cm}
        got = {k: now[k] - before[k] for k in now}
        _check(got == want, f"rank {rank} {mode} step {len(marks) + 1}: "
               f"launches {got}, expected {want}")
        prev.update(now)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    res = train_cli.main(_TWO_RANK_ARGS + _TWO_RANK_MODES[mode]
                         + ["--device", _DEV], on_step=on_step)
    ts = res.train_step
    launches = _two_rank_counts(ts)               # ... and ends here
    step_ms = [a.elapsed_time(b) for a, b in
               zip(marks[_TRAIN_WARMUP - 1:-1], marks[_TRAIN_WARMUP:])]
    # both ranks trace the same 3 further steps (their ring calls pair up)
    trace = (trace_train_steps(ts, res.state, res.batch,
                               float(np.percentile(step_ms, 50)),
                               label=f"rank {rank} {mode}, 8 x 1024")
             if fused else None)
    params = ts.gather_params(res.state)          # dear-fused: through K4
    digest = hashlib.sha256()
    for name in sorted(params):
        digest.update(params[name].detach().cpu().numpy().tobytes())
    (out / f"rank{rank}.json").write_text(json.dumps({
        "losses": res.losses, "launches": launches, "step_ms": step_ms,
        "tokens_per_s": res.total_mean * 1024, "params": digest.hexdigest(),
        "trace": trace, "ring_errs": ring_errs, "cm_errs": cm_errs,
        "shard_sizes": sorted({b.shard_size for b in ts.plan.buckets}),
        "bucket_shards": [b.shard_size for b in ts.plan.buckets],
        "buckets": ts.plan.num_buckets,
        "device": str(backend.device()), "card_shared": backend.card_shared(),
        "backend": torch.distributed.get_backend()}))
    ts.close()
    backend.shutdown()


def train_two_ranks(mode: str, timeout: float = 600.0) -> list:
    """Spawn the two ranks of ``mode`` (this script with ``--train-rank``),
    wait for both, and return their results; any rank's failure, or the
    deadline, fails the run with both ranks' logs."""
    return spawn_two_ranks(
        mode, lambda r, out: ["--train-rank", str(r), "--out", str(out),
                              "--mode", mode], timeout)


def spawn_two_ranks(name: str, worker_args, timeout: float) -> list:
    """Spawn two ranks of this script (argv ``worker_args(rank, out)``),
    each writing ``out/rank<r>.json``, wait for both, and return their
    results; any rank's failure, or the deadline, fails the run with both
    ranks' logs."""
    out = _ROOT / "build" / "chip_smoke" / f"{name}-{os.getpid()}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    torch.cuda.empty_cache()
    logs = [out / f"rank{r}.log" for r in range(2)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 *worker_args(r, out)],
                stdout=f, stderr=subprocess.STDOUT, cwd=_ROOT))
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode != 0 for p in procs):
        for r, (p, log) in enumerate(zip(procs, logs)):
            print(f"--- rank {r} of {name} (exit {p.returncode}):\n"
                  + "\n".join(log.read_text().splitlines()[-40:]))
        raise RuntimeError(f"chip_smoke: a rank of the two-rank {name} run "
                           f"failed or passed the {timeout:.0f} s deadline")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(2)]


def train_dear_fused() -> tuple:
    """The main paths of slices 3 and 4: GPT-2 small at full width trained
    20 steps with ``--mode dear-fused`` by two ranks sharing card 0 (two
    processes, one ring), again with ``--ring-projections``, then with
    ``--mode dear`` for the loss comparison. Checks: finite and falling
    losses, equal on both ranks; both ranks' gathered parameters bitwise
    equal; every step's launches (in each rank); dear-fused's step-20
    loss within `_FUSED_VS_DEAR_RTOL` of dear's, and with ring projections
    within `_RP_VS_FUSED_RTOL` of dear-fused's. Returns the two ranks'
    results of each run: (dear-fused, ring projections, dear)."""
    t0 = time.perf_counter()
    fused = train_two_ranks("dear-fused")
    t1 = time.perf_counter()
    rp = train_two_ranks("ring-projections")
    t2 = time.perf_counter()
    dear = train_two_ranks("dear")
    t3 = time.perf_counter()
    for mode, ranks in (("dear-fused", fused), ("ring-projections", rp),
                        ("dear", dear)):
        losses = ranks[0]["losses"]
        print(f"two ranks {mode}: losses {[round(x, 4) for x in losses]}; "
              f"{ranks[0]['buckets']} buckets, backend "
              f"{ranks[0]['backend']}, devices "
              f"{[r['device'] for r in ranks]}, card shared "
              f"{ranks[0]['card_shared']}")
        _check(len(losses) == 20 and all(np.isfinite(losses)),
               f"two ranks {mode}: losses {losses}")
        _check(losses[-1] < losses[0], f"two ranks {mode}: no fall")
        _check(ranks[1]["losses"] == losses,
               f"two ranks {mode}: the ranks' losses differ")
        _check(ranks[1]["params"] == ranks[0]["params"],
               f"two ranks {mode}: the ranks' gathered parameters differ")
    _check(fused[0]["shard_sizes"] == _plan_shard_sizes(2),
           "two ranks: the run's plan is not the one the kernels were "
           "checked at")
    lf, ld = fused[0]["losses"][-1], dear[0]["losses"][-1]
    lr = rp[0]["losses"][-1]
    rel = abs(lf - ld) / abs(ld)
    rel_rp = abs(lr - lf) / abs(lf)
    print(f"step-20 loss: dear-fused {lf:.6f}, dear {ld:.6f}, relative "
          f"difference {rel:.3e} (limit {_FUSED_VS_DEAR_RTOL:g}); with ring "
          f"projections {lr:.6f}, {rel_rp:.3e} from dear-fused (limit "
          f"{_RP_VS_FUSED_RTOL:g}); parameters of the two ranks bitwise "
          f"equal in every run; wall {t1 - t0:.1f} s (dear-fused), "
          f"{t2 - t1:.1f} s (ring projections), {t3 - t2:.1f} s (dear)")
    _check(rel <= _FUSED_VS_DEAR_RTOL, "dear-fused and dear losses differ")
    _check(rel_rp <= _RP_VS_FUSED_RTOL,
           "ring projections and dear-fused losses differ")
    return fused, rp, dear


# ---------------------------------------------------------------------------
# phase 5c: the overhead probe
# ---------------------------------------------------------------------------

#: K9 launches of one elementwise section: per granularity one warm-up,
#: `probe.ITERS` host-timed and as many event-timed calls
_PROBE_K9_LAUNCHES = len(probe.GRANULARITIES) * (1 + 2 * probe.ITERS)
#: K4 and K5 ring launches of one kernel section, each: per shard size one
#: warm-up and `probe.RING_ITERS` host-timed calls, and as many event-timed
#: ones on a `LocalRing`
_PROBE_RING_LAUNCHES = len(probe.SHARDS) * (1 + probe.RING_ITERS)
_PROBE_LOCAL_RING_LAUNCHES = len(probe.SHARDS) * (1 + 2 * probe.RING_ITERS)


def _probe_counts() -> dict:
    return {"overhead_probe": OP.affine_probe_launches,
            "ring_ag": CM.ring_ag_launches, "ring_rs": CM.ring_rs_launches}


def _zero_probe_counts() -> None:
    OP.affine_probe_launches = CM.ring_ag_launches = CM.ring_rs_launches = 0


def run_probe() -> tuple:
    """The probe's main path in this process, as a user runs it on the
    card (`scripts.overhead_probe.main`, both sections, the kernel section
    on a two-rank `LocalRing`): every count set to 0 just before, read just
    after, and checked (K9 `_PROBE_K9_LAUNCHES` times, K4 and the K5 ring
    `_PROBE_LOCAL_RING_LAUNCHES` each). Returns (its rows, the
    launches)."""
    _zero_probe_counts()
    res = probe.main(["--section", "all", "--world", "2"])
    launches = _probe_counts()
    want = {"overhead_probe": _PROBE_K9_LAUNCHES,
            "ring_ag": _PROBE_LOCAL_RING_LAUNCHES,
            "ring_rs": _PROBE_LOCAL_RING_LAUNCHES}
    _check(launches == want, f"overhead probe: launches {launches}, "
           f"expected {want}")
    _check(len(res["elementwise"]) == len(probe.GRANULARITIES)
           and all(r["transport"] == "LocalRing" for r in res["kernels"])
           and len(res["kernels"]) == 2 * len(probe.SHARDS),
           f"overhead probe: rows {res}")
    return res, launches


def probe_rank_worker(rank: int, out: Path) -> None:
    """One of the two ranks of the probe's kernel section (a process of
    its own on card ``rank % device_count``): the entry point started
    through the launcher variables, the IPC `Ring` over a gloo group that
    meets at a FileStore in ``out``; its rows and launches (counted from
    0) into ``out/rank<r>.json``."""
    os.environ.update(
        DEAR_NUM_PROCESSES="2", DEAR_PROCESS_ID=str(rank),
        DEAR_COORDINATOR_ADDRESS=f"file://{out}/store",
        DEAR_LOCAL_RANK=str(rank), DEAR_LOCAL_SIZE="2")
    _zero_probe_counts()
    res = probe.main(["--section", "kernels"])
    (out / f"rank{rank}.json").write_text(json.dumps({
        "rows": res["kernels"], "launches": _probe_counts()}))


def probe_two_ranks(local_rows: list) -> tuple:
    """The probe's kernel section again as two processes sharing the card
    (`probe_rank_worker`): each rank's launches checked; prints each
    kernel's time per call on the IPC ring beside the `LocalRing`'s
    (``local_rows``) and their difference, the cost of pairing a ring call
    across two contexts. Returns the launches over both ranks."""
    ranks = spawn_two_ranks(
        "probe", lambda r, out: ["--probe-rank", str(r), "--out", str(out)],
        300.0)
    want = {"overhead_probe": 0, "ring_ag": _PROBE_RING_LAUNCHES,
            "ring_rs": _PROBE_RING_LAUNCHES}
    local = {(r["kernel"], r["shard"]): r for r in local_rows}
    for r, rank in enumerate(ranks):
        _check(rank["launches"] == want, f"probe rank {r}: launches "
               f"{rank['launches']}, expected {want}")
        _check(sorted((x["kernel"], x["shard"]) for x in rank["rows"])
               == sorted(local) and all(
                   x["transport"] == "Ring" and x["world"] == 2
                   and x["device"].startswith("cuda") for x in rank["rows"]),
               f"probe rank {r}: rows {rank['rows']}")
    for key, lr in local.items():
        ipc = [next(x for x in rank["rows"]
                    if (x["kernel"], x["shard"]) == key) for rank in ranks]
        mean = sum(x["ms"] for x in ipc) / len(ipc)
        print(f"probe {key[0]} shard={key[1]}: LocalRing {lr['ms']:.5f} "
              f"ms/call ({lr['us_per_hop']:.2f} us/hop; device "
              f"{lr['device_ms']:.5f} ms); IPC Ring, two "
              f"processes sharing the card: {ipc[0]['ms']:.5f} (rank 0), "
              f"{ipc[1]['ms']:.5f} (rank 1) ms/call; pairing across two "
              f"contexts: {mean - lr['ms']:.5f} ms per call")
    return {k: sum(rank["launches"][k] for rank in ranks) for k in want}


def time_overhead_probe(hbm) -> dict:
    """K9 at the probe's granularities, inputs cycled over two sets (128
    MiB, past the 50 MB L2), beside its plain version, one PyTorch call
    computing the same function (``torch.add(one, x, alpha=2.0)``, a
    yardstick the port never calls) and the bytes bound: each call reads x
    and writes o once, 8 bytes per element. Returns the rows by
    (nblocks, rows_per_block)."""
    gen = torch.Generator(device=_DEV).manual_seed(16)
    one = torch.ones((), device=_DEV)
    rows = {}
    for nblocks, rpb in probe.GRANULARITIES:
        sets = [(torch.randn(nblocks * rpb, OP.WIDTH, generator=gen,
                             device=_DEV),
                 torch.empty(nblocks * rpb, OP.WIDTH, device=_DEV))
                for _ in range(2)]
        nbytes = 2 * sets[0][0].numel() * 4
        row = {"shape": f"grid {nblocks} x ({rpb}, 512) fp32",
               "ms": device_ms(lambda x, o: OP.affine_probe(x, rpb, out=o),
                               sets, 20),
               "plain_ms": device_ms(lambda x, o: OP.affine_probe_plain(x),
                                     sets, 20),
               "library_ms": device_ms(
                   lambda x, o: torch.add(one, x, alpha=2.0, out=o), sets,
                   20),
               "library_note": "torch.add(one, x, alpha=2.0): one PyTorch "
                               "call",
               "bound_ms": nbytes / hbm * 1e3, "bound_by": "bytes",
               "bytes": nbytes}
        print("kernel time " + json.dumps({"kernel": "overhead_probe"}
                                          | row))
        rows[nblocks, rpb] = row
    return rows


def train_flops_per_step(cfg, B, S) -> float:
    """6 x (matmul parameters) x tokens, plus causal attention: QK^T and
    PV over the S(S+1)/2 causal pairs, forward and backward (x3)."""
    h, L, V = cfg.hidden_size, cfg.num_hidden_layers, cfg.padded_vocab_size
    n_matmul = L * (4 * h * h + 2 * h * cfg.intermediate_size) + V * h
    attn = 3 * 4 * h * L * B * S * (S + 1) // 2
    return 6 * n_matmul * B * S + attn


def trace_train_steps(ts, state, batch, step_p50_ms, n=2,
                      label="bf16, B=16, S=1024"):
    """``torch.profiler`` over ``n`` training steps: device ops per step,
    device busy time, idle share (of the profiled wall, an upper bound, and
    of the unprofiled step p50), the top device ops by time, and the spans
    of the ring kernels (K4, K5 ring), waits included."""
    from torch.profiler import ProfilerActivity, profile

    state, _ = ts.step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = ts.step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    if not kernels or busy <= 0:
        print("train step trace: no device time in the profile "
              "(not measured)")
        return None
    by_name: dict = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    ring = sum(ms for name, (ms, _) in by_name.items()
               if "::ring_" in name) / n
    cm = sum(ms for name, (ms, _) in by_name.items()
             if "::cm_" in name) / n
    print(f"train step trace ({label}, {n} steps): "
          f"{len(kernels) / n:.1f} device ops/step, device busy "
          f"{busy:.3f} ms/step, wall {wall / n * 1e3:.3f} ms/step under the "
          f"profiler (idle {1 - busy / (wall / n * 1e3):.1%}), idle "
          f"{1 - busy / step_p50_ms:.1%} of the unprofiled step p50 "
          f"{step_p50_ms:.3f} ms; ring kernels resident {ring:.3f} ms/step, "
          f"ring matmul kernels {cm:.3f} ms/step (their spans, waits "
          "included)")
    for name, (ms, count) in top:
        print(f"  top op {ms / n:9.3f} ms/step {count // n:5d}x/step "
              f"{name[:110]}")
    return {"ops_per_step": len(kernels) / n, "busy_ms": busy,
            "wall_ms": wall / n * 1e3, "ring_ms": ring, "cm_ms": cm,
            "top": [(name, ms / n) for name, (ms, _) in top]}


# ---------------------------------------------------------------------------
# phase 6: timings
# ---------------------------------------------------------------------------


def trace_decode_ticks(model, warm=8, n=16):
    """Where a steady bf16 decode tick's time goes: ``torch.profiler`` over
    ``n`` ticks of 4 decoding slots — kernel launches per tick, device busy
    time per tick, K1's share, and the device's idle share of the traced
    wall time (the profiler's own host cost inflates the wall, so the idle
    share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    eng = DecodeEngine(model, slots=_SLOTS, device=_DEV)
    rs = np.random.RandomState(1)
    for i in range(_SLOTS):
        eng.submit(list(rs.randint(0, GPT2_SMALL.vocab_size, 4)),
                   warm + n + 8, request_id=i)
    for _ in range(warm):
        eng.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()   # kernels, copies and memsets
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    flash = sum(e.time_range.elapsed_us() for e in kernels
                if "flash_fwd_kernel" in e.name) / 1e6
    if not kernels or busy <= 0:
        print("decode tick trace: no device time in the profile "
              "(not measured)")
        return
    print(f"decode tick trace (bf16, {_SLOTS} slots decoding, {n} ticks): "
          f"{len(kernels) / n:.1f} device ops/tick, wall "
          f"{wall / n * 1e3:.3f} ms/tick under the profiler, device busy "
          f"{busy / n * 1e3:.3f} ms/tick, flash_fwd "
          f"{flash / n * 1e3:.3f} ms/tick ({flash / busy:.1%} of busy), "
          f"device idle {1 - busy / wall:.1%} of wall")


def device_ms(fn, sets, reps):
    """Mean device time of ``fn(*s)`` over ``reps`` calls that cycle
    through input ``sets`` (more bytes than the 50 MB L2, so each call
    finds its inputs cold, as a decode tick does across 12 layers). CUDA
    events bracket the calls behind a sleep kernel long enough for the host
    to enqueue them all, so host overhead does not leak into the time."""
    for s in sets[:2]:
        fn(*s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(host_s * 2e9 * 2) + 1_000_000)
    start.record()
    for i in range(reps):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_shape(name, B, Sq, Sk, dtype, causal, n_sets, hbm):
    """K1 at one shape: first held against its plain version on the first
    input set (the tolerance of `check_kernel`), then timed beside its
    plain version, SDPA and the card's bound."""
    gen = torch.Generator(device=_DEV).manual_seed(1)
    sets = [_case(gen, B, Sq, Sk, dtype, causal) for _ in range(n_sets)]
    q, k, v, m = sets[0]
    o = FA.flash_attention(q, k, v, causal=causal, kv_mask=m)
    ref, _ = FA.flash_attention_reference(q, k, v, causal=causal, kv_mask=m,
                                          out_dtype=torch.float32)
    torch.cuda.synchronize()
    err = float((o.float() - ref.to(dtype).float()).abs().max())
    _check(bool(torch.isfinite(o.float()).all())
           and err <= {torch.float32: 2e-5, torch.bfloat16: 2e-2}[dtype],
           f"{name} {dtype}: kernel disagrees with its plain version "
           f"(max |o - plain| {err:.3e})")
    del o, ref

    def kernel(q, k, v, m):
        FA.flash_attention(q, k, v, causal=causal, kv_mask=m)

    def plain(q, k, v, m):
        FA.flash_attention_reference(q, k, v, causal=causal, kv_mask=m)

    def library(q, k, v, m):
        F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=None if causal else m.bool()[:, None, None, :],
            is_causal=causal)

    ms = device_ms(kernel, sets, 50)
    plain_ms = device_ms(plain, sets, 20)
    library_ms = device_ms(library, sets, 50)
    esize = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * Sq * _H * _D + 2 * B * Sk * _H * _D) * esize \
        + B * Sk * 4 + B * _H * Sq * 4          # q, o, k, v, mask, lse
    pairs = B * _H * (Sq * (Sq + 1) // 2 if causal else Sq * Sk)
    flops = 4 * _D * pairs                       # QK^T and PV per pair
    bytes_ms = nbytes / hbm * 1e3
    ops_ms = flops / _PEAK_FLOPS[dtype] * 1e3
    row = {"shape": name, "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "flops": flops}
    print("kernel time " + json.dumps(row))
    return row


def time_bwd(B, S, hbm, launches_per_step):
    """K2 and K3 at the training shape ([B, S, 12, 64], causal, bf16,
    through the [B, S, H, D] dispatch the autograd Function uses): first
    held against their plain versions on the first input set (the largest
    error over the largest |plain value|, at most 2e-2 as in
    `check_bwd_kernels`), then timed beside their plain versions and the
    backward of SDPA (is_causal; dq, dk and dv in one call), the yardstick
    for K2 + K3 together. Returns (rows, the largest absolute error of dQ
    and of dK/dV)."""
    gen = torch.Generator(device=_DEV).manual_seed(5)
    dt = torch.bfloat16
    scale = _D ** -0.5
    sets = [_bwd_operands(gen, B, S, dt, True) for _ in range(2)]
    q, k, v, do, mask, lse, delta = sets[0]
    args = (q, k, v, mask, do, lse, delta, scale, True)
    got = {"dq": FA._dispatch_dq(*args)}
    got["dk"], got["dv"] = FA._dispatch_dkv(*args)
    ref = {"dq": FA._dq_reference(*args)}
    ref["dk"], ref["dv"] = FA._dkv_reference(*args)
    torch.cuda.synchronize()
    errs = {n: _rel(got[n], ref[n]) for n in got}
    print(f"backward kernel check main path causal B={B} S={S} bf16: "
          + ", ".join(f"max|{n}-plain| {a:.3e} (rel {r:.3e})"
                      for n, (a, r) in errs.items()))
    for n, out in got.items():
        _check(bool(torch.isfinite(out.float()).all()) and errs[n][1] <= 2e-2,
               f"main path B={B}: {n} disagrees with its plain version")
    main_err = (errs["dq"][0], max(errs["dk"][0], errs["dv"][0]))
    del got, ref

    def dq(q, k, v, do, mask, lse, delta):
        FA._dispatch_dq(q, k, v, mask, do, lse, delta, scale, True)

    def dkv(q, k, v, do, mask, lse, delta):
        FA._dispatch_dkv(q, k, v, mask, do, lse, delta, scale, True)

    def dq_plain(q, k, v, do, mask, lse, delta):
        FA._dq_reference(q, k, v, mask, do, lse, delta, scale, True)

    def dkv_plain(q, k, v, do, mask, lse, delta):
        FA._dkv_reference(q, k, v, mask, do, lse, delta, scale, True)

    sdpa = []
    for q, k, v, do, *_ in sets:
        xs = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*xs, is_causal=True)
        sdpa.append((out, xs, do.transpose(1, 2)))

    def library(out, xs, do):
        torch.autograd.grad(out, xs, do, retain_graph=True)

    rows = {}
    esize = 2
    pairs = B * _H * S * (S + 1) // 2
    elems = B * S * _H * _D
    for name, fn, plain, flops_per_pair, n_out in (
            ("flash_bwd_dq", dq, dq_plain, 6 * _D, 1),
            ("flash_bwd_dkv", dkv, dkv_plain, 8 * _D, 2)):
        ms = device_ms(fn, sets, 20)
        plain_ms = device_ms(plain, sets, 4)
        # q, k, v, dO read, the outputs written; lse, delta and the mask
        nbytes = (4 + n_out) * elems * esize + 2 * B * _H * S * 4 + B * S * 4
        flops = flops_per_pair * pairs
        bytes_ms, ops_ms = nbytes / hbm * 1e3, flops / _PEAK_FLOPS[dt] * 1e3
        rows[name] = {"shape": f"train causal B={B} S={S} H={_H} D={_D}",
                      "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": ("bytes" if bytes_ms >= ops_ms
                                   else "operations"),
                      "bytes": nbytes, "flops": flops,
                      "launches_per_step": launches_per_step}
    # one SDPA backward computes dq, dk and dv: the yardstick of K2 + K3
    # together, so both rows carry it with that scope
    sdpa_ms = device_ms(library, sdpa, 20)
    for row in rows.values():
        row.update(library_ms=sdpa_ms, library_scope="dq+dk+dv")
        print("kernel time " + json.dumps(row))
    both = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    print(f"backward yardstick: SDPA backward (is_causal, dq+dk+dv) "
          f"{sdpa_ms:.4f} ms vs K2 + K3 {both:.4f} ms "
          f"({both / sdpa_ms:.1f}x) at B={B} S={S} bf16")
    return rows, main_err


def time_update(n, hbm, launches_per_step):
    """The shard update on one bucket of the main path (``n`` elements, bf16
    gradient, SGD momentum 0.9 past its first step), its plain version, and
    ``torch.optim.SGD(fused=True)`` over the same elements (an fp32
    gradient: the fused SGD needs the parameter's dtype) as the yardstick."""
    gen = torch.Generator(device=_DEV).manual_seed(6)
    opt = FS.fused_sgd(lr=0.01, momentum=0.9)
    sets = []
    for _ in range(2):
        p = torch.randn(n, generator=gen, device=_DEV)
        st = opt.init(p)
        st["buf"].normal_(generator=gen)
        st["initialized"] = True
        sets.append((torch.randn(n, generator=gen, device=_DEV).bfloat16(),
                     st, p))
    scal = opt.scalars(sets[0][1], 1, 0)

    def kernel(g, st, p):
        opt.update(g, st, p)

    def plain(g, st, p):
        FS.fused_update_reference(opt, g, st, p, scal)

    lib = []
    for g, _, p in sets:
        w = torch.nn.Parameter(p.clone())
        w.grad = g.float()
        sgd = torch.optim.SGD([w], lr=0.01, momentum=0.9, fused=True)
        sgd.step()                         # seed the momentum buffer
        lib.append((sgd,))

    ms = device_ms(kernel, sets, 50)
    plain_ms = device_ms(plain, sets, 20)
    library_ms = device_ms(lambda sgd: sgd.step(), lib, 50)
    nbytes = n * (2 + 4 * 4)               # grad; param and buf in and out
    row = {"shape": f"bucket shard n={n}", "dtype": "bf16 grad, fp32 state",
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": nbytes / hbm * 1e3, "bound_by": "bytes",
           "bytes": nbytes, "flops": 6 * n,
           "launches_per_step": launches_per_step}
    print("kernel time " + json.dumps(row))
    return row


def time_ring(bucket_shards, hbm):
    """K4 and K5 ring on a `LocalRing` of two ranks (one launch drives
    both, as the two processes' launches share the card) at each shard
    size of the main path's plan: the gather in fp32 (dear-fused gathers
    the master shards in fp32, as the JAX CLI), the reduce-scatter of a
    bf16 gradient with SGD momentum 0.9 past its first step; beside their
    stacked plain versions and the bytes bound. Bytes per rank: K4 reads
    its shard and writes the W chunks of the output, (1 + W)·n·4; K5 ring
    reads its W·n bf16 gradient and reads and writes the parameter and the
    momentum, W·n·2 + 16·n; both ranks' bytes over the card's memory rate
    (they share it). NCCL refuses two ranks on one device, so K4's library
    time is the one-card replicate of the stacked shards (one copy into
    the same output, checked equal to K4's); K5 ring has no one library
    call on one card. Returns the rows of each kernel by shard size."""
    world = 2
    sizes = sorted(set(bucket_shards))
    gen = torch.Generator(device=_DEV).manual_seed(9)
    ring = LocalRing(world, _DEV, max(sizes))
    opt = FS.fused_sgd(lr=0.01, momentum=0.9)
    note = ("none on one card: NCCL refuses two ranks on one device"
            if torch.cuda.device_count() < 2 else "not measured")
    rows = {"ring_all_gather": {}, "ring_rs_update": {}}
    for n in sizes:
        ag_sets, rs_sets = [], []
        for _ in range(2):
            x = torch.randn(world, n, generator=gen, device=_DEV)
            ag_sets.append((x, torch.empty(world, world * n, device=_DEV)))
            p = torch.randn(world, n, generator=gen, device=_DEV)
            st = [opt.init(p[i]) for i in range(world)]
            for one in st:
                one["buf"].normal_(generator=gen)
                one["initialized"] = True
            g = torch.randn(world, world * n, generator=gen,
                            device=_DEV).bfloat16()
            rs_sets.append((g, p, st))

        def ag(x, o):
            CM.ring_all_gather(x, ring, out=o)

        def ag_plain(x, o):
            CM.ring_all_gather_stacked(x)

        def ag_library(x, o):
            o.copy_(x.reshape(1, -1).expand(world, -1))

        x, o = ag_sets[0]
        ag(x, o)
        want = o.clone()
        ag_library(x, o)
        _check(torch.equal(o, want), f"the one-card replicate at n={n} is "
               "not K4's all-gather")

        def rs(g, p, st):
            CM.fused_reduce_scatter_update(g, p, st, opt, ring,
                                           mean_world=world)

        def rs_plain(g, p, st):
            CM.fused_reduce_scatter_update_stacked(g, p, st, opt,
                                                   mean_world=world)

        for name, fn, plain, library, sets, nbytes in (
                ("ring_all_gather", ag, ag_plain, ag_library, ag_sets,
                 world * (1 + world) * n * 4),
                ("ring_rs_update", rs, rs_plain, None, rs_sets,
                 world * (world * n * 2 + 16 * n))):
            ms = device_ms(fn, sets, 20)
            plain_ms = device_ms(plain, sets, 5)
            row = {"shape": f"W=2 LocalRing shard n={n}",
                   "dtype": ("fp32" if name == "ring_all_gather"
                             else "bf16 grad, fp32 state"),
                   "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                   "library_note": note, "bound_ms": nbytes / hbm * 1e3,
                   "bound_by": "bytes", "bytes": nbytes,
                   "launches_per_step": len(bucket_shards)}
            if library is not None:
                row.update(library_ms=device_ms(library, sets, 20),
                           library_scope="one-card replicate",
                           library_note="NCCL refuses two ranks on one "
                           "device: one copy replicating the stacked "
                           "shards stands in")
            print("kernel time " + json.dumps({"kernel": name} | row))
            rows[name][n] = row
    ring.close()
    for name, by_n in rows.items():
        keys = ("ms", "plain_ms", "bound_ms", "library_ms")
        per_step = {k: sum(by_n[n][k] for n in bucket_shards)
                    for k in keys if by_n[sizes[0]][k] is not None}
        library = (f", library {per_step['library_ms']:.4f} ms"
                   if "library_ms" in per_step else "")
        print(f"{name}: per step at W=2 (one launch per bucket, "
              f"{len(bucket_shards)} buckets), both ranks: kernel "
              f"{per_step['ms']:.4f} ms, plain {per_step['plain_ms']:.4f} "
              f"ms, bound {per_step['bound_ms']:.4f} ms{library}")
    return rows


def time_ring_matmul(hbm, calls_per_step):
    """K6, K7 and K8 on a two-rank `LocalRing` (one cooperative launch
    drives both ranks, as the two processes' launches share the card) at
    the main path's shapes (`_CM_MAIN`, bf16), each held to its plain
    version first; beside the stacked plain versions, the bound and one
    cuBLAS call computing the same function for both ranks (a yardstick
    the port never calls): K6 ``x @ w`` (x stacked [2, M, K], w the full
    [K, N]), K7 ``dy @ wᵀ``, K8 ``x_catᵀ @ dy_cat`` (the ranks' rows
    concatenated: every rank's dw shard at once). Per call, both ranks:
    operations 2 x 2·M·K·N, bytes 2 x (M·K + kc·N + M·N) x 2 (each input
    read once, each output written once). Per step: ``calls_per_step[N]``
    calls at each N. Returns the rows of each kernel by N."""
    world = 2
    gen = torch.Generator(device=_DEV).manual_seed(13)
    ring = LocalRing(world, _DEV, 1,
                     cm_elems=max(kc * n for _, kc, n in _CM_MAIN))
    rows = {"cm_fwd": {}, "cm_dx": {}, "cm_dw": {}}
    for m, kc, n in _CM_MAIN:
        k = world * kc
        sets = [_cm_operands(world, m, kc, n, torch.bfloat16, gen)
                for _ in range(2)]
        worst: dict = {}
        _cm_hold(f"timed W=2 M={m} K={k} N={n}", _cm_pairs(*sets[0], ring),
                 worst)
        fns = {
            "cm_fwd": (lambda x, ws, dy: CM.ring_matmul(x, ws, ring),
                       lambda x, ws, dy: CM.ring_matmul_stacked(x, ws),
                       lambda x, ws, dy: torch.matmul(x, ws.reshape(k, n))),
            "cm_dx": (lambda x, ws, dy: CM.ring_matmul_dx(dy, ws, ring),
                      lambda x, ws, dy: CM.ring_matmul_dx_stacked(dy, ws),
                      lambda x, ws, dy: torch.matmul(
                          dy, ws.reshape(k, n).T)),
            "cm_dw": (lambda x, ws, dy: CM.ring_matmul_dw(x, dy, ring),
                      lambda x, ws, dy: CM.ring_matmul_dw_stacked(x, dy),
                      lambda x, ws, dy: x.reshape(-1, k).T
                      @ dy.reshape(-1, n)),
        }
        flops = world * 2 * m * k * n
        nbytes = world * (m * k + kc * n + m * n) * 2
        bound = max(nbytes / hbm, flops / _PEAK_FLOPS[torch.bfloat16]) * 1e3
        for name, (kernel, plain, library) in fns.items():
            got = kernel(*sets[0]).reshape(-1)
            lib = library(*sets[0]).reshape(-1)
            _check(float((got.float() - lib.float()).abs().max())
                   <= 2 * _CM_RTOL[torch.bfloat16]
                   * float(lib.float().abs().max()),
                   f"{name}'s cuBLAS yardstick computes another function")
            ms = device_ms(kernel, sets, 20)
            row = {"shape": f"W=2 LocalRing M={m} K={k} N={n}",
                   "dtype": "bf16", "ms": ms,
                   "plain_ms": device_ms(plain, sets, 5),
                   "library_ms": device_ms(library, sets, 20),
                   "library_scope": "one cuBLAS call for both ranks",
                   "bound_ms": bound,
                   "bound_by": ("operations" if flops
                                / _PEAK_FLOPS[torch.bfloat16]
                                >= nbytes / hbm else "bytes"),
                   "flops": flops, "bytes": nbytes,
                   "tflops": flops / ms / 1e9,
                   "launches_per_step": calls_per_step[n]}
            print("kernel time " + json.dumps({"kernel": name} | row))
            rows[name][n] = row
    ring.close()
    for name, by_n in rows.items():
        per_step = {key: sum(by_n[n][key] * calls_per_step[n] for n in by_n)
                    for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        print(f"{name}: per step at W=2 ({sum(calls_per_step.values())} "
              "calls, both ranks): kernel "
              f"{per_step['ms']:.4f} ms, plain {per_step['plain_ms']:.4f} "
              f"ms, bound {per_step['bound_ms']:.4f} ms, cuBLAS "
              f"{per_step['library_ms']:.4f} ms")
    return rows


def _kernel_entry(name, source, replaces, launches, err, row):
    entry = {"name": name, "route": "cuda",
             "source": f"dear_pytorch_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": row["library_ms"]}
    if "library_scope" in row:   # one library call for several kernels
        entry["library_scope"] = row["library_scope"]
    if "library_note" in row:    # what the library time is, or why none
        entry["library_note"] = row["library_note"]
    return entry


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kernels_only = argv == ["--kernels-only"]
    worker = len(argv) == 6 and argv[0::2] == ["--train-rank", "--out",
                                               "--mode"]
    probe_worker = len(argv) == 4 and argv[0::2] == ["--probe-rank",
                                                     "--out"]
    if argv and not (kernels_only or worker or probe_worker):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip check needs the "
              "card", file=sys.stderr)
        return 1
    if worker:                   # one rank of phase 5b, spawned below
        rank_worker(int(argv[1]), Path(argv[3]), argv[5])
        return 0
    if probe_worker:             # one rank of phase 5c, spawned below
        probe_rank_worker(int(argv[1]), Path(argv[3]))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _build.build(["flash_fwd", "flash_bwd", "fused_update", "ring",
                         "ring_matmul", "overhead_probe"])
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'cached'}) into {_build.BUILD_DIR}")
    for log in logs.values():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas " + line.strip())

    t0 = time.perf_counter()
    max_err = check_kernel()
    dq_err, dkv_err = check_bwd_kernels()
    upd_err = check_update_kernel()
    ag_err, rs_err = check_ring_kernels()
    cm_err = check_ring_matmul_kernels()
    k9_err = check_overhead_probe_kernel()
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    if kernels_only:
        return 0

    launches, runs = check_serving()
    t0 = time.perf_counter()
    res, train_launches, step_ms = train_gpt2()
    print(f"train phase: {time.perf_counter() - t0:.1f} s")
    upd_err = max(upd_err, check_update_main_path(res.train_step))
    check_flash_step_vs_dense()
    train_with_dropout()
    t0 = time.perf_counter()
    fused, rp, _ = train_dear_fused()
    for rank in fused:      # the IPC ring's own checks, in each rank
        ag_err = max(ag_err, rank["ring_errs"][0])
        rs_err = max(rs_err, rank["ring_errs"][1])
    for rank in rp:
        for k, v in rank["cm_errs"].items():
            cm_err[k] = max(cm_err[k], v)
    print("IPC ring check, both ranks: K4 fp32 and bf16, K5 ring bf16 (two "
          "steps) at the plan's shard sizes: 0 ulp from the plain versions")
    print(f"two-rank phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    probe_res, probe_launches = run_probe()
    probe_ipc_launches = probe_two_ranks(probe_res["kernels"])
    print(f"overhead probe phase: {time.perf_counter() - t0:.1f} s; "
          f"launches in this process {probe_launches}, over both IPC "
          f"ranks {probe_ipc_launches}")
    trace_decode_ticks(runs[-1][3].model)

    B, S = 16, 1024
    p50, p99 = (float(np.percentile(step_ms, q)) for q in (50, 99))
    tok_s = res.total_mean * S
    flops = train_flops_per_step(GPT2_SMALL, B, S)
    print(f"train step (GPT-2 small, bf16, B={B}, S={S}, "
          f"{res.train_step.plan.num_buckets} buckets, {len(step_ms)} timed "
          f"steps): p50 {p50:.3f} ms p99 {p99:.3f} ms; {tok_s:.1f} tokens/s "
          f"(the CLI's timed mean); {flops / 1e12:.3f} TFLOP per step "
          f"(6 x matmul params x tokens + causal attention) -> MFU "
          f"{tok_s / (B * S) * flops / _PEAK_FLOPS[torch.bfloat16]:.2%} of "
          f"{_PEAK_FLOPS[torch.bfloat16] / 1e12:.0f} TF/s bf16")
    trace_train_steps(res.train_step, res.state, res.batch, p50)
    for label, r, rank in ([("dear-fused", r, x) for r, x in enumerate(fused)]
                           + [("dear-fused --ring-projections", r, x)
                              for r, x in enumerate(rp)]):
        fp50, fp99 = (float(np.percentile(rank["step_ms"], q))
                      for q in (50, 99))
        print(f"two-rank {label} step, rank {r} (GPT-2 small, bf16, 8 "
              f"sequences of {S} per rank, {len(rank['step_ms'])} timed "
              f"steps): p50 {fp50:.3f} ms p99 {fp99:.3f} ms; "
              f"{rank['tokens_per_s']:.1f} tokens/s over both ranks (the "
              "CLI's timed mean); both ranks share one card, so this is "
              "the card's time for 16 sequences plus the ring's waits, not "
              "a per-card rate")
        tr = rank["trace"]
        if tr is not None:
            print(f"  traced (2 steps, this rank's context): "
                  f"{tr['ops_per_step']:.1f} device ops/step, kernels' "
                  f"spans {tr['busy_ms']:.3f} ms/step of which the ring "
                  f"kernels {tr['ring_ms']:.3f} and the ring matmul "
                  f"kernels {tr['cm_ms']:.3f}, wall {tr['wall_ms']:.3f} "
                  "ms/step under the profiler; top: "
                  + "; ".join(f"{ms:.3f} {name[:48]}"
                              for name, ms in tr["top"][:6]))

    hbm = probe.memory_rate(name)
    print(f"bounds: {hbm / 1e12} TB/s memory ({name}), peak "
          f"{_PEAK_FLOPS[torch.bfloat16] / 1e12} TF/s bf16, "
          f"{_PEAK_FLOPS[torch.float32] / 1e12} TF/s fp32; power limit as "
          f"above: {card}")
    # each K1 shape is held against the plain version before it is timed;
    # decode B=4 and train B=16 are the main paths' own shapes
    fwd_rows = [
        time_shape("decode B=4 Sq=1 Sk=1024 H=12 D=64", _SLOTS, 1, _L,
                   torch.bfloat16, False, 8, hbm),
        time_shape("decode B=4 Sq=1 Sk=1024 H=12 D=64", _SLOTS, 1, _L,
                   torch.float32, False, 4, hbm),
        time_shape("causal prefill B=2 S=1024 H=12 D=64", 2, _L, _L,
                   torch.bfloat16, True, 2, hbm),
        time_shape("causal prefill B=2 S=1024 H=12 D=64", 2, _L, _L,
                   torch.float32, True, 2, hbm),
        time_shape("causal train B=16 S=1024 H=12 D=64", B, S, S,
                   torch.bfloat16, True, 2, hbm)]
    decode = fwd_rows[0]
    max_err = max([max_err] + [r["max_abs_err"] for r in fwd_rows])
    layers = GPT2_SMALL.num_hidden_layers
    bwd, (dq_main, dkv_main) = time_bwd(B, S, hbm, layers)
    dq_err, dkv_err = max(dq_err, dq_main), max(dkv_err, dkv_main)
    buckets = res.train_step.plan.buckets
    nb = len(buckets)
    # a bucket of the 25 MB threshold (the kernels line) and the largest
    # one (wte alone: a layer over the threshold gets its own bucket)
    upd = time_update(max(b.shard_size for b in buckets
                          if b.size * 4 <= 25 * 2**20), hbm, nb)
    time_update(max(b.shard_size for b in buckets), hbm, nb)
    ring_rows = time_ring(fused[0]["bucket_shards"], hbm)
    # the kernels line: the 25 MB bucket's shard, as for the update
    ring_n = max(n for n in fused[0]["shard_sizes"]
                 if 2 * n * 4 <= 25 * 2**20)
    cm_rows = time_ring_matmul(hbm, {768: 3 * layers, 3072: layers})
    k9_rows = time_overhead_probe(hbm)
    fused_launches = {k: sum(r["launches"][k] for r in fused + rp)
                      for k in fused[0]["launches"]}
    # K4 and the K5 ring also run on the probe's path (both transports)
    ring_launches = {k: fused_launches[k] + probe_launches[k]
                     + probe_ipc_launches[k] for k in ("ring_ag", "ring_rs")}
    rp_launches = {k: sum(r["launches"][k] for r in rp)
                   for k in rp[0]["launches"]}
    print(f"main paths (two ranks, dear-fused, with and without ring "
          f"projections): launches over both ranks and runs "
          f"{fused_launches}; with ring projections {rp_launches}; K4 and "
          f"the K5 ring with the probe's {ring_launches}")

    print(json.dumps({"kernels": [
        _kernel_entry("flash_fwd", "flash_fwd.cu",
                      "dear_pytorch_tpu/ops/flash_attention.py:97",
                      launches + train_launches["flash_fwd"]
                      + fused_launches["flash_fwd"], max_err, decode),
        _kernel_entry("flash_bwd_dq", "flash_bwd.cu",
                      "dear_pytorch_tpu/ops/flash_attention.py:152",
                      train_launches["flash_bwd_dq"]
                      + fused_launches["flash_bwd_dq"], dq_err,
                      bwd["flash_bwd_dq"]),
        _kernel_entry("flash_bwd_dkv", "flash_bwd.cu",
                      "dear_pytorch_tpu/ops/flash_attention.py:195",
                      train_launches["flash_bwd_dkv"]
                      + fused_launches["flash_bwd_dkv"], dkv_err,
                      bwd["flash_bwd_dkv"]),
        _kernel_entry("fused_update", "fused_update.cu",
                      "dear_pytorch_tpu/ops/collective_matmul.py:317",
                      train_launches["fused_update"], upd_err, upd),
        _kernel_entry("ring_all_gather", "ring.cu",
                      "dear_pytorch_tpu/ops/collective_matmul.py:218",
                      ring_launches["ring_ag"], ag_err,
                      ring_rows["ring_all_gather"][ring_n]),
        _kernel_entry("ring_rs_update", "ring.cu",
                      "dear_pytorch_tpu/ops/collective_matmul.py:317",
                      ring_launches["ring_rs"], rs_err,
                      ring_rows["ring_rs_update"][ring_n]),
    ] + [
        # the mlp_in shape (N = 3072); PERF.md has both shapes and per step
        _kernel_entry(kname, "ring_matmul.cu",
                      f"dear_pytorch_tpu/ops/collective_matmul.py:{line}",
                      rp_launches[kname], cm_err[kname],
                      cm_rows[kname][3072])
        for kname, line in (("cm_fwd", 510), ("cm_dx", 545),
                            ("cm_dw", 572))] + [
        # the finer granularity: per-step cost, not one SM's bandwidth
        _kernel_entry("overhead_probe", "overhead_probe.cu",
                      "scripts/pallas_overhead_probe.py:33",
                      probe_launches["overhead_probe"], k9_err,
                      k9_rows[2048, 8])]}))
    backend.shutdown()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
