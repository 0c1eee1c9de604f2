"""Synthetic GPT causal-LM pre-training benchmark — the port of
``dear_pytorch_tpu/benchmarks/gpt.py``: GPT-2 trained with the DeAR
schedule (`parallel.dear`) on one fixed seeded batch, printing tokens/s.

Example (on the card; ``--device cpu`` runs the plain PyTorch path):
  python -m dear_pytorch_tpu_torch.benchmarks.gpt \\
      --model gpt2 --batch-size 16 --sequence-len 1024 --fp16 \\
      --flash-attention --dropout0

Each process drives one device. Several processes form one data-parallel
group through the launcher variables of `comm.backend`
(``DEAR_NUM_PROCESSES``, ``DEAR_PROCESS_ID``, ``DEAR_COORDINATOR_ADDRESS``);
every rank draws the same global batch and trains on its own slice.
``--mode dear-fused`` runs both legs as the ring kernels (K4, K5 ring), also
for ranks that share one card; ``--ring-projections`` (which requires it)
also runs every block's query, key, value and MLP-up projections as the
ring collective matmul (K6 forward, K7 and K8 backward). ``--mfu``
counts one step's FLOPs (`runner.step_flops`) and logs the MFU.
``--remat`` recomputes every block in the backward (``GptConfig.remat``;
``--remat-policy full`` recomputes the whole forward at the step's level
instead). ``--pipeline {none,native,numpy}``, ``--profile-dir`` and
``--metrics-file`` are the JAX CLI's (`runner.make_batch_source`; the
streamed batch is JAX's ``gpt_spec`` of the global batch, its int32 ids
cast to the constant batch's int64 on the host). ``--num-experts`` is not
ported yet and raises (ROADMAP Queue 1 item 10b).

``--sp-degree N`` (slice 20) trains with sequence parallelism: the world
is dp x N (`runner.build_sp_groups`: N consecutive ranks per sp group),
each rank holds its dp row block and sp column block of the global batch
of ``batch_size x dp`` sequences, attention runs over the sp group
(``--sp-attention ring`` by default, ``ring_flash`` with
``--flash-attention``; ``ulysses``; ``zigzag``: the load-balanced causal
ring flash over a striped layout, the batch's columns pre-permuted with
`parallel.ring_attention.zigzag_permutation`), and the step sums
gradients over sp and averages them over dp (``mean_axes=("dp",)``). The
model's weights are its dense twin's (the same seed); tokens/s counts the
global batch. On the CPU: ``DEAR_NUM_PROCESSES=2 DEAR_PROCESS_ID=r
DEAR_COORDINATOR_ADDRESS=file:///tmp/store python -m
dear_pytorch_tpu_torch.benchmarks.gpt --device cpu --sp-degree 2 ...``
for r in 0 and 1.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional

import torch

from dear_pytorch_tpu_torch import models
from dear_pytorch_tpu_torch._device import resolve_device
from dear_pytorch_tpu_torch.benchmarks import runner
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.models import data
from dear_pytorch_tpu_torch.models.gpt import (
    flash_causal_attention_impl,
    gpt_lm_loss,
)
from dear_pytorch_tpu_torch.ops.collective_matmul import (
    make_ring_projection_impl,
)
from dear_pytorch_tpu_torch.parallel import sp as SP
from dear_pytorch_tpu_torch.parallel.ring_attention import (
    zigzag_permutation,
)
from dear_pytorch_tpu_torch.runtime import pipeline as RP


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Synthetic GPT Benchmark (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model", type=str, default="gpt2",
                   help=f"one of {models.gpt_names()}")
    p.add_argument("--sequence-len", type=int, default=1024)
    p.add_argument("--num-hidden-layers", type=int, default=None,
                   help="override depth (smoke tests)")
    p.add_argument("--num-experts", type=int, default=0,
                   help="mixture of experts (not ported yet: > 0 raises)")
    p.add_argument("--ring-projections", action="store_true", default=False,
                   help="ring collective-matmul projections; requires "
                        "--mode dear-fused")
    p.add_argument("--dropout0", action="store_true", default=False,
                   help="zero every dropout prob")
    p.add_argument("--remat", action="store_true", default=False,
                   help="rematerialise blocks in the backward (cfg.remat): "
                        "the enabler for 350M+ dense-attention configs")
    p.add_argument("--flash-attention", action="store_true", default=False,
                   help="causal flash-attention kernels (forward and "
                        "backward) instead of the dense core")
    p.add_argument("--sp-degree", type=int, default=1,
                   help="sequence-parallel degree: dp x sp layout, causal "
                        "ring attention (or ring-flash with "
                        "--flash-attention) over global positions")
    p.add_argument("--sp-attention", type=str, default=None,
                   choices=["ring", "ring_flash", "ulysses", "zigzag"],
                   help="sequence-parallel attention scheme (default: ring, "
                        "or ring_flash with --flash-attention; zigzag = "
                        "load-balanced causal ring flash over a striped "
                        "shard layout)")
    runner.add_common_args(p)
    p.set_defaults(batch_size=8, base_lr=1e-4, momentum=0.0)
    return p


def main(argv=None, on_step: Optional[Callable] = None
         ) -> runner.BenchResult:
    """Run the benchmark; returns the `runner.BenchResult`, with the
    per-step losses (floats, read once after the run) as ``.losses``, the
    train step as ``.train_step``, its last state as ``.state`` and this
    rank's batch as ``.batch``. ``on_step(train_step, state, metrics)`` is
    called after every step (warmup included)."""
    args = build_parser().parse_args(argv)
    runner.validate_scan_steps(args)     # refuse before building
    if args.ring_projections and (args.mode != "dear-fused"
                                  or args.sp_degree > 1):
        raise SystemExit("--ring-projections requires --mode dear-fused "
                         "on a pure dp mesh (no --sp-degree)")
    if args.num_experts > 0:
        raise NotImplementedError(
            "--num-experts: not ported yet (ROADMAP Queue 1 item 10b: TP, "
            "ring-TP decode and EP)")
    sp = max(int(args.sp_degree), 1)
    if args.sp_attention and sp == 1:
        raise SystemExit("--sp-attention requires --sp-degree > 1")
    if (args.flash_attention and args.sp_attention
            and args.sp_attention != "ring_flash"):
        raise SystemExit("--flash-attention conflicts with "
                         f"--sp-attention {args.sp_attention}; pass one")
    if args.sp_attention == "zigzag" and args.sequence_len % (2 * sp):
        raise SystemExit(
            f"--sp-attention zigzag needs --sequence-len divisible by "
            f"2*sp-degree ({2 * sp}), got {args.sequence_len}")
    resolve_device(args.device)          # raises without a card
    group = backend.init(args.device)    # "cuda" or None: this rank's card
    if sp > 1:
        runner.build_sp_groups(sp, args.sequence_len, args.pipeline,
                               seq_flag="--sequence-len")
    dev, world = backend.device(), backend.size() // sp

    dtype = torch.bfloat16 if args.fp16 else torch.float32
    cfg = models.gpt_config(args.model, dtype=dtype)
    if args.num_hidden_layers is not None:
        cfg = dataclasses.replace(cfg,
                                  num_hidden_layers=args.num_hidden_layers)
    if args.dropout0:
        cfg = models.dropout_free(cfg)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=True)
    if args.sequence_len > cfg.max_position_embeddings:
        raise SystemExit(f"--sequence-len {args.sequence_len} exceeds "
                         f"max_position_embeddings "
                         f"{cfg.max_position_embeddings}")
    kernel_attn = (args.flash_attention
                   or args.sp_attention in ("ring_flash", "ulysses",
                                            "zigzag"))
    if kernel_attn and cfg.attention_probs_dropout_prob:
        runner.log("kernel attention: attention_probs_dropout_prob "
                   f"{cfg.attention_probs_dropout_prob} -> 0.0 "
                   "(no prob-dropout path in the requested impl)")
        cfg = dataclasses.replace(cfg, attention_probs_dropout_prob=0.0)
    global_bs = args.batch_size * world
    batch = data.synthetic_gpt_batch(
        torch.Generator(device=dev).manual_seed(0), global_bs,
        seq_len=args.sequence_len, vocab_size=cfg.vocab_size)
    if sp > 1:
        zigzag = args.sp_attention == "zigzag"
        # the dense twin's weights: the seeded init does not depend on
        # the attention impl
        model = SP.sp_gpt_model(cfg, flash=args.flash_attention,
                                attention=args.sp_attention, device=dev,
                                seed=0)
        if zigzag:
            perm = torch.as_tensor(zigzag_permutation(args.sequence_len,
                                                      sp), device=dev)
            batch = {"input_ids": batch["input_ids"][:, perm]}
        loss_fn = SP.make_sp_gpt_loss_fn(model, vocab_size=cfg.vocab_size,
                                         train=True, zigzag=zigzag)
    else:
        model = models.GptLmHeadModel(
            cfg, attention_impl=(flash_causal_attention_impl()
                                 if args.flash_attention else None),
            projection_impl=(make_ring_projection_impl()
                             if args.ring_projections else None),
            device=dev, seed=0)

        def loss_fn(m, b, generator):
            logits = m(b["input_ids"], train=True, generator=generator)
            return gpt_lm_loss(logits, b["input_ids"],
                               vocab_size=cfg.vocab_size)

    spec = RP.gpt_spec(global_bs, args.sequence_len, vocab=cfg.vocab_size)
    result = runner.train_timed(
        args, model, batch, loss_fn, group=group, unit="sen",
        on_step=on_step, spec=spec, sp=sp, header=[
            f"{args.model} causal-LM pretraining, sequence len: "
            f"{args.sequence_len}",
            f"Batch size: {args.batch_size} (per "
            f"{'dp rank' if sp > 1 else 'rank'}), {global_bs} global "
            f"({global_bs * args.sequence_len} tokens/step)"])
    runner.log(f"Tokens/sec on {result.world} {result.device}(s): "
               f"{result.total_mean * args.sequence_len:.0f}")
    return result


if __name__ == "__main__":
    main().train_step.close()   # dear-fused: after every rank's last call
    backend.shutdown()
