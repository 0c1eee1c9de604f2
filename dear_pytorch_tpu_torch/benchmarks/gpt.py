"""Synthetic GPT causal-LM pre-training benchmark — the port of
``dear_pytorch_tpu/benchmarks/gpt.py`` at ``sp=1``: GPT-2 trained with the
DeAR schedule (`parallel.dear`) on one fixed seeded batch, printing
tokens/s.

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
ring collective matmul (K6 forward, K7 and K8 backward). ``--sp-degree >
1``, ``--remat`` and ``--num-experts`` are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional

import torch

from dear_pytorch_tpu_torch import models
from dear_pytorch_tpu_torch._device import resolve_device
from dear_pytorch_tpu_torch.api import broadcast_parameters
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
from dear_pytorch_tpu_torch.parallel.dear import build_train_step


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
                   help="rematerialise blocks (not ported yet: raises)")
    p.add_argument("--flash-attention", action="store_true", default=False,
                   help="causal flash-attention kernels (forward and "
                        "backward) instead of the dense core")
    p.add_argument("--sp-degree", type=int, default=1,
                   help="sequence parallelism (not ported yet: > 1 raises)")
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
    if args.ring_projections and (args.mode != "dear-fused"
                                  or args.sp_degree > 1):
        raise SystemExit("--ring-projections requires --mode dear-fused "
                         "on a pure dp mesh (no --sp-degree)")
    unported = [flag for flag, on in (
        ("--sp-degree > 1", args.sp_degree > 1),
        ("--remat", args.remat), ("--num-experts", args.num_experts > 0))
        if on]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not ported yet (ROADMAP Queue 1 items "
            "7 and 10)")
    resolve_device(args.device)          # raises without a card
    group = backend.init(args.device)    # "cuda" or None: this rank's card
    dev = backend.device()
    world, rank = backend.size(), backend.rank()

    dtype = torch.bfloat16 if args.fp16 else torch.float32
    cfg = models.gpt_config(args.model, dtype=dtype)
    if args.num_hidden_layers is not None:
        cfg = dataclasses.replace(cfg,
                                  num_hidden_layers=args.num_hidden_layers)
    if args.dropout0:
        cfg = models.dropout_free(cfg)
    if args.sequence_len > cfg.max_position_embeddings:
        raise SystemExit(f"--sequence-len {args.sequence_len} exceeds "
                         f"max_position_embeddings "
                         f"{cfg.max_position_embeddings}")
    if args.flash_attention and cfg.attention_probs_dropout_prob:
        runner.log("kernel attention: attention_probs_dropout_prob "
                   f"{cfg.attention_probs_dropout_prob} -> 0.0 "
                   "(no prob-dropout path in the requested impl)")
        cfg = dataclasses.replace(cfg, attention_probs_dropout_prob=0.0)
    model = models.GptLmHeadModel(
        cfg, attention_impl=(flash_causal_attention_impl()
                             if args.flash_attention else None),
        projection_impl=(make_ring_projection_impl()
                         if args.ring_projections else None),
        device=dev, seed=0)
    broadcast_parameters(model, group=group)

    global_bs = args.batch_size * world
    batch = data.synthetic_gpt_batch(
        torch.Generator(device=dev).manual_seed(0), global_bs,
        seq_len=args.sequence_len, vocab_size=cfg.vocab_size)
    batch = {k: v[rank * args.batch_size:(rank + 1) * args.batch_size]
             for k, v in batch.items()}

    def loss_fn(m, b, generator):
        logits = m(b["input_ids"], train=True, generator=generator)
        return gpt_lm_loss(logits, b["input_ids"],
                           vocab_size=cfg.vocab_size)

    dear_cfg = runner.config_from_args(args, world=world)
    ts = build_train_step(loss_fn, model, group=group,
                          threshold_mb=dear_cfg.threshold_mb,
                          nearby_layers=dear_cfg.nearby_layers,
                          flags=dear_cfg.flags, device=dev,
                          **dear_cfg.build_kwargs())
    holder = {"state": ts.init(), "losses": []}

    runner.log(f"{args.model} causal-LM pretraining, "
               f"sequence len: {args.sequence_len}")
    runner.log(f"Batch size: {args.batch_size} (per rank), {global_bs} "
               f"global ({global_bs * args.sequence_len} tokens/step)")
    runner.log(f"Number of {runner.device_name(dev)}s: {world}")
    runner.log(f"Schedule: {args.mode}; fusion: {ts.plan.num_buckets} "
               "bucket(s)")

    def step_fn():
        holder["state"], metrics = ts.step(holder["state"], batch)
        holder["losses"].append(metrics["loss"])
        if on_step is not None:
            on_step(ts, holder["state"], metrics)

    sync = torch.cuda.synchronize if dev.type == "cuda" else None
    result = runner.run_timed(
        step_fn, batch_size=args.batch_size,
        num_warmup_batches=args.num_warmup_batches,
        num_batches_per_iter=args.num_batches_per_iter,
        num_iters=args.num_iters, unit="sen", sync=sync, world=world,
        device=runner.device_name(dev))
    runner.log(f"Tokens/sec on {result.world} {result.device}(s): "
               f"{result.total_mean * args.sequence_len:.0f}")
    result.losses = [float(x) for x in holder["losses"]]
    result.train_step, result.state, result.batch = ts, holder["state"], batch
    return result


if __name__ == "__main__":
    main().train_step.close()   # dear-fused: after every rank's last call
    backend.shutdown()
