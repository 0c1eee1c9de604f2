"""Synthetic BERT pre-training benchmark — the port of
``dear_pytorch_tpu/benchmarks/bert.py`` at ``sp=1``: `BertForPreTraining`
(Base or Large) trained with the DeAR schedule (`parallel.dear`) on one
fixed seeded batch of random tokens with the MLM + NSP criterion, printing
sentences/s.

Example (on the card; ``--device cpu`` runs the plain PyTorch path):
  python -m dear_pytorch_tpu_torch.benchmarks.bert \\
      --model bert_base --batch-size 32 --sentence-len 128 --fp16 \\
      --flash-attention --dropout0

Each process drives one device; several processes form one data-parallel
group through the launcher variables of `comm.backend`, every rank draws
the same global batch and trains on its own slice. Dropout draws its masks
from the step's generator (``rng_seed`` 42). ``--flash-attention`` runs
every layer's attention through the flash kernels (K1 forward, K2 and K3
backward; `ops.flash_attention.make_flash_attention_impl`, with the
padding mask as the kernels' key validity) and zeroes the
attention-probability dropout first, with the JAX CLI's log line: the
kernels have no dropout path, and measuring the impl's dense fallback
would be worse than changing the config. ``--ring-projections`` (with
``--mode dear-fused`` only, as in JAX) routes every layer's query, key,
value and intermediate products through the ring collective matmul
(`ops.collective_matmul.make_ring_projection_impl`: K6 forward, K7 and K8
backward). ``--mfu`` counts one step's FLOPs (`runner.step_flops`) and
logs the MFU. ``--sp-degree > 1`` and ``--sp-attention`` (sequence
parallelism, ROADMAP Queue 1 item 10) are not ported yet and raise.
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
from dear_pytorch_tpu_torch.ops.collective_matmul import (
    make_ring_projection_impl,
)
from dear_pytorch_tpu_torch.ops.flash_attention import (
    make_flash_attention_impl,
)

_TITLES = {"bert": "BERT Large", "bert_large": "BERT Large",
           "bert_base": "BERT Base"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Synthetic BERT Benchmark (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model", type=str, default="bert",
                   help=f"one of {models.bert_names()} ('bert' = "
                        "BERT-Large, reference naming)")
    p.add_argument("--sentence-len", type=int, default=128)
    p.add_argument("--num-hidden-layers", type=int, default=None,
                   help="override encoder depth (smoke tests)")
    p.add_argument("--flash-attention", action="store_true", default=False,
                   help="flash-attention kernels (forward and backward) "
                        "instead of the dense core")
    p.add_argument("--sp-degree", type=int, default=1,
                   help="sequence parallelism (not ported yet: > 1 raises)")
    p.add_argument("--sp-attention", type=str, default=None,
                   choices=["ring", "ring_flash", "ulysses"],
                   help="sequence-parallel attention (not ported yet)")
    p.add_argument("--ring-projections", action="store_true", default=False,
                   help="route the QKV/intermediate projections through the "
                        "ring collective matmul (requires --mode "
                        "dear-fused on a pure dp group)")
    p.add_argument("--dropout0", action="store_true", default=False,
                   help="zero every dropout prob")
    runner.add_common_args(p)
    p.set_defaults(batch_size=8, base_lr=2e-5, momentum=0.0)
    return p


def main(argv=None, on_step: Optional[Callable] = None
         ) -> runner.BenchResult:
    """Run the benchmark; returns the `runner.BenchResult` with the
    per-step losses (floats, read once after the run) as ``.losses``, the
    train step as ``.train_step`` (the model is its ``.model``), its last
    state as ``.state`` and this rank's batch as ``.batch``.
    ``on_step(train_step, state, metrics)`` is called after every step
    (warmup included)."""
    args = build_parser().parse_args(argv)
    if args.ring_projections and (args.mode != "dear-fused"
                                  or args.sp_degree > 1):
        raise SystemExit("--ring-projections requires --mode dear-fused "
                         "on a pure dp mesh (no --sp-degree)")
    unported = [flag for flag, on in (
        ("--sp-degree > 1", args.sp_degree > 1),
        ("--sp-attention", args.sp_attention is not None)) if on]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not ported yet (ROADMAP Queue 1 item "
            "10 (sequence parallelism))")
    if not models.is_bert(args.model):
        raise SystemExit(f"--model {args.model}: one of "
                         f"{models.bert_names()}")
    resolve_device(args.device)          # raises without a card
    group = backend.init(args.device)    # "cuda" or None: this rank's card
    dev, world = backend.device(), backend.size()

    dtype = torch.bfloat16 if args.fp16 else torch.float32
    cfg = models.bert_config(args.model, dtype=dtype)
    if args.num_hidden_layers is not None:
        cfg = dataclasses.replace(cfg,
                                  num_hidden_layers=args.num_hidden_layers)
    if args.dropout0:
        cfg = models.dropout_free(cfg)
    if args.sentence_len > cfg.max_position_embeddings:
        raise SystemExit(f"--sentence-len {args.sentence_len} exceeds "
                         f"max_position_embeddings "
                         f"{cfg.max_position_embeddings}")
    if args.flash_attention and cfg.attention_probs_dropout_prob:
        runner.log("kernel attention: attention_probs_dropout_prob "
                   f"{cfg.attention_probs_dropout_prob} -> 0.0 "
                   "(no prob-dropout path in the requested impl)")
        cfg = dataclasses.replace(cfg, attention_probs_dropout_prob=0.0)
    model = models.BertForPreTraining(
        cfg, attention_impl=(make_flash_attention_impl()
                             if args.flash_attention else None),
        projection_impl=(make_ring_projection_impl()
                         if args.ring_projections else None),
        device=dev, seed=0)
    global_bs = args.batch_size * world
    batch = data.synthetic_bert_batch(
        torch.Generator(device=dev).manual_seed(0), global_bs,
        seq_len=args.sentence_len, vocab_size=cfg.vocab_size)

    def loss_fn(m, b, generator):
        logits, nsp = m(b["input_ids"], b["token_type_ids"],
                        b["attention_mask"], train=True,
                        generator=generator)
        return models.bert_pretraining_loss(
            logits, nsp, b["masked_lm_labels"], b["next_sentence_labels"])

    return runner.train_timed(
        args, model, batch, loss_fn, group=group, unit="sen",
        on_step=on_step, header=[
            f"{_TITLES[args.model.lower()]} Pretraining, Sentence len: "
            f"{args.sentence_len}",
            f"Batch size: {args.batch_size} (per rank), {global_bs} global"])


if __name__ == "__main__":
    main().train_step.close()   # dear-fused: after every rank's last call
    backend.shutdown()
