"""Synthetic BERT pre-training benchmark — the port of
``dear_pytorch_tpu/benchmarks/bert.py``: `BertForPreTraining`
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
logs the MFU. ``--pipeline {none,native,numpy}``, ``--profile-dir`` and
``--metrics-file`` are the JAX CLI's (`runner.make_batch_source`; the
streamed batch is JAX's ``bert_spec`` of the global batch).

``--sp-degree N`` (slice 20) trains with sequence parallelism, as the GPT
CLI does (`benchmarks.gpt`): a dp x N layout, each rank's dp rows and sp
columns of the global batch (its ``[B]`` labels by dp rows), attention
over the sp group (``--sp-attention ring``, the default, with attention
dropout; ``ring_flash``, also ``--flash-attention``; ``ulysses``; the
kernel schemes zero the attention-probability dropout first), the CLS
token pooled from sp rank 0 and the loss normalised globally
(`parallel.sp`), gradients summed over sp and averaged over dp.
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
from dear_pytorch_tpu_torch.parallel import sp as SP
from dear_pytorch_tpu_torch.runtime import pipeline as RP

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
                   help="sequence-parallel degree: dp x sp layout with the "
                        "sequence dim split over sp and ring attention "
                        "(or ring-flash with --flash-attention) inside the "
                        "model; DeAR gradients reduce over both")
    p.add_argument("--sp-attention", type=str, default=None,
                   choices=["ring", "ring_flash", "ulysses"],
                   help="sequence-parallel attention scheme (default: "
                        "ring, or ring_flash with --flash-attention)")
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
    runner.validate_scan_steps(args)     # refuse before building
    if args.ring_projections and (args.mode != "dear-fused"
                                  or args.sp_degree > 1):
        raise SystemExit("--ring-projections requires --mode dear-fused "
                         "on a pure dp mesh (no --sp-degree)")
    sp = max(int(args.sp_degree), 1)
    if args.sp_attention and sp == 1:
        raise SystemExit("--sp-attention requires --sp-degree > 1")
    if (args.flash_attention and args.sp_attention
            and args.sp_attention != "ring_flash"):
        raise SystemExit("--flash-attention conflicts with "
                         f"--sp-attention {args.sp_attention}; pass one")
    if not models.is_bert(args.model):
        raise SystemExit(f"--model {args.model}: one of "
                         f"{models.bert_names()}")
    resolve_device(args.device)          # raises without a card
    group = backend.init(args.device)    # "cuda" or None: this rank's card
    if sp > 1:
        runner.build_sp_groups(sp, args.sentence_len, args.pipeline)
    dev, world = backend.device(), backend.size() // sp

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
    # impls with no attention-prob-dropout path: dropout > 0 would silently
    # measure their dense fallback instead of the requested kernel
    kernel_attn = (args.flash_attention
                   or args.sp_attention in ("ring_flash", "ulysses"))
    if kernel_attn and cfg.attention_probs_dropout_prob:
        runner.log("kernel attention: attention_probs_dropout_prob "
                   f"{cfg.attention_probs_dropout_prob} -> 0.0 "
                   "(no prob-dropout path in the requested impl)")
        cfg = dataclasses.replace(cfg, attention_probs_dropout_prob=0.0)
    if sp > 1:
        # the dense twin's weights: the seeded init does not depend on
        # the attention impl
        model = SP.sp_bert_model(cfg, flash=args.flash_attention,
                                 attention=args.sp_attention, device=dev,
                                 seed=0)
        loss_fn = SP.make_sp_bert_loss_fn(model, train=True)
    else:
        model = models.BertForPreTraining(
            cfg, attention_impl=(make_flash_attention_impl()
                                 if args.flash_attention else None),
            projection_impl=(make_ring_projection_impl()
                             if args.ring_projections else None),
            device=dev, seed=0)

        def loss_fn(m, b, generator):
            logits, nsp = m(b["input_ids"], b["token_type_ids"],
                            b["attention_mask"], train=True,
                            generator=generator)
            return models.bert_pretraining_loss(
                logits, nsp, b["masked_lm_labels"],
                b["next_sentence_labels"])
    global_bs = args.batch_size * world
    batch = data.synthetic_bert_batch(
        torch.Generator(device=dev).manual_seed(0), global_bs,
        seq_len=args.sentence_len, vocab_size=cfg.vocab_size)

    spec = RP.bert_spec(global_bs, args.sentence_len,
                        vocab=cfg.vocab_size)
    return runner.train_timed(
        args, model, batch, loss_fn, group=group, unit="sen",
        on_step=on_step, spec=spec, sp=sp, header=[
            f"{_TITLES[args.model.lower()]} Pretraining, Sentence len: "
            f"{args.sentence_len}",
            f"Batch size: {args.batch_size} (per "
            f"{'dp rank' if sp > 1 else 'rank'}), {global_bs} global"])


if __name__ == "__main__":
    main().train_step.close()   # dear-fused: after every rank's last call
    backend.shutdown()
