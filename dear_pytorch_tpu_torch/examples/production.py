"""Production training loop: every reliability subsystem working together —
the port of ``examples/production.py``.

  - the ZeRO-3 ``fsdp`` schedule (or any other ``--mode``) via
    `parallel.dear.build_train_step`, global-norm clipping, a warmup +
    cosine lr over the training horizon (evaluated from the step count, so
    it resumes where it left off);
  - crash-safe progress: `utils.guard.GuardedTrainer` with ASYNC
    checkpoints (NaN rollback, retention, the divergence circuit breaker);
  - resume-from-latest on startup: the newest step passing checksum
    verification (`utils.checkpoint.latest_valid_step`), restored into the
    live step, with the `elastic_restore` re-pack when the layout changed
    (another world or bucketing); crash-orphaned temporary dirs are pruned
    by the guard first;
  - preemption safety: SIGTERM triggers a verified synchronous emergency
    checkpoint at the next step boundary, then a clean exit — a relaunch
    resumes from it (`resilience.preempt.PreemptionHandler`);
  - host input from `runtime.pipeline.NumpyPipeline` (each rank its own
    shard of ``--batch-size`` rows a step);
  - structured JSONL metrics (`utils.metrics.MetricsLogger`).

Run (on the card; ``--device cpu`` runs the plain PyTorch path):
  python -m dear_pytorch_tpu_torch.examples.production --steps 40 \\
      --workdir /tmp/run

Chaos-test the recovery paths (with the defaults, as in the JAX example,
the first checkpoint comes at step 20, so these faults find nothing to
restore and the run stops with the guard's DivergenceError; checkpoint
sooner to see them recovered):
  DEAR_FAULTS="nan@6,exc@9" python -m \\
      dear_pytorch_tpu_torch.examples.production --steps 40 \\
      --workdir /tmp/run --device cpu --checkpoint-every 4 --log-every 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def _truncate_metrics(path: str, start: int) -> None:
    """Drop records past the restored checkpoint: resume replays those
    steps and would otherwise log duplicate step records with conflicting
    values."""
    from dear_pytorch_tpu_torch.utils.metrics import read_metrics

    kept = [r for r in read_metrics(path) if r.get("step", 0) <= start]
    # atomic rewrite: a crash mid-truncation must not lose the history
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for r in kept:
            f.write(json.dumps(r) + "\n")
    os.replace(tmp, path)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="production training loop (PyTorch port)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8,
                    help="per device (each rank's rows a step)")
    ap.add_argument("--mode", type=str, default="fsdp")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--workdir", type=str, required=True)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", type=str, default=None,
                    help="the card by default; 'cpu' runs the plain "
                         "PyTorch path over a gloo group")
    return ap


def main(argv=None) -> float:
    args = build_parser().parse_args(argv)

    from dear_pytorch_tpu_torch._device import resolve_device
    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.models import get_model
    from dear_pytorch_tpu_torch.ops import schedules
    from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd
    from dear_pytorch_tpu_torch.parallel.dear import build_train_step
    from dear_pytorch_tpu_torch.utils import checkpoint as ckpt

    resolve_device(args.device)          # raises without a card
    group = backend.init(args.device)
    dev, world, rank = backend.device(), backend.size(), backend.rank()

    model = get_model("mnistnet", device=dev)

    def loss_fn(m, b):
        logits = m(b["image"], train=False)     # log-probabilities
        return -logits.gather(1, b["label"][:, None]).mean()

    # warmup+cosine over the training horizon, from the step count: it
    # resumes correctly from a checkpoint
    lr = schedules.warmup_cosine(
        0.05, warmup_steps=min(20, args.steps // 10),
        total_steps=max(args.steps, 1) + 1, min_lr=0.005)
    ts = build_train_step(
        loss_fn, model, group=group, device=dev, mode=args.mode,
        threshold_mb=0.05, accum_steps=args.accum_steps,
        clip_norm=5.0,  # global-norm clipping, exact on shards
        optimizer=fused_sgd(lr=lr, momentum=0.9))
    state = ts.init()

    ckpt_dir = os.path.join(args.workdir, "ckpts")
    start = 0
    # resume-from-latest: the newest step passing checksum verification,
    # walked ONCE (the walk re-hashes payloads); an all-corrupt dir starts
    # fresh instead of crashing at startup
    resume_step = ckpt.latest_valid_step(ckpt_dir)
    if resume_step is not None:
        try:
            state = ckpt.restore_checkpoint(ckpt_dir, ts, step=resume_step,
                                            template=state)
        except ValueError:
            # the layout changed since the checkpoint (another world, or
            # another bucketing): re-pack by parameter name
            state = ckpt.elastic_restore(ckpt_dir, ts, step=resume_step)
            print("elastic resume: checkpoint layout differed "
                  "(world resize or re-bucketing)")
        start = int(state.step)
        print(f"resumed from checkpoint step {start}")

    try:
        return _train(args, ts, state, start, ckpt_dir, dev, rank, world)
    finally:
        ts.close()


def _train(args, ts, state, start, ckpt_dir, dev, rank, world) -> float:
    """The guarded loop from ``state`` (at step ``start``); returns the
    last logged loss."""
    from dear_pytorch_tpu_torch.resilience.preempt import PreemptionHandler
    from dear_pytorch_tpu_torch.runtime import pipeline as RP
    from dear_pytorch_tpu_torch.utils import GuardedTrainer, MetricsLogger

    pipe = RP.NumpyPipeline(RP.mnist_spec(args.batch_size), shard=rank,
                            num_shards=world)

    def to_device(b):
        return {"image": torch.from_numpy(b["image"]).permute(
                    0, 3, 1, 2).contiguous().to(dev),
                "label": torch.from_numpy(b["label"]).long().to(dev)}

    preempt = PreemptionHandler()
    guard = GuardedTrainer(
        ts, ckpt_dir,
        check_every=args.log_every,
        checkpoint_every=args.checkpoint_every,
        async_checkpoints=True,
        preemption=preempt)
    guard.steps_seen = start  # keep the cadence aligned after resume
    metrics_path = os.path.join(args.workdir, "metrics.jsonl")
    if start > 0 and os.path.exists(metrics_path) and rank == 0:
        _truncate_metrics(metrics_path, start)
    last_loss = float("nan")
    with preempt, guard, MetricsLogger(
            metrics_path if rank == 0 else os.devnull,
            append=start > 0) as ml:
        try:
            # a host mirror of the step count: it only diverges on
            # rollback, where it re-syncs from the restored state
            cur = start
            while cur < args.steps:
                state, m = guard.step(state, to_device(pipe.next()))
                if m.get("preempted"):
                    # exit cleanly for relaunch; report what is durable
                    saved = m.get("preempt_checkpoint_step")
                    ml.log(event="preempted", saved_step=saved)
                    if saved is not None:
                        print(f"preempted: emergency checkpoint at step "
                              f"{saved}; exiting for relaunch")
                    else:
                        print("preempted: emergency save skipped/failed; "
                              "relaunch resumes from the last periodic "
                              "checkpoint")
                    break
                if m.get("rolled_back"):
                    cur = int(state.step)
                    # replayed steps re-log their numbers (latest wins)
                    ml.log(event="rollback", restored_step=cur)
                    continue
                cur += 1
                if cur % args.log_every == 0:
                    last_loss = float(m["loss"])
                    ml.log(step=cur, loss=last_loss,
                           grad_norm=float(m["grad_norm"]))
                    print(f"step {cur}: loss {last_loss:.4f}")
        finally:
            pipe.close()
    print(f"done at step {int(state.step)}, loss {last_loss:.4f}")
    return last_loss


if __name__ == "__main__":
    main()
    from dear_pytorch_tpu_torch.comm import backend

    backend.shutdown()
    sys.exit(0)
