"""Headline benchmarks of the port — the counterpart of the root
``bench.py`` (the JAX package's bench): end-to-end training throughput of
ResNet-50, BERT-Base, BERT-Large, ViT-B/16 and GPT-2 on one card, with
MFU from a counted step and the peak memory.

  python -m dear_pytorch_tpu_torch.bench [--device cpu]

Prints ONE JSON line on stdout (progress goes to stderr), bench.py's
contract line, primary metric first::

  {"metric": "resnet50_bs64_train_img_sec_per_chip", "value": N,
   "unit": "img/s", "mfu": F, "peak_hbm_gb": G, ...,
   "extra_metrics": [{"metric": "bert_base_sen_sec_per_chip", ...},
                     {"metric": "bert_large_sen_sec_per_chip", ...},
                     {"metric": "vit_b16_bs64_train_img_sec_per_chip", ...},
                     {"metric": "gpt2_s1024_tok_sec_per_chip", ...}]}

Each entry also carries ``step_ms`` (milliseconds per step of the timed
window) and ``flops_per_step`` (`benchmarks.runner.step_flops`). A
secondary metric that raises becomes bench.py's ``{"metric", "error"}``
entry; a failure of the primary metric, or no card without ``--device
cpu``, exits non-zero.

The five models, configurations and optimizers are bench.py's
(``bench_resnet``, ``bench_bert`` for Base and Large, ``bench_vit``,
``bench_gpt``): bf16 compute with fp32 masters, ``mode="dear"``, 25 MB
buckets, gradients in bf16, gathers in fp32 at world 1 and bf16 above
(`_gather_dtype`, ``DEAR_BENCH_GATHER_DTYPE``). Every attention runs the
dense core, as bench.py's does (BERT trains with dropout 0.1, which the
flash kernels do not carry; ViT's 197 tokens; GPT's default causal core),
so this line launches no attention kernel; the K5 epilogue runs once per
bucket per step in every model. On the card cuDNN picks each conv's
algorithm (``cudnn.benchmark``), as the ImageNet CLI does.

Timing (bench.py's ``_compile_once``/``_timed``): one step counted by
`runner.step_flops` (an eager step before the window), then the warmup in
whole iterations of ``ts.multi_step(10)`` (one), one host fetch, then 10
timed iterations of ``ts.multi_step(10)`` dispatched back to back and ONE
host fetch at the end; value = items per step / seconds per step.
``multi_step`` runs its 10 steps eagerly (`parallel.dear`; JAX compiles
them as one program).
``peak_hbm_gb`` is ``torch.cuda.max_memory_allocated`` over the timed
window (reset before it), null on the CPU, as is ``mfu`` (no known peak).

``DEAR_BENCH_SMOKE=1`` runs tiny shapes (CPU-safe); ``DEAR_BENCH_BERT_LARGE``,
``DEAR_BENCH_VIT`` and ``DEAR_BENCH_GPT`` set to 0 skip those metrics.
``DEAR_BENCH_ITERS=N`` times N iterations of 10 steps per model instead of
bench.py's 10 (a shorter window, for a quick comparison of two settings).

The line carries bench.py's ``telemetry`` block (root bench.py:565-570,
:629): the tracer's snapshot (`observability.tracer.snapshot`) after every
model, on by default with counters only (``configure(memory=False)``: no
span records, so the timed windows accumulate nothing); an explicit
``DEAR_TELEMETRY`` — an explicit disable included — is honoured as it is.

The phase watchdog is bench.py's (``_Watchdog``, root bench.py:490-560):
each model's phase has ``DEAR_BENCH_WATCHDOG_SECS`` (default 2400; 0
disables it) to finish; past it a daemon thread reports the open spans and
every thread's stack (`resilience.watchdog.StepWatchdog`) and, once the
primary metric exists, prints the partial line and exits 0, else the
primary's error line and exits 3.

Left out, on purpose: bench.py's ``vs_baseline``, ``baseline_protocol``
and ``baseline_config`` — its pins (``BASELINE_IMG_SEC`` 2304.13,
``BASELINE_GPT_TOK_SEC``) were measured on a TPU and may not stand as the
port's baseline.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
from typing import Callable

import torch

PRIMARY_METRIC = "resnet50_bs64_train_img_sec_per_chip"
#: (metric, unit) of every entry, in bench.py's order
METRICS = (
    (PRIMARY_METRIC, "img/s"),
    ("bert_base_sen_sec_per_chip", "sen/s"),
    ("bert_large_sen_sec_per_chip", "sen/s"),
    ("vit_b16_bs64_train_img_sec_per_chip", "img/s"),
    ("gpt2_s1024_tok_sec_per_chip", "tok/s"),
)


def _env_enabled(name: str) -> bool:
    """Opt-out env flag: on unless set to a falsy marker."""
    return os.environ.get(name, "1").strip().lower() not in (
        "", "0", "false", "no")


def _gather_dtype(world: int):
    """The all-gather's dtype: bf16 only where there is gather traffic to
    halve (world > 1), fp32 at world 1 (bench.py's rule);
    ``DEAR_BENCH_GATHER_DTYPE=bf16|f32`` overrides it."""
    v = os.environ.get("DEAR_BENCH_GATHER_DTYPE", "").strip().lower()
    if v in ("f32", "fp32", "float32", "none"):
        return None
    if v in ("bf16", "bfloat16"):
        return torch.bfloat16
    if v:
        raise SystemExit(
            f"DEAR_BENCH_GATHER_DTYPE={v!r}: use 'bf16' or 'f32'")
    return torch.bfloat16 if world > 1 else None


@dataclasses.dataclass(frozen=True)
class Protocol:
    """Steps of bench.py's timing protocol."""

    smoke: bool
    warmup_batches: int
    num_iters: int
    batches_per_iter: int

    @classmethod
    def from_env(cls) -> "Protocol":
        smoke = bool(os.environ.get("DEAR_BENCH_SMOKE"))
        iters = os.environ.get("DEAR_BENCH_ITERS", "").strip()
        return cls(smoke, 2 if smoke else 10,
                   int(iters) if iters else 2 if smoke else 10,
                   2 if smoke else 10)

    @property
    def warmup_steps(self) -> int:
        """Whole iterations of warmup, at least one (bench.py's
        ``n_warm_iters``)."""
        return max(self.warmup_batches // self.batches_per_iter, 1) \
            * self.batches_per_iter


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _timed(ts, batch, items_per_step: int, proto: Protocol,
           dev: torch.device) -> dict:
    """bench.py's ``_timed`` around ``ts.multi_step(batches_per_iter)``
    from ``ts.init()``: {"value", "step_ms", "flops_per_step",
    "peak_bytes"}."""
    from dear_pytorch_tpu_torch.benchmarks import runner

    holder = {"state": ts.init(), "metrics": None}

    def step():
        holder["state"], holder["metrics"] = ts.step(holder["state"], batch)

    flops = runner.step_flops(step)          # one eager step, counted
    run = ts.multi_step(proto.batches_per_iter)
    for _ in range(proto.warmup_steps // proto.batches_per_iter):
        holder["state"], holder["metrics"] = run(holder["state"], batch)
    float(holder["metrics"]["loss"])         # drain once before timing
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(proto.num_iters):
        holder["state"], holder["metrics"] = run(holder["state"], batch)
    float(holder["metrics"]["loss"])         # ONE host fetch for the window
    secs = (time.perf_counter() - t0) / (proto.num_iters
                                         * proto.batches_per_iter)
    return {"value": items_per_step / secs, "step_ms": secs * 1e3,
            "flops_per_step": flops,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
            else None}


def _entry(metric: str, unit: str, run: dict, dev, digits=2) -> dict:
    from dear_pytorch_tpu_torch.benchmarks import runner

    value = runner.mfu(run["flops_per_step"], run["step_ms"] / 1e3, dev)
    peak = run["peak_bytes"]
    return {"metric": metric, "value": round(run["value"], digits),
            "unit": unit, "mfu": round(value, 4) if value else None,
            "peak_hbm_gb": round(peak / 2**30, 3) if peak else None,
            "step_ms": run["step_ms"],
            "flops_per_step": run["flops_per_step"]}


def _train_step(loss_fn, model, group, dev, optimizer, **kw):
    from dear_pytorch_tpu_torch.parallel.dear import build_train_step

    return build_train_step(
        loss_fn, model, group=group, device=dev, mode="dear",
        threshold_mb=25.0, optimizer=optimizer,
        comm_dtype=torch.bfloat16,
        gather_dtype=_gather_dtype(torch.distributed.get_world_size(group)),
        **kw)


# ---------------------------------------------------------------------------
# the five models (bench.py's configurations)
# ---------------------------------------------------------------------------


def bench_resnet(group, dev, proto: Protocol) -> dict:
    """ResNet-50 bs64 bf16 at 224², BatchNorm state, SGD lr 0.01 momentum
    0.9 (smoke: ResNet-18, bs8, 64²)."""
    from dear_pytorch_tpu_torch import models
    from dear_pytorch_tpu_torch.models import data
    from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd

    B = 8 if proto.smoke else 64
    model = models.get_model("resnet18" if proto.smoke else "resnet50",
                             dtype=torch.bfloat16, device=dev, seed=0)
    batch = data.synthetic_image_batch(
        torch.Generator(device=dev).manual_seed(0), B,
        image_size=64 if proto.smoke else 224, dtype=torch.bfloat16)

    def loss_fn(m, b):
        return data.softmax_xent(m(b["image"]), b["label"])

    ts = _train_step(loss_fn, model, group, dev,
                     fused_sgd(lr=0.01, momentum=0.9))
    return _entry(PRIMARY_METRIC, "img/s", _timed(ts, batch, B, proto, dev),
                  dev)


def bench_vit(group, dev, proto: Protocol) -> dict:
    """ViT-B/16 bs64 bf16 at 224², the loss in eval mode as bench.py
    writes it, SGD lr 0.01 momentum 0.9 (smoke: ViT-S/16 of 2 layers,
    bs8, 32²)."""
    from dear_pytorch_tpu_torch import models
    from dear_pytorch_tpu_torch.models import data
    from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd

    B, size = (8, 32) if proto.smoke else (64, 224)
    model = models.get_model(
        "vit_s16" if proto.smoke else "vit_b16", dtype=torch.bfloat16,
        device=dev, seed=0, image_size=size,
        **({"num_layers": 2} if proto.smoke else {}))
    batch = data.synthetic_image_batch(
        torch.Generator(device=dev).manual_seed(0), B, image_size=size,
        dtype=torch.bfloat16)

    def loss_fn(m, b):
        return data.softmax_xent(m(b["image"], train=False), b["label"])

    ts = _train_step(loss_fn, model, group, dev,
                     fused_sgd(lr=0.01, momentum=0.9))
    return _entry("vit_b16_bs64_train_img_sec_per_chip", "img/s",
                  _timed(ts, batch, B, proto, dev), dev)


def bench_bert(group, dev, proto: Protocol, variant: str = "bert_base"
               ) -> dict:
    """BERT pre-training, S=64, bs32 (Large, ``variant="bert"``: bs16),
    dropout on with ``rng_seed=42``, SGD lr 2e-5 without momentum (smoke:
    2 layers, bs4, S=32)."""
    from dear_pytorch_tpu_torch import models
    from dear_pytorch_tpu_torch.models import data
    from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd

    large = variant != "bert_base"
    B = 4 if proto.smoke else (16 if large else 32)
    S = 32 if proto.smoke else 64
    cfg = models.bert_config(variant, dtype=torch.bfloat16)
    if proto.smoke:
        cfg = dataclasses.replace(cfg, num_hidden_layers=2)
    model = models.BertForPreTraining(cfg, device=dev, seed=0)
    batch = data.synthetic_bert_batch(
        torch.Generator(device=dev).manual_seed(0), B, seq_len=S,
        vocab_size=cfg.vocab_size)

    def loss_fn(m, b, generator):
        logits, nsp = m(b["input_ids"], b["token_type_ids"],
                        b["attention_mask"], train=True, generator=generator)
        return models.bert_pretraining_loss(
            logits, nsp, b["masked_lm_labels"], b["next_sentence_labels"])

    ts = _train_step(loss_fn, model, group, dev,
                     fused_sgd(lr=2e-5, momentum=0.0), rng_seed=42)
    name = "bert_large" if large else "bert_base"
    return _entry(f"{name}_sen_sec_per_chip", "sen/s",
                  _timed(ts, batch, B, proto, dev), dev)


def gpt_smoke_config(cfg):
    """bench.py's tiny GPT for the smoke run."""
    return dataclasses.replace(
        cfg, num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
        intermediate_size=128, vocab_size=128, max_position_embeddings=32)


def bench_gpt(group, dev, proto: Protocol) -> dict:
    """GPT-2 (124M) S=1024 causal-LM pre-training, bs16, every dropout
    zeroed, the dense causal core, SGD lr 0.01 momentum 0.9,
    ``rng_seed=7`` (smoke: bench.py's tiny GPT, bs2, S=32)."""
    from dear_pytorch_tpu_torch import models
    from dear_pytorch_tpu_torch.models import data
    from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd

    B, S = (2, 32) if proto.smoke else (16, 1024)
    cfg = models.dropout_free(models.gpt_config("gpt2",
                                                dtype=torch.bfloat16))
    if proto.smoke:
        cfg = gpt_smoke_config(cfg)
    model = models.GptLmHeadModel(cfg, device=dev, seed=0)
    batch = data.synthetic_gpt_batch(
        torch.Generator(device=dev).manual_seed(0), B, seq_len=S,
        vocab_size=cfg.vocab_size)

    def loss_fn(m, b, generator):
        del generator          # dropout-free config
        return models.gpt_lm_loss(m(b["input_ids"], train=True),
                                  b["input_ids"], vocab_size=cfg.vocab_size)

    ts = _train_step(loss_fn, model, group, dev,
                     fused_sgd(lr=0.01, momentum=0.9), rng_seed=7)
    return _entry("gpt2_s1024_tok_sec_per_chip", "tok/s",
                  _timed(ts, batch, B * S, proto, dev), dev, digits=1)


# ---------------------------------------------------------------------------
# the analytic FLOP counts the counted steps are held against
# ---------------------------------------------------------------------------


def conv_fc_flops(model, size: int) -> tuple:
    """(every conv's and dense layer's forward products per image, the
    first conv's alone): ``2·kh·kw·C_in·C_out·H_out·W_out`` per conv (the
    output sizes from one forward of ``model`` on a ``size``² image) plus
    ``2·in·out`` per dense layer, each applied once per image (some
    models call an fp32 ``F.linear`` on its weight, which no module hook
    sees)."""
    flops = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: flops.append(2 * m.weight[0].numel()
                                     * m.out_channels * o.shape[2]
                                     * o.shape[3]))
        for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model.eval()(torch.zeros(1, 3, size, size, device=model.device))
    for h in hooks:
        h.remove()
    dense = sum(2 * m.in_features * m.out_features for m in model.modules()
                if isinstance(m, torch.nn.Linear))
    return float(sum(flops) + dense), float(flops[0])


def resnet_step_flops(name: str, B: int, size: int) -> float:
    """One training step: 3 x the forward's products (forward, input and
    weight gradients), less the first conv's input gradient (the image
    needs none)."""
    from dear_pytorch_tpu_torch import models

    fwd, stem = conv_fc_flops(models.get_model(name, device="cpu"), size)
    return B * (3 * fwd - stem)


def bert_step_flops(cfg, B: int, S: int) -> float:
    """6 x matmul parameters x tokens (every layer's query, key, value,
    output and MLP, ``mlm_transform`` and the tied decoder over the padded
    vocab), 6 x the pooler's and classifier's over the B [CLS] rows, and
    the dense attention's products forward and backward, 3·4·h·L·B·S²."""
    h, L = cfg.hidden_size, cfg.num_hidden_layers
    per_token = (L * (4 * h * h + 2 * h * cfg.intermediate_size) + h * h
                 + cfg.padded_vocab_size * h)
    return float(6 * per_token * B * S + 6 * (h * h + 2 * h) * B
                 + 12 * h * L * B * S * S)


def vit_step_flops(B: int, *, hidden_size: int, num_layers: int,
                   mlp_dim: int, patch: int = 16, image_size: int = 224,
                   num_classes: int = 1000, **_) -> float:
    """6 x the blocks' matmul parameters x tokens (patches + [CLS]), the
    patch conv's forward and weight gradient (2 x 2·p²·3·E per patch), 6 x
    the head's over the [CLS] rows, and the dense attention, 3·4·E·L·B·T²."""
    E, L, M = hidden_size, num_layers, mlp_dim
    P = (image_size // patch) ** 2
    T = P + 1
    return float(6 * L * (4 * E * E + 2 * E * M) * B * T
                 + 2 * 2 * patch ** 2 * 3 * E * P * B
                 + 6 * E * num_classes * B + 12 * E * L * B * T * T)


#: the widths of `models.vit.ViTS16` and `ViTB16`
VIT_S16 = {"hidden_size": 384, "num_layers": 12, "mlp_dim": 1536}
VIT_B16 = {"hidden_size": 768, "num_layers": 12, "mlp_dim": 3072}


def gpt_step_flops(cfg, B: int, S: int) -> float:
    """6 x matmul parameters x tokens (the blocks and the tied LM head over
    the padded vocab) plus the dense causal core's full S² products,
    3·4·h·L·B·S² (the core computes every pair, then masks)."""
    h, L = cfg.hidden_size, cfg.num_hidden_layers
    per_token = (L * (4 * h * h + 2 * h * cfg.intermediate_size)
                 + cfg.padded_vocab_size * h)
    return float(6 * per_token * B * S + 12 * h * L * B * S * S)


def analytic_step_flops(smoke: bool = False) -> dict:
    """{metric: the analytic FLOPs of one step} at the bench's (or the
    smoke run's) sizes."""
    from dear_pytorch_tpu_torch import models

    bf = torch.bfloat16
    base, large = (models.bert_config(n, dtype=bf) for n in ("bert_base",
                                                            "bert"))
    gpt = models.dropout_free(models.gpt_config("gpt2", dtype=bf))
    if smoke:
        base, large = (dataclasses.replace(c, num_hidden_layers=2)
                       for c in (base, large))
        return {PRIMARY_METRIC: resnet_step_flops("resnet18", 8, 64),
                "bert_base_sen_sec_per_chip": bert_step_flops(base, 4, 32),
                "bert_large_sen_sec_per_chip": bert_step_flops(large, 4, 32),
                "vit_b16_bs64_train_img_sec_per_chip": vit_step_flops(
                    8, **dict(VIT_S16, num_layers=2, image_size=32)),
                "gpt2_s1024_tok_sec_per_chip": gpt_step_flops(
                    gpt_smoke_config(gpt), 2, 32)}
    return {PRIMARY_METRIC: resnet_step_flops("resnet50", 64, 224),
            "bert_base_sen_sec_per_chip": bert_step_flops(base, 32, 64),
            "bert_large_sen_sec_per_chip": bert_step_flops(large, 16, 64),
            "vit_b16_bs64_train_img_sec_per_chip": vit_step_flops(64, **VIT_B16),
            "gpt2_s1024_tok_sec_per_chip": gpt_step_flops(gpt, 16, 1024)}


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def _secondary(metric: str, fn: Callable[[], dict]) -> dict:
    """``fn()``, or bench.py's error entry when it raises."""
    try:
        return fn()
    except Exception as exc:  # a second metric must not sink the primary
        _log(f"bench: {metric} failed: {type(exc).__name__}: {exc}")
        return {"metric": metric,
                "error": f"{type(exc).__name__}: {exc}"[:200]}
    finally:
        gc.collect()       # the model and its step hold cycles (hooks)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


class _Watchdog:
    """Per-phase hang guard (root bench.py's ``_Watchdog``): built on
    `resilience.watchdog.StepWatchdog` — a daemon thread and ``os._exit``
    fire even while the main thread is blocked in a CUDA synchronize or a
    gloo wait, which a signal handler would not; the firing report
    carries the open spans and every thread's stack. Each phase gets its
    own budget (``arm`` beats the clock), and once the primary metric
    exists a late hang prints the partial line and exits 0.
    ``DEAR_BENCH_WATCHDOG_SECS=0`` disables it."""

    def __init__(self):
        self.secs = float(os.environ.get("DEAR_BENCH_WATCHDOG_SECS", "2400"))
        self.primary = None
        self.extras: list = []  # completed secondary metrics so far
        self._dog = None
        self._phase = ""
        self._metric = ""

    def arm(self, phase: str, metric: str) -> None:
        if self.secs <= 0:
            return
        self._phase, self._metric = phase, metric
        if self._dog is None:
            from dear_pytorch_tpu_torch.resilience.watchdog import (
                StepWatchdog)

            self._dog = StepWatchdog(self.secs, on_timeout=self._fire,
                                     name="bench-watchdog").start()
        self._dog.beat(phase=phase, metric=metric)

    def disarm(self) -> None:
        if self._dog is not None:
            self._dog.stop()
            self._dog = None

    def _fire(self, report) -> None:
        from dear_pytorch_tpu_torch.observability import tracer

        phase, metric = self._phase, self._metric
        _log(f"bench watchdog: phase {phase!r} still running after "
             f"{report.waited_s:.0f}s; aborting")
        err = {"metric": metric,
               "error": f"watchdog: {phase} wedged after {self.secs:.0f}s"}
        if self.primary is not None:
            done = list(self.extras)
            # a phase that finished right at the timeout is already in
            # extras: don't also report it as wedged
            if not any(m.get("metric") == metric for m in done):
                done.append(err)
            print(json.dumps(dict(self.primary, extra_metrics=done,
                                  telemetry=tracer.snapshot())), flush=True)
            os._exit(0)
        print(json.dumps(dict(err, metric=PRIMARY_METRIC)), flush=True)
        os._exit(3)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="The port's headline benchmarks: one JSON line")
    p.add_argument("--device", type=str, default=None,
                   help="the card by default; 'cpu' runs the plain PyTorch "
                        "path (no MFU, no peak memory)")
    args = p.parse_args(argv)
    from dear_pytorch_tpu_torch._device import resolve_device
    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.observability import tracer

    before = tracer._tracer       # put back on return (an embedding caller)
    if os.environ.get(tracer.TELEMETRY_ENV) is None:
        # default-on, counters only (memory=False: no span records — the
        # timed loops must accumulate nothing) so the line always carries
        # a telemetry block; an explicit DEAR_TELEMETRY value — including
        # an explicit disable — is honoured as it is
        tracer.configure(memory=False)
    try:
        return _main(args)
    finally:
        tracer.set_tracer(before)


def _main(args) -> int:
    from dear_pytorch_tpu_torch._device import resolve_device
    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.observability import tracer

    proto = Protocol.from_env()
    owned = not backend.is_initialized()    # shut down only our own group
    try:
        resolve_device(args.device)
        group = backend.init(args.device)
    except Exception as exc:
        print(json.dumps({"metric": PRIMARY_METRIC,
                          "error": f"backend unavailable: "
                                   f"{type(exc).__name__}: {exc}"[:300]}),
              flush=True)
        return 2
    dev = backend.device()
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    _log(f"bench: {'smoke ' if proto.smoke else ''}run on {dev}")
    dog = _Watchdog()
    dog.arm("resnet", PRIMARY_METRIC)
    try:
        resnet = bench_resnet(group, dev, proto)
    except BaseException:
        dog.disarm()
        raise
    dog.primary = resnet
    gc.collect()
    _log(f"bench: {json.dumps(resnet)}")
    runs = [("bert_base_sen_sec_per_chip", True,
             lambda: bench_bert(group, dev, proto)),
            ("bert_large_sen_sec_per_chip",
             _env_enabled("DEAR_BENCH_BERT_LARGE"),
             lambda: bench_bert(group, dev, proto, "bert")),
            ("vit_b16_bs64_train_img_sec_per_chip",
             _env_enabled("DEAR_BENCH_VIT"),
             lambda: bench_vit(group, dev, proto)),
            ("gpt2_s1024_tok_sec_per_chip", _env_enabled("DEAR_BENCH_GPT"),
             lambda: bench_gpt(group, dev, proto))]
    extras = dog.extras
    for metric, on, fn in runs:
        if on:
            dog.arm(metric.split("_")[0], metric)
            extras.append(_secondary(metric, fn))
            _log(f"bench: {json.dumps(extras[-1])}")
    dog.disarm()
    print(json.dumps(dict(resnet, extra_metrics=extras,
                          telemetry=tracer.snapshot())), flush=True)
    if owned:
        backend.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
