"""Shared benchmark runner — the port of what
``dear_pytorch_tpu/benchmarks/runner.py`` gives the GPT CLI: the
reference's measurement protocol (``num_warmup_batches`` untimed steps,
then ``num_iters`` timed runs of ``num_batches_per_iter`` steps, a
throughput per run and the mean ± 1.96σ), the common flags, the flags
-> `DearConfig` mapping, and ``--mfu``'s accounting: `step_flops` counts
one training step's FLOPs and `log_mfu` logs the model FLOP utilisation.

XLA's cost analysis (the JAX runner's ``step_flops``) has no torch analog:
`step_flops` runs one real step under ``torch.utils.flop_counter.
FlopCounterMode`` (its matmuls, convolutions and attention, forward and
backward; elementwise work is not counted) and adds
`ops.flash_attention.flash_flops`, what the hand-written attention
kernels launched in that step count for their plain versions (a ``ctypes``
launch is invisible to the mode; on the CPU the plain versions run and are
counted by the mode itself). The MFU is against the card's dense bf16 peak
(`PEAK_FLOPS`); on the CPU, or a card without a known peak, it is None, as
the JAX package's ``perf_model.mfu`` is for an unknown device.

Only the flags the port carries are registered: an unported flag of the
JAX CLI would be an argparse error, not silently ignored (every flag of
the JAX CLIs is carried since slice 20). Every ``--mode`` of the JAX CLI
builds (the baselines and ``fsdp`` since slice 13, with ``--partition``
and ``--exclude-parts``),
and so do ``--optimizer lamb``, the compression flags (``--compressor``,
``--density``, ``--momentum-correction``, ``--gtopk``: on ``allreduce``
and ``dear``, the JAX runner's rule and warnings) and ``--remat-policy``
(slice 14).

Since slice 15 the train step comes from `build_stepper` (JAX
runner.py:717), the one construction path: ``--autotune {bo,wait_time,
plan}`` drives a `tuning.autotune.AutoTuner` (``--tune-steps`` steps of
it before the timed protocol: `run_pretune`), ``--mgwfbp`` builds the
MG-WFBP plan from a measured α-β fit of the group's all-reduce. The timed
loop comes from `make_step_source`: ``--scan-steps k`` runs k steps per
call through `parallel.dear.TrainStep.multi_step` on the one batch
(warmup and iteration counts become calls by ceiling division, and
`run_timed`'s ``steps_per_call`` keeps every reported time per step). The
combinations JAX refuses are refused with its messages
(`validate_scan_steps`, `build_stepper`).

Since slice 16 the timed loop streams its batches (JAX runner.py:420-492):
``--pipeline none`` re-feeds the one constant batch (the reference's
fixed-fake-data protocol), ``native`` draws a fresh global batch per step
from the C++ producers (`runtime.pipeline.Pipeline`; refused when the
library cannot be built) and ``numpy`` from `runtime.pipeline.
NumpyPipeline` (`make_batch_source`). Every rank draws the same global
batch from the same stream and stages only its own slice
(`stage_global`): cast to the constant batch's dtypes on the host, so
under ``--fp16`` an fp32 image crosses as bf16, into pinned host memory
and to the card without blocking (`PinnedStager`). ``--metrics-file``
writes one JSONL record per timed run and a summary (`utils.metrics.
MetricsLogger`), ``--profile-dir`` a ``torch.profiler`` trace of the timed
runs, and with ``DEAR_TELEMETRY`` on `run_timed` prints the tracer's
snapshot as one ``TELEMETRY {...}`` line (the sweep driver scrapes it) and
logs it to the metrics file.

Since slice 20 the GPT and BERT CLIs train with sequence parallelism
(``--sp-degree``): `build_sp_groups` lays the world out as dp x sp (the
JAX runner's `build_sp_mesh`, runner.py:393-417, with its three
refusals), and `train_timed` with ``sp > 1`` gives each rank its rows (by
dp index) and columns (by sp index) of the global batch
(`parallel.sp.shard_sp_batch`), builds the step with ``mean_axes=("dp",)``
and reports sequences per rank as the global batch over the world (JAX's
``batch_size / sp``: each sequence spans sp ranks).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from dear_pytorch_tpu_torch.comm import backend

__all__ = ["BenchResult", "PEAK_FLOPS", "PinnedStager", "add_common_args",
           "build_sp_groups", "build_stepper", "config_from_args",
           "device_name", "log",
           "log_mfu", "make_batch_source", "make_step_source",
           "metrics_from_args", "mfu", "parse_exclude_parts", "peak_flops",
           "run_pretune", "run_timed", "stage_global", "step_flops",
           "threshold_mb", "train_timed", "validate_scan_steps"]

#: dense bf16 peak FLOP/s of a card, by a part of its name (NVIDIA's data
#: sheet: the H100 SXM); the PCIe card's is lower and not listed
PEAK_FLOPS = {"H100 80GB HBM3": 989e12}


@dataclasses.dataclass
class BenchResult:
    unit: str                  # 'sen' (sequences) here
    device: str                # 'GPU' or 'CPU'
    world: int
    per_device_mean: float
    per_device_conf: float     # 1.96 sigma
    iter_time_mean: float      # seconds per step
    iter_time_conf: float
    per_iter: list = dataclasses.field(default_factory=list)
    #: seconds per step of each timed run
    iter_times: list = dataclasses.field(default_factory=list)
    #: FLOPs of one step (`step_flops`; with ``count_flops`` only)
    flops_per_step: Optional[float] = None

    @property
    def total_mean(self) -> float:
        return self.world * self.per_device_mean

    @property
    def total_conf(self) -> float:
        return self.world * self.per_device_conf


def log(s: str, nl: bool = True) -> None:
    """Rank-0 printing."""
    if backend.rank() != 0:
        return
    print(s, end="\n" if nl else "", flush=True)


def device_name(device: Optional[torch.device] = None) -> str:
    dev = device or backend.device()
    return {"cuda": "GPU", "cpu": "CPU"}.get(dev.type, dev.type.upper())


def peak_flops(device: torch.device) -> Optional[float]:
    """The dense bf16 peak FLOP/s of ``device`` (`PEAK_FLOPS`), or None."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((peak for key, peak in PEAK_FLOPS.items() if key in name),
                None)


def mfu(flops: Optional[float], secs_per_step: float,
        device: torch.device) -> Optional[float]:
    """Achieved FLOP/s over the device's peak; None without a peak, a FLOP
    count or a time."""
    peak = peak_flops(device)
    if not peak or not flops or secs_per_step <= 0:
        return None
    return flops / secs_per_step / peak


def step_flops(step_fn: Callable[[], Any]) -> float:
    """FLOPs of one call of ``step_fn`` (one training step, which it runs):
    ``FlopCounterMode``'s count of the ops it dispatches plus what the
    flash-attention kernels it launches add to
    `ops.flash_attention.flash_flops`."""
    from torch.utils.flop_counter import FlopCounterMode

    from dear_pytorch_tpu_torch.ops import flash_attention as FA

    before = FA.flash_flops
    with FlopCounterMode(display=False) as counter:
        step_fn()
    return float(counter.get_total_flops() + FA.flash_flops - before)


def log_mfu(result: BenchResult,
            device: Optional[torch.device] = None) -> Optional[float]:
    """Log the achieved FLOP/s and the MFU of ``result`` (a `run_timed`
    result with ``count_flops``; its step time is the timed mean)."""
    dev = device or backend.device()
    flops, secs = result.flops_per_step, result.iter_time_mean
    value = mfu(flops, secs, dev)
    achieved = flops / secs if flops and secs else 0.0
    if value:
        log(f"MFU: {100 * value:.1f}% ({flops / 1e9:.2f} GFLOP/step, "
            f"{achieved / 1e12:.1f} TFLOP/s)")
    else:
        log(f"FLOP/step: {(flops or 0.0) / 1e9:.2f} GFLOP "
            f"({achieved / 1e12:.2f} TFLOP/s; peak unknown for "
            f"{device_name(dev)})")
    return value


def run_timed(step_fn: Callable[[], Any], *, batch_size: int,
              num_warmup_batches: int = 10, num_batches_per_iter: int = 10,
              num_iters: int = 5, unit: str = "sen",
              sync: Optional[Callable[[], None]] = None,
              world: Optional[int] = None, device: Optional[str] = None,
              count_flops: bool = False, steps_per_call: int = 1,
              metrics=None,
              profile_dir: Optional[str] = None) -> BenchResult:
    """The warmup + timed-iteration protocol around ``step_fn`` (one
    call, enqueued asynchronously on the card); ``sync`` blocks until the
    enqueued work is done (pass one: on the card,
    ``torch.cuda.synchronize``). ``steps_per_call``: the training steps
    one call runs (the scanned protocol; ``batch_size`` is then the items
    per call), so the reported step times stay per step. ``count_flops``:
    the first warmup call runs under `step_flops` (with no warmup, one
    extra untimed call does), and the result carries ``flops_per_step``
    (the call's count over ``steps_per_call``). ``metrics`` (a
    `utils.metrics.MetricsLogger`) gets one record per timed run and a
    summary; ``profile_dir`` gets a ``torch.profiler`` trace of the timed
    runs (``trace_rank<r>.json``, the card's kernels too). With the tracer
    on (``DEAR_TELEMETRY``), its snapshot is printed as one ``TELEMETRY
    {...}`` line and logged to ``metrics`` (JAX runner.py:230-240)."""
    dev = device or device_name()
    world = backend.size() if world is None else world
    steps_per_call = max(int(steps_per_call), 1)
    # opt-in per-iteration hang guard (JAX runner.py:130-141):
    # DEAR_STEP_WATCHDOG_SECS is the deadline one timed iteration must
    # finish within; past it the watchdog dumps the open spans and every
    # thread's stack and exits with the last completed iteration number.
    # It arms at the first timed iteration's beat: the warmup (the
    # kernels' first builds) stays under bench's phase watchdog.
    dog_secs = float(os.environ.get("DEAR_STEP_WATCHDOG_SECS", "0"))
    dog = None
    if dog_secs > 0:
        from dear_pytorch_tpu_torch.resilience.watchdog import StepWatchdog

        dog = StepWatchdog(dog_secs, name="bench-step-watchdog").start()
    try:
        return _run_timed(step_fn, dog, batch_size=batch_size,
                          num_warmup_batches=num_warmup_batches,
                          num_batches_per_iter=num_batches_per_iter,
                          num_iters=num_iters, unit=unit, sync=sync,
                          world=world, dev=dev, count_flops=count_flops,
                          steps_per_call=steps_per_call, metrics=metrics,
                          profile_dir=profile_dir)
    finally:
        if dog is not None:
            dog.stop()


def _run_timed(step_fn, dog, *, batch_size, num_warmup_batches,
               num_batches_per_iter, num_iters, unit, sync, world, dev,
               count_flops, steps_per_call, metrics, profile_dir):
    log("Running warmup...")
    flops = (step_flops(step_fn) / steps_per_call if count_flops
             else None)
    for _ in range(num_warmup_batches - int(count_flops
                                            and num_warmup_batches > 0)):
        step_fn()
    if sync is not None:
        sync()
    log("Running benchmark...")
    prof = _start_profile(profile_dir)
    per_iter, iter_times = [], []
    try:
        for x in range(num_iters):
            if dog is not None:
                dog.beat(phase="timed", iter=x)
            t0 = time.perf_counter()
            for _ in range(num_batches_per_iter):
                step_fn()
            if sync is not None:
                sync()
            dt = time.perf_counter() - t0
            thr = batch_size * num_batches_per_iter / dt
            log(f"Iter #{x}: {thr:.1f} {unit}/sec per {dev}")
            per_iter.append(thr)
            # per training step, whatever the calls' shape
            step_time_s = dt / (num_batches_per_iter * steps_per_call)
            iter_times.append(step_time_s)
            if metrics is not None:
                metrics.log(iter=x, **{f"{unit}_per_sec_per_device": thr},
                            step_time_s=step_time_s)
    finally:
        _stop_profile(prof, profile_dir)
    res = BenchResult(
        unit=unit, device=dev, world=world,
        per_device_mean=float(np.mean(per_iter)),
        per_device_conf=float(1.96 * np.std(per_iter)),
        iter_time_mean=float(np.mean(iter_times)),
        iter_time_conf=float(1.96 * np.std(iter_times)),
        per_iter=per_iter, iter_times=iter_times, flops_per_step=flops)
    log(f"Iteration time: {res.iter_time_mean:.3f} +-{res.iter_time_conf:.3f}")
    log(f"{unit.capitalize()}/sec per {dev}: "
        f"{res.per_device_mean:.1f} +-{res.per_device_conf:.1f}")
    log(f"Total {unit}/sec on {res.world} {dev}(s): "
        f"{res.total_mean:.1f} +-{res.total_conf:.1f}")
    if metrics is not None:
        metrics.log(summary=True, world=res.world, unit=unit,
                    per_device_mean=res.per_device_mean,
                    per_device_conf=res.per_device_conf,
                    iter_time_mean=res.iter_time_mean)
    # the telemetry block: one line the sweep driver scrapes into
    # reports.json, and one JSONL record (the snapshot travels as a JSON
    # string: metrics records hold scalars)
    from dear_pytorch_tpu_torch.observability import tracer as _tracer

    snap = _tracer.snapshot()
    if snap["enabled"]:
        log("TELEMETRY " + json.dumps(snap))
        if metrics is not None:
            metrics.log(kind="telemetry", telemetry=json.dumps(snap))
    return res


def _start_profile(profile_dir: Optional[str]):
    """A started ``torch.profiler`` session (the card's activity too when
    there is one), or None without ``profile_dir``."""
    if not profile_dir:
        return None
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and backend.device().type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: Optional[str]) -> None:
    if prof is None:
        return
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_rank{backend.rank()}.json")
    prof.export_chrome_trace(path)
    log(f"Profile: {path}")


def metrics_from_args(args):
    """`utils.metrics.MetricsLogger` for ``--metrics-file`` (None when
    unset); the one construction point the CLIs share (JAX
    runner.py:420)."""
    if not getattr(args, "metrics_file", None):
        return None
    from dear_pytorch_tpu_torch.utils.metrics import MetricsLogger

    return MetricsLogger(args.metrics_file)


class PinnedStager:
    """Host-to-device staging of host batches through pinned memory.

    Each call fills one of ``slots`` sets of pinned host buffers (one per
    field, cast to the field's target dtype by the copy into it) and
    enqueues each buffer's copy to ``device`` with ``non_blocking=True``
    on the current stream, into a fresh device tensor, then records an
    event after the copies. A slot is filled again only once the event of
    its previous copies has completed: refilling a pinned buffer while its
    copy is in flight would hand the card another batch's bytes. On the
    CPU the copies are plain (synchronous) copies into fresh tensors and
    nothing is pinned. What a call returns never aliases a slot."""

    def __init__(self, device, slots: int = 2):
        self.device = torch.device(device)
        self.slots = max(int(slots), 1)
        self._cuda = self.device.type == "cuda"
        self._bufs = [dict() for _ in range(self.slots)]
        self._events = [None] * self.slots
        self._next = 0

    def _buffer(self, slot: int, name: str, shape, dtype) -> torch.Tensor:
        buf = self._bufs[slot].get(name)
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype, pin_memory=self._cuda)
            self._bufs[slot][name] = buf
        return buf

    def __call__(self, host: dict, dtypes: dict) -> dict:
        """``{name: tensor on device}`` from ``{name: array}`` (numpy or
        CPU tensors), each in ``dtypes[name]``."""
        slot = self._next
        self._next = (slot + 1) % self.slots
        event = self._events[slot]
        if event is not None:
            event.synchronize()
        out = {}
        for name, arr in host.items():
            src = arr if isinstance(arr, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(arr))
            buf = self._buffer(slot, name, src.shape, dtypes[name])
            buf.copy_(src)              # the host cast, into pinned memory
            dst = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
            dst.copy_(buf, non_blocking=self._cuda)
            out[name] = dst
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
            self._events[slot] = event
        return out


def stage_global(host: dict, stager: PinnedStager, dtypes: dict, *,
                 rank: int = 0, world: int = 1) -> dict:
    """This rank's slice of a host-replicated GLOBAL batch, on the card:
    rows ``[rank·B, (rank+1)·B)`` of every field (B = the global rows over
    ``world``), staged by ``stager`` in ``dtypes`` — the torch form of JAX
    runner.py:430's multi-host protocol, where every process holds the
    same full array and materialises only its addressable shards."""
    out = {}
    for name, arr in host.items():
        per = arr.shape[0] // world
        out[name] = arr[rank * per:(rank + 1) * per]
    return stager(out, dtypes)


def make_batch_source(args, spec, template_batch: dict, *, rank: int = 0,
                      world: int = 1, device=None,
                      layout: Optional[Callable[[dict], dict]] = None):
    """``(next_batch, pipeline, close)`` for the timed loop, honouring
    ``--pipeline`` (JAX runner.py:452). 'none' returns ``template_batch``
    (this rank's constant batch) every step, with no pipeline. 'native'
    and 'numpy' draw a fresh global batch of ``spec`` per step from
    `runtime.pipeline.Pipeline` (refused when the native library cannot
    be built: JAX runner.py:469-474) or `NumpyPipeline`, seed 0, and stage
    this rank's slice in the template's dtypes (`stage_global`);
    ``layout`` then maps the staged fields to the model's layout on the
    card (the ImageNet CLI's NHWC -> NCHW permute)."""
    if args.pipeline == "none":
        return (lambda: template_batch), None, (lambda: None)
    from dear_pytorch_tpu_torch.runtime import build as RB
    from dear_pytorch_tpu_torch.runtime import pipeline as RP

    if args.pipeline == "native":
        if not RP.native_available():
            raise SystemExit(
                "--pipeline native: the native runtime library is not "
                f"available ({RB.load_error()})")
        pl = RP.Pipeline(spec)
    else:
        pl = RP.NumpyPipeline(spec)
    dtypes = {k: v.dtype for k, v in template_batch.items()}
    stager = PinnedStager(device if device is not None else
                          next(iter(template_batch.values())).device)

    def next_batch():
        batch = stage_global(pl.next(), stager, dtypes, rank=rank,
                             world=world)
        return layout(batch) if layout is not None else batch

    return next_batch, pl, pl.close


def build_sp_groups(sp: int, seq_len: int, pipeline: str,
                    seq_flag: str = "--sentence-len"):
    """The dp x sp layout of a sequence-parallel CLI run over the world
    (`comm.backend.form_sp_groups`), after the JAX runner's refusals and
    messages (`build_sp_mesh`, runner.py:393-417); returns this rank's sp
    group. The group must exist (`comm.backend.init`)."""
    world = backend.size()
    if world % sp:
        raise SystemExit(f"--sp-degree {sp} does not divide the "
                         f"{world}-device world")
    if seq_len % sp:
        raise SystemExit(f"{seq_flag} {seq_len} must divide by "
                         f"--sp-degree {sp}")
    if pipeline != "none":
        raise SystemExit("--pipeline streaming is dp-only; use "
                         "--pipeline none with --sp-degree")
    return backend.form_sp_groups(sp)


def train_timed(args, model, batch: dict, loss_fn: Callable, *, group,
                unit: str, header: list,
                on_step: Optional[Callable] = None, spec=None,
                layout: Optional[Callable[[dict], dict]] = None,
                metrics=None, sp: int = 1) -> BenchResult:
    """What the CLIs share once they have a model, the global ``batch`` and
    ``loss_fn(model, batch, generator)``: rank 0's parameters broadcast,
    this rank's slice of the batch, the train step from the flags
    (`config_from_args`, `build_stepper`: the `tuning.autotune.AutoTuner`
    with ``--autotune``, the MG-WFBP plan with ``--mgwfbp``), the
    ``header`` lines and the group's size and schedule logged, the
    autotuner's pre-tuning (`run_pretune`), then `run_timed` over
    `make_step_source`'s calls (``--scan-steps``: `TrainStep.multi_step`;
    ``--mfu``: the counted call and `log_mfu`). Returns the `BenchResult`
    with the per-call losses (the last step's of each call; floats, read
    once after the run) as ``.losses``, the live train step as
    ``.train_step``, what the loop drove (the train step or the
    autotuner) as ``.stepper``, its last state as ``.state``, this
    rank's constant batch as ``.batch`` and the input pipeline the loop
    drew from (None under ``--pipeline none``) as ``.pipeline``.
    ``on_step(train_step, state, metrics)`` is called after every
    timed-protocol call (warmup included) with the live train step. The
    steps stream their batches from `make_batch_source` (``spec``: the
    pipeline's global batch; ``layout``: its map to the model's layout),
    and run on ``group``, whose size is the world reported. ``metrics``:
    a `utils.metrics.MetricsLogger` to log to (the caller closes it);
    else one for ``--metrics-file``, closed here. ``sp > 1``: the run is
    sequence-parallel over `build_sp_groups`' layout (module docstring):
    this rank's rows and columns of the batch, ``mean_axes=("dp",)``, the
    world in the group-size line as ``dp x sp``."""
    import torch.distributed as dist

    from dear_pytorch_tpu_torch.api import broadcast_parameters

    scan_steps = validate_scan_steps(args)
    dev = backend.device()
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    broadcast_parameters(model, group=group)   # parameters and buffers
    B = args.batch_size
    extra = {}
    if sp > 1:
        from dear_pytorch_tpu_torch.parallel.sp import shard_sp_batch

        batch = shard_sp_batch(batch)
        extra = {"mean_axes": (backend.DP_AXIS,)}
    else:
        batch = {k: v[rank * B:(rank + 1) * B] for k, v in batch.items()}
    dear_cfg = config_from_args(args, world=world // sp)
    ts, stepper = build_stepper(dear_cfg, loss_fn, model, group=group,
                                device=dev, mgwfbp=args.mgwfbp, **extra)
    holder = {"state": stepper.init(), "metrics": None, "batch": batch}
    for line in header + [
            f"Number of {device_name(dev)}s: {world}"
            + (f" (dp {world // sp} x sp {sp})" if sp > 1 else ""),
            f"Schedule: {args.mode}; fusion: {ts.plan.num_buckets} "
            "bucket(s)"]:
        log(line)

    next_batch, pipeline, close = make_batch_source(
        args, spec, batch, rank=rank, world=world, device=dev,
        layout=layout)
    del ts   # the autotuner may replace it: keep only the live one
    metrics_log = metrics_from_args(args) if metrics is None else metrics
    try:
        run_pretune(args, stepper, holder, next_batch)
        call, protocol = make_step_source(args, scan_steps,
                                          getattr(stepper, "ts", stepper),
                                          stepper, holder, next_batch)
        # sequences per RANK per step: with sp, each spans sp ranks
        protocol["batch_size"] = protocol["batch_size"] / sp
        losses = []

        def step_fn():
            call()
            losses.append(holder["metrics"]["loss"])
            if on_step is not None:
                on_step(getattr(stepper, "ts", stepper), holder["state"],
                        holder["metrics"])

        result = run_timed(
            step_fn, unit=unit,
            sync=torch.cuda.synchronize if dev.type == "cuda" else None,
            world=world, device=device_name(dev), count_flops=args.mfu,
            metrics=metrics_log, profile_dir=args.profile_dir, **protocol)
    finally:
        if metrics_log is not None and metrics is None:
            metrics_log.close()
        close()
    if args.mfu:
        log_mfu(result, dev)
    result.losses = [float(x) for x in losses]
    result.train_step = getattr(stepper, "ts", stepper)
    result.stepper, result.state, result.batch = (stepper, holder["state"],
                                                  batch)
    result.pipeline = pipeline
    return result


def validate_scan_steps(args) -> int:
    """Resolve ``--scan-steps`` (JAX runner.py:617); call it right after
    ``parse_args`` so a refused combination fails before anything is
    built."""
    k = int(getattr(args, "scan_steps", 1) or 1)
    if k <= 1:
        return 1
    if getattr(args, "pipeline", "none") != "none":
        raise SystemExit("--scan-steps re-feeds one constant batch inside "
                         "the scanned program; incompatible with --pipeline")
    if args.autotune:
        raise SystemExit("--scan-steps and --autotune are incompatible "
                         "(the tuner re-buckets between steps)")
    return k


def _ceil_div_keep_zero(n: int, k: int) -> int:
    return -(-n // k) if n > 0 else 0


def make_step_source(args, scan_steps: int, ts, stepper, holder,
                     next_batch):
    """(step_fn, run_timed protocol kwargs) honoring ``--scan-steps``
    (JAX runner.py:636). Scanned mode runs ``scan_steps`` steps per call
    (`TrainStep.multi_step`) on the constant batch in ``holder['batch']``;
    warmup/iteration counts convert to calls by ceiling division (a zero
    warmup stays zero)."""
    if scan_steps > 1:
        log(f"Scanned protocol: {scan_steps} steps per dispatch")
        runner_fn = ts.multi_step(scan_steps)

        def step_fn():
            holder["state"], holder["metrics"] = runner_fn(
                holder["state"], holder["batch"])
    else:
        def step_fn():
            holder["state"], holder["metrics"] = stepper.step(
                holder["state"], next_batch())

    kwargs = dict(
        batch_size=args.batch_size * scan_steps,
        num_warmup_batches=_ceil_div_keep_zero(
            args.num_warmup_batches, scan_steps),
        num_batches_per_iter=max(
            _ceil_div_keep_zero(args.num_batches_per_iter, scan_steps), 1),
        num_iters=args.num_iters,
        steps_per_call=scan_steps,
    )
    return step_fn, kwargs


def run_pretune(args, stepper, holder, next_batch) -> int:
    """Tune-then-measure (JAX runner.py:673): drive the autotuner to
    convergence BEFORE the warmup/timed protocol, so the timed region
    measures the CONVERGED configuration. Returns the steps spent.
    ``--tune-steps`` sets the budget; by default only the 'plan' strategy
    pre-tunes (its tuner's ``budget_steps``), bo and wait_time tune while
    measuring unless ``--tune-steps`` is given."""
    if not getattr(args, "autotune", None):
        return 0
    tuner = getattr(stepper, "tuner", None)
    n = getattr(args, "tune_steps", None)
    if n is None:
        if args.autotune != "plan":
            return 0
        n = getattr(tuner, "budget_steps", 0) if tuner is not None else 0
    n = int(n)
    if n <= 0:
        return 0
    log(f"Pre-tuning: up to {n} steps "
        "(tune-then-measure; the timed region runs the converged config)")
    for _ in range(n):
        holder["state"], holder["metrics"] = stepper.step(
            holder["state"], next_batch())
        if tuner is not None and getattr(tuner, "finished", False):
            break
    planner = getattr(stepper, "planner", None)
    if planner is not None:
        if planner.finished:
            log(f"Converged plan config: {planner.current.describe()}")
        else:
            log(f"Plan tuner NOT converged after {n} pre-tune steps; "
                f"current trial config: {planner.current.describe()} "
                "(timed region may include further trials)")
        log("TUNE_SUMMARY " + json.dumps(planner.summary()))
    return n


def build_stepper(cfg, loss_fn, model, *, group, device, model_state=None,
                  mgwfbp: bool = False, **extra):
    """(train_step, stepper) from a `DearConfig` — the one construction
    path the CLIs share (JAX runner.py:717). ``stepper.step(state,
    batch)`` is what the timed loop calls: a `tuning.autotune.AutoTuner`
    when ``cfg.autotune`` is set (its live step is ``stepper.ts``), else
    the `TrainStep` itself. ``mgwfbp``: the MG-WFBP plan
    (`tuning.mgwfbp.plan_mgwfbp`) from a measured α-β fit of the group's
    all-reduce (`utils.profiling.CommunicationProfiler`; kept as the
    step's ``alpha_beta``) and the layers' estimated backward times.
    ``extra`` goes to `parallel.dear.build_train_step`."""
    from dear_pytorch_tpu_torch.parallel.dear import build_train_step

    if mgwfbp and cfg.autotune:
        raise SystemExit("--mgwfbp and --autotune are mutually exclusive: "
                         "both own the fusion plan")
    kwargs = dict(cfg.build_kwargs(), group=group, device=device,
                  model_state_template=model_state, **extra)
    if cfg.autotune:
        from dear_pytorch_tpu_torch.tuning import AutoTuner

        tuned = AutoTuner(
            loss_fn, model,
            strategy=cfg.autotune,
            threshold_mb=cfg.threshold_mb or 25.0,
            bound=cfg.bo_bound, max_trials=cfg.bo_trials,
            interval=cfg.bo_interval, cycle_time_s=cfg.cycle_time_s,
            log=log, **kwargs,
        )
        return tuned.ts, tuned

    plan = fit = None
    if mgwfbp:
        import torch.distributed as dist

        from dear_pytorch_tpu_torch.tuning import (
            estimate_layer_backward_times,
            plan_mgwfbp,
        )
        from dear_pytorch_tpu_torch.utils.profiling import (
            CommunicationProfiler,
        )

        fit = CommunicationProfiler(group, device=device).fit(
            sizes=[2 ** k for k in range(10, 21, 2)], repeats=3)
        log(f"MG-WFBP: measured alpha={fit[0]:.2e}s beta={fit[1]:.2e}s/B")
        plan = plan_mgwfbp(
            model, dist.get_world_size(group),
            layer_times=estimate_layer_backward_times(model),
            alpha=fit[0], beta=fit[1])
        log(f"MG-WFBP plan: {plan.num_buckets} buckets")

    ts = build_train_step(
        loss_fn, model,
        threshold_mb=cfg.threshold_mb,
        nearby_layers=cfg.nearby_layers,
        flags=cfg.flags,
        plan=plan,
        **kwargs,
    )
    ts.alpha_beta = fit
    return ts, ts


def add_common_args(parser) -> None:
    """The flags of the JAX CLIs that the port carries."""
    parser.add_argument("--fp16", action="store_true", default=False,
                        help="bfloat16 compute; gradients travel in bf16")
    parser.add_argument("--batch-size", type=int, default=32,
                        help="input batch size PER RANK")
    parser.add_argument("--num-warmup-batches", type=int, default=10)
    parser.add_argument("--num-batches-per-iter", type=int, default=10)
    parser.add_argument("--num-iters", type=int, default=5)
    parser.add_argument("--mode", type=str, default="dear",
                        choices=["dear", "dear-fused", "allreduce", "rsag",
                                 "rb", "bytescheduler", "fsdp"],
                        help="communication schedule ('dear'; "
                             "'dear-fused' = dear with the ring kernels; "
                             "the baselines 'allreduce', 'rsag', 'rb', "
                             "'bytescheduler'; 'fsdp' = ZeRO-3, "
                             "re-gather in backward)")
    parser.add_argument("--partition", type=float, default=4.0,
                        help="bytescheduler partition size in MB "
                             "(reference bytescheduler --partition, "
                             "imagenet_benchmark.py:37-38)")
    parser.add_argument("--pipeline", type=str, default="none",
                        choices=["none", "native", "numpy"],
                        help="input pipeline: 'none' re-feeds one "
                             "pre-generated batch (the reference's "
                             "fixed-fake-data protocol); 'native' streams "
                             "fresh batches from the C++ ring-buffer "
                             "producers (csrc/dear_runtime.cpp, built at "
                             "first use); 'numpy' from the pure-numpy "
                             "pipeline; staged through pinned memory")
    parser.add_argument("--threshold", type=float, default=25.0,
                        help="tensor-fusion threshold in MB; <= 0: one "
                             "bucket")
    parser.add_argument("--exclude-parts", type=str, default="",
                        help="comma list of {reducescatter,allgather} "
                             "(time-breakdown ablations of --mode dear, "
                             "dear/batch.sh)")
    parser.add_argument("--nearby-layers", type=int, default=None,
                        help="fuse every k layers instead of by threshold")
    parser.add_argument("--compressor", type=str, default="none",
                        help="gradient compressor (reference "
                             "dear/compression.py registry, and qint8)")
    parser.add_argument("--density", type=float, default=1.0,
                        help="sparsification density for topk-family "
                             "compressors")
    parser.add_argument("--momentum-correction", type=float, default=0.0,
                        help="DGC-style momentum correction coefficient "
                             "for sparse compressed training (disables "
                             "the optimizer's momentum while active)")
    parser.add_argument("--gtopk", action="store_true", default=False,
                        help="gTop-k recursive-halving sparse allreduce "
                             "(with a top-k-family --compressor)")
    parser.add_argument("--remat-policy", type=str, default=None,
                        choices=["none", "full"],
                        help="recompute the whole forward in the backward "
                             "at the train-step level (a checkpoint around "
                             "the loss); the GPT CLI's --remat checkpoints "
                             "per block instead")
    parser.add_argument("--mgwfbp", action="store_true", default=False,
                        help="analytic MG-WFBP bucket sizing: measure the "
                             "group's alpha-beta, estimate layer times, "
                             "merge buckets per the INFOCOM'19 model "
                             "(reference wfbp/dopt.py:380-486)")
    parser.add_argument("--autotune", type=str, default=None,
                        choices=["bo", "wait_time", "plan"],
                        help="runtime fusion tuning: Bayesian optimization "
                             "over the threshold (reference dopt_rsag_bo), "
                             "wait-time split flags (dopt_rsag_wt), or "
                             "'plan' — the plan-space search over fusion x "
                             "compression x wire dtypes x mode x remat "
                             "(restrict axes via DEAR_TUNE_* env)")
    parser.add_argument("--tune-steps", type=int, default=None,
                        help="drive the autotuner for this many steps "
                             "BEFORE the timed protocol (tune-then-"
                             "measure). Default: the tuner's full trial "
                             "budget for --autotune plan, 0 for bo/"
                             "wait_time (they tune while measuring)")
    parser.add_argument("--accum-steps", type=int, default=1,
                        help="gradient accumulation microbatches per step")
    parser.add_argument("--scan-steps", type=int, default=1,
                        help="run k train steps per call on one batch "
                             "(TrainStep.multi_step); no --autotune")
    parser.add_argument("--base-lr", type=float, default=0.01)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--optimizer", type=str, default="sgd",
                        choices=["sgd", "adamw", "lamb"],
                        help="shard optimizer (adamw: torch semantics; "
                             "lamb: exact per-parameter trust ratios on "
                             "the shards); betas, eps and weight decay "
                             "via DEAR_ADAM_BETAS, DEAR_ADAM_EPS, "
                             "DEAR_WEIGHT_DECAY")
    parser.add_argument("--clip-norm", type=float, default=None,
                        help="clip gradients to this global L2 norm")
    parser.add_argument("--lr-schedule", type=str, default=None,
                        choices=["linear", "cosine", "multistep"])
    parser.add_argument("--warmup-steps", type=int, default=0)
    parser.add_argument("--total-steps", type=int, default=None)
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of the timed "
                             "region here (trace_rank<r>.json)")
    parser.add_argument("--metrics-file", type=str, default=None,
                        help="write per-iteration + summary records as "
                             "JSONL here (utils.metrics.MetricsLogger)")
    parser.add_argument("--mfu", action="store_true", default=False,
                        help="count one step's FLOPs (FlopCounterMode and "
                             "the attention kernels' counts; the first "
                             "warmup step) and log the MFU against the "
                             "card's bf16 peak")
    parser.add_argument("--device", type=str, default=None,
                        help="the card by default; 'cpu' runs the plain "
                             "PyTorch path over a gloo group")


def parse_exclude_parts(s: str) -> tuple:
    """``--exclude-parts`` -> the parts (the JAX runner's rule and
    message)."""
    parts = tuple(p.strip() for p in s.split(",") if p.strip())
    for p in parts:
        if p not in ("reducescatter", "allgather"):
            raise SystemExit(f"--exclude-parts: unknown part {p!r}")
    return parts


def threshold_mb(args) -> Optional[float]:
    return (None if args.threshold is None or args.threshold <= 0
            else float(args.threshold))


def config_from_args(args, *, world: Optional[int] = None):
    """CLI args -> `DearConfig` (``DEAR_*`` variables fill the rest): the
    JAX runner's rule (runner.py:537-615). With ``--fp16`` gradients
    travel in bf16, except in ``fsdp``, whose reduce-scatter travels in
    the gather dtype; the gathers travel in bf16 for ``dear`` and ``fsdp``
    only when world > 1 (at world 1 there is no gather traffic to halve,
    and the pre-gather cast is pure overhead). The compression flags reach
    the config on ``allreduce``, ``dear`` and ``dear-fused`` (which the
    build then refuses, loudly); the other schedules ignore them with the
    JAX runner's warning, and ``--density`` without a compressor warns."""
    import warnings

    from dear_pytorch_tpu_torch.config import DearConfig

    use_compression = (args.compressor != "none"
                       and args.mode in ("allreduce", "dear", "dear-fused"))
    if args.compressor != "none" and not use_compression:
        warnings.warn(
            f"--compressor is ignored by the {args.mode!r} schedule; "
            "use --mode allreduce or --mode dear.")
    if args.density < 1.0 and args.compressor == "none":
        warnings.warn(
            "--density without --compressor has no effect (dense gradients)")
    return DearConfig.from_env(
        mode=args.mode,
        threshold_mb=threshold_mb(args),
        nearby_layers=args.nearby_layers,
        exclude_parts=parse_exclude_parts(args.exclude_parts),
        compressor=args.compressor if use_compression else None,
        density=args.density,
        gtopk=args.gtopk and use_compression,
        momentum_correction=(args.momentum_correction if use_compression
                             else 0.0),
        optimizer_name=args.optimizer,
        lr=args.base_lr,
        momentum=args.momentum,
        clip_norm=args.clip_norm,
        **{k: v for k, v in {
            "lr_schedule": args.lr_schedule,
            "warmup_steps": args.warmup_steps,
            "total_steps": args.total_steps,
            "remat": args.remat_policy,
            "autotune": args.autotune,
        }.items() if v},
        comm_dtype=(torch.bfloat16 if args.fp16 and args.mode != "fsdp"
                    else None),
        gather_dtype=(torch.bfloat16 if args.fp16 and world != 1
                      and args.mode in ("dear", "fsdp") else None),
        rng_seed=42,
        partition_mb=args.partition,
        accum_steps=args.accum_steps,
    )
