"""Batch experiment driver (reference benchmarks.py, 176 LoC) — the port of
``dear_pytorch_tpu/benchmarks/driver.py``.

Runs the cartesian sweep {task} x {method} x {nworkers}, one run of the
port's CLI per cell (fresh processes isolate caches and device memory the
way the reference's per-config mpirun did), with:

  - resume-skip: a cell whose log already contains a scrape-able result is
    not re-run (reference benchmarks.py:86-115 via exp.log),
  - log scraping of the ``Total <unit>/sec on N <DEV>(s): mean +-ci`` lines
    (reference extract_log, benchmarks.py:119-128),
  - ``reports.json`` aggregation (benchmarks.py:142-151), including a
    ``telemetry`` block: sweep-level cell accounting plus each cell's
    ``TELEMETRY`` snapshot (printed by the runner when ``DEAR_TELEMETRY``
    is set in the environment).

Methods are schedule configurations of the SAME framework (the reference
compares separate per-directory implementations; here one --mode/--flags
switch does it):

  dear        DeAR decoupled RS+AG, 25 MB fusion       (reference dear/)
  dear-notf   DeAR without tensor fusion (per-layer)   (THRESHOLD=None mode)
  dear-bo     DeAR + Bayesian threshold tuning         (dear/dopt_rsag_bo.py)
  allreduce   bucketed all-reduce after backward       (horovod//pytorch-ddp/)
  rsag        all-reduce decomposed RS+AG inline       (wfbp/)
  rb          reduce + broadcast decomposition         (dear/dopt_rb.py)
  mgwfbp      analytic MG-WFBP bucket sizing           (mgwfbp/)
  eftopk      compressed allreduce, 1% density         (wfbp sparse path)
  bytescheduler  partitioned priority allreduce, 4 MB  (bytescheduler/)
  autotune    unified plan-space search: fusion x compression x wire
              dtype x mode x remat, converged pre-timing
  dear-fused  dear with the ring kernels (K4, the K5 ring)

A cell of N ranks is N processes of the CLI, rank r with the launcher
variables of `comm.backend` (``DEAR_NUM_PROCESSES`` N, ``DEAR_PROCESS_ID``
r, ``DEAR_COORDINATOR_ADDRESS`` a free local port, ``DEAR_LOCAL_RANK`` r,
``DEAR_LOCAL_SIZE`` N); rank 0's output is the cell's log, the others' go
beside it (``<tag>.rank<r>.log``). ``--emulate`` runs the ranks with
``--device cpu`` over gloo (JAX's ``--emulate`` ran N virtual CPU devices
in one process), ``--nworkers`` ranks per cell (8 by default, JAX's).
Without it a cell runs one rank per card, or ``--nworkers`` ranks on the
cards (ranks beyond the card count share them, over gloo).

Usage:
  python -m dear_pytorch_tpu_torch.benchmarks.driver --logdir logs \\
      --tasks resnet50:64,bert_base:8 --methods dear,allreduce \\
      --emulate --nworkers 2
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import time
from typing import Optional

METHOD_ARGS: dict[str, list[str]] = {
    "dear": ["--mode", "dear", "--threshold", "25"],
    "dear-notf": ["--mode", "dear", "--threshold", "0",
                  "--nearby-layers", "1"],
    "dear-bo": ["--mode", "dear", "--autotune", "bo"],
    # the unified plan-space autotuner: fusion threshold x compressor x
    # wire dtypes x mode x remat, tune-then-measure — the search converges
    # during the pre-timing phase and the timed region runs the CONVERGED
    # config. Restrict the searched axes per-cell via DEAR_TUNE_* env vars.
    "autotune": ["--mode", "dear", "--autotune", "plan"],
    # the hand-written ring kernels (the K5 ring: reduce-scatter with the
    # update at the last hop; K4: the ring all-gather) — A/B against
    # 'dear' with identical bucketing
    "dear-fused": ["--mode", "dear-fused", "--threshold", "25"],
    "allreduce": ["--mode", "allreduce", "--threshold", "25"],
    "rsag": ["--mode", "rsag", "--threshold", "25"],
    "rb": ["--mode", "rb", "--threshold", "25"],
    "mgwfbp": ["--mode", "dear", "--mgwfbp"],
    "eftopk": ["--mode", "allreduce", "--threshold", "25",
               "--compressor", "eftopk", "--density", "0.01"],
    "bytescheduler": ["--mode", "bytescheduler", "--threshold", "25",
                      "--partition", "4"],
    "fsdp": ["--mode", "fsdp", "--threshold", "25"],
    # time-breakdown ablations (reference dear/batch.sh:18-43)
    "dear-noag": ["--mode", "dear", "--threshold", "25",
                  "--exclude-parts", "allgather"],
    "dear-nors": ["--mode", "dear", "--threshold", "25",
                  "--exclude-parts", "reducescatter"],
    "eftopk-mc": ["--mode", "allreduce", "--threshold", "25",
                  "--compressor", "eftopk", "--density", "0.01",
                  "--momentum-correction", "0.9"],
}

#: reference sweep workloads (benchmarks.py:21-28)
DEFAULT_TASKS = "resnet50:64,densenet201:32,inceptionv4:64,bert_base:64,bert:32"

_RESULT_RE = re.compile(
    r"Total (?:img|sen)/sec on (\d+) \w+\(s\): ([\d.]+) \+-([\d.]+)"
)
# the runner's per-run telemetry snapshot (one JSON object per line,
# printed when DEAR_TELEMETRY is enabled in the cell's environment)
_TELEMETRY_RE = re.compile(r"^TELEMETRY (\{.*\})\s*$")

BERT_MODELS = ("bert", "bert_base", "bert_large")
GPT_MODELS = ("gpt2", "gpt2_medium", "gpt2_large")
#: the launcher variables a cell's ranks get (and nothing inherited)
_LAUNCH_VARS = ("DEAR_NUM_PROCESSES", "DEAR_PROCESS_ID",
                "DEAR_COORDINATOR_ADDRESS", "DEAR_LOCAL_RANK",
                "DEAR_LOCAL_SIZE", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                "JAX_COORDINATOR_ADDRESS")


def extract_log(logfile: str) -> Optional[tuple[float, float]]:
    """(mean, ci) from the last Total line, or None."""
    if not os.path.exists(logfile):
        return None
    result = None
    with open(logfile) as f:
        for line in f:
            m = _RESULT_RE.search(line)
            if m:
                result = (float(m.group(2)), float(m.group(3)))
    return result


def extract_telemetry(logfile: str) -> Optional[dict]:
    """The last TELEMETRY snapshot a cell printed, or None (cells only
    print one when DEAR_TELEMETRY is set; an unparsable line is treated
    as absent rather than sinking the sweep)."""
    if not os.path.exists(logfile):
        return None
    snap = None
    with open(logfile) as f:
        for line in f:
            m = _TELEMETRY_RE.match(line)
            if m:
                try:
                    snap = json.loads(m.group(1))
                except json.JSONDecodeError:
                    pass
    return snap


def cell_cmd(model: str, bs: int, method: str, extra: list[str]) -> list[str]:
    if model in BERT_MODELS:
        mod = "dear_pytorch_tpu_torch.benchmarks.bert"
    elif model in GPT_MODELS:
        mod = "dear_pytorch_tpu_torch.benchmarks.gpt"
    else:
        mod = "dear_pytorch_tpu_torch.benchmarks.imagenet"
    return [
        sys.executable, "-m", mod, "--model", model,
        "--batch-size", str(bs), *METHOD_ARGS[method], *extra,
    ]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _card_count() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def run_cell(cmd: list[str], nranks: int, logfile: str,
             timeout: float) -> list[int]:
    """Run ``cmd`` as ``nranks`` ranks (one without launcher variables);
    rank 0 writes ``logfile``, rank r > 0 ``<logfile stem>.rank<r>.log``.
    The first rank to fail or the deadline ends the others. Returns the
    exit codes (None for a rank killed at the deadline)."""
    base = {k: v for k, v in os.environ.items() if k not in _LAUNCH_VARS}
    addr = f"tcp://127.0.0.1:{_free_port()}"
    procs, files = [], []
    for r in range(nranks):
        env = dict(base)
        if nranks > 1:
            env.update(DEAR_NUM_PROCESSES=str(nranks),
                       DEAR_PROCESS_ID=str(r),
                       DEAR_COORDINATOR_ADDRESS=addr,
                       DEAR_LOCAL_RANK=str(r),
                       DEAR_LOCAL_SIZE=str(nranks))
        path = (logfile if r == 0 else
                logfile[:-len(".log")] + f".rank{r}.log")
        f = open(path, "w")
        files.append(f)
        procs.append(subprocess.Popen(cmd, stdout=f,
                                      stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    if timed_out:
        with open(logfile, "a") as out:
            out.write(f"\nDRIVER: timeout {timeout}s\n")
    return [p.returncode for p in procs]


def run_sweep(args) -> dict:
    tasks = []
    for spec in args.tasks.split(","):
        model, _, bs = spec.partition(":")
        tasks.append((model.strip(), int(bs or 32)))
    methods = [m.strip() for m in args.methods.split(",")]
    for m in methods:
        if m not in METHOD_ARGS:
            raise SystemExit(f"unknown method {m!r}; have {sorted(METHOD_ARGS)}")
    explicit = args.nworkers is not None
    if explicit:
        nworkers = [int(n) for n in str(args.nworkers).split(",")]
    else:
        nworkers = [8] if args.emulate else [0]
    if any(n < 1 for n in nworkers if explicit or n):
        raise SystemExit(f"--nworkers {args.nworkers}: want counts >= 1")

    os.makedirs(args.logdir, exist_ok=True)
    report: dict = {}
    telemetry: dict = {"cells_run": 0, "cells_skipped": 0,
                       "cells_failed": 0, "per_cell": {}}
    for model, bs in tasks:
        for method in methods:
            for nw in nworkers:
                tag = f"{model}-bs{bs}-{method}" + (f"-n{nw}" if nw else "")
                logfile = os.path.join(args.logdir, tag + ".log")
                prior = extract_log(logfile)
                if prior is not None:
                    print(f"[skip] {tag}: {prior[0]:.1f} (from log)")
                    telemetry["cells_skipped"] += 1
                else:
                    extra = ["--num-warmup-batches", str(args.warmup),
                             "--num-batches-per-iter", str(args.batches),
                             "--num-iters", str(args.iters)]
                    if args.emulate:
                        extra += ["--device", "cpu"]
                    if args.extra_args:
                        extra += args.extra_args.split()
                    cmd = cell_cmd(model, bs, method, extra)
                    if not args.emulate and not _card_count():
                        raise SystemExit("no CUDA card: pass --emulate to "
                                         "run the cells' ranks on the CPU")
                    ranks = nw or _card_count()
                    print(f"[run ] {tag} ({ranks} rank(s)): {' '.join(cmd)}")
                    run_cell(cmd, ranks, logfile, args.timeout)
                    prior = extract_log(logfile)
                    status = f"{prior[0]:.1f}" if prior else "FAILED"
                    print(f"[done] {tag}: {status}")
                    telemetry["cells_run"] += 1
                    if prior is None:
                        telemetry["cells_failed"] += 1
                report.setdefault(model, {}).setdefault(method, {})[
                    str(nw or "all")
                ] = list(prior) if prior else None
                cell_snap = extract_telemetry(logfile)
                if cell_snap is not None:
                    telemetry["per_cell"][tag] = cell_snap

    report["telemetry"] = telemetry
    report_path = os.path.join(args.logdir, "reports.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    print(f"wrote {report_path}")
    return report


def build_parser():
    p = argparse.ArgumentParser(description="benchmark sweep driver "
                                            "(PyTorch port)")
    p.add_argument("--logdir", type=str, default="logs")
    p.add_argument("--tasks", type=str, default=DEFAULT_TASKS,
                   help="comma list of model:batch_size")
    p.add_argument("--methods", type=str, default="dear,allreduce,mgwfbp",
                   help=f"comma list from {sorted(METHOD_ARGS)}")
    p.add_argument("--nworkers", type=str, default=None,
                   help="comma list of ranks per cell (default: 8 with "
                        "--emulate, else one per card)")
    p.add_argument("--emulate", action="store_true", default=False,
                   help="run each cell's ranks on the CPU (--device cpu, "
                        "gloo)")
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--batches", type=int, default=10)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--timeout", type=float, default=1800.0)
    p.add_argument("--extra-args", type=str, default="")
    return p


def main(argv=None):
    return run_sweep(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
