"""K4 (the ring all-gather), the K5 ring (reduce-scatter + update) and the
two-rank dear-fused training step, timed in one or more checkouts of this
repository one after the other on the same card, so that two versions of
the ring kernels compare within one machine's run:

  python3 dear_pytorch_tpu_torch/scripts/ring_ab.py ROOT[:slot] ...

Each ROOT is the root of a checkout: this one, or another commit's tree
unpacked (``git archive``) into a git-ignored directory. List them as
``A B B A`` to see how far the card drifts between runs. For each, a child
process with ROOT first on its path builds the kernels and then:

1. times, on a two-rank `LocalRing` (both ranks' work in one launch),
   K4 on its slot route (fp32, ``ring_all_gather(x, ring, out=o)``) and
   the K5 ring (bf16 gradient, SGD momentum 0.9) at a 25 MB bucket's shard
   n = 3248640 (the vector width), at n + 2 (the scalar width, one
   element per access) and at n + 4 (the K5 ring's bf16 in 4-element
   units), with ``chip_smoke.device_ms``;
2. trains GPT-2 small 20 steps with ``--mode dear-fused`` as two ranks
   sharing the card (two processes of this script; the training CLI with
   chip_smoke's two-rank flags, a gloo group at a file store), each step
   marked by a CUDA event, and takes each rank's last 15 step times.
   ``ROOT:slot`` runs the step with K4 on its slot route instead of the
   direct one (the ranks' route chooser sees no registered output), to
   price the direct route's hand-off apart from the kernels.

It prints one JSON line per ROOT (``ring_ab {...}``): the kernels' times
in ms, each rank's step p50, p99, min and max, and its K4 launches by
route where the checkout counts them. Only entry points that every
checkout since the port's ring kernels has are used.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

#: a 25 MB bucket's shard of GPT-2 small's plan at two ranks
BUCKET_SHARD = 3248640
_KERNELS = ["flash_fwd", "flash_bwd", "fused_update", "ring", "ring_matmul",
            "overhead_probe"]


def time_kernels() -> dict:
    """Step 1: K4 and the K5 ring on a two-rank `LocalRing`, ms per call."""
    import torch

    import chip_smoke as cs
    from dear_pytorch_tpu_torch.comm.ring import LocalRing
    from dear_pytorch_tpu_torch.ops import collective_matmul as CM
    from dear_pytorch_tpu_torch.ops import fused_sgd as FS

    world, dev = 2, "cuda"
    gen = torch.Generator(device=dev).manual_seed(9)
    sizes = (BUCKET_SHARD, BUCKET_SHARD + 2, BUCKET_SHARD + 4)
    ring = LocalRing(world, dev, max(sizes))
    opt = FS.fused_sgd(lr=0.01, momentum=0.9)
    ms = {}
    for n in sizes:
        ag_sets, rs_sets = [], []
        for _ in range(2):
            x = torch.randn(world, n, generator=gen, device=dev)
            ag_sets.append((x, torch.empty(world, world * n, device=dev)))
            p = torch.randn(world, n, generator=gen, device=dev)
            st = [opt.init(p[i]) for i in range(world)]
            for one in st:
                one["buf"].normal_(generator=gen)
                one["initialized"] = True
            g = torch.randn(world, world * n, generator=gen,
                            device=dev).bfloat16()
            rs_sets.append((g, p, st))
        ms[f"K4 slot fp32 n={n}"] = cs.device_ms(
            lambda x, o: CM.ring_all_gather(x, ring, out=o), ag_sets, 20)
        ms[f"K5 ring bf16 n={n}"] = cs.device_ms(
            lambda g, p, st: CM.fused_reduce_scatter_update(
                g, p, st, opt, ring, mean_world=world), rs_sets, 20)
    ring.close()
    return ms


def rank_worker(rank: int, out: Path, slot: bool) -> None:
    """One rank of step 2: 20 dear-fused steps, the step times and K4's
    launches into ``out/rank<r>.json``."""
    import torch

    import chip_smoke as cs
    from dear_pytorch_tpu_torch.benchmarks import gpt as train_cli
    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.comm.ring import Ring
    from dear_pytorch_tpu_torch.ops import collective_matmul as CM

    os.environ.update(
        DEAR_NUM_PROCESSES="2", DEAR_PROCESS_ID=str(rank),
        DEAR_COORDINATOR_ADDRESS=f"file://{out}/store",
        DEAR_LOCAL_RANK=str(rank), DEAR_LOCAL_SIZE="2")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if slot:
        Ring.direct_links = lambda self, out: None
        route = CM.ag_route
        CM.ag_route = lambda *a, **k: route(*a, **(k | {"direct": False}))
    marks = []

    def on_step(ts, state, metrics):
        del ts, state, metrics
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    res = train_cli.main(cs._TWO_RANK_ARGS + ["--mode", "dear-fused",
                                              "--device", "cuda"],
                         on_step=on_step)
    torch.cuda.synchronize()
    warm = cs._TRAIN_WARMUP
    (out / f"rank{rank}.json").write_text(json.dumps({
        "step_ms": [a.elapsed_time(b) for a, b in
                    zip(marks[warm - 1:-1], marks[warm:])],
        "ag_launches": getattr(CM, "ring_ag_route_launches",
                               CM.ring_ag_launches)}))
    res.train_step.close()
    backend.shutdown()


def train_two_ranks(root: str, slot: bool) -> dict:
    """Step 2: spawn the two ranks, wait for both, and summarise."""
    import numpy as np

    out = Path(root) / "build" / "ring_ab" / ("slot" if slot else "as-is")
    out.mkdir(parents=True, exist_ok=True)
    for f in out.iterdir():
        f.unlink()
    procs = []
    for r in range(2):
        with open(out / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--rank",
                 str(r), str(out), str(int(slot))],
                stdout=log, stderr=subprocess.STDOUT, cwd=root))
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        for r in range(2):
            print(f"--- rank {r} (exit {codes[r]}):\n"
                  + (out / f"rank{r}.log").read_text()[-4000:])
        raise RuntimeError("ring_ab: a rank of the two-rank step failed")
    steps = {}
    for r in range(2):
        got = json.loads((out / f"rank{r}.json").read_text())
        t = np.asarray(got["step_ms"])
        steps[f"rank{r}"] = {
            "p50": float(np.percentile(t, 50)),
            "p99": float(np.percentile(t, 99)),
            "min": float(t.min()), "max": float(t.max()), "n": len(t),
            "ag_launches": got["ag_launches"]}
    return steps


def child(root: str, slot: bool) -> dict:
    """Both steps in the checkout this process imports."""
    from dear_pytorch_tpu_torch.ops import _build

    _build.build(_KERNELS)
    return {"ms": time_kernels(),
            "dear_fused_step_ms": train_two_ranks(root, slot)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        rank_worker(int(argv[1]), Path(argv[2]), argv[3] == "1")
        return 0
    if argv[:1] == ["--child"]:
        root, slot = argv[1], argv[2] == "1"
        print("ring_ab " + json.dumps(
            {"root": root, "k4_route": "slot" if slot else "as built"}
            | child(root, slot)), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for spec in argv:
        path, _, variant = spec.partition(":")
        if variant not in ("", "slot"):
            print(f"ring_ab: unknown variant {variant!r}", file=sys.stderr)
            return 2
        root = str(Path(path).resolve())
        code = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", root,
             str(int(variant == "slot"))],
            cwd=root, env=dict(os.environ, PYTHONPATH=root)).returncode
        if code != 0:
            print(f"ring_ab: the run in {root} failed ({code})",
                  file=sys.stderr)
            return code
    return 0


if __name__ == "__main__":
    sys.exit(main())
