"""Per-grid-step and per-ring-hop overhead probes — the port of
``scripts/pallas_overhead_probe.py``, with its sections, sizes and
printed fields.

  python -m dear_pytorch_tpu_torch.scripts.overhead_probe \\
      [--section elementwise|kernels|all] [--device cpu] [--world 2]

1. ``elementwise``: the probe's kernel K9 (`ops.overhead_probe`, ``o = 2x +
   1`` over ones(16384, 512) fp32) at two grid granularities over the same
   bytes: 16 blocks of (1024, 512) and 2048 blocks of (8, 512). Per
   granularity: the host wall time per call (20 back-to-back launches and
   one sync, as the JAX probe measures) and, on the card, the device time
   per call (CUDA events around 20 launches queued behind a sleep), each
   per grid step; the bytes bound over the card's memory rate; and one
   PyTorch call computing the same function (``torch.add(one, x,
   alpha=2.0)``, held bitwise equal to K9's output). 16 blocks occupy 16
   SMs, so that line measures per-SM bandwidth, not per-step cost.
2. ``kernels``: the ring all-gather (K4) and the fused ring reduce-scatter
   + update (K5 ring, SGD momentum 0.9, lr 0.01, ``mean_world`` = world)
   at a big shard (65536 fp32) and a tiny one (1024), 5 timed calls each
   (host clock, as the JAX probe; on a `LocalRing` on the card also 5
   event-timed ones), reported per ring hop and as GiB/s per device on
   the wire. Started as
   ranks of a group (``comm.backend``'s launcher variables, world >= 2)
   it runs over the IPC `comm.ring.Ring`, one rank per process: two ranks
   on one card time-slice it, so the per-call cost over this transport
   minus a `LocalRing`'s is the cost of pairing each call across two
   contexts. As one process it runs on a `LocalRing` of ``--world`` ranks,
   which drives every rank in one launch. At world 1 it skips, as the JAX
   probe does.

Everything runs on the card unless ``--device cpu`` is given; on the CPU
every kernel's plain version runs, so only host times are printed (they
time the plain PyTorch code, not a kernel). Started as ranks, the
elementwise section runs on rank 0 only. `main` returns the measured rows.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch._device import resolve_device
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm.ring import LocalRing, Ring
from dear_pytorch_tpu_torch.ops import collective_matmul as CM
from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd
from dear_pytorch_tpu_torch.ops.overhead_probe import (
    WIDTH, affine_probe, affine_probe_plain,
)

__all__ = ["GRANULARITIES", "SHARDS", "elementwise_section",
           "kernel_section", "main", "memory_rate", "run"]

#: (nblocks, rows_per_block): the same 16384 rows at two granularities
GRANULARITIES = ((16, 1024), (2048, 8))
#: the ring probe's shard sizes per rank (fp32 elements): big and tiny
SHARDS = (1 << 16, 1 << 10)
ITERS = 20
RING_ITERS = 5


def memory_rate(name: str) -> float:
    """Device-memory rate of the named card in bytes/s (data sheets)."""
    n = name.upper()
    if "H200" in n:
        return 4.8e12
    if "H100" in n and "PCIE" in n:
        return 2.0e12
    if "H100" in n and "NVL" in n:
        return 3.9e12
    return 3.35e12  # H100 SXM (80 GB HBM3)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_ms(fn, iters: int, host_s: float) -> float:
    """Device time per call of ``fn()``: CUDA events around ``iters``
    calls queued behind a sleep kernel longer than ``host_s`` (the host's
    time to enqueue them), so host time does not leak in."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(host_s * 2e9 * 2) + 1_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(nblocks: int, rows_per_block: int, device, iters: int = ITERS):
    """K9 over ones(nblocks * rows_per_block, 512): one warm-up launch,
    ``iters`` host-timed launches and, on the card, ``iters`` event-timed
    ones. Prints the JAX probe's line and the device's; returns the row."""
    device = torch.device(device)
    x = torch.ones((nblocks * rows_per_block, WIDTH), dtype=torch.float32,
                   device=device)
    o = affine_probe(x, rows_per_block)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        o = affine_probe(x, rows_per_block)
    float(o[0, 0])
    dt = (time.perf_counter() - t0) / iters
    print(f"grid={nblocks:5d} x ({rows_per_block},512): {dt*1e3:8.3f} ms "
          f"-> {dt/nblocks*1e6:8.2f} us/grid-step", flush=True)
    if not torch.equal(o, affine_probe_plain(x)):
        raise RuntimeError(f"affine_probe at grid {nblocks} x "
                           f"({rows_per_block}, 512) is not 2x + 1")
    nbytes = 2 * x.numel() * x.element_size()     # read x, write o
    row = {"nblocks": nblocks, "rows_per_block": rows_per_block,
           "host_ms": dt * 1e3, "bytes": nbytes, "device": str(device)}
    if device.type != "cuda":
        print("  device time: not measured (the plain version ran on the "
              f"CPU); {nbytes} bytes moved per call", flush=True)
        return row
    name = torch.cuda.get_device_name(device)
    rate = memory_rate(name)
    one = torch.ones((), dtype=torch.float32, device=device)
    lib = torch.add(one, x, alpha=2.0)
    if not torch.equal(lib, o):
        raise RuntimeError("torch.add(one, x, alpha=2.0) is not K9's output")
    dev_ms = _device_ms(lambda: affine_probe(x, rows_per_block), iters,
                        dt * iters)
    lib_ms = _device_ms(lambda: torch.add(one, x, alpha=2.0), iters,
                        dt * iters)
    plain_ms = _device_ms(lambda: affine_probe_plain(x), iters, dt * iters)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row.update(device_ms=dev_ms, bound_ms=nbytes / rate * 1e3,
               library_ms=lib_ms, plain_ms=plain_ms)
    print(f"  device {dev_ms:.5f} ms -> {dev_ms / nblocks * 1e3:.4f} "
          f"us/grid-step; bound {row['bound_ms']:.5f} ms ({nbytes} bytes "
          f"over {rate / 1e12:g} TB/s, {name}); one PyTorch call "
          f"(torch.add(one, x, alpha=2.0), bitwise equal) {lib_ms:.5f} ms; "
          f"plain version {plain_ms:.5f} ms", flush=True)
    if nblocks < sms:
        print(f"  {nblocks} blocks occupy {nblocks} of the card's {sms} "
              "SMs: this line measures per-SM bandwidth, not per-step "
              "overhead", flush=True)
    return row


def elementwise_section(device) -> list:
    # identical total work (16384 rows of 512), different grid granularity
    return [run(nb, rpb, device) for nb, rpb in GRANULARITIES]


def _timeit(fn, device, group, iters: int = RING_ITERS) -> float:
    fn()
    _sync(device)
    if group is not None:
        backend.barrier()      # the ranks start the timed calls together
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def kernel_section(device, world: int = 2, group=None) -> list:
    """K4 and the K5 ring per hop at `SHARDS`: over ``group`` (this
    process one rank of it) on the IPC `Ring`, else on a `LocalRing` of
    ``world`` ranks. Returns one row per kernel and shard size."""
    device = torch.device(device)
    if group is not None:
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    if world < 2:
        print("kernel section needs a multi-device mesh; skipping",
              flush=True)
        return []
    if group is not None:
        ring = Ring(group, device, max(SHARDS))
        transport = "Ring"
        where = (f"IPC Ring, rank {rank} of {world}, one rank per process"
                 if device.type == "cuda" else
                 f"gloo group, rank {rank} of {world}")
        lead = ()
    else:
        ring = LocalRing(world, device, max(SHARDS))
        transport = "LocalRing"
        where = "LocalRing, every rank in one launch"
        lead = (world,)
    note = ("kernel times" if device.type == "cuda" else
            "the plain versions on the CPU: host times, not kernel speed")
    print(f"ring-kernel probes on a {world}-rank {where} ({device}; {note})",
          flush=True)
    opt = fused_sgd(lr=0.01, momentum=0.9)
    hops = world - 1
    rows = []
    for ss in SHARDS:   # big vs tiny shards, per rank
        f32 = dict(dtype=torch.float32, device=device)
        shard = torch.ones(lead + (ss,), **f32)
        gathered = torch.empty(lead + (world * ss,), **f32)
        grad = torch.ones(lead + (world * ss,), **f32)
        param = torch.ones(lead + (ss,), **f32)
        state = (opt.init(param) if not lead else
                 [opt.init(param[i]) for i in range(world)])

        def ag():
            CM.ring_all_gather(shard, ring, out=gathered)

        def rs():
            CM.fused_reduce_scatter_update(grad, param, state, opt, ring,
                                           mean_world=world)

        for name, fn in (("ring_all_gather", ag), ("ring_rs_update", rs)):
            dt = _timeit(fn, device, group)
            gib_s = ss * 4 * hops / max(dt, 1e-12) / 2**30
            label = ("ring_all_gather " if name == "ring_all_gather"
                     else "fused_rs_update ")
            extra = ("" if name == "ring_all_gather"
                     else "incl. SGD-momentum epilogue; ")
            print(f"{label} shard={ss:7d} f32: {dt*1e3:8.3f} ms "
                  f"-> {dt/hops*1e6:8.2f} us/hop ({extra}{gib_s:6.2f} "
                  "GiB/s/device wire)", flush=True)
            row = {"kernel": name, "transport": transport, "world": world,
                   "shard": ss, "ms": dt * 1e3, "us_per_hop": dt / hops * 1e6,
                   "gib_s": gib_s, "device": str(device)}
            if group is None and device.type == "cuda":
                # one launch drives every rank: its device time alone,
                # the rest of `ms` is the host's (the wrapper, the launch)
                dev_ms = _device_ms(fn, RING_ITERS, dt * RING_ITERS)
                row["device_ms"] = dev_ms
                print(f"  device {dev_ms:.5f} ms -> {dev_ms / hops * 1e3:.2f}"
                      " us/hop (CUDA events behind a sleep)", flush=True)
            rows.append(row)
        if not bool((gathered == 1).all()):
            raise RuntimeError(f"ring all-gather of ones at shard {ss} "
                               "gave another value")
        if not bool(torch.isfinite(param).all()):
            raise RuntimeError(f"ring reduce-scatter update at shard {ss} "
                               "gave a non-finite parameter")
    ring.close()
    return rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Per-grid-step / per-ring-hop overhead probes (PyTorch "
                    "port)")
    p.add_argument("--section", default="all",
                   choices=["elementwise", "kernels", "all"])
    p.add_argument("--device", default=None,
                   help="where to run (default: the card; 'cpu' runs the "
                        "plain versions)")
    p.add_argument("--world", type=int, default=2,
                   help="ranks of the one-process LocalRing (ignored when "
                        "started as ranks of a group)")
    return p


def main(argv=None) -> dict:
    """Run the chosen sections; returns ``{"elementwise": rows, "kernels":
    rows}`` (a section not run has no rows)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    group = None
    if backend.launched_size() > 1:      # started as ranks of a group
        group = backend.init(args.device)
        device = backend.device()
    out = {"elementwise": [], "kernels": []}
    try:
        if args.section in ("elementwise", "all"):
            if group is None or backend.rank() == 0:
                out["elementwise"] = elementwise_section(device)
            else:
                print(f"rank {backend.rank()}: the elementwise section runs "
                      "on rank 0 only", flush=True)
        if args.section in ("kernels", "all"):
            out["kernels"] = kernel_section(device, args.world, group)
    finally:
        if group is not None:
            backend.shutdown()
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
