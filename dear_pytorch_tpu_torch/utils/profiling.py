"""Step, layer and collective timing — the port of
``dear_pytorch_tpu/utils/profiling.py``.

  - `StepTimer`: per-step wall times with the reference harness's mean and
    95% interval (dear/imagenet_benchmark.py:165-172).
  - `measure_layerwise_backward`: per-layer backward seconds in forward
    order, the input MG-WFBP and the wait-time heuristic read (reference
    dear/profiling.py:98-129).
  - `CommunicationProfiler`: a collective's time against its message
    size over a process group, fitted to t = α + β·bytes (reference
    dear/profiling.py:132-165).

On the card every time is a pair of ``torch.cuda.Event`` records around
the timed calls (the device's time; the host returns as soon as the work
is enqueued); on the CPU it is ``time.perf_counter`` around them.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import collectives as C
from dear_pytorch_tpu_torch.ops import fusion as F
from dear_pytorch_tpu_torch.utils import perf_model

__all__ = ["CommunicationProfiler", "StepTimer", "measure_layerwise_backward",
           "time_calls"]


class StepTimer:
    """Collect per-step wall times; report mean/std/CI like the reference
    harness (dear/imagenet_benchmark.py:165-172)."""

    def __init__(self):
        self.times: list[float] = []
        self._t: Optional[float] = None

    def __enter__(self):
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t)

    def tick(self) -> None:
        """Lap timer: call once per step."""
        now = time.perf_counter()
        if self._t is not None:
            self.times.append(now - self._t)
        self._t = now

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def ci95(self) -> float:
        return float(1.96 * np.std(self.times)) if self.times else 0.0

    def summary(self) -> str:
        return f"{self.mean:.4f} +-{self.ci95:.4f} s over {len(self.times)} steps"


def time_calls(fn: Callable[[], object], device: torch.device, *,
               repeats: int, warmup: int) -> float:
    """Mean seconds of one ``fn()`` over ``repeats`` calls after
    ``warmup`` untimed ones: CUDA events around the calls on the card,
    ``time.perf_counter`` on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        return (time.perf_counter() - t0) / repeats
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / repeats


def measure_layerwise_backward(
    loss_fn: Callable,
    model: torch.nn.Module,
    batch,
    *,
    repeats: int = 5,
    warmup: int = 2,
) -> list[float]:
    """Per-layer backward-time measurements in forward order (seconds).

    For each atomic layer i (`ops.fusion`'s layers, module order), times
    the forward and the gradient of ``loss_fn(model, batch)`` with respect
    to the parameters of layers ``i..L-1`` (``torch.autograd.grad``: no
    ``.grad`` is written and no gradient hook fires); layers ``0..i-1``
    are held constant. The difference between successive measurements is
    the marginal cost of extending backprop through layer i — the
    per-layer number MG-WFBP consumes (reference benchmark(),
    dear/profiling.py:98-129). Run it on a model no train step is bound
    to."""
    specs = F.leaf_specs(model)
    params = dict(model.named_parameters())
    n_layers = len({s.layer for s in specs})
    device = next(iter(params.values())).device

    totals = []
    for start in range(n_layers):
        train = [params[s.name] for s in specs if s.layer >= start]

        def run():
            loss = loss_fn(model, batch)
            return torch.autograd.grad(loss, train)

        totals.append(time_calls(run, device, repeats=repeats,
                                 warmup=warmup))

    # totals[start] = fwd + backward through layers >= start; marginal cost
    # of layer i = totals[i] - totals[i+1] (clamped: timing noise)
    times = []
    for i in range(n_layers):
        nxt = totals[i + 1] if i + 1 < n_layers else min(totals)
        times.append(max(totals[i] - nxt, 1e-7))
    return times


class CommunicationProfiler:
    """Collective latency vs message size over a process group (reference
    dear/profiling.py:132-165), fitted to t = α + β·bytes. ``group``:
    default `comm.backend.group()`; ``device``: where the messages live
    (default `comm.backend.device()`)."""

    def __init__(
        self,
        group=None,
        collective: str = "all_reduce",
        dtype=torch.float32,
        device=None,
    ):
        self.group = backend.group() if group is None else group
        self.device = torch.device(device) if device is not None \
            else backend.device()
        self.dtype = dtype
        ops = {
            "all_reduce": lambda x, g: C.all_reduce(x, g, out=x),
            "reduce_scatter": C.reduce_scatter,
            "all_gather": C.all_gather,
            "all_reduce_rsag": lambda x, g: C.all_reduce_rsag(x, g, out=x),
        }
        if collective not in ops:
            raise KeyError(f"collective must be one of {sorted(ops)}")
        self._op = ops[collective]
        self.collective = collective

    @property
    def world(self) -> int:
        return dist.get_world_size(self.group)

    def benchmark(
        self,
        sizes: Optional[Sequence[int]] = None,
        *,
        repeats: int = 10,
        warmup: int = 3,
    ) -> tuple[list[int], list[float]]:
        """Time the collective for each element count (each rank's input,
        padded to a multiple of the world); returns (sizes_bytes,
        times_s). Every rank of the group must call it."""
        world = self.world
        if sizes is None:
            sizes = [2 ** k for k in range(10, 25, 2)]
        sizes = [F.padded_length(s, world) for s in sizes]
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        sizes_bytes, times = [], []
        for n in sizes:
            x = torch.ones((n,), dtype=self.dtype, device=self.device)
            times.append(time_calls(lambda: self._op(x, self.group),
                                    self.device, repeats=repeats,
                                    warmup=warmup))
            sizes_bytes.append(n * itemsize)
        return sizes_bytes, times

    def fit(self, **kwargs) -> tuple[float, float]:
        """Run the sweep and return fitted (α, β)."""
        sizes_bytes, times = self.benchmark(**kwargs)
        return perf_model.fit_alpha_beta(sizes_bytes, times)
