"""Wait-time heuristic fusion: derive bucket-split flags from layer timing
— the port of ``dear_pytorch_tpu/tuning/wait_time.py``.

The reference (dear/dopt_rsag_wt.py) starts with ALL layers in one bucket,
records how long each parameter's gradient sits in the buffer before the
bucket fires (EMA over steps), converts to per-module wait times, and splits
where cumulative wait exceeds multiples of ``CYCLE_TIME`` (5 ms) — i.e. a
reduce-scatter should launch roughly every CYCLE_TIME of backward compute so
communication overlaps instead of queueing behind one giant bucket.

The decision needs per-layer backward *times*. Two sources:
  - `estimate_layer_backward_times`: analytic estimate from layer sizes
    (backward of a layer streams ~3x its parameter bytes through memory;
    for the split decision only relative magnitudes matter);
  - measured per-layer times from
    `utils.profiling.measure_layerwise_backward`.

`wait_time_flags` turns those times into split flags consumable by
`ops.fusion.plan_by_flags` (flag=1 means "this layer starts a new bucket";
same contract as tensorfusion.py:175-192).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from dear_pytorch_tpu_torch.ops import fusion as F

__all__ = ["estimate_layer_backward_times", "wait_time_flags"]


def estimate_layer_backward_times(
    plan_or_params,
    *,
    hbm_gbps: float = 800.0,
    world: int = 1,
) -> list[float]:
    """Per-layer backward-time estimate in seconds, forward order: a
    layer's backward writes its gradient and reads activations and weights
    — time roughly proportional to parameter bytes / memory bandwidth (the
    role of the reference's measured ``layerwise_times``,
    dear/profiling.py:98-129, when no measurement is at hand).
    ``plan_or_params``: a `FusionPlan`, an ``nn.Module`` or anything
    `ops.fusion.leaf_specs` takes."""
    specs = (plan_or_params.leaves
             if isinstance(plan_or_params, F.FusionPlan)
             else F.leaf_specs(plan_or_params))
    layers: dict[int, float] = {}
    for s in specs:
        byte = s.size * s.dtype.itemsize
        layers[s.layer] = layers.get(s.layer, 0.0) + 3.0 * byte
    return [layers[k] / (hbm_gbps * 1e9) for k in sorted(layers)]


def wait_time_flags(
    layer_times: Sequence[float],
    cycle_time_s: float = 5e-3,
    ema_prev: Optional[Sequence[float]] = None,
    ema_alpha: float = 0.9,
) -> list[int]:
    """Split flags from per-layer backward times (forward order).

    Backward visits layers in REVERSE forward order; accumulate time in that
    order and start a new bucket each time the running sum crosses
    ``cycle_time_s`` (the reference's cumulative-wait-over-CYCLE_TIME rule,
    dopt_rsag_wt.py). Flags are returned in forward order: ``flags[i] == 1``
    means layer i starts a bucket. Layer 0 (first in forward order, last
    produced in backward) always starts one.

    ``ema_prev`` smooths times across calls with the reference's alpha=0.9.
    """
    t = np.asarray(layer_times, np.float64)
    if ema_prev is not None:
        t = ema_alpha * np.asarray(ema_prev, np.float64) + (1 - ema_alpha) * t
    n = len(t)
    flags = [0] * n
    acc = 0.0
    # walk in backward-execution order (last layer first); when the
    # accumulated backward time exceeds a cycle, the NEXT (earlier) layer
    # group begins a new bucket — equivalently, the current layer is the
    # first (in forward order) of the bucket just closed.
    for i in range(n - 1, -1, -1):
        acc += t[i]
        if acc >= cycle_time_s:
            flags[i] = 1
            acc = 0.0
    flags[0] = 1
    return flags
