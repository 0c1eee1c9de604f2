"""MG-WFBP: analytic merged-gradient bucket sizing — the port of
``dear_pytorch_tpu/tuning/mgwfbp.py``.

Implements the published MG-WFBP algorithm (S. Shi et al., "MG-WFBP:
Efficient Data Communication for Distributed Synchronous SGD Algorithms",
INFOCOM 2019) that the reference embeds in its WFBP optimizer
(reference wfbp/dopt.py:380-486): given per-layer backward times and an
α-β communication model, merge a layer's gradient into its successor's
bucket whenever communicating it separately cannot finish before the
successor's gradient is ready (or would save less than the per-message
startup α) — each merge trades one α for β·(merged bytes) of serialized
bandwidth.

Differences from the reference implementation (deliberate):
  - α-β constants come from timing the group's collectives
    (`utils.profiling.CommunicationProfiler.fit`) instead of hard-coded
    per-worker-count GPU/Ethernet tables (wfbp/dopt.py:385-400).
  - Operates on the atomic layers of a model (``named_parameters()``
    order, `ops.fusion`) and returns a `FusionPlan` in that module order,
    so the result drops into `build_train_step` like every other
    strategy.
  - The reference's tiny-tensor rule (merge layers under 8192 elements
    regardless of timing, wfbp/dopt.py:469) is kept as ``min_elements``.

Notation (forward order, layer 0 first): backward executes layers
L-1, L-2, ..., 0. ``ready[l]`` = when layer l's gradient is available;
``comm_start[l]`` = when its bucket's collective can begin (after the
previous bucket's collective finished and the gradient is ready).
"""

from __future__ import annotations

from typing import Optional, Sequence

from dear_pytorch_tpu_torch.ops import fusion as F
from dear_pytorch_tpu_torch.utils import perf_model

__all__ = ["mgwfbp_layer_groups", "plan_mgwfbp"]


def mgwfbp_layer_groups(
    sizes_bytes: Sequence[float],
    backward_times: Sequence[float],
    alpha: float,
    beta: float,
    *,
    min_bytes: float = 8192 * 4,
) -> list[list[int]]:
    """Merge decision on (per-layer bytes, per-layer backward seconds).

    Inputs are in FORWARD order; returns groups of forward-order layer
    indices, each group one bucket, covering all layers contiguously.
    """
    L = len(sizes_bytes)
    if L != len(backward_times):
        raise ValueError("sizes and times length mismatch")
    if L == 0:
        return []
    p = [float(b) for b in sizes_bytes]          # bucket bytes (head layer)
    tb = [float(t) for t in backward_times]

    # ready[l]: gradient availability — backward runs from layer L-1 down
    ready = [0.0] * L
    acc = 0.0
    for l in range(L - 1, -1, -1):
        acc += tb[l]
        ready[l] = acc

    def comm_time(nbytes):
        return perf_model.predict_allreduce_time(alpha, beta, nbytes)

    tc = [comm_time(b) for b in p]

    # bucket_low[head] = lowest (earliest-forward) member of head's bucket;
    # the bucket's collective can only fire once THAT member's gradient is
    # ready (backward produces lower indices later, so ready[low] is the
    # latest ready time in the bucket)
    bucket_low = list(range(L))

    def comm_starts():
        """comm_start[l] for the current merge state (0-byte buckets are
        already merged into a later-indexed head)."""
        starts = [0.0] * L
        prev_end = None
        for l in range(L - 1, -1, -1):
            if p[l] == 0.0:
                starts[l] = starts[l + 1]
                continue
            fire = ready[bucket_low[l]]
            s = fire if prev_end is None else max(prev_end, fire)
            starts[l] = s
            prev_end = s + tc[l]
        return starts

    # walk backward-execution order; head = index of the current bucket's
    # head layer (the latest-in-forward-order unmerged layer)
    head = L - 1
    groups: list[list[int]] = []
    current = [L - 1]
    for l in range(L - 2, -1, -1):
        starts = comm_starts()
        merged = False
        head_end = starts[head] + tc[head]
        if ready[l] < head_end:
            waiting = starts[head] > ready[l]  # head comm not yet started
            t_wait = ready[l] - starts[head]
            if waiting or t_wait < alpha:
                merged = True
        if not merged and p[l] < min_bytes:
            merged = True
        if merged:
            p[head] += p[l]
            p[l] = 0.0
            tc[head] = comm_time(p[head])
            tc[l] = 0.0
            bucket_low[head] = l
            current.append(l)
        else:
            groups.append(current)
            current = [l]
            head = l
    groups.append(current)
    # groups were built newest-layer-first; forward order for the plan
    return [sorted(g) for g in reversed(groups)]


def plan_mgwfbp(
    params,
    world: int,
    *,
    layer_times: Sequence[float],
    alpha: float,
    beta: float,
    comm_itemsize: Optional[int] = None,
    min_bytes: float = 8192 * 4,
) -> F.FusionPlan:
    """Build a `FusionPlan` with MG-WFBP bucket boundaries.

    ``layer_times``: per-atomic-layer backward seconds in forward order
    (from `utils.profiling.measure_layerwise_backward` or
    `tuning.wait_time.estimate_layer_backward_times`).
    ``alpha``/``beta``: the measured interconnect model
    (`utils.profiling.CommunicationProfiler.fit`).
    """
    sizes = F.layer_sizes(params, in_bytes=True, comm_itemsize=comm_itemsize)
    if len(sizes) != len(layer_times):
        raise ValueError(
            f"{len(layer_times)} layer times for {len(sizes)} layers"
        )
    groups = mgwfbp_layer_groups(
        sizes, layer_times, alpha, beta, min_bytes=min_bytes
    )
    return F.plan_by_groups(params, world, groups)
