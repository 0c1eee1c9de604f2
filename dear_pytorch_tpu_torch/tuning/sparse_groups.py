"""ASC and MGS-SGD layer-grouping strategies (the reference's remaining
analytic bucketizers, completing the MG-WFBP family in `tuning.mgwfbp`) —
the port of ``dear_pytorch_tpu/tuning/sparse_groups.py``.

  - **ASC** (adaptive synchronization coalescing, reference
    dear/hv_distributed_optimizer.py:353-427): walk layers in backward
    order; if, at the moment the NEXT gradient becomes ready, the current
    bucket's all-reduce has not even started (it is queued behind earlier
    collectives), merging is free bandwidth-wise — coalesce. Unlike
    MG-WFBP's alpha-saving rule, ASC merges ONLY on comm-start blockage.

  - **MGS-SGD** (merged gradient sparsification, S. Shi et al., INFOCOM
    2020; reference wfbp/dopt.py:488-569): for sparsified (top-k) training
    the trade-off adds the sparsification kernel itself — merging two
    layers re-runs top-k over the union (cost ~ s·n·log2 n) but saves one
    sparse all-gather launch. Merge when the extra wait (backward of the
    next layer + combined-vs-separate top-k - idle gap) is smaller than
    the all-gather saving.

Both operate on the atomic layers of a model (module order) and return a
`FusionPlan`, dropping into `build_train_step` like every other
strategy (the reference instead rebuilds its optimizer hooks per grouping).
Cost constants come from measured interconnect fits (`utils.perf_model`),
not the reference's hard-coded GPU/Ethernet tables.
"""

from __future__ import annotations

from typing import Optional, Sequence

from dear_pytorch_tpu_torch.ops import fusion as F
from dear_pytorch_tpu_torch.utils import perf_model

__all__ = ["asc_layer_groups", "mgs_layer_groups", "plan_asc", "plan_mgs"]


def _backward_schedule(tb: Sequence[float]) -> list[float]:
    """taob[l] = start of layer l's backward (runs L-1, L-2, ..., 0)."""
    L = len(tb)
    taob = [0.0] * L
    for l in range(L - 2, -1, -1):
        taob[l] = taob[l + 1] + tb[l + 1]
    return taob


def asc_layer_groups(
    sizes_bytes: Sequence[float],
    backward_times: Sequence[float],
    alpha: float,
    beta: float,
) -> list[list[int]]:
    """ASC merge decision (reference hv_distributed_optimizer.py:353-427).

    Inputs in FORWARD order; returns contiguous forward-order groups.
    """
    L = len(sizes_bytes)
    if L != len(backward_times):
        raise ValueError("sizes and times length mismatch")
    if L == 0:
        return []
    p = [float(b) for b in sizes_bytes]
    tb = list(backward_times)
    tc = [perf_model.predict_allreduce_time(alpha, beta, b) for b in p]
    taob = _backward_schedule(tb)

    def comm_starts():
        taoc = [0.0] * L
        taoc[L - 1] = taob[L - 1] + tb[L - 1]
        for l in range(L - 2, -1, -1):
            taoc[l] = max(taoc[l + 1] + tc[l + 1], taob[l] + tb[l])
        return taoc

    taoc = comm_starts()
    groups: list[list[int]] = []
    group: list[int] = []
    for l in range(L - 1, 0, -1):
        group.append(l)
        ready_next = taob[l - 1] + tb[l - 1]
        # this bucket's comm has not even STARTED (queued behind earlier
        # collectives) when the next gradient arrives -> coalescing is free
        if taoc[l] > ready_next:
            p[l - 1] += p[l]
            p[l] = 0.0
            tc[l] = 0.0
            tc[l - 1] = perf_model.predict_allreduce_time(
                alpha, beta, p[l - 1]
            )
            taoc = comm_starts()
        else:
            groups.append(group)
            group = []
    group.append(0)
    groups.append(group)
    return [sorted(g) for g in reversed(groups)]


def mgs_layer_groups(
    sizes_elems: Sequence[float],
    backward_times: Sequence[float],
    alpha: float,
    beta: float,
    *,
    world: int,
    density: float,
    topk_s: float = 2.18e-9,
    itemsize: int = 4,
) -> list[list[int]]:
    """MGS-SGD merge decision (reference wfbp/dopt.py:488-569).

    ``sizes_elems`` are ELEMENT counts (top-k cost scales with elements;
    comm with bytes). Inputs in FORWARD order; returns contiguous groups.
    """
    L = len(sizes_elems)
    if L != len(backward_times):
        raise ValueError("sizes and times length mismatch")
    if L == 0:
        return []
    if L == 1:
        return [[0]]

    def t_topk(n):
        return perf_model.topk_perf_model(int(n), topk_s)

    def t_ag(n):
        # sparse all-gather of 2k entries per device (values + indices);
        # merged-away buckets (n == 0) cost NOTHING — charging them the
        # (world-1)·α startup would inflate every later merge decision
        if not n:
            return 0.0
        k = max(n * density, 1.0)
        return perf_model.allgather_perf_model(
            2.0 * k * itemsize * world, world, alpha, beta
        )

    p = [float(n) for n in sizes_elems]
    tb = list(backward_times)

    def sparse_schedule(tb_, p_, L_, start=0.0):
        """(taob, taos, ts): backward + serial per-bucket top-k chain."""
        ts_ = [t_topk(n) for n in p_]
        taob_ = [start] * L_
        taos_ = [start] * L_
        taos_[L_ - 1] = taob_[L_ - 1] + tb_[L_ - 1]
        for l in range(L_ - 2, -1, -1):
            taob_[l] = taos_[l + 1] + ts_[l + 1]
            taos_[l] = taob_[l] + tb_[l]
        return taob_, taos_, ts_

    def comm_schedule(ts_, taos_, p_):
        tc_ = [t_ag(n) for n in p_]
        taoc_ = [0.0] * L
        taoc_[L - 1] = taos_[L - 1] + ts_[L - 1]
        for l in range(L - 2, -1, -1):
            taoc_[l] = max(taoc_[l + 1] + tc_[l + 1], taos_[l] + ts_[l])
        return taoc_, tc_

    taob, taos, ts = sparse_schedule(tb, p, L)
    taoc, tc = comm_schedule(ts, taos, p)

    # Deviation from the reference loop bounds (wfbp/dopt.py:543,565): the
    # reference seeds its first group with layers L-1 AND L-2 before any
    # cost evaluation, never scoring the (L-1, L-2) pair and never folding
    # p[L-1] into the merged-size bookkeeping. Here EVERY adjacent pair is
    # scored, so the head pair merges only when the model says so.
    groups: list[list[int]] = []
    group: list[int] = [L - 1]
    for l in range(L - 1, 0, -1):
        # extra wait if merged: next backward + combined-vs-separate top-k
        # minus the idle gap this bucket's comm already sits on
        tw = (
            tb[l - 1]
            + t_topk(p[l] + p[l - 1]) - t_topk(p[l]) - t_topk(p[l - 1])
            - (taoc[l] - (taos[l] + ts[l]))
        )
        tsave = t_ag(p[l]) + t_ag(p[l - 1]) - t_ag(p[l] + p[l - 1])
        if tw < tsave:
            p[l - 1] += p[l]
            p[l] = 0.0
            tb[l - 1] += tb[l]
            tb[l] = 0.0
            taob2, taos2, ts2 = sparse_schedule(
                tb[:l], p[:l], l, start=taob[l] + tb[l]
            )
            taob[:l], taos[:l], ts[:l] = taob2, taos2, ts2
            taoc, tc = comm_schedule(ts, taos, p)
            group.append(l - 1)
        else:
            groups.append(group)
            group = [l - 1]
    groups.append(group)
    return [sorted(g) for g in reversed(groups)]


def plan_asc(
    params,
    world: int,
    *,
    layer_times: Sequence[float],
    alpha: float,
    beta: float,
    comm_itemsize: Optional[int] = None,
) -> F.FusionPlan:
    """`FusionPlan` with ASC bucket boundaries."""
    sizes = F.layer_sizes(params, in_bytes=True, comm_itemsize=comm_itemsize)
    if len(sizes) != len(layer_times):
        raise ValueError(
            f"{len(layer_times)} layer times for {len(sizes)} layers"
        )
    groups = asc_layer_groups(sizes, layer_times, alpha, beta)
    return F.plan_by_groups(params, world, groups)


def plan_mgs(
    params,
    world: int,
    *,
    layer_times: Sequence[float],
    alpha: float,
    beta: float,
    density: float,
    topk_s: float = 2.18e-9,
    comm_itemsize: Optional[int] = None,
) -> F.FusionPlan:
    """`FusionPlan` with MGS-SGD bucket boundaries (use with the sparse
    compressed-allreduce schedule)."""
    sizes = F.layer_sizes(params, in_bytes=False)
    if len(sizes) != len(layer_times):
        raise ValueError(
            f"{len(layer_times)} layer times for {len(sizes)} layers"
        )
    groups = mgs_layer_groups(
        sizes, layer_times, alpha, beta, world=world, density=density,
        topk_s=topk_s, itemsize=comm_itemsize or 4,
    )
    return F.plan_by_groups(params, world, groups)
