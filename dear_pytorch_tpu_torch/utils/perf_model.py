"""Analytic α-β communication/computation cost models — the part of
``dear_pytorch_tpu/utils/perf_model.py`` that the tuners call, copied.

The reference hard-codes α-β constants measured on its GPU clusters
(reference dear/utils.py:62-88, wfbp/dopt.py:385-400) and fits fresh ones
with sklearn (wfbp/dopt.py:260-285). Here the constants come from timing
the group's collectives with `utils.profiling.CommunicationProfiler` and a
plain least-squares fit — no sklearn, no hard-coded tables. The MFU
helpers of the JAX module are the bench runner's in the port
(`benchmarks.runner.mfu`).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

__all__ = ["allgather_perf_model", "fit_alpha_beta",
           "predict_allreduce_time", "topk_perf_model"]


def predict_allreduce_time(alpha: float, beta: float, nbytes: float) -> float:
    """t = α + β·nbytes (reference ``predict_allreduce_time_with_size``,
    dear/utils.py:151-154)."""
    return alpha + beta * nbytes


def fit_alpha_beta(
    sizes_bytes: Sequence[float], times_s: Sequence[float]
) -> tuple[float, float]:
    """Least-squares fit of t ≈ α + β·size (replaces the sklearn
    LinearRegression fit, wfbp/dopt.py:260-285). Returns (α, β), clipped to
    be non-negative."""
    A = np.vstack([np.ones(len(sizes_bytes)), np.asarray(sizes_bytes)]).T
    (alpha, beta), *_ = np.linalg.lstsq(A, np.asarray(times_s), rcond=None)
    return max(float(alpha), 0.0), max(float(beta), 0.0)


def topk_perf_model(n: int, s: float = 2.18e-9) -> float:
    """Cost model of a top-k over n elements, s·n·log2 n (reference
    dear/utils.py:95-102)."""
    if n <= 1:
        return 0.0
    return s * n * math.log2(n)


def allgather_perf_model(
    nbytes: float, world: int, alpha: float, beta: float
) -> float:
    """Ring all-gather cost: (world-1) rounds of α + β·(nbytes/world)
    (reference dear/utils.py:104-117 models allgather for the sparse path)."""
    if world <= 1:
        return 0.0
    return (world - 1) * (alpha + beta * nbytes / world)
