"""Bayesian optimization of the fusion threshold — self-contained GP + EI;
a copy of ``dear_pytorch_tpu/tuning/bo.py`` (numpy only).

The reference delegates to the ``bayes_opt`` package (reference
dear/tuner.py:1-2: BayesianOptimization + UtilityFunction(kind='ei',
xi=0.1)) and wraps it in a step-driven `Tuner` that measures iteration time
every ``interval=5`` steps and runs ``num_trials=10`` threshold trials
(tuner.py:9-10,56-89). That package is not available here and pulling it in
for a 10-point 1-D problem is overkill; this module implements the same
method in ~100 lines of numpy: an RBF-kernel Gaussian process fit by
Cholesky, and expected improvement maximized on a dense grid.

Timing protocol parity (tuner.py:56-68): per measurement window of
``interval`` steps, the first window after a (re)configuration is discarded
as warmup (the rebuilt step lands there), and the first 3 durations of a
window are skipped.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional, Sequence

import numpy as np


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _norm_cdf(z):
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


class BayesianOptimizer:
    """Minimize a scalar function of one variable on [lo, hi] from samples.

    GP with RBF kernel on x normalized to [0,1], y standardized; EI
    acquisition with exploration margin ``xi`` (the reference's
    UtilityFunction(kind='ei', xi=0.1), tuner.py:40).
    """

    def __init__(self, bound: tuple[float, float], *, xi: float = 0.1,
                 length_scale: float = 0.15, noise: float = 1e-4,
                 grid: int = 512, seed: int = 0):
        self.lo, self.hi = float(bound[0]), float(bound[1])
        if not self.hi > self.lo:
            raise ValueError(f"bad bound {bound}")
        self.xi = xi
        self.ls = length_scale
        self.noise = noise
        self.xs: list[float] = []
        self.ys: list[float] = []
        #: observation namespace — observations are only comparable within
        #: one (world size, model, membership epoch) context; a rescaled
        #: fleet must not exploit posteriors fit on another world's timings
        self.context: str = ""
        self._archive: dict[str, tuple[list[float], list[float]]] = {}
        self._rng = np.random.default_rng(seed)
        self._grid = np.linspace(0.0, 1.0, grid)

    def set_context(self, context: str) -> None:
        """Switch the observation namespace. The current observation set is
        archived under the old context and the (possibly empty) set
        previously archived under ``context`` becomes live — the posterior
        never mixes observations across contexts, fixing the
        history-keyed-only-by-x staleness after an elastic rescale."""
        context = str(context)
        if context == self.context:
            return
        self._archive[self.context] = (self.xs, self.ys)
        xs, ys = self._archive.get(context, ([], []))
        self.xs, self.ys = list(xs), list(ys)
        self.context = context

    def _z(self, x):
        return (np.asarray(x, np.float64) - self.lo) / (self.hi - self.lo)

    def register(self, x: float, y: float) -> None:
        """Add an observation (y = iteration time; smaller is better)."""
        self.xs.append(float(x))
        self.ys.append(float(y))

    def _kernel(self, a, b):
        d = a[:, None] - b[None, :]
        return np.exp(-0.5 * (d / self.ls) ** 2)

    def _posterior(self, q):
        x = self._z(self.xs)
        y = np.asarray(self.ys, np.float64)
        mu0, sd0 = y.mean(), y.std() + 1e-12
        yn = (y - mu0) / sd0
        K = self._kernel(x, x) + self.noise * np.eye(len(x))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        Ks = self._kernel(x, q)
        mean = Ks.T @ alpha
        v = np.linalg.solve(L, Ks)
        var = np.clip(1.0 - np.sum(v * v, axis=0), 1e-12, None)
        return mean * sd0 + mu0, np.sqrt(var) * sd0

    def suggest(self) -> float:
        """Next x maximizing expected improvement (for minimization)."""
        if not self.xs:
            return float(self._rng.uniform(self.lo, self.hi))
        mean, std = self._posterior(self._grid)
        best = min(self.ys)
        imp = best - mean - self.xi * (abs(best) + 1e-12)
        z = imp / std
        ei = imp * _norm_cdf(z) + std * _norm_pdf(z)
        # tiny jitter breaks exact ties on the grid
        ei = ei + 1e-12 * self._rng.random(ei.shape)
        x01 = float(self._grid[int(np.argmax(ei))])
        return self.lo + x01 * (self.hi - self.lo)

    @property
    def best(self) -> tuple[float, float]:
        i = int(np.argmin(self.ys))
        return self.xs[i], self.ys[i]


class Tuner:
    """Step-driven threshold tuner (reference dear/tuner.py semantics).

    Call `step()` once per training iteration; it returns a new threshold
    (MB) when a measurement window completes and a different point should be
    tried, else None. After ``max_num_steps`` trials it adopts and returns
    the best point (printing the trial table like tuner.py:78-89), then
    always returns None.
    """

    def __init__(self, x: float = 25.0, bound: tuple[float, float] = (1.0, 256.0),
                 max_num_steps: int = 10, interval: int = 5,
                 log: Callable[[str], None] = print,
                 clock: Callable[[], float] = time.perf_counter,
                 seed: int = 0):
        self._current = float(x)
        # the trial RNG is PINNED per tuner (EI tie-break jitter + the
        # cold-start draw): two runs of the same seed propose identical
        # trial sequences, so tests assert on plan-rebuild behavior
        # without loss-trajectory flake
        self._opt = BayesianOptimizer(bound, seed=seed)
        self._max = max_num_steps
        if interval < 4:
            # the first 3 durations of each window are discarded, so a
            # smaller interval would never produce a measurement
            raise ValueError(f"interval must be >= 4, got {interval}")
        self._interval = interval
        self._log = log
        self._clock = clock
        self._num_steps = 0
        self._timestamps: list[float] = []
        self._warmup = True
        self._best: Optional[tuple[float, float]] = None
        self._feasible_ys: list[float] = []  # real measurements only
        self._context_key = ""
        self.finished = False

    def _record(self) -> Optional[float]:
        self._timestamps.append(self._clock())
        if len(self._timestamps) < self._interval:
            return None
        if self._warmup:  # discard the first window (the rebuild lands here)
            self._warmup = False
            self._timestamps = []
            return None
        ts = self._timestamps
        durations = [ts[i] - ts[i - 1] for i in range(3, len(ts))]
        self._timestamps = []
        return float(np.mean(durations)) if durations else None

    def notify_rebuild(self) -> None:
        """Tell the tuner a re-bucketing happened: next window is warmup."""
        self._warmup = True
        self._timestamps = []

    def notify_context(self, **ctx) -> None:
        """Invalidate measurement-derived state on a context change the
        observations cannot survive — world size, membership epoch, model
        identity (`AutoTuner.rescale` calls this). The GP observations are
        namespaced per context (`BayesianOptimizer.set_context`), the
        incumbent best and feasible-measurement history reset, and the
        next window is warmup; the trial budget is NOT reset (a rescale
        mid-search spends remaining trials on the new world rather than
        restarting the run's tuning phase)."""
        key = ",".join(f"{k}={ctx[k]}" for k in sorted(ctx))
        if key == self._context_key:
            return
        self._context_key = key
        self._opt.set_context(key)
        self._best = None
        self._feasible_ys = []
        self.notify_rebuild()
        self._log(f"BO Tuning context changed ({key}); "
                  "stale observations shelved")

    def mark_infeasible(self, x: float, *,
                        revert_to: Optional[float] = None,
                        penalty: Optional[float] = None) -> None:
        """Record trial point ``x`` as infeasible (its rebuild failed or it
        diverged): register a dominated observation so the GP steers away,
        count it as a consumed trial, and reset the measurement window
        (the failed attempt's wall time must not contaminate timing).
        ``revert_to`` is the threshold actually still live (the rebuild
        never happened); ``penalty`` overrides the default dominated value
        (10x the worst FEASIBLE measurement — prior penalties excluded so
        consecutive infeasible trials don't compound and blow up the GP's
        y-standardization — or 1e6 before any real observation)."""
        if penalty is None:
            penalty = (10.0 * max(self._feasible_ys)
                       if self._feasible_ys else 1e6)
        self._opt.register(float(x), float(penalty))
        self._num_steps += 1
        self._timestamps = []
        if revert_to is not None:
            self._current = float(revert_to)
        self._log(
            f"BO Tuning step [{self._num_steps - 1}], param: {x:.4f} "
            f"INFEASIBLE (penalty {penalty:.4g}); staying at "
            f"{self._current:.4f}"
        )

    def step(self) -> Optional[float]:
        if self.finished:
            return None
        if self._num_steps >= self._max:
            self.finished = True
            if self._best is None:
                # every trial was infeasible: nothing to adopt
                self._log("BO Tuning finished: no feasible measurement; "
                          f"keeping param {self._current:.4f}")
                return None
            point, t = self._best
            self._log(
                f"BO Tuning optimal param: {point:.4f}, "
                f"optimal iteration time {t:.4f}"
            )
            return point if point != self._current else None

        iter_time = self._record()
        if iter_time is None:
            return None

        self._log(
            f"BO Tuning step [{self._num_steps}], param: "
            f"{self._current:.4f}, iteration time: {iter_time:.4f}"
        )
        if self._best is None or iter_time < self._best[1]:
            self._best = (self._current, iter_time)
        self._feasible_ys.append(iter_time)
        self._opt.register(self._current, iter_time)
        nxt = self._opt.suggest()
        self._num_steps += 1
        if nxt == self._current:
            # re-measuring the same point needs no rebuild; the next
            # window simply registers another observation of it
            return None
        self._current = nxt
        return nxt

    @property
    def current(self) -> float:
        return self._current

    @property
    def budget_steps(self) -> int:
        """Upper-bound training steps to consume the whole trial budget:
        one warmup window per rebuild plus one measured window per trial,
        plus the adoption window (the tune-then-measure protocol sizes
        its pre-timing loop with this)."""
        return (2 * self._max + 2) * self._interval
