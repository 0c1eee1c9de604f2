"""Plan-space search: every speed lever of the train step in ONE tuned
space — the port of ``dear_pytorch_tpu/tuning/planspace.py`` (its training
half).

The BO tuner (`bo.Tuner`) tunes one knob, the fusion threshold. The
schedule carries five more: six gradient compressors (`ops.compression`),
comm/gather wire dtypes (bf16 casts, the qint8 int8-packed format), the
schedule mode (``dear`` vs the ring-kernel ``dear-fused``), and
rematerialization. This module turns those levers into a typed
`PlanSpace` and searches it with a mixed bandit/BO strategy:

  - **Axes.** One continuous axis (``threshold_mb``) and five categorical
    axes (``mode``, ``compressor``, ``comm_dtype``, ``gather_dtype``,
    ``remat``). A categorical combination is an *arm*; the threshold is
    refined WITHIN an arm by the 1-D GP+EI optimizer
    (`bo.BayesianOptimizer`).
  - **Feasibility.** Combinations the schedules cannot execute
    (compressed payloads through the dear-fused ring kernels; a wire
    dtype under a compressor that already owns the wire format) are
    rejected at space-construction time — they never consume a trial.
    Runtime failures (a build error, a diverging trial) arrive via
    `PlanTuner.mark_infeasible`: penalty observation, arm optionally
    retired, measurement window reset.
  - **Analytic pruning.** Before an arm burns live trial steps, its
    communication cost is predicted (`observability.costmodel.CostModel`:
    `observability.counters.plan_comm_accounting` x the α-β interconnect
    fit). The model calibrates the fit against measured step times and
    prunes any arm whose ideal-overlap floor cannot beat the incumbent by
    the margin. Pruned arms are counted (``tune.prunes``) and logged.
  - **Context invalidation.** `PlanTuner.notify_context` shelves every
    observation, per-arm posterior and prune decision under the old
    context key.

Telemetry: ``tune.trials`` / ``tune.prunes`` / ``tune.infeasible`` /
``tune.best_changed`` counters and ``tune.*`` events on the global tracer
(`observability.tracer`). The JAX module's per-decision JSONL trial log
(``trial_log`` / ``DEAR_TUNE_LOG``) rides its ``observability/export.py``,
which is not ported yet: asking for it raises ``NotImplementedError``
naming ROADMAP Queue 1 item 12. The serving retarget (``ServeConfig``,
``ServeSpace``, ``ServeTuner``) waits for item 11.

Semantics note: the compressor and dtype axes are LOSSY — the search
optimizes step time, not the loss trajectory. Restrict the space
(constructor args or ``DEAR_TUNE_*`` env) when convergence parity matters.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from dear_pytorch_tpu_torch.observability import tracer as _telemetry
from dear_pytorch_tpu_torch.observability.costmodel import (
    DTYPE_ITEMSIZE as _DTYPE_ITEMSIZE,
)
from dear_pytorch_tpu_torch.observability.costmodel import CostModel

__all__ = ["Axis", "CostModel", "PlanConfig", "PlanSpace", "PlanTuner",
           "dtype_token"]

#: compressor names whose ``density`` argument is live (top-k family)
_SPARSE = ("topk", "eftopk", "gaussian")

#: wire-dtype token -> torch dtype
_TORCH_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}


def dtype_token(dtype) -> Optional[str]:
    """Map a torch dtype (or a token, a name, or None) to the canonical
    token: None (fp32, the masters' dtype), ``"bf16"`` or ``"f16"``."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        tok = {"": None, "none": None, "f32": None, "float32": None,
               "bf16": "bf16", "bfloat16": "bf16",
               "f16": "f16", "float16": "f16"}.get(dtype.lower(), dtype)
    else:
        tok = {torch.float32: None, torch.bfloat16: "bf16",
               torch.float16: "f16"}.get(dtype, str(dtype))
    if tok is not None and tok not in _DTYPE_ITEMSIZE:
        raise ValueError(f"unknown wire dtype {dtype!r}")
    return tok


def _torch_dtype(token: Optional[str]):
    return None if token is None else _TORCH_DTYPES[token]


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """One point of the plan space (hashable, JSON-safe)."""

    threshold_mb: float = 25.0
    mode: str = "dear"
    compressor: Optional[str] = None
    density: float = 0.01           # top-k family kept fraction
    comm_dtype: Optional[str] = None
    gather_dtype: Optional[str] = None
    remat: Optional[str] = None     # None | 'full'
    #: per-level bucket partition: the cross-node message size of the
    #: hierarchical schedule (None = the build default). A searched axis
    #: only on multi-slice spaces (`PlanSpace(num_slices > 1)`: an
    #: `AutoTuner` over a ``dcn=`` step, `parallel.dear`).
    partition_mb: Optional[float] = None

    def key(self) -> tuple:
        """Categorical identity (the bandit arm) — everything but the
        continuous threshold."""
        return (self.mode, self.compressor, self.comm_dtype,
                self.gather_dtype, self.remat, self.partition_mb)

    def describe(self) -> str:
        parts = [f"{self.mode}", f"thr={self.threshold_mb:.3g}MB"]
        if self.compressor:
            parts.append(self.compressor
                         + (f"@{self.density:g}"
                            if self.compressor in _SPARSE else ""))
        if self.comm_dtype:
            parts.append(f"comm={self.comm_dtype}")
        if self.gather_dtype:
            parts.append(f"gather={self.gather_dtype}")
        if self.remat:
            parts.append(f"remat={self.remat}")
        if self.partition_mb is not None:
            parts.append(f"dcn={self.partition_mb:.3g}MB")
        return "/".join(parts)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def build_kwargs(self) -> dict:
        """kwargs for `parallel.dear.build_train_step` (the dtype tokens
        as torch dtypes)."""
        kw = dict(
            threshold_mb=float(self.threshold_mb),
            mode=self.mode,
            compressor=self.compressor,
            density=float(self.density),
            comm_dtype=_torch_dtype(self.comm_dtype),
            gather_dtype=_torch_dtype(self.gather_dtype),
            remat=self.remat,
        )
        if self.partition_mb is not None:
            kw["partition_mb"] = float(self.partition_mb)
        return kw


@dataclasses.dataclass(frozen=True)
class Axis:
    """Typed description of one searched dimension."""

    name: str
    kind: str                      # 'continuous' | 'categorical'
    choices: tuple = ()            # categorical values
    bound: tuple = ()              # continuous (lo, hi)


class PlanSpace:
    """The typed search space + its feasibility rules.

    Defaults search both schedule modes, the error-feedback compressor
    family plus the int8 wire format, bf16 wire casts, and remat.
    ``DEAR_TUNE_MODES`` / ``DEAR_TUNE_COMPRESSORS`` / ``DEAR_TUNE_DTYPES``
    / ``DEAR_TUNE_REMAT`` / ``DEAR_TUNE_DENSITY`` restrict or extend each
    axis from the environment (comma lists; 'none' = the None choice) —
    see `from_env`.
    """

    def __init__(
        self,
        *,
        threshold_bound: tuple[float, float] = (1.0, 256.0),
        modes: Sequence[str] = ("dear", "dear-fused"),
        compressors: Sequence[Optional[str]] = (
            None, "eftopk", "gaussian", "efsignum", "qint8"),
        comm_dtypes: Sequence[Optional[str]] = (None, "bf16"),
        gather_dtypes: Sequence[Optional[str]] = (None, "bf16"),
        remats: Sequence[Optional[str]] = (None, "full"),
        density: float = 0.01,
        num_slices: int = 1,
        partition_mbs: Sequence[Optional[float]] = (None,),
    ):
        if not threshold_bound[1] > threshold_bound[0] > 0:
            raise ValueError(f"bad threshold bound {threshold_bound}")
        for m in modes:
            if m not in ("dear", "dear-fused"):
                raise ValueError(
                    f"plan-space mode axis supports 'dear'/'dear-fused', "
                    f"got {m!r} (other schedules are hand-picked baselines)")
        self.threshold_bound = (float(threshold_bound[0]),
                                float(threshold_bound[1]))
        self.modes = tuple(modes)
        self.compressors = tuple(compressors)
        self.comm_dtypes = tuple(dtype_token(d) for d in comm_dtypes)
        self.gather_dtypes = tuple(dtype_token(d) for d in gather_dtypes)
        self.remats = tuple(None if r in (None, "none") else r
                            for r in remats)
        for r in self.remats:
            if r not in (None, "full"):
                raise ValueError(f"bad remat choice {r!r}")
        self.density = float(density)
        #: topology: >1 = the hierarchical (multi-slice) schedule; the
        #: per-level bucket partition (DCN message size) then becomes a
        #: searched axis and DCN-illegal combos become infeasible arms
        self.num_slices = int(num_slices)
        if self.num_slices < 1:
            raise ValueError(f"num_slices must be >= 1, got {num_slices}")
        self.partition_mbs = tuple(
            None if p in (None, "none") else float(p)
            for p in partition_mbs)
        for p in self.partition_mbs:
            if p is not None and p <= 0:
                raise ValueError(f"bad partition_mb choice {p!r}")
        if self.num_slices == 1 and any(
                p is not None for p in self.partition_mbs):
            raise ValueError(
                "partition_mb is the cross-slice (DCN) message size — a "
                "searched axis only on multi-slice spaces (num_slices>1)")

    @classmethod
    def from_env(cls, **overrides) -> "PlanSpace":
        """Build a space with ``DEAR_TUNE_*`` env restrictions applied
        (explicit ``overrides`` win)."""

        def _list(var, none_ok=True):
            raw = os.environ.get(var)
            if raw is None:
                return None
            out = []
            for tok in raw.split(","):
                tok = tok.strip()
                if not tok:
                    continue
                out.append(None if none_ok and tok.lower() == "none"
                           else tok)
            return tuple(out)

        kw: dict = {}
        v = _list("DEAR_TUNE_MODES", none_ok=False)
        if v is not None:
            kw["modes"] = v
        v = _list("DEAR_TUNE_COMPRESSORS")
        if v is not None:
            kw["compressors"] = v
        v = _list("DEAR_TUNE_DTYPES")
        if v is not None:
            kw["comm_dtypes"] = v
            kw["gather_dtypes"] = v
        v = _list("DEAR_TUNE_REMAT")
        if v is not None:
            kw["remats"] = v
        if os.environ.get("DEAR_TUNE_DENSITY"):
            kw["density"] = float(os.environ["DEAR_TUNE_DENSITY"])
        if os.environ.get("DEAR_TUNE_BOUND"):
            lo, hi = os.environ["DEAR_TUNE_BOUND"].split(",")
            kw["threshold_bound"] = (float(lo), float(hi))
        if os.environ.get("DEAR_TUNE_SLICES"):
            kw["num_slices"] = int(os.environ["DEAR_TUNE_SLICES"])
        v = _list("DEAR_TUNE_PARTITION")
        if v is not None:
            kw["partition_mbs"] = tuple(
                None if p is None else float(p) for p in v)
        kw.update(overrides)
        return cls(**kw)

    @property
    def cont_bound(self) -> tuple[float, float]:
        """The continuous axis' (lo, hi) — the tuner-facing name shared
        with `ServeSpace` (whose continuous axis is the prefill chunk)."""
        return self.threshold_bound

    def default_config(self) -> "PlanConfig":
        return PlanConfig(threshold_mb=0.5 * sum(self.threshold_bound))

    def axes(self) -> tuple[Axis, ...]:
        out = (
            Axis("threshold_mb", "continuous", bound=self.threshold_bound),
            Axis("mode", "categorical", choices=self.modes),
            Axis("compressor", "categorical", choices=self.compressors),
            Axis("comm_dtype", "categorical", choices=self.comm_dtypes),
            Axis("gather_dtype", "categorical", choices=self.gather_dtypes),
            Axis("remat", "categorical", choices=self.remats),
        )
        if self.num_slices > 1:
            out += (Axis("partition_mb", "categorical",
                         choices=self.partition_mbs),)
        return out

    def feasible(self, config: PlanConfig) -> Optional[str]:
        """None when the combination can build, else the reason it cannot
        (mirrors `parallel.build_train_step`'s build-time guards — checked
        here so infeasible combos never consume a live trial)."""
        if config.compressor is not None and config.mode == "dear-fused":
            return ("dear-fused ring kernels exchange dense fp tiles; "
                    "compressed payloads need mode='dear'")
        if config.compressor is not None and config.comm_dtype is not None:
            return ("the compressed wire format already owns the gradient "
                    "leg; comm_dtype is dead weight under a compressor")
        if self.num_slices > 1:
            if config.mode == "dear-fused":
                return ("multislice x dear-fused: the ring kernels "
                        "address a single flat mesh axis — a ring "
                        "spanning the DCN boundary cannot build "
                        "(parallel.build_train_step rejects it)")
            if config.compressor is not None:
                return ("multislice x compression: the cross-slice leg "
                        "averages dense partials on the host")
        elif config.partition_mb is not None:
            return ("partition_mb is the cross-slice (DCN) message size; "
                    "it needs a multi-slice space (num_slices>1)")
        return None

    def configs(self, threshold_mb: Optional[float] = None
                ) -> list[PlanConfig]:
        """Every FEASIBLE categorical combination, instantiated at
        ``threshold_mb`` (default: the bound midpoint)."""
        thr = (float(threshold_mb) if threshold_mb is not None
               else 0.5 * (self.threshold_bound[0]
                           + self.threshold_bound[1]))
        parts = (self.partition_mbs if self.num_slices > 1 else (None,))
        out = []
        for mode in self.modes:
            for comp in self.compressors:
                for cd in self.comm_dtypes:
                    for gd in self.gather_dtypes:
                        for rm in self.remats:
                            for pm in parts:
                                cfg = PlanConfig(
                                    threshold_mb=thr, mode=mode,
                                    compressor=comp,
                                    density=self.density,
                                    comm_dtype=cd, gather_dtype=gd,
                                    remat=rm, partition_mb=pm,
                                )
                                if self.feasible(cfg) is None:
                                    out.append(cfg)
        return out


# ---------------------------------------------------------------------------
# the mixed bandit/BO tuner
# ---------------------------------------------------------------------------


class PlanTuner:
    """Step-driven plan-space tuner (the `bo.Tuner` step protocol).

    The search machinery is config-type-generic: the space provides the
    arms (`configs`/`feasible`/`cont_bound`/`default_config`) and
    ``CONT_FIELD`` names the one continuous dataclass field the per-arm
    BO refines — ``threshold_mb`` here (the JAX package's serving
    retarget, ``ServeTuner``, refines ``prefill_chunk``).

    Call `step()` once per training iteration. It returns a `PlanConfig`
    when a measurement window completes and a different configuration
    should be tried, else None; after ``max_trials`` completed windows it
    adopts the best observed configuration (returning it if not current)
    and sets ``finished``. Timing protocol parity with `bo.Tuner`: windows
    of ``interval`` steps, the first window after every (re)build is
    warmup, the first 3 durations of a window are discarded.

    Arm selection: unvisited arms are swept first in analytic-cost order
    (cheapest `CostModel.comm` first; arms whose `CostModel.floor` cannot
    beat the incumbent by ``prune_margin`` are pruned instead of trialed);
    once every arm is visited or pruned, ε-greedy exploitation picks the
    best arm (or, with probability ``explore``, a random visited one) and
    refines its threshold through that arm's own `bo.BayesianOptimizer`.
    """

    #: name of the config dataclass' continuous field (per-arm BO axis)
    CONT_FIELD = "threshold_mb"

    def _cont(self, config) -> float:
        return float(getattr(config, self.CONT_FIELD))

    def _with_cont(self, config, value: float):
        return dataclasses.replace(config,
                                   **{self.CONT_FIELD: float(value)})

    def __init__(
        self,
        space: PlanSpace,
        *,
        x: Optional[PlanConfig] = None,
        max_trials: int = 12,
        interval: int = 5,
        log: Callable[[str], None] = print,
        clock: Callable[[], float] = time.perf_counter,
        seed: int = 0,
        cost_model: Optional[CostModel] = None,
        prune_margin: float = 0.25,
        min_obs_to_prune: int = 2,
        explore: float = 0.15,
        trial_log: Optional[str] = None,
        tracer: Optional[Any] = None,
        bo_factory: Optional[Callable] = None,
    ):
        if interval < 4:
            raise ValueError(f"interval must be >= 4, got {interval}")
        self.space = space
        base = x if x is not None else space.default_config()
        why = space.feasible(base)
        if why is not None:
            raise ValueError(f"infeasible starting config "
                             f"{base.describe()}: {why}")
        self._current = base
        self._max = int(max_trials)
        self._interval = int(interval)
        self._log = log
        self._clock = clock
        self._seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self.cost_model = cost_model
        self._prune_margin = float(prune_margin)
        self._min_obs_to_prune = int(min_obs_to_prune)
        self._explore = float(explore)
        if trial_log or os.environ.get("DEAR_TUNE_LOG"):
            raise NotImplementedError(
                "the plan tuner's JSONL trial log (trial_log / "
                "DEAR_TUNE_LOG) rides observability/export.py, which is "
                "not ported yet: ROADMAP Queue 1 item 12")
        self._tracer = tracer
        self._bo_factory = bo_factory
        # arm universe: feasible combos + the starting arm
        self._arm_keys: list[tuple] = []
        self._arm_cfg: dict[tuple, PlanConfig] = {}
        for cfg in space.configs(self._cont(base)):
            self._arm_keys.append(cfg.key())
            self._arm_cfg[cfg.key()] = cfg
        if base.key() not in self._arm_cfg:
            self._arm_keys.insert(0, base.key())
            self._arm_cfg[base.key()] = base
        if len(self._arm_keys) > self._max:
            self._log(
                f"plan tuner budget ({self._max} trials) is below the "
                f"feasible arm count ({len(self._arm_keys)}): the sweep "
                "samples axis values diversity-first (or cost-ordered "
                "with a fit) but cannot visit every combination — raise "
                "max_trials or restrict DEAR_TUNE_* axes")
        # per-context search state (see notify_context)
        self._context_key = ""
        self._archive: dict[str, dict] = {}
        self._reset_observations()
        self._num_trials = 0
        self._timestamps: list[float] = []
        self._warmup = True
        self.finished = False

    # -- bookkeeping ---------------------------------------------------------

    def _reset_observations(self) -> None:
        self._obs: dict[tuple, list[tuple[float, float]]] = {}
        self._best: Optional[tuple[PlanConfig, float]] = None
        self._arm_bo: dict[tuple, Any] = {}
        self._pruned: dict[tuple, str] = {}
        self._dead: dict[tuple, str] = {}      # fatal build failures
        self._feasible_ys: list[float] = []

    def _tr(self):
        if self._tracer is not None:
            return self._tracer
        return _telemetry.get_tracer()

    def _bo_for(self, key: tuple):
        opt = self._arm_bo.get(key)
        if opt is None:
            if self._bo_factory is None:
                from dear_pytorch_tpu_torch.tuning.bo import (
                    BayesianOptimizer,
                )

                factory = BayesianOptimizer
            else:
                factory = self._bo_factory
            opt = factory(self.space.cont_bound,
                          seed=self._seed + 7 * len(self._arm_bo))
            self._arm_bo[key] = opt
        return opt

    # -- bo.Tuner-shaped protocol -------------------------------------------

    def notify_rebuild(self) -> None:
        """A rebuild happened: the next window is warmup."""
        self._warmup = True
        self._timestamps = []

    def notify_context(self, **ctx) -> None:
        """Shelve every observation, posterior, and prune decision under
        the old context key and start clean for the new one (elastic
        rescale: stale posteriors must not be exploited — the budget is
        not reset, see `bo.Tuner.notify_context`)."""
        key = ",".join(f"{k}={ctx[k]}" for k in sorted(ctx))
        if key == self._context_key:
            return
        self._archive[self._context_key] = {
            "obs": self._obs, "best": self._best, "arm_bo": self._arm_bo,
            "pruned": self._pruned, "dead": self._dead,
            "feasible_ys": self._feasible_ys,
        }
        shelved = self._archive.get(key)
        if shelved is not None:
            self._obs = shelved["obs"]
            self._best = shelved["best"]
            self._arm_bo = shelved["arm_bo"]
            self._pruned = shelved["pruned"]
            self._dead = shelved["dead"]
            self._feasible_ys = shelved["feasible_ys"]
        else:
            self._reset_observations()
        self._context_key = key
        self.notify_rebuild()
        self._log(f"plan tuner context changed ({key}); "
                  "stale observations shelved")

    def mark_infeasible(self, config: PlanConfig, *,
                        revert_to: Optional[PlanConfig] = None,
                        fatal: bool = False,
                        why: str = "") -> None:
        """Sandbox a failed/diverged trial: dominated observation so the
        search steers away, window reset. ``fatal=True`` retires the
        whole arm (its build raised — no threshold can fix a structurally
        impossible combo) WITHOUT consuming a trial from the measurement
        budget: a build failure costs milliseconds, not a measurement
        window, and a space full of combos the surrounding static kwargs
        cannot express (clip_norm x compression, LAMB x dear-fused, ...)
        must not eat the search budget arm by arm — retirement bounds the
        total at the arm count. A non-fatal failure (a diverging live
        trial burned real steps) consumes its trial and only penalizes
        this threshold."""
        penalty = (10.0 * max(self._feasible_ys)
                   if self._feasible_ys else 1e6)
        key = config.key()
        self._bo_for(key).register(self._cont(config), penalty)
        self._obs.setdefault(key, []).append(
            (self._cont(config), penalty))
        if fatal:
            self._dead[key] = why or "build failed"
        else:
            self._num_trials += 1
        self._timestamps = []
        if revert_to is not None:
            self._current = revert_to
        tr = self._tr()
        if tr.enabled:
            tr.count("tune.infeasible")
            tr.event("tune.trial_infeasible", config=config.describe(),
                     fatal=int(fatal), why=why[:120])
        label = ("arm retired (no trial charged)" if fatal
                 else f"trial [{self._num_trials - 1}]")
        self._log(
            f"plan tuner {label} "
            f"{config.describe()} INFEASIBLE"
            + (f" (fatal: {why})" if fatal else f" ({why})" if why else "")
            + f"; staying at {self._current.describe()}"
        )

    def _record(self) -> Optional[float]:
        self._timestamps.append(self._clock())
        if len(self._timestamps) < self._interval:
            return None
        if self._warmup:   # discard the first window (the rebuild lands here)
            self._warmup = False
            self._timestamps = []
            return None
        ts = self._timestamps
        durations = [ts[i] - ts[i - 1] for i in range(3, len(ts))]
        self._timestamps = []
        return float(np.mean(durations)) if durations else None

    # -- selection -----------------------------------------------------------

    def _live_arms(self) -> list[tuple]:
        return [k for k in self._arm_keys
                if k not in self._pruned and k not in self._dead]

    def _prune_sweep(self) -> None:
        """Analytically retire unvisited arms whose ideal-overlap floor
        cannot beat the incumbent (only once calibrated: >= min_obs
        measurements and a known best)."""
        if (self.cost_model is None or self._best is None
                or len(self._feasible_ys) < self._min_obs_to_prune):
            return
        bar = self._best[1] * (1.0 + self._prune_margin)
        tr = self._tr()
        for key in self._live_arms():
            if key in self._obs:
                continue
            cfg = self._arm_cfg[key]
            try:
                floor = self.cost_model.floor(
                    self._with_cont(cfg, self._cont(self._best[0])))
            except Exception:
                continue   # an unpriceable arm is trialed, not dropped
            if floor is not None and floor > bar:
                self._pruned[key] = (
                    f"analytic floor {floor * 1e3:.3f} ms > "
                    f"{bar * 1e3:.3f} ms bar")
                if tr.enabled:
                    tr.count("tune.prunes")
                    tr.event("tune.pruned", config=cfg.describe(),
                             floor_s=floor, bar_s=bar)
                self._log(f"plan tuner pruned {cfg.describe()} "
                          f"({self._pruned[key]})")

    def _propose(self) -> Optional[PlanConfig]:
        self._prune_sweep()
        live = self._live_arms()
        if not live:
            return None
        unvisited = [k for k in live if k not in self._obs]
        thr = self._cont(self._best[0] if self._best is not None
                         else self._current)
        if unvisited:
            if self.cost_model is not None:
                def price(k):
                    try:
                        return self.cost_model.comm(
                            self._with_cont(self._arm_cfg[k], thr))
                    except Exception:
                        return float("inf")

                key = min(unvisited, key=price)
            else:
                # no cost model: maximize AXIS coverage instead of taking
                # nested-loop order — a budget smaller than the arm count
                # must still sample every mode/compressor/dtype value at
                # least once rather than burn every trial on the first
                # mode's dtype combinations
                seen: dict[tuple, int] = {}
                for k in self._obs:
                    for pos, val in enumerate(k):
                        seen[(pos, val)] = seen.get((pos, val), 0) + 1

                def novelty(k):
                    return sum(seen.get((pos, val), 0)
                               for pos, val in enumerate(k))

                key = min(unvisited, key=novelty)
            return self._with_cont(self._arm_cfg[key], thr)
        visited = [k for k in live if k in self._obs]
        if not visited:
            return None
        if self._best is not None and self._rng.random() >= self._explore:
            key = self._best[0].key()
            if key not in self._obs or key in self._dead \
                    or key in self._pruned:  # best arm retired meanwhile
                key = visited[0]
        else:
            key = visited[int(self._rng.integers(len(visited)))]
        nxt = float(self._bo_for(key).suggest())
        return self._with_cont(self._arm_cfg[key], nxt)

    def _adopt(self) -> Optional[PlanConfig]:
        """Budget exhausted: install the best observed config."""
        self.finished = True
        if self._best is None:
            self._log("plan tuner finished: no feasible measurement; "
                      f"keeping {self._current.describe()}")
            return None
        cfg, t = self._best
        self._log(f"plan tuner optimal config: {cfg.describe()}, "
                  f"iteration time {t:.4f}")
        if cfg != self._current:
            self._current = cfg
            return cfg
        return None

    def _ingest(self, iter_time: float) -> Optional[PlanConfig]:
        """Book one completed measurement of ``self._current`` and
        propose the next config (None = stay)."""
        key = self._current.key()
        self._obs.setdefault(key, []).append(
            (self._cont(self._current), iter_time))
        self._feasible_ys.append(iter_time)
        self._bo_for(key).register(self._cont(self._current), iter_time)
        if self.cost_model is not None:
            try:
                self.cost_model.observe(self._current, iter_time)
            except Exception:
                pass
        tr = self._tr()
        best_changed = self._best is None or iter_time < self._best[1]
        if best_changed:
            self._best = (self._current, iter_time)
        if tr.enabled:
            tr.count("tune.trials")
            if best_changed:
                tr.count("tune.best_changed")
            tr.event("tune.trial", config=self._current.describe(),
                     measured_s=iter_time, best=int(best_changed))
        self._log(
            f"plan tuner trial [{self._num_trials}] "
            f"{self._current.describe()}: iteration time {iter_time:.4f}"
            + (" *best*" if best_changed else "")
        )
        self._num_trials += 1
        if self._num_trials >= self._max:
            # budget exhausted: the next step() adopts the best config —
            # proposing one more trial here would force a rebuild
            # (plus a snapshot state copy) of a config that is abandoned
            # unmeasured one step later
            return None
        nxt = self._propose()
        if nxt is None or nxt == self._current:
            return None
        self._current = nxt
        return nxt

    def step(self) -> Optional[PlanConfig]:
        if self.finished:
            return None
        if self._num_trials >= self._max:
            return self._adopt()
        iter_time = self._record()
        if iter_time is None:
            return None
        return self._ingest(iter_time)

    @property
    def current(self) -> PlanConfig:
        return self._current

    @property
    def budget_steps(self) -> int:
        """Upper-bound training steps to consume the whole trial budget:
        every trial may cost a warmup window (config changes rebuild) plus
        its measured window, plus the adoption window."""
        return (2 * self._max + 2) * self._interval

    @property
    def best_config(self) -> Optional[PlanConfig]:
        return self._best[0] if self._best is not None else None

    def summary(self) -> dict:
        """JSON-safe snapshot of the search (bench reporting)."""
        return {
            "trials": self._num_trials,
            "finished": self.finished,
            "context": self._context_key,
            "current": self._current.to_dict(),
            "best": (self._best[0].to_dict()
                     if self._best is not None else None),
            "best_s": (self._best[1] if self._best is not None else None),
            "arms": len(self._arm_keys),
            "visited": len(self._obs),
            "pruned": {"/".join(str(p) for p in k): v
                       for k, v in self._pruned.items()},
            "dead": {"/".join(str(p) for p in k): v
                     for k, v in self._dead.items()},
        }
