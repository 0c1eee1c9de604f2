"""The α-β cost model the plan tuner prunes with — the part of
``dear_pytorch_tpu/observability/costmodel.py`` that `tuning.planspace`
uses: `LinkFit` / `Calibration` (serializable fits, and
`load_calibration`), `fit_allgather_sweep` (the normalization of
`overlap.fit_interconnect`'s sweep), `fit_dcn` (the cross-slice link's
α-β from a `comm.dcn.DcnExchanger`'s fetch samples), `CostModel` (a
configuration's predicted comm and its step-time floor) and
`price_degraded_round` (one remote slice's cost in a degraded-mode DCN
round). The serving cost model (``ServeCostModel``) waits for the
serving tuner (ROADMAP Queue 1 item 11); the trace calibration waits for
item 12.

The JSON grammar of a calibration accepts both the flat shape
``{"alpha": ..., "beta": ...}`` and the two-level shape
``{"ici": {...}, "dcn": {...}}`` (the JAX package's names for the
intra-node and cross-node links).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Callable, Optional, Sequence

__all__ = ["CostModel", "Calibration", "DTYPE_ITEMSIZE", "LinkFit",
           "fit_allgather_sweep", "fit_dcn", "load_calibration",
           "price_degraded_round"]

#: wire itemsize per comm/gather dtype token (None = keep f32) — shared
#: with `tuning.planspace`
DTYPE_ITEMSIZE = {None: 4, "bf16": 2, "f16": 2}


# ---------------------------------------------------------------------------
# serializable fits
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkFit:
    """One (α, β) link fit: seconds per message plus seconds per byte.

    ``source`` records provenance ("measured", "env", "file", "default")
    and ``nsamples`` how many points backed the fit — both are carried
    into dumps so a simulated report can say what its prices rest on."""

    alpha: float
    beta: float
    source: str = "measured"
    nsamples: int = 0

    def to_dict(self) -> dict:
        return {"alpha": self.alpha, "beta": self.beta,
                "source": self.source, "nsamples": self.nsamples}

    @classmethod
    def from_dict(cls, d: dict, *, source: str = "file") -> "LinkFit":
        return cls(alpha=float(d["alpha"]), beta=float(d["beta"]),
                   source=str(d.get("source", source)),
                   nsamples=int(d.get("nsamples", 0)))


@dataclasses.dataclass(frozen=True)
class Calibration:
    """The per-level link fits one topology needs: the intra-node link
    (``ici``, the JAX package's name) and, multi-node only, the cross-node
    one (``dcn``). Their α-β constants differ by orders of magnitude — one
    fit cannot price both levels (why `CostModel` takes
    ``dcn_alpha/dcn_beta`` separately)."""

    ici: LinkFit
    dcn: Optional[LinkFit] = None

    def to_dict(self) -> dict:
        d: dict = {"ici": self.ici.to_dict()}
        if self.dcn is not None:
            d["dcn"] = self.dcn.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        if "ici" not in d and "alpha" in d:
            # flat legacy shape: one fit, assumed intra-slice
            return cls(ici=LinkFit.from_dict(d))
        dcn = d.get("dcn")
        return cls(ici=LinkFit.from_dict(d["ici"]),
                   dcn=None if dcn is None else LinkFit.from_dict(dcn))

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")


def load_calibration(source) -> Calibration:
    """`Calibration` from a dict, a JSON file path, or a JSON string.

    File contents may be either calibration shape, or a whole record
    that EMBEDS one under a ``"calibration"`` key."""
    if isinstance(source, Calibration):
        return source
    if isinstance(source, dict):
        d = source
    else:
        text = str(source)
        if text.lstrip().startswith("{"):
            d = json.loads(text)
        else:
            with open(text, encoding="utf-8") as f:
                d = json.load(f)
    if "calibration" in d and isinstance(d["calibration"], dict):
        d = d["calibration"]
    return Calibration.from_dict(d)


# ---------------------------------------------------------------------------
# fit plumbing (the math halves of overlap.fit_interconnect / fit_dcn)
# ---------------------------------------------------------------------------


def fit_allgather_sweep(world: int, sizes_bytes: Sequence[float],
                        times_s: Sequence[float]) -> tuple[float, float]:
    """(α, β) from a whole-collective ring all-gather sweep — the
    normalization half of `overlap.fit_interconnect` (which owns the live
    measurement): whole-collective times become the per-round α-β form
    the leg model consumes, ``t_leg = (w-1)·α + β·wire ≈ measured``. At
    world 1 the rounds are the whole collective (one local copy)."""
    from dear_pytorch_tpu_torch.utils import perf_model

    w = max(int(world), 1)
    per_round = [t / max(w - 1, 1) for t in times_s]
    round_bytes = [s / w for s in sizes_bytes]
    return perf_model.fit_alpha_beta(round_bytes, per_round)


def fit_dcn(samples: Sequence[tuple[float, float]],
            *, min_samples: int = 4) -> tuple[float, float]:
    """(α, β) for the cross-slice DCN level from the exchanger's own
    per-fetch timing samples (`comm.dcn.DcnExchanger.samples` —
    ``(bytes, seconds)`` per remote chunk fetch). The per-level half of
    the link-aware fit: `fit_allgather_sweep` normalizes the intra-slice
    sweep, this one reuses the transfer timings the training run already
    paid for. Raises ``ValueError`` below ``min_samples`` — a one-point
    fit would hand the cost model a degenerate β and silently
    mis-prune."""
    from dear_pytorch_tpu_torch.utils import perf_model

    pts = [(float(b), float(t)) for b, t in samples
           if t > 0 and b >= 0]
    if len(pts) < int(min_samples):
        raise ValueError(
            f"DCN fit needs >= {min_samples} (bytes, secs) samples, got "
            f"{len(pts)} — run more exchanges or set DEAR_TUNE_FIT_DCN "
            "to an explicit 'alpha,beta'")
    return perf_model.fit_alpha_beta(*zip(*pts))


# ---------------------------------------------------------------------------
# cost model: the exposed-comm estimate as a trial pruner
# ---------------------------------------------------------------------------


class CostModel:
    """Analytic per-config step-time floor from the α-β interconnect fit.

    ``comm(config)`` prices the config's collective legs via
    `counters.plan_comm_accounting` (compression ratios and wire dtypes
    included) x `overlap.predict_leg_times`. Because the raw α-β fit of
    standalone collectives need not price the step's own (which overlap
    and share launches), the model calibrates one multiplicative scale
    from live measurements: ``scale = min(measured / comm_pred)`` over
    observed configs, capped at 1. The pruning floor is the ideal-overlap
    bound ``max(compute_est, scale x comm_pred)`` where ``compute_est`` is
    the median of ``measured − scale x comm_pred`` over observations
    (remat='full' scales it by ``remat_factor``). Sound up to the stated
    assumption that the fit's error is a config-independent factor.
    """

    def __init__(self, plan_fn: Callable[[float], Any], alpha: float,
                 beta: float, *, remat_factor: float = 1.3,
                 num_slices: int = 1,
                 dcn_alpha: Optional[float] = None,
                 dcn_beta: Optional[float] = None):
        self._plan_fn = plan_fn      # threshold_mb -> FusionPlan
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.remat_factor = float(remat_factor)
        #: multi-slice pricing: the 'dcn' accounting rows (cross-slice
        #: host exchange, chunked at each config's ``partition_mb``) are
        #: costed with their OWN link fit — the two links' α-β constants
        #: differ by orders of magnitude, so one fit cannot rank a
        #: partition/threshold trade across levels.
        #: With no DCN fit the rows fall back to the intra-slice fit
        #: (`overlap.predict_leg_times` states the same behavior).
        self.num_slices = int(num_slices)
        self.dcn_alpha = None if dcn_alpha is None else float(dcn_alpha)
        self.dcn_beta = None if dcn_beta is None else float(dcn_beta)
        self._plans: dict = {}
        self._obs: list[tuple[float, float]] = []   # (comm_pred, measured)

    def _plan(self, threshold_mb: float):
        key = round(float(threshold_mb), 3)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = self._plan_fn(key)
        return plan

    def comm(self, config) -> float:
        """Uncalibrated unoverlapped comm seconds for one config."""
        from dear_pytorch_tpu_torch.observability import counters as CTR
        from dear_pytorch_tpu_torch.observability import overlap as OV

        acct = CTR.plan_comm_accounting(
            self._plan(config.threshold_mb), mode=config.mode,
            comm_itemsize=DTYPE_ITEMSIZE[config.comm_dtype],
            gather_itemsize=DTYPE_ITEMSIZE[config.gather_dtype],
            compressor=config.compressor, density=config.density,
            num_slices=self.num_slices,
            dcn_partition_mb=config.partition_mb,
        )
        return float(sum(OV.predict_leg_times(
            acct, self.alpha, self.beta,
            dcn_alpha=self.dcn_alpha, dcn_beta=self.dcn_beta)))

    def observe(self, config, measured_s: float) -> None:
        if measured_s > 0 and math.isfinite(measured_s):
            self._obs.append((self.comm(config), float(measured_s)))

    @property
    def _scale(self) -> float:
        ratios = [m / c for c, m in self._obs if c > 0]
        return min(min(ratios), 1.0) if ratios else 1.0

    @property
    def compute_est(self) -> Optional[float]:
        """LOWER bound on the config-independent compute: the MINIMUM
        residual over observations. A config whose slowness is compute
        the model cannot see (e.g. software-emulated bf16 casts on CPU)
        would drag any averaged estimate up and prune arms that are
        genuinely cheap (the JAX package saw one slow bf16 trial set a
        median compute above every arm's bar and retire the whole space)
        — pruning soundness needs the floor to UNDERestimate, never
        over."""
        if not self._obs:
            return None
        s = self._scale
        return min(max(m - s * c, 0.0) for c, m in self._obs)

    def floor(self, config) -> Optional[float]:
        """Ideal-overlap step-time floor, or None before any calibration
        observation exists (never prune blind)."""
        compute = self.compute_est
        if compute is None:
            return None
        if config.remat == "full":
            compute = compute * self.remat_factor
        return max(compute, self._scale * self.comm(config))


# ---------------------------------------------------------------------------
# degraded-mode DCN pricing (comm/dcn.py's escalation ladder)
# ---------------------------------------------------------------------------


def price_degraded_round(fit: LinkFit, wire_bytes: float, *,
                         timeout_s: float,
                         partition_mb: Optional[float] = None,
                         outage: bool = False) -> float:
    """Seconds the cross-slice leg charges for ONE remote slice in one
    exchange round under the degraded-mode ladder (`comm.dcn`).

    Healthy: the α-β price of the slice's chunked payload — one α per
    chunk at ``partition_mb`` granularity plus β per wire byte, the same
    per-message accounting `overlap.predict_leg_times` applies to 'dcn'
    rows. Outage: rung 1 burns the slice's WHOLE retry budget
    (``DEAR_DCN_TIMEOUT_SECS`` — retries spread inside it) before rung 2
    skips, so the cost of deciding to skip is exactly ``timeout_s``,
    bounded by construction."""
    if outage:
        return float(timeout_s)
    wire = max(float(wire_bytes), 0.0)
    if partition_mb is not None and partition_mb > 0:
        chunks = max(int(math.ceil(wire / (partition_mb * 2**20))), 1)
    else:
        chunks = 1
    return chunks * fit.alpha + wire * fit.beta
