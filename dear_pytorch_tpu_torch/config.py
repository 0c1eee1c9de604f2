"""One typed configuration for the train step — the port of
``dear_pytorch_tpu/config.py``.

The same fields and the same ``DEAR_<FIELD>`` environment names as the JAX
package's `DearConfig`. Fields of features the port does not carry yet are
accepted (so one environment serves both packages), and `build_kwargs`
raises ``NotImplementedError`` when such a field is set away from its
default, naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence

import torch

__all__ = ["DearConfig"]

_COMM_DTYPES = {
    "": None, "none": None,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f32": torch.float32, "float32": torch.float32,
    "f16": torch.float16, "float16": torch.float16,
}

#: field -> (its default, the ROADMAP item that ports it)
_UNPORTED = {
    "exclude_parts": ((), "Queue 1 item 7 (modes and ablations)"),
    "autotune": (None, "Queue 1 item 8 (tuning)"),
    "compressor": (None, "Queue 1 item 7 (compression)"),
    "gtopk": (False, "Queue 1 item 7 (compression)"),
    "momentum_correction": (0.0, "Queue 1 item 7 (compression)"),
    "remat": (None, "Queue 1 item 7 (remat)"),
}


@dataclasses.dataclass
class DearConfig:
    """Every train-step knob in one place (defaults = the reference's)."""

    mode: str = "dear"
    exclude_parts: tuple = ()
    partition_mb: float = 4.0

    threshold_mb: Optional[float] = 25.0
    nearby_layers: Optional[int] = None
    flags: Optional[Sequence[int]] = None

    autotune: Optional[str] = None
    bo_bound: tuple = (1.0, 256.0)
    bo_trials: int = 10
    bo_interval: int = 5
    cycle_time_s: float = 5e-3

    compressor: Optional[str] = None
    density: float = 1.0
    gtopk: bool = False
    momentum_correction: float = 0.0

    optimizer_name: str = "sgd"     # sgd | adamw (lamb: not ported)
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.0
    nesterov: bool = False
    adam_betas: tuple = (0.9, 0.999)
    adam_eps: float = 1e-8
    clip_norm: Optional[float] = None

    lr_schedule: Optional[str] = None
    warmup_steps: int = 0
    total_steps: Optional[int] = None
    end_lr: float = 0.0
    lr_milestones: tuple = ()
    lr_gamma: float = 0.1

    comm_dtype: Any = None
    gather_dtype: Any = None
    compute_bf16: bool = False

    remat: Optional[str] = None

    rng_seed: Optional[int] = None
    donate: bool = True
    accum_steps: int = 1

    def __post_init__(self):
        if self.mode not in ("dear", "dear-fused", "allreduce", "rsag",
                             "rb", "bytescheduler", "fsdp"):
            raise ValueError(f"bad mode {self.mode!r}")
        if self.autotune not in (None, "bo", "wait_time", "plan"):
            raise ValueError(f"bad autotune {self.autotune!r}")
        if self.remat not in (None, "none", "full"):
            raise ValueError(f"bad remat {self.remat!r}")
        if not 0.0 < self.density <= 1.0:
            raise ValueError(f"density must be in (0, 1], got {self.density}")

    _ENV_PREFIX = "DEAR_"

    @classmethod
    def from_env(cls, **overrides) -> "DearConfig":
        """Read ``DEAR_<FIELD>`` variables; ``overrides`` win."""
        kwargs: dict = {}
        for f in dataclasses.fields(cls):
            env = os.environ.get(cls._ENV_PREFIX + f.name.upper())
            if env is not None:
                kwargs[f.name] = cls._parse(f.name, env)
        kwargs.update(overrides)
        return cls(**kwargs)

    @staticmethod
    def _parse(name: str, raw: str):
        raw = raw.strip()
        if name in ("threshold_mb", "clip_norm"):
            return None if raw.lower() in ("none", "") else float(raw)
        if name in ("nearby_layers", "bo_trials", "bo_interval"):
            return None if raw.lower() in ("none", "") else int(raw)
        if name == "accum_steps":
            try:
                v = int(raw)
            except ValueError:
                v = 0
            if v < 1:
                raise ValueError(
                    f"DEAR_ACCUM_STEPS must be a positive int, got {raw!r}")
            return v
        if name in ("lr", "momentum", "weight_decay", "density",
                    "cycle_time_s", "partition_mb", "momentum_correction",
                    "adam_eps", "end_lr", "lr_gamma"):
            return float(raw)
        if name == "warmup_steps":
            return int(raw)
        if name == "total_steps":
            return None if raw.lower() in ("none", "") else int(raw)
        if name == "lr_milestones":
            return tuple(int(x) for x in raw.split(",") if x)
        if name == "lr_schedule":
            return None if raw.lower() in ("none", "") else raw
        if name == "adam_betas":
            b1, b2 = raw.split(",")
            return (float(b1), float(b2))
        if name in ("gtopk", "nesterov", "donate", "compute_bf16"):
            return raw.lower() in ("1", "true", "yes")
        if name in ("comm_dtype", "gather_dtype"):
            return _COMM_DTYPES[raw.lower()]
        if name == "exclude_parts":
            return tuple(p for p in raw.split(",") if p)
        if name == "flags":
            return [int(x) for x in raw.split(",")]
        if name == "bo_bound":
            lo, hi = raw.split(",")
            return (float(lo), float(hi))
        if name in ("autotune", "compressor", "mode", "remat"):
            return None if raw.lower() in ("none", "") else raw
        return raw

    def optimizer(self):
        from dear_pytorch_tpu_torch.ops import schedules
        from dear_pytorch_tpu_torch.ops.fused_sgd import (
            fused_adamw,
            fused_lamb,
            fused_sgd,
        )

        lr = schedules.from_config(self)
        if self.optimizer_name == "adamw":
            return fused_adamw(lr=lr, betas=self.adam_betas,
                               eps=self.adam_eps,
                               weight_decay=self.weight_decay)
        if self.optimizer_name == "lamb":
            return fused_lamb(lr=lr)
        if self.optimizer_name != "sgd":
            raise ValueError(
                f"optimizer_name must be 'sgd', 'adamw' or 'lamb', "
                f"got {self.optimizer_name!r}")
        return fused_sgd(lr=lr, momentum=self.momentum,
                         weight_decay=self.weight_decay,
                         nesterov=self.nesterov)

    def build_kwargs(self) -> dict:
        """kwargs for `parallel.dear.build_train_step`; raises on a field
        the port does not carry yet."""
        for name, (default, item) in _UNPORTED.items():
            value = getattr(self, name)
            if value != default and not (name == "remat" and value == "none"):
                raise NotImplementedError(
                    f"DearConfig.{name}={value!r} is not ported yet: "
                    f"ROADMAP {item}")
        return dict(
            mode=self.mode,
            optimizer=self.optimizer(),
            comm_dtype=self.comm_dtype,
            gather_dtype=self.gather_dtype,
            rng_seed=self.rng_seed,
            accum_steps=self.accum_steps,
            clip_norm=self.clip_norm,
        )
