"""Learning-rate schedules for the shard optimizers — the port of
``dear_pytorch_tpu/ops/schedules.py``.

Each factory returns a callable ``step -> lr``. The JAX package evaluates it
on the device from the step counter inside the jitted step; the eager step
here knows its step number, so the schedule is evaluated on the host, in
fp32 (numpy ``float32`` arithmetic, as the JAX version's ``jnp`` float32
math), and handed to the update as a scalar.

    from dear_pytorch_tpu_torch.ops import schedules
    opt = fused_adamw(lr=schedules.warmup_linear(1e-4, 1000, 100_000))
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

__all__ = ["constant", "from_config", "multistep", "warmup_cosine",
           "warmup_linear"]

Schedule = Callable[[int], np.float32]
_f32 = np.float32


def constant(base_lr: float) -> Schedule:
    """Fixed lr as a schedule."""
    def lr_at(step):
        del step
        return _f32(base_lr)
    return lr_at


def _check(warmup_steps, total_steps):
    if total_steps <= warmup_steps:
        raise ValueError(
            f"total_steps ({total_steps}) must exceed warmup_steps "
            f"({warmup_steps})")


def warmup_linear(base_lr: float, warmup_steps: int, total_steps: int,
                  end_lr: float = 0.0) -> Schedule:
    """Linear warmup 0 -> base_lr over ``warmup_steps``, then linear decay
    to ``end_lr`` at ``total_steps``; constant at ``end_lr`` past it."""
    _check(warmup_steps, total_steps)

    def lr_at(step):
        step = _f32(step)
        if step < warmup_steps:
            return _f32(base_lr) * step / _f32(max(warmup_steps, 1))
        frac = np.clip((step - _f32(warmup_steps))
                       / _f32(total_steps - warmup_steps), _f32(0), _f32(1))
        return _f32(base_lr) + frac * (_f32(end_lr) - _f32(base_lr))

    return lr_at


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_lr: float = 0.0) -> Schedule:
    """Linear warmup then half-cosine decay to ``min_lr`` (the GPT shape)."""
    _check(warmup_steps, total_steps)

    def lr_at(step):
        step = _f32(step)
        if step < warmup_steps:
            return _f32(base_lr) * step / _f32(max(warmup_steps, 1))
        frac = np.clip((step - _f32(warmup_steps))
                       / _f32(total_steps - warmup_steps), _f32(0), _f32(1))
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * frac))
        return _f32(min_lr) + (_f32(base_lr) - _f32(min_lr)) * cos

    return lr_at


def multistep(base_lr: float, milestones: Sequence[int],
              gamma: float = 0.1) -> Schedule:
    """torch ``MultiStepLR`` shape: lr * gamma^(milestones passed)."""
    ms = tuple(sorted(int(m) for m in milestones))
    if any(m < 0 for m in ms):
        raise ValueError(f"milestones must be non-negative, got {milestones}")

    def lr_at(step):
        passed = sum(1 for m in ms if step >= m)
        return _f32(base_lr) * _f32(gamma) ** _f32(passed)

    return lr_at


def from_config(cfg):
    """A `DearConfig`'s lr fields as a float or a schedule."""
    name = (cfg.lr_schedule or "").strip().lower()
    if not name or name == "none":
        return cfg.lr
    if name in ("linear", "warmup_linear"):
        return warmup_linear(cfg.lr, cfg.warmup_steps, _total(cfg),
                             end_lr=cfg.end_lr)
    if name in ("cosine", "warmup_cosine"):
        return warmup_cosine(cfg.lr, cfg.warmup_steps, _total(cfg),
                             min_lr=cfg.end_lr)
    if name == "multistep":
        if not cfg.lr_milestones:
            raise ValueError(
                "lr_schedule='multistep' needs lr_milestones "
                "(DEAR_LR_MILESTONES=30000,60000,...)")
        return multistep(cfg.lr, cfg.lr_milestones, gamma=cfg.lr_gamma)
    raise ValueError(
        f"lr_schedule must be 'linear', 'cosine' or 'multistep', got "
        f"{cfg.lr_schedule!r}")


def _total(cfg) -> int:
    if not cfg.total_steps:
        raise ValueError(f"lr_schedule={cfg.lr_schedule!r} needs total_steps")
    return int(cfg.total_steps)
