"""Shard optimizers: the per-bucket update of the DeAR schedule, as a
hand-written Hopper kernel and its plain PyTorch version.

The port of ``dear_pytorch_tpu/ops/fused_sgd.py`` (`fused_sgd`,
`fused_adamw`) fused with the epilogue of the TPU kernel
``dear_pytorch_tpu/ops/collective_matmul.py::_rs_update_kernel``
(:361-393): after a bucket's reduce-scatter, one launch over the owned
shard computes ``grad = rs_out.float() / mean_world`` (times the clip
scale, with ``clip_norm``) and applies the optimizer, in place. The kernel
is ``csrc/fused_update.cu``, CUDA C++ for ``sm_90a``, built by `ops._build`
at first use and called through ``ctypes`` on the current stream.

The plain version, `fused_update_reference`, is the same sequence as
separate PyTorch ops, each one IEEE rounding. The kernel uses
``__fmul_rn``/``__fadd_rn``/``__fdiv_rn``/``__fsqrt_rn``, which are never
contracted into FMAs, and takes the same fp32 scalars (computed once per
step on the host): so on the card the two agree bitwise. The plain version
divides by 0-dim tensors rather than Python numbers, because PyTorch's CUDA
division by a Python scalar multiplies by its reciprocal instead.

The update runs in place on the master shard and the optimizer state (the
JAX package's update is functional; here the shard buffers are owned by
the train step, so in place saves a copy per bucket). The optimizer state
is a dict of shard tensors plus host-side Python values: SGD's
``initialized`` flag and AdamW's step count — the eager step knows them
without reading the device.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises; any other device raises. ``fused_update_launches``
counts kernel launches. ``fused_lamb`` and ``from_optax`` are not ported
(ROADMAP Queue 1 item 3): LAMB needs per-parameter reductions that
``_rs_update_kernel`` cannot fuse either (collective_matmul.py:298-305).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

__all__ = [
    "LayerwiseShardOptimizer", "ShardOptimizer", "from_optax", "fused_adamw",
    "fused_lamb", "fused_sgd", "fused_update_reference",
]

#: kernel launches so far (incremented only where the kernel launches)
fused_update_launches = 0

_KINDS = {"sgd": 0, "sgd_momentum": 1, "adamw": 2}
_GRAD_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class ShardOptimizer:
    """An elementwise optimizer over flat fp32 shard buffers.

    ``init(param) -> state`` and ``update(rs_out, state, param, *,
    mean_world=1, clip_scale=None, step=0) -> (param, state)``, which
    updates ``param`` and the state tensors in place. ``rs_out`` is the
    reduced (summed) gradient shard in the comm dtype; ``clip_scale`` an
    optional fp32 0-dim tensor on the shard's device; ``step`` the global
    step, for an ``lr`` schedule (``needs_step``)."""

    kind: str                       # 'sgd' | 'adamw'
    lr: Union[float, Callable]
    momentum: float = 0.0
    weight_decay: float = 0.0
    dampening: float = 0.0
    nesterov: bool = False
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8

    @property
    def needs_step(self) -> bool:
        return callable(self.lr)

    def init(self, param: torch.Tensor) -> dict:
        if self.kind == "adamw":
            return {"exp_avg": torch.zeros_like(param),
                    "exp_avg_sq": torch.zeros_like(param), "t": 0}
        if self.momentum != 0.0:
            # torch seeds the buffer with d_p on first use
            return {"buf": torch.zeros_like(param), "initialized": False}
        return {}

    def scalars(self, state: dict, mean_world: int, step: int) -> np.ndarray:
        """The kernel's 12 fp32 scalars (``csrc/fused_update.cu``'s
        ``Hyper``) for this step; the plain version reads the same ones."""
        f32 = np.float32
        lr = f32(self.lr(step) if callable(self.lr) else self.lr)
        wd = f32(self.weight_decay)
        out = np.zeros(12, np.float32)
        out[0], out[1], out[2] = mean_world, lr, wd
        if self.kind == "adamw":
            b1, b2 = f32(self.betas[0]), f32(self.betas[1])
            t = f32(state["t"] + 1)
            bc1 = f32(1.0) - b1 ** t
            bc2_sqrt = np.sqrt(f32(1.0) - b2 ** t)
            out[5] = f32(1.0) - lr * wd
            out[6] = f32(1.0 - self.betas[0])
            out[7], out[8] = b2, f32(1.0 - self.betas[1])
            out[9], out[10], out[11] = lr / bc1, bc2_sqrt, f32(self.eps)
        else:
            out[3] = f32(self.momentum)
            out[4] = f32(1.0 - self.dampening)
        return out

    def update(self, rs_out, state, param, *, mean_world: int = 1,
               clip_scale: Optional[torch.Tensor] = None, step: int = 0):
        if param.dtype != torch.float32 or rs_out.dtype not in _GRAD_DTYPES:
            raise ValueError(
                "shard update: the master shard must be float32 and the "
                f"gradient float32 or bfloat16, got {param.dtype}, "
                f"{rs_out.dtype}")
        shards = [rs_out] + [v for v in state.values() if torch.is_tensor(v)]
        if any(t.shape != param.shape for t in shards):
            raise ValueError("shard update: gradient, shard and state "
                             "shapes differ")
        extra = [] if clip_scale is None else [clip_scale]
        if len({t.device for t in shards + extra + [param]}) != 1:
            raise ValueError("shard update: tensors on several devices")
        scal = self.scalars(state, mean_world, step)
        kind = param.device.type
        if kind == "cpu":
            fused_update_reference(self, rs_out, state, param, scal,
                                   clip_scale)
        elif kind == "cuda":
            _launch(self, rs_out, state, param, scal, clip_scale)
        else:
            raise RuntimeError(f"shard update: no kernel for device "
                               f"{param.device}")
        self.advance(state)
        return param, state

    def advance(self, state: dict) -> None:
        """The host-side bookkeeping of one update: AdamW's step count,
        SGD's ``initialized`` flag."""
        if self.kind == "adamw":
            state["t"] += 1
        elif "initialized" in state:
            state["initialized"] = True


class LayerwiseShardOptimizer(NamedTuple):
    """The type of an optimizer that needs per-PARAMETER reductions over
    the flat shards (LAMB's trust ratios), as the JAX package's
    (dear_pytorch_tpu/ops/fused_sgd.py:54). The port builds none yet
    (`fused_lamb` raises); the train step refuses one by this type with the
    JAX package's messages."""

    init: Callable[[torch.Tensor], Any]
    update: Callable[..., tuple]
    needs_step: bool = False


def _kind(opt: ShardOptimizer) -> str:
    if opt.kind == "adamw":
        return "adamw"
    return "sgd_momentum" if opt.momentum != 0.0 else "sgd"


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def fused_update_reference(opt: ShardOptimizer, rs_out, state, param,
                           scalars, clip_scale=None) -> None:
    """The kernel's sequence as separate PyTorch ops, in place on ``param``
    and the state tensors. ``scalars`` is `ShardOptimizer.scalars`."""
    (mean_world, lr, wd, momentum, omd, decay, omb1, b2, omb2, step_size,
     bc2_sqrt, eps) = (float(x) for x in scalars)

    def t(x):  # a 0-dim divisor on the shard's device: a true division
        return torch.tensor(x, dtype=torch.float32, device=param.device)

    g = rs_out.float() / t(mean_world)
    if clip_scale is not None:
        g = g * clip_scale
    if opt.kind == "adamw":
        m, v = state["exp_avg"], state["exp_avg_sq"]
        if wd != 0.0:
            param.mul_(decay)
        m.add_((g - m) * omb1)
        v.copy_(v * b2 + (g * g) * omb2)
        denom = v.sqrt() / t(bc2_sqrt) + eps
        param.sub_((m * step_size) / denom)
        return
    d = g
    if wd != 0.0:
        d = d + param * wd
    if "buf" in state:
        buf = state["buf"]
        if state["initialized"]:
            buf.copy_(buf * momentum + d * omd)
        else:
            buf.copy_(d)
        d = d + buf * momentum if opt.nesterov else buf
    param.sub_(d * lr)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from dear_pytorch_tpu_torch.ops import _build

        lib = _build.load("fused_update")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fused_update.argtypes = [
            i32, i32, ptr, ptr, ptr, ptr, ctypes.c_longlong, ptr, ptr, i32,
            i32, ptr]
        lib.fused_update.restype = i32
        lib.fused_update_error_string.argtypes = [i32]
        lib.fused_update_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(opt, rs_out, state, param, scalars, clip_scale) -> None:
    """Launch ``csrc/fused_update.cu`` over contiguous shard tensors."""
    global fused_update_launches
    kind = _kind(opt)
    s1 = state.get("buf", state.get("exp_avg"))
    s2 = state.get("exp_avg_sq")
    for name, x in (("gradient", rs_out), ("shard", param), ("state", s1),
                    ("state", s2)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"shard update kernel: {name} is not "
                             "contiguous")
    if clip_scale is not None and (clip_scale.numel() != 1
                                   or clip_scale.dtype != torch.float32):
        raise ValueError("shard update kernel: clip_scale must be one "
                         "float32 value")
    lib = _kernel_lib()
    host = np.ascontiguousarray(scalars, np.float32)
    with torch.cuda.device(param.device):
        err = lib.fused_update(
            _KINDS[kind], int(rs_out.dtype == torch.bfloat16),
            rs_out.data_ptr(), param.data_ptr(),
            None if s1 is None else s1.data_ptr(),
            None if s2 is None else s2.data_ptr(), param.numel(),
            host.ctypes.data,
            None if clip_scale is None else clip_scale.data_ptr(),
            int(bool(state.get("initialized", False))), int(opt.nesterov),
            torch.cuda.current_stream(param.device).cuda_stream)
    if err:
        raise RuntimeError("shard update kernel launch failed: "
                           + lib.fused_update_error_string(err).decode())
    fused_update_launches += 1


# ---------------------------------------------------------------------------
# the factories (the JAX package's signatures)
# ---------------------------------------------------------------------------


def fused_sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0,
              dampening: float = 0.0, nesterov: bool = False
              ) -> ShardOptimizer:
    """torch.optim.SGD semantics on flat shards
    (dear_pytorch_tpu/ops/fused_sgd.py:70):

        d_p = grad + wd * p
        buf = momentum * buf + (1 - dampening) * d_p   (d_p on the first step)
        d_p = d_p + momentum * buf   if nesterov else buf
        p  -= lr * d_p

    ``lr`` is a float or a schedule (`ops.schedules`)."""
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError("nesterov requires momentum > 0 and zero dampening")
    return ShardOptimizer("sgd", lr, momentum=momentum,
                          weight_decay=weight_decay, dampening=dampening,
                          nesterov=nesterov)


def fused_adamw(lr, betas: tuple = (0.9, 0.999), eps: float = 1e-8,
                weight_decay: float = 0.01) -> ShardOptimizer:
    """torch.optim.AdamW semantics on flat shards, in its evaluation order
    (dear_pytorch_tpu/ops/fused_sgd.py:115):

        p   *= 1 - lr * wd
        m    = m + (1 - b1) * (g - m)
        v    = b2 * v + (1 - b2) * g^2
        p   -= (lr / (1 - b1^t)) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)"""
    b1, b2 = betas
    if not (0.0 <= b1 < 1.0 and 0.0 <= b2 < 1.0):
        raise ValueError(f"betas must be in [0, 1), got {betas}")
    return ShardOptimizer("adamw", lr, weight_decay=weight_decay,
                          betas=tuple(betas), eps=eps)


def fused_lamb(*args, **kwargs):
    raise NotImplementedError(
        "fused_lamb (layerwise trust ratios over shards) is not ported yet: "
        "ROADMAP Queue 1 item 3")


def from_optax(*args, **kwargs):
    raise NotImplementedError(
        "from_optax adapts optax transforms, which the port does not use: "
        "ROADMAP Queue 1 item 3")
