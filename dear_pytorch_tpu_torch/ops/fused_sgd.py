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
counts kernel launches.

`fused_lamb` (the JAX package's, fused_sgd.py:171) is a
`LayerwiseShardOptimizer`: its trust ratios are per-parameter reductions
over a shard that the train step completes across the ranks, which
``_rs_update_kernel`` cannot fuse (collective_matmul.py:298-305), so its
update is plain PyTorch ops on the card too (XLA's ops in the JAX
package). `from_torch_optim` adapts an elementwise ``torch.optim``
optimizer to shards, as the JAX package's `from_optax` adapts an optax
transform; `from_optax` itself raises (the port takes no optax).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

__all__ = [
    "LayerwiseShardOptimizer", "ShardOptimizer", "TorchOptimShard",
    "from_optax", "from_torch_optim", "fused_adamw", "fused_lamb",
    "fused_sgd", "fused_update_reference",
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
    """An optimizer that needs per-PARAMETER reductions over the flat
    shards (LAMB's trust ratios), as the JAX package's
    (dear_pytorch_tpu/ops/fused_sgd.py:54). ``update(rs_out, state, param,
    seg_ids, num_segments, psum, *, mean_world=1, clip_scale=None,
    step=0) -> (param, state)``, in place: ``seg_ids`` maps each element
    of this rank's shard to its bucket-local parameter index
    (`ops.fusion.FusionPlan.segment_ids`), padding in the trailing dummy
    segment ``num_segments - 1``; ``psum`` completes shard-local segment
    sums over the ranks (the identity when the buffer is replicated). The
    train step supplies both; ``dear-fused`` refuses this type with the
    JAX package's message."""

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


def _lr_at(lr, step: int) -> float:
    return float(lr(step)) if callable(lr) else lr


def _grad_of(rs_out, mean_world, clip_scale, device) -> torch.Tensor:
    """The update's fp32 gradient: the reduced sum over ``mean_world``,
    times the clip scale (`fused_update_reference`'s order)."""
    g = rs_out.float() / torch.tensor(float(mean_world), device=device)
    return g if clip_scale is None else g * clip_scale


#: the most elements one first-level sum of `_segment_sums` covers
_PIECE = 1 << 14


def segment_pieces(lengths: Sequence[int], device, rows: int = 1) -> tuple:
    """`_segment_sums`'s host plan for segments of ``lengths`` elements,
    ``rows`` times back to back (the rows of its ``x``): each segment cut
    into pieces of at most `_PIECE` elements; ``(piece offsets, segment
    offsets)``, int64 tensors on ``device``, the first into the elements,
    the second into the pieces. Fixed per fusion plan and shard, so the
    train step makes it once per bucket."""
    pieces, per = [], []
    for n in (int(n) for n in lengths):
        k = -(-n // _PIECE)
        pieces += [_PIECE] * (k - 1) + ([n - _PIECE * (k - 1)] if k else [])
        per.append(k)
    return tuple(torch.from_numpy(np.cumsum([0] + v * rows)).to(device)
                 for v in (pieces, per))


def _segment_sums(x: torch.Tensor, seg_ids: torch.Tensor,
                  num_segments: int, pieces: Optional[tuple] = None
                  ) -> torch.Tensor:
    """``jax.ops.segment_sum`` along the last axis of ``x`` (each row on
    its own) for NONDECREASING ``seg_ids`` (a fusion plan's: each
    parameter a contiguous run, the padding last), in fp64 and over each
    segment's own elements only: two segmented reductions, the pieces of
    `segment_pieces` (many pieces of one large parameter reduce in
    parallel), then each segment's pieces; no host sync. ``pieces``: that
    plan for ``x``'s rows (the train step passes it); without it the
    segment lengths are read from ``seg_ids`` (one host sync). Returns
    ``x``'s rows by ``num_segments`` in ``x``'s dtype. Not an
    ``index_add_`` (it serialises on a few segments' addresses: one
    31M-element embedding took ~1 s on the card), and not differences of
    one running sum over the bucket: its rounding grows with the whole
    prefix, and on the card a parallel scan rounds the prefix differently
    at a segment's two ends, so a small parameter after a large one lost
    its sum and a zero one (a key bias, whose gradient is zero) read
    +-1e-13 instead of 0."""
    rows = x.shape[:-1]
    if pieces is None:
        ids = torch.arange(num_segments, dtype=seg_ids.dtype,
                           device=seg_ids.device)
        ends = torch.searchsorted(seg_ids, ids, right=True)
        lengths = torch.diff(ends, prepend=ends.new_zeros((1,))).tolist()
        pieces = segment_pieces(lengths, x.device, int(np.prod(rows)))
    piece_offs, seg_offs = pieces
    part = torch.segment_reduce(x.reshape(-1).double(), "sum",
                                offsets=piece_offs, unsafe=True)
    sums = torch.segment_reduce(part, "sum", offsets=seg_offs, unsafe=True)
    return sums.view(*rows, num_segments).to(x.dtype)


def fused_lamb(lr, betas: tuple = (0.9, 0.999), eps: float = 1e-6,
               weight_decay: float = 0.01) -> LayerwiseShardOptimizer:
    """LAMB (You et al. 2020, the BERT large-batch optimizer) on flat shard
    buffers with EXACT per-parameter trust ratios (the JAX package's
    fused_sgd.py:171-232):

        m    = b1 m + (1-b1) g;   v = b2 v + (1-b2) g^2
        u    = m/(1-b1^t) / (sqrt(v/(1-b2^t)) + eps) + wd * w
        r    = ||w||_seg / ||u||_seg          (1 where either norm is 0)
        w   -= lr * r[seg] * u

    ``seg_ids`` is nondecreasing, as a fusion plan's are (`_segment_sums`);
    ``seg_pieces`` (the train step's) is its `segment_pieces` for two
    rows: both sums of squares reduce in one pair of launches.
    The two segment sums of squares go to ``psum`` as one ``[2,
    num_segments]`` tensor (one collective). Padding lives in the dummy
    trailing segment and never moves (w = 0, g = 0 -> u = 0). The state
    is ``{"m", "v"}`` shard tensors, the host step count ``t`` and, after
    an update, that update's ``trust`` ratios (one per segment, the same
    on every rank)."""
    b1, b2 = betas
    if not (0.0 <= b1 < 1.0 and 0.0 <= b2 < 1.0):
        raise ValueError(f"betas must be in [0, 1), got {betas}")

    def init(param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param),
                "t": 0}

    def update(rs_out, state, param, seg_ids, num_segments, psum, *,
               mean_world: int = 1, clip_scale=None, step: int = 0,
               seg_pieces: Optional[tuple] = None):
        f32 = np.float32
        g = _grad_of(rs_out, mean_world, clip_scale, param.device)
        m, v = state["m"], state["v"]
        t = f32(state["t"] + 1)
        m.mul_(b1).add_(g * (1.0 - b1))
        v.mul_(b2).add_(g * g * (1.0 - b2))
        bc1 = float(f32(1.0) - f32(b1) ** t)
        bc2 = float(f32(1.0) - f32(b2) ** t)
        u = (m / bc1) / ((v / bc2).sqrt() + eps)
        if weight_decay:
            u = u + weight_decay * param
        sq = param.new_empty((2, param.numel()), dtype=torch.float64)
        torch.mul(param, param, out=sq[0])
        torch.mul(u, u, out=sq[1])
        sums = _segment_sums(sq, seg_ids, num_segments, seg_pieces)
        w_norm, u_norm = psum(sums.float()).sqrt()
        trust = torch.where((w_norm > 0.0) & (u_norm > 0.0),
                            w_norm / torch.clamp(u_norm, min=1e-12),
                            torch.ones_like(w_norm))
        param.sub_(_lr_at(lr, step) * trust.index_select(0, seg_ids) * u)
        state["t"] += 1
        state["trust"] = trust
        return param, state

    return LayerwiseShardOptimizer(init, update, callable(lr))


class TorchOptimShard:
    """`from_torch_optim`'s optimizer: ``init(param)`` binds one
    ``torch.optim`` optimizer to the shard tensor (its state is that
    optimizer's); ``update(rs_out, state, param, *, mean_world=1,
    clip_scale=None, step=0)`` sets the shard's ``.grad`` to the mean
    gradient and steps it, in place. An ``lr`` schedule (callable) sets
    the learning rate of each step."""

    def __init__(self, optimizer_cls, hyper: dict):
        self.optimizer_cls, self.hyper = optimizer_cls, dict(hyper)

    @property
    def needs_step(self) -> bool:
        return callable(self.hyper.get("lr"))

    def init(self, param: torch.Tensor) -> dict:
        hyper = dict(self.hyper)
        if self.needs_step:
            hyper["lr"] = _lr_at(hyper["lr"], 0)
        return {"optim": self.optimizer_cls([param], **hyper),
                "param": param}

    def update(self, rs_out, state, param, *, mean_world: int = 1,
               clip_scale=None, step: int = 0):
        if state["param"] is not param:
            raise ValueError("from_torch_optim: update() got another shard "
                             "than init() bound")
        opt = state["optim"]
        if self.needs_step:
            for group in opt.param_groups:
                group["lr"] = _lr_at(self.hyper["lr"], step)
        param.grad = _grad_of(rs_out, mean_world, clip_scale, param.device)
        opt.step()
        param.grad = None
        return param, state


def from_torch_optim(optimizer_cls, **hyper) -> TorchOptimShard:
    """Adapt an elementwise ``torch.optim`` optimizer (SGD, Adam, AdamW,
    RMSprop, ...) to flat shard buffers — the port's counterpart of the
    JAX package's `from_optax` (fused_sgd.py:248): ``hyper`` are the
    optimizer's arguments (``lr`` a float or a schedule).

    Valid only for elementwise optimizers: state and update must depend on
    each element independently, so running on a shard equals running on
    the full tensor. A cross-element transform (a norm over a parameter
    or over all of them, e.g. LAMB's trust ratio or global-norm clipping)
    would silently compute SHARD-LOCAL values: for those use
    `fused_lamb` or ``build_train_step(clip_norm=...)``, which complete
    their sums over the ranks. ``mode="dear-fused"`` fuses only a
    `ShardOptimizer` into its kernel and refuses this one."""
    return TorchOptimShard(optimizer_cls, hyper)


def from_optax(*args, **kwargs):
    raise NotImplementedError(
        "from_optax adapts optax transforms, which the port does not use: "
        "adapt an elementwise torch.optim optimizer with "
        "from_torch_optim(optimizer_cls, **hyper)")
