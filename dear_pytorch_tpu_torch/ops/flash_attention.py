"""Flash attention forward: a hand-written Hopper kernel and its plain
PyTorch version.

Replaces the TPU kernel ``dear_pytorch_tpu/ops/flash_attention.py::
_fwd_kernel`` (reached through ``_flash_fwd_impl`` and ``flash_pair_fwd``).
The kernel is ``csrc/flash_fwd.cu``, CUDA C++ for ``sm_90a``, built by
`ops._build` at first use and called through ``ctypes`` on the current
stream. It computes the TPU kernel's function, not its block structure:

  - ``q`` is scaled by ``scale`` (default ``D ** -0.5``) in fp32 before
    QKᵀ; all accumulation is fp32;
  - key ``j`` counts for query ``i`` iff ``kv_mask[b, j] > 0`` and, when
    ``causal``, ``j <= i`` — top-left aligned (both positions count from
    0), as the TPU kernel does; not SDPA's bottom-right convention;
  - the row max is floored at ``-1e30`` and the denominator at ``1e-30``,
    so a row with no valid key gives ``o = 0`` and ``lse = -1e30``;
  - ``o`` is in q's dtype (or ``out_dtype``), ``lse`` is fp32.

Any ``Sq``/``Sk`` is accepted, including 1 and lengths that no tile
divides: the kernel masks the ragged edge itself. The TPU tiling rules
(``_pick_block``, ``check_mosaic_block``) are not carried over. Head dim:
a multiple of 8 up to 128; q, k and v all fp32 or all bf16.

What bounds it on the H100: a decode tick (``Sq = 1`` over the ``L``-slot
cache) reads K and V once — bytes; a causal prefill at ``S = 1024`` is
O(S² D) flops — operations. The kernel's source note says what its first,
simple design does about each; a split-K decode is later work.

Dispatch: a CPU tensor takes the plain version (the CPU tests use it);
a CUDA tensor launches the kernel or raises; any other device raises.
There is no fallback. ``flash_fwd_launches`` counts kernel launches.
Forward only: backward (the TPU kernels ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``) arrives with the training slice, and until then a
backward through this op raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = [
    "flash_attention", "flash_attention_reference", "flash_pair_fwd",
    "flash_pair_fwd_reference",
]

_NEG_BIG = -1e30
_TINY = 1e-30
_DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches so far (incremented only where the kernel launches)
flash_fwd_launches = 0


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _reference(q, k, v, mask, scale, causal, out_dtype):
    """[B,Sq,H,D] x [B,Sk,H,D], int mask [B,Sk] -> (o [B,Sq,H,D],
    lse f32 [B,H,Sq]): one block, the same masks and floors."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    valid = (mask > 0)[:, None, None, :]
    if causal:
        ar_k = torch.arange(Sk, device=q.device)
        ar_q = torch.arange(Sq, device=q.device)
        valid = valid & (ar_k[None, :] <= ar_q[:, None])
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1).clamp_min(_NEG_BIG)
    p = torch.exp(s - m[..., None])
    den = p.sum(dim=-1).clamp_min(_TINY)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / den.transpose(1, 2)[..., None]
    return o.to(out_dtype), m + torch.log(den)


def flash_attention_reference(q, k, v, *, causal: bool = False,
                              scale: Optional[float] = None,
                              kv_mask: Optional[torch.Tensor] = None,
                              out_dtype: Optional[torch.dtype] = None):
    """The plain PyTorch version of `flash_attention`: returns ``o``
    ``[B, Sq, H, D]`` and ``lse`` fp32 ``[B, H, Sq]``."""
    scale, mask, out_dtype = _prepare(q, k, scale, kv_mask, out_dtype)
    return _reference(q, k, v, mask, scale, causal, out_dtype)


def flash_pair_fwd_reference(q, k, v, kv_mask, scale, causal,
                             out_dtype=None):
    """The plain version of `flash_pair_fwd` over folded ``[BH, S, D]``."""
    o, lse = flash_attention_reference(
        q[:, :, None], k[:, :, None], v[:, :, None], causal=causal,
        scale=scale, kv_mask=kv_mask, out_dtype=out_dtype)
    return o[:, :, 0], lse[:, 0]


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from dear_pytorch_tpu_torch.ops import _build

        lib = _build.load("flash_fwd")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_fwd.argtypes = (
            [ptr] * 6 + [i32] * 5 + [i64] * 13
            + [ctypes.c_float, i32, i32, i32, ptr])
        lib.flash_fwd.restype = i32
        lib.flash_fwd_error_string.argtypes = [i32]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(q, k, v, mask, scale, causal, out_dtype):
    """Launch ``csrc/flash_fwd.cu`` on [B,S,H,D] views (any strides with a
    contiguous last dim) and an int32 [B,Sk] mask."""
    global flash_fwd_launches
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    align = 16 // q.element_size()  # the kernel loads K/V rows 16 B at a time
    for name, t in (("q", q), ("k", k), ("v", v)):
        misaligned = t.data_ptr() % 16 or any(
            st % align for st, n in zip(t.stride()[:-1], t.shape[:-1])
            if n > 1)
        if t.stride(-1) != 1 or misaligned:
            raise ValueError(
                f"flash attention kernel: {name} needs a contiguous last "
                "dim and rows on 16-byte boundaries, got strides "
                f"{t.stride()} at offset {t.data_ptr() % 16}")
    if mask.stride(-1) != 1:
        raise ValueError("flash attention kernel: kv_mask needs a "
                         "contiguous last dim")
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(
            f"flash attention kernel: head dim {D} is not a multiple of 8 "
            "in [8, 128]")
    if B * H > 65535:
        raise ValueError(f"flash attention kernel: B*H = {B * H} > 65535")
    o = torch.empty((B, Sq, H, D), dtype=out_dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, H, Sq, Sk, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2), mask.stride(0),
            scale, int(causal), int(q.dtype == torch.bfloat16),
            int(out_dtype == torch.float32),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            "flash attention kernel launch failed: "
            + lib.flash_fwd_error_string(err).decode())
    flash_fwd_launches += 1
    return o, lse


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _prepare(q, k, scale, kv_mask, out_dtype):
    """Default scale, an int32 [B,Sk] mask, and the output dtype."""
    B, Sk, D = q.shape[0], k.shape[1], q.shape[-1]
    scale = D ** -0.5 if scale is None else float(scale)
    if kv_mask is None:
        mask = torch.ones((B, Sk), dtype=torch.int32, device=q.device)
    else:
        mask = kv_mask.to(torch.int32)
    return scale, mask, out_dtype or q.dtype


def _dispatch(q, k, v, mask, scale, causal, out_dtype):
    devices = {t.device for t in (q, k, v, mask)}
    if len(devices) != 1:
        raise ValueError(f"flash attention: inputs on several devices "
                         f"{sorted(map(str, devices))}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(
            "flash attention: q, k, v must all be float32 or all bfloat16, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(f"flash attention: out_dtype {out_dtype} is "
                         "neither q's dtype nor float32")
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("flash attention: empty query or key sequence")
    kind = q.device.type
    if kind == "cpu":
        return _reference(q, k, v, mask, scale, causal, out_dtype)
    if kind == "cuda":
        return _launch(q, k, v, mask, scale, causal, out_dtype)
    raise RuntimeError(f"flash attention: no kernel for device {q.device}")


class _ForwardOnly(torch.autograd.Function):
    """Gradients through the forward kernel are the training slice's work
    (the TPU backward kernels are not ported yet)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, causal, out_dtype):
        o, lse = _dispatch(q, k, v, mask, scale, causal, out_dtype)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError(
            "flash attention backward is not ported yet: the dQ and dK/dV "
            "kernels (TPU _bwd_dq_kernel and _bwd_dkv_kernel) arrive with "
            "the training slice")


def _flash_fwd(q, k, v, mask, scale, causal, out_dtype):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _ForwardOnly.apply(q, k, v, mask, scale, causal, out_dtype)
    return _dispatch(q, k, v, mask, scale, causal, out_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention over ``[B, S, H, D]`` inputs; ``kv_mask`` is the
    optional key-validity mask ``[B, Sk]`` (true or > 0 = attend). The
    kernel reads the ``[B, S, H, D]`` layout through strides and indexes
    the per-batch mask by ``bh // H``: no fold, no repeat over heads."""
    scale, mask, out_dtype = _prepare(q, k, scale, kv_mask, None)
    o, _ = _flash_fwd(q, k, v, mask, scale, causal, out_dtype)
    return o


def flash_pair_fwd(q, k, v, kv_mask, scale, causal, out_dtype=None):
    """``(o, lse)`` over folded ``[BH, S, D]`` operands with a ``[BH, Sk]``
    mask — ring attention's per-step building block. ``out_dtype``
    (default: q's dtype) may be float32."""
    scale, mask, out_dtype = _prepare(q, k, scale, kv_mask, out_dtype)
    o, lse = _flash_fwd(q[:, :, None], k[:, :, None], v[:, :, None], mask,
                        scale, causal, out_dtype)
    return o[:, :, 0], lse[:, 0]
