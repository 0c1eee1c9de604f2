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

Three routes, picked by `fwd_route` from the shape and dtypes alone:

  - ``"tensor_core"`` (bf16 in and out, ``Sq > 1``, ``D = 64``: the
    training step) — ``wgmma`` and TMA, bound by operations;
  - ``"split_k"`` (``Sq = 1``, any dtype: the decode tick) — each row's
    keys split over several blocks (`decode_splits`), their partials
    combined in split order by the last block of the row; bound by bytes;
  - ``"cuda_core"`` (everything else: fp32 inputs, bf16 inputs with an fp32
    output, other head dims) — the first, simple design on CUDA cores.

The kernel's source note says what each design does about its bound.
``flash_fwd_route_launches`` counts the launches of each route beside
``flash_fwd_launches``, which counts them all.

Backward: the TPU kernels ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` are
``csrc/flash_bwd.cu`` (`flash_pair_dq`, `flash_pair_dkv`), each with two
routes picked by `bwd_route` from the head dim and the dtypes alone:
``"tensor_core"`` (bf16 in and out, ``D = 64``: every backward call of the
bf16 training step; TMA and ``wgmma``, P and dS rounded to bf16 before the
second products) and ``"cuda_core"`` (fp32 inputs, bf16 inputs with an fp32
output, other head dims: the first design on CUDA cores).
``flash_bwd_route_launches["dq"]`` and ``["dkv"]`` count each kernel's
launches by route, and ``flash_shape_launches`` every kernel's by route,
shape, causality and input dtype. A
``torch.autograd.Function`` around the forward saves ``q, k, v, mask, o,
lse``; its backward computes ``delta = rowsum(dO * O)`` in fp32 with plain
PyTorch (the JAX package does it in XLA, ``_flash_bwd``) and launches the
dQ and dK/dV kernels. They recompute ``p = exp(s - lse)`` where the key is
valid and select 0 elsewhere (never ``exp(...) * 0``: an all-masked row has
``lse = -1e30``), so such a row gives ``dq = 0`` and never-attended keys
``dk = dv = 0``, with no NaN. Called directly (ring attention's
`flash_pair_dq` / `flash_pair_dkv`), they write q's dtype or, with
``out_dtype=torch.float32``, fp32 from the same fp32 sums.

Dispatch: a CPU tensor takes the plain version (the CPU tests use it);
a CUDA tensor launches the kernel or raises; any other device raises.
There is no fallback. ``flash_fwd_launches``, ``flash_bwd_dq_launches`` and
``flash_bwd_dkv_launches`` count kernel launches; ``flash_flops`` adds, at
each launch, what ``torch.utils.flop_counter.FlopCounterMode`` counts for
that kernel's plain version on the same shapes (`plain_flops`), which the
mode cannot see in a ``ctypes`` launch (`benchmarks.runner.step_flops`).

`make_flash_attention_impl` is the model zoo's ``attention_impl`` over
these kernels (BERT's ``--flash-attention``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

__all__ = [
    "flash_attention", "flash_attention_reference", "flash_pair_dkv",
    "flash_pair_dkv_reference", "flash_pair_dq", "flash_pair_dq_reference",
    "flash_pair_fwd", "flash_pair_fwd_reference",
    "make_flash_attention_impl", "plain_flops",
]

_NEG_BIG = -1e30
_TINY = 1e-30
_DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches so far (incremented only where each kernel launches)
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
#: K1's launches by route (see `fwd_route`); they sum to flash_fwd_launches
FWD_ROUTES = ("tensor_core", "split_k", "cuda_core")
flash_fwd_route_launches = dict.fromkeys(FWD_ROUTES, 0)
#: K2's ("dq") and K3's ("dkv") launches by route (see `bwd_route`); they
#: sum to flash_bwd_dq_launches and flash_bwd_dkv_launches
BWD_ROUTES = ("tensor_core", "cuda_core")
flash_bwd_route_launches = {
    which: dict.fromkeys(BWD_ROUTES, 0) for which in ("dq", "dkv")}
#: launches by (kernel "fwd" / "dq" / "dkv", route, Sq, Sk, causal, input
#: dtype name): which of a path's shapes each kernel ran
flash_shape_launches: dict = {}
#: the plain versions' FLOPs of every launch so far (`plain_flops`)
flash_flops = 0


def plain_flops(which: str, B: int, H: int, Sq: int, Sk: int,
                D: int) -> int:
    """What FlopCounterMode counts for the plain version of one launch of
    K1 (``which="fwd"``), K2 (``"dq"``) or K3 (``"dkv"``): its full ``Sq x
    Sk`` einsums (causal or not), ``2·B·H·Sq·Sk·D`` each — QKᵀ and PV in
    the forward; S, dP and dS·K in dQ's; S, dP, Pᵀ·dO and dSᵀ·Q in
    dK/dV's."""
    return {"fwd": 2, "dq": 3, "dkv": 4}[which] * 2 * B * H * Sq * Sk * D


def reset_launch_counts() -> None:
    """Set every launch count of this module, and `flash_flops`, to 0."""
    global flash_fwd_launches, flash_bwd_dq_launches, flash_bwd_dkv_launches
    global flash_flops
    flash_fwd_launches = flash_bwd_dq_launches = flash_bwd_dkv_launches = 0
    flash_flops = 0
    for route in FWD_ROUTES:
        flash_fwd_route_launches[route] = 0
    for counts in flash_bwd_route_launches.values():
        for route in BWD_ROUTES:
            counts[route] = 0
    flash_shape_launches.clear()


def _count_shape(which, route, Sq, Sk, causal, dtype) -> None:
    key = (which, route, Sq, Sk, bool(causal),
           str(dtype).replace("torch.", ""))
    flash_shape_launches[key] = flash_shape_launches.get(key, 0) + 1


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _valid(mask, Sq, Sk, causal):
    """Key validity [B, 1, Sq or 1, Sk]: the mask and, when causal, j <= i."""
    valid = (mask > 0)[:, None, None, :]
    if causal:
        ar_k = torch.arange(Sk, device=mask.device)
        ar_q = torch.arange(Sq, device=mask.device)
        valid = valid & (ar_k[None, :] <= ar_q[:, None])
    return valid


def _reference(q, k, v, mask, scale, causal, out_dtype):
    """[B,Sq,H,D] x [B,Sk,H,D], int mask [B,Sk] -> (o [B,Sq,H,D],
    lse f32 [B,H,Sq]): one block, the same masks and floors."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    s = s.masked_fill(~_valid(mask, q.shape[1], k.shape[1], causal),
                      float("-inf"))
    m = s.amax(dim=-1).clamp_min(_NEG_BIG)
    p = torch.exp(s - m[..., None])
    den = p.sum(dim=-1).clamp_min(_TINY)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / den.transpose(1, 2)[..., None]
    return o.to(out_dtype), m + torch.log(den)


def _bwd_terms(q, k, v, mask, do, lse, delta, scale, causal):
    """(p, ds) [B,H,Sq,Sk] fp32 of the backward, with lse and delta
    [B,H,Sq]: p = exp(s - lse) SELECTED where the key counts (an all-masked
    row's lse is -1e30, so exp(s - lse) is inf there and a product with the
    mask would be NaN), ds = p * (dO.v - delta)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    p = torch.where(_valid(mask, q.shape[1], k.shape[1], causal),
                    torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def _dq_reference(q, k, v, mask, do, lse, delta, scale, causal,
                  out_dtype=None):
    _, ds = _bwd_terms(q, k, v, mask, do, lse, delta, scale, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(out_dtype or q.dtype)


def _dkv_reference(q, k, v, mask, do, lse, delta, scale, causal,
                   out_dtype=None):
    p, ds = _bwd_terms(q, k, v, mask, do, lse, delta, scale, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float() * scale)
    return dk.to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype)


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


def _folded(q, k, v, kv_mask, do, lse, delta, out_dtype):
    """Folded [BH,S,D] operands as [BH,S,1,D] views, an int32 mask,
    lse/delta as [BH,1,Sq], and the output dtype: q's (the default) or
    float32, as the forward's `_dispatch` takes."""
    if out_dtype not in (None, q.dtype, torch.float32):
        raise ValueError(f"flash attention backward: out_dtype {out_dtype} "
                         f"is neither q's dtype {q.dtype} nor float32")
    return (q[:, :, None], k[:, :, None], v[:, :, None],
            kv_mask.to(torch.int32), do[:, :, None],
            lse.float()[:, None].contiguous(),
            delta.float()[:, None].contiguous(), out_dtype or q.dtype)


def flash_pair_dq_reference(q, k, v, kv_mask, do, lse, delta, scale, causal,
                            out_dtype=None):
    """The plain version of `flash_pair_dq` over folded ``[BH, S, D]``."""
    *args, out_dtype = _folded(q, k, v, kv_mask, do, lse, delta, out_dtype)
    return _dq_reference(*args, scale, causal, out_dtype)[:, :, 0]


def flash_pair_dkv_reference(q, k, v, kv_mask, do, lse, delta, scale,
                             causal, out_dtype=None):
    """The plain version of `flash_pair_dkv` over folded ``[BH, S, D]``."""
    *args, out_dtype = _folded(q, k, v, kv_mask, do, lse, delta, out_dtype)
    dk, dv = _dkv_reference(*args, scale, causal, out_dtype)
    return dk[:, :, 0], dv[:, :, 0]


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_libs: dict = {}


def _kernel_lib(name: str = "flash_fwd"):
    """The loaded ``csrc/<name>.cu`` library with its argument types set."""
    lib = _libs.get(name)
    if lib is None:
        from dear_pytorch_tpu_torch.ops import _build

        lib = _build.load(name)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "flash_fwd":
            lib.flash_fwd.argtypes = (
                [ptr] * 6 + [i32] * 5 + [i64] * 13
                + [ctypes.c_float] + [i32] * 6 + [ptr] * 3)
            lib.flash_fwd.restype = i32
        else:
            lib.flash_bwd_dq.argtypes = (
                [ptr] * 8 + [i32] * 5
                + [ptr, ctypes.c_float, i32, i32, i32, i32, ptr])
            lib.flash_bwd_dkv.argtypes = (
                [ptr] * 9 + [i32] * 5
                + [ptr, ctypes.c_float, i32, i32, i32, i32, ptr])
            lib.flash_bwd_dq.restype = lib.flash_bwd_dkv.restype = i32
        err_string = getattr(lib, f"{name}_error_string")
        err_string.argtypes = [i32]
        err_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _check_views(D, B, H, named):
    """The kernels' layout contract: a contiguous last dim, rows on 16-byte
    boundaries (base pointer and every stride), D a multiple of 8 up to
    128, and B * H blocks along the grid's y axis."""
    for name, t in named:
        align = 16 // t.element_size()  # 16-byte row loads
        misaligned = t.data_ptr() % 16 or any(
            st % align for st, n in zip(t.stride()[:-1], t.shape[:-1])
            if n > 1)
        if t.stride(-1) != 1 or misaligned:
            raise ValueError(
                f"flash attention kernel: {name} needs a contiguous last "
                "dim and rows on 16-byte boundaries, got strides "
                f"{t.stride()} at offset {t.data_ptr() % 16}")
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(
            f"flash attention kernel: head dim {D} is not a multiple of 8 "
            "in [8, 128]")
    if B * H > 65535:
        raise ValueError(f"flash attention kernel: B*H = {B * H} > 65535")


def fwd_route(Sq: int, D: int, dtype: torch.dtype,
              out_dtype: torch.dtype) -> str:
    """K1's route for a call, from its shape and dtypes alone: one query row
    (a decode tick) -> ``"split_k"``; bf16 in and out at head dim 64 (the
    training step) -> ``"tensor_core"``; anything else (fp32 inputs, an
    fp32 output — which bf16-rounded probabilities could not meet — or
    another head dim) -> ``"cuda_core"``."""
    if Sq == 1:
        return "split_k"
    if dtype == out_dtype == torch.bfloat16 and D == 64:
        return "tensor_core"
    return "cuda_core"


def bwd_route(D: int, dtype: torch.dtype, out_dtype: torch.dtype) -> str:
    """K2's and K3's route for a call, from its head dim and dtypes alone:
    bf16 in and out at head dim 64 (the training step) ->
    ``"tensor_core"``; anything else (fp32 inputs, an fp32 output — which
    bf16-rounded P and dS could not meet — or another head dim) ->
    ``"cuda_core"``."""
    if dtype == out_dtype == torch.bfloat16 and D == 64:
        return "tensor_core"
    return "cuda_core"


#: the routes' numbers in csrc/flash_fwd.cu and csrc/flash_bwd.cu (their
#: enum Route)
_ROUTE_IDS = {"cuda_core": 0, "split_k": 1, "tensor_core": 2}
#: the split-K route's limits: a split reads at least this many keys (one
#: CUDA-core tile), a row takes at most this many splits
SPLIT_MIN_KEYS = 128
SPLIT_MAX = 16


def decode_splits(rows: int, Sk: int, sms: int) -> tuple:
    """``(splits, split_keys)`` of the split-K route for ``rows = B * H``
    query rows over ``Sk`` keys on a card of ``sms`` SMs: enough blocks to
    give every SM about three (``rows * splits >= 3 * sms``), each split at
    least `SPLIT_MIN_KEYS` keys (a multiple of 64) and at most `SPLIT_MAX`
    splits; ``splits * split_keys >= Sk`` and no split is empty. GPT-2
    small's tick (48 rows, 1024 keys, 132 SMs) gets 8 x 128."""
    want = -(-3 * sms // max(rows, 1))
    splits = max(1, min(want, -(-Sk // SPLIT_MIN_KEYS), SPLIT_MAX))
    split_keys = -(-(-(-Sk // splits)) // 64) * 64
    return -(-Sk // split_keys), split_keys


#: per (device, stream): the split-K route's arrival counters, zeroed once;
#: every launch leaves them at zero again (the kernel's atomicInc wraps)
_counters: dict = {}


def _split_buffers(dev, rows, splits, D):
    """The split-K route's workspace (fresh, uninitialised) and its
    persistent zeroed counters for ``rows`` rows on the current stream."""
    ws = torch.empty(rows * splits * (D + 2), dtype=torch.float32,
                     device=dev)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    cnt = _counters.get(key)
    if cnt is None or cnt.numel() < rows:
        cnt = torch.zeros(max(rows, 1024), dtype=torch.int32, device=dev)
        _counters[key] = cnt
    return ws, cnt


def _launch(q, k, v, mask, scale, causal, out_dtype):
    """Launch ``csrc/flash_fwd.cu`` on [B,S,H,D] views (any strides with a
    contiguous last dim) and an int32 [B,Sk] mask, by `fwd_route`."""
    global flash_fwd_launches, flash_flops
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    _check_views(D, B, H, (("q", q), ("k", k), ("v", v)))
    if mask.stride(-1) != 1:
        raise ValueError("flash attention kernel: kv_mask needs a "
                         "contiguous last dim")
    route = fwd_route(Sq, D, q.dtype, out_dtype)
    dev = q.device
    o = torch.empty((B, Sq, H, D), dtype=out_dtype, device=dev)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    splits, split_keys, ws, cnt = 1, max(Sk, 1), None, None
    if route == "split_k":
        splits, split_keys = decode_splits(
            B * H, Sk, torch.cuda.get_device_properties(
                dev).multi_processor_count)
        if splits > 1:
            ws, cnt = _split_buffers(dev, B * H, splits, D)
    lib = _kernel_lib("flash_fwd")
    with torch.cuda.device(dev):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, H, Sq, Sk, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2), mask.stride(0),
            scale, int(causal), int(q.dtype == torch.bfloat16),
            int(out_dtype == torch.float32), _ROUTE_IDS[route], splits,
            split_keys,
            None if ws is None else ws.data_ptr(),
            None if cnt is None else cnt.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"flash attention kernel ({route}) launch failed: "
            + lib.flash_fwd_error_string(err).decode())
    flash_fwd_launches += 1
    flash_fwd_route_launches[route] += 1
    _count_shape("fwd", route, Sq, Sk, causal, q.dtype)
    flash_flops += plain_flops("fwd", B, H, Sq, Sk, D)
    return o, lse


def _strides(*views):
    """(batch, sequence, head) element strides of [B,S,H,D] views (None:
    an unused slot), then the mask's batch stride, as the C array the
    backward kernels take."""
    vals = []
    for t in views[:-1]:
        vals += [0, 0, 0] if t is None else list(t.stride()[:3])
    vals.append(views[-1].stride(0))
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch_bwd(which, q, k, v, mask, do, lse, delta, scale, causal,
                out_dtype=None):
    """Launch ``csrc/flash_bwd.cu``'s dQ (``which="dq"``) or dK/dV kernel
    on [B,S,H,D] views, an int32 [B,Sk] mask and contiguous fp32 lse and
    delta [B,H,Sq]; the outputs in ``out_dtype`` (q's or float32); the
    route by `bwd_route`."""
    global flash_bwd_dq_launches, flash_bwd_dkv_launches, flash_flops
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    _check_views(D, B, H, (("q", q), ("k", k), ("v", v), ("do", do)))
    if mask.stride(-1) != 1 or not (lse.is_contiguous()
                                    and delta.is_contiguous()):
        raise ValueError("flash attention backward kernel: kv_mask needs a "
                         "contiguous last dim, lse and delta contiguity")
    lib = _kernel_lib("flash_bwd")
    bf16 = int(q.dtype == torch.bfloat16)
    out_dtype = out_dtype or q.dtype
    out_f32 = int(out_dtype == torch.float32)
    route = bwd_route(D, q.dtype, out_dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if which == "dq":
            dq = torch.empty((B, Sq, H, D), dtype=out_dtype, device=q.device)
            st = _strides(q, k, v, do, dq, None, None, mask)
            err = lib.flash_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                mask.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), B, H, Sq, Sk, D, st, scale, int(causal), bf16,
                out_f32, _ROUTE_IDS[route], stream)
            out = dq
        else:
            dk = torch.empty((B, Sk, H, D), dtype=out_dtype, device=q.device)
            dv = torch.empty((B, Sk, H, D), dtype=out_dtype, device=q.device)
            st = _strides(q, k, v, do, None, dk, dv, mask)
            err = lib.flash_bwd_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                mask.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, H, Sq, Sk, D, st, scale,
                int(causal), bf16, out_f32, _ROUTE_IDS[route], stream)
            out = (dk, dv)
    if err:
        raise RuntimeError(
            f"flash attention backward ({which}, {route}) kernel launch "
            "failed: " + lib.flash_bwd_error_string(err).decode())
    if which == "dq":
        flash_bwd_dq_launches += 1
    else:
        flash_bwd_dkv_launches += 1
    flash_bwd_route_launches[which][route] += 1
    _count_shape(which, route, Sq, Sk, causal, q.dtype)
    flash_flops += plain_flops(which, B, H, Sq, Sk, D)
    return out


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


def _bwd_device(q, k, v, mask, do, lse, delta):
    """The device type the backward runs on, after the input checks."""
    devices = {t.device for t in (q, k, v, mask, do, lse, delta)}
    if len(devices) != 1:
        raise ValueError(f"flash attention backward: inputs on several "
                         f"devices {sorted(map(str, devices))}")
    if not (q.dtype == k.dtype == v.dtype == do.dtype) \
            or q.dtype not in _DTYPES:
        raise ValueError(
            "flash attention backward: q, k, v, do must all be float32 or "
            f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}")
    kind = q.device.type
    if kind not in ("cpu", "cuda"):
        raise RuntimeError(
            f"flash attention backward: no kernel for device {q.device}")
    return kind


def _dispatch_dq(q, k, v, mask, do, lse, delta, scale, causal,
                 out_dtype=None):
    """dQ [B,Sq,H,D] from [B,S,H,D] operands and fp32 lse/delta [B,H,Sq],
    in ``out_dtype`` (default q's; or float32)."""
    if _bwd_device(q, k, v, mask, do, lse, delta) == "cpu":
        return _dq_reference(q, k, v, mask, do, lse, delta, scale, causal,
                             out_dtype)
    return _launch_bwd("dq", q, k, v, mask, do, lse, delta, scale, causal,
                       out_dtype)


def _dispatch_dkv(q, k, v, mask, do, lse, delta, scale, causal,
                  out_dtype=None):
    """(dK, dV) [B,Sk,H,D], as `_dispatch_dq`."""
    if _bwd_device(q, k, v, mask, do, lse, delta) == "cpu":
        return _dkv_reference(q, k, v, mask, do, lse, delta, scale, causal,
                              out_dtype)
    return _launch_bwd("dkv", q, k, v, mask, do, lse, delta, scale, causal,
                       out_dtype)


class _FlashAttention(torch.autograd.Function):
    """K1 forward; K2 and K3 backward (the JAX package's custom VJP
    ``_flash``). ``lse`` is an output but not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, causal, out_dtype):
        o, lse = _dispatch(q, k, v, mask, scale, causal, out_dtype)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        del dlse  # lse is non-differentiable: its cotangent is zero
        q, k, v, mask, o, lse = ctx.saved_tensors
        # do may arrive non-contiguous (the cotangent of a transpose or a
        # reshape): make it contiguous in q's dtype, which gives the kernels
        # unit-stride rows on 16-byte boundaries
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = _dispatch_dq(q, k, v, mask, do, lse, delta, ctx.scale,
                          ctx.causal)
        dk, dv = _dispatch_dkv(q, k, v, mask, do, lse, delta, ctx.scale,
                               ctx.causal)
        return dq, dk, dv, None, None, None, None


def _flash_fwd(q, k, v, mask, scale, causal, out_dtype):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, mask, scale, causal, out_dtype)
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


def flash_pair_dq(q, k, v, kv_mask, do, lse, delta, scale, causal,
                  out_dtype=None):
    """dQ over folded ``[BH, S, D]`` operands given the global ``lse`` and
    ``delta`` ``[BH, Sq]`` (fp32) — the flash backward's dq leg, exposed for
    ring attention. ``out_dtype`` (default: q's dtype) may be float32, as
    ring attention asks for bf16 inputs."""
    *args, out_dtype = _folded(q, k, v, kv_mask, do, lse, delta, out_dtype)
    return _dispatch_dq(*args, scale, causal, out_dtype)[:, :, 0]


def flash_pair_dkv(q, k, v, kv_mask, do, lse, delta, scale, causal,
                   out_dtype=None):
    """(dK, dV) over folded ``[BH, S, D]`` operands (see `flash_pair_dq`)."""
    *args, out_dtype = _folded(q, k, v, kv_mask, do, lse, delta, out_dtype)
    dk, dv = _dispatch_dkv(*args, scale, causal, out_dtype)
    return dk[:, :, 0], dv[:, :, 0]


def make_flash_attention_impl() -> Callable:
    """The model zoo's ``attention_impl`` (the `models.bert.
    dot_product_attention` contract) over K1, K2 and K3 — the port of the
    JAX package's ``make_flash_attention_impl`` (ops/flash_attention.py:546).
    The model's additive ``[B, 1, 1, S]`` mask becomes the kernels' key
    validity (``mask > -1``). The kernels have no attention-dropout path:
    with an active dropout rate the impl takes the dense core with dropout,
    the JAX impl's semantics (the CLIs zero that rate under
    ``--flash-attention`` before it can happen)."""
    from dear_pytorch_tpu_torch.models.bert import dot_product_attention

    def impl(q, k, v, mask, *, dropout_rate=0.0, generator=None,
             dtype=torch.float32):
        if generator is not None and dropout_rate > 0.0:
            return dot_product_attention(q, k, v, mask,
                                         dropout_rate=dropout_rate,
                                         generator=generator, dtype=dtype)
        kv_mask = None
        if mask is not None:
            kv_mask = mask.reshape(mask.shape[0], mask.shape[-1]) > -1.0
        return flash_attention(q, k, v, kv_mask=kv_mask)

    return impl
