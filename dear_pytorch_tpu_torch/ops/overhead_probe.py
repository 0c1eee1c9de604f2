"""The overhead probe's elementwise kernel (K9), as a hand-written Hopper
kernel and its plain PyTorch version.

The port of ``scripts/pallas_overhead_probe.py::kern`` (:33): ``o = x * 2
+ 1`` over an fp32 ``(nblocks * rows_per_block, 512)`` tensor, launched
over a grid of ``nblocks`` steps that each own one ``(rows_per_block,
512)`` block. The kernel is ``csrc/overhead_probe.cu``, CUDA C++ for
``sm_90a``, built by `ops._build` at first use and called through
``ctypes`` on the current stream: one CUDA block per grid step, so the
probe's two granularities mean on the card what they meant on the TPU.

`affine_probe_plain` is ``x * 2.0 + 1.0``: two PyTorch ops, each rounded.
``2x`` is exact in fp32, so the kernel's result, rounded once with or
without FMA contraction, is bitwise equal to it (and to the Pallas kernel
in interpret mode).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises; any other device raises. ``affine_probe_launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["WIDTH", "affine_probe", "affine_probe_plain"]

#: the probe's row width (the Pallas block's last dimension)
WIDTH = 512

#: kernel launches so far (incremented only where the kernel launches)
affine_probe_launches = 0


def affine_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``x * 2.0 + 1.0``."""
    return x * 2.0 + 1.0


def _check(x: torch.Tensor, rows_per_block: int) -> int:
    """The grid's step count for ``x``; raises on what the kernel does not
    take."""
    if x.dtype != torch.float32:
        raise ValueError(f"affine_probe: the probe runs in float32, got "
                         f"{x.dtype}")
    if x.dim() != 2 or x.shape[1] != WIDTH:
        raise ValueError(f"affine_probe: expected rows of {WIDTH}, got "
                         f"shape {tuple(x.shape)}")
    rows_per_block = int(rows_per_block)
    if rows_per_block <= 0 or x.shape[0] == 0 \
            or x.shape[0] % rows_per_block:
        raise ValueError(f"affine_probe: {x.shape[0]} rows do not split "
                         f"into a grid of blocks of {rows_per_block}")
    return x.shape[0] // rows_per_block


def affine_probe(x: torch.Tensor, rows_per_block: int,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x * 2 + 1`` over a grid of ``x.shape[0] // rows_per_block`` blocks
    of ``(rows_per_block, 512)`` rows, into ``out`` when given."""
    nblocks = _check(x, rows_per_block)
    if out is None:
        out = torch.empty_like(x)
    if out.shape != x.shape or out.dtype != x.dtype \
            or out.device != x.device:
        raise ValueError(f"affine_probe: out must be {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    kind = x.device.type
    if kind == "cpu":
        return out.copy_(affine_probe_plain(x))
    if kind != "cuda":
        raise RuntimeError(f"affine_probe: no kernel for device {x.device}")
    _launch(x, out, nblocks, rows_per_block)
    return out


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from dear_pytorch_tpu_torch.ops import _build

        lib = _build.load("overhead_probe")
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.affine_probe.argtypes = [ptr, ptr, i64, i64, ctypes.c_int, ptr]
        lib.affine_probe.restype = ctypes.c_int
        lib.affine_probe_error_string.argtypes = [ctypes.c_int]
        lib.affine_probe_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(x, out, nblocks, rows_per_block) -> None:
    """Launch ``csrc/overhead_probe.cu`` over contiguous CUDA tensors."""
    global affine_probe_launches
    if not (x.is_cuda and out.device == x.device):
        raise ValueError(f"affine_probe kernel: tensors on {x.device} and "
                         f"{out.device}, not on one card")
    if not (x.is_contiguous() and out.is_contiguous()):
        raise ValueError("affine_probe kernel: tensors not contiguous")
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        err = lib.affine_probe(
            x.data_ptr(), out.data_ptr(), nblocks, int(rows_per_block),
            WIDTH, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("affine_probe kernel launch failed: "
                           + lib.affine_probe_error_string(err).decode())
    affine_probe_launches += 1
