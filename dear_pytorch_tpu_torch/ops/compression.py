"""Gradient compression — the port of
``dear_pytorch_tpu/ops/compression.py``: the reference's compressor
registry (none / topk / eftopk / gaussian / signum / efsignum) plus the
int8 wire format, and the reductions over a ``torch.distributed`` group
that consume their payloads (all-gather and scatter-add, gTop-k's
recursive halving, the int8 dequantize-sum, the sign majority vote).

The JAX package's design holds here:
  - **Explicit state.** A compressor's residual is a tensor the caller
    carries (one per bucket and rank: error feedback is local); `compress`
    returns a new one and never writes its inputs.
  - **Static shapes.** ``k = max(int(n * density), 1)``; every payload's
    shape depends only on ``n`` and ``density``.
  - **JAX's selection, exactly.** ``lax.top_k`` picks the largest ``|x|``
    and, among equal values, the lower index first, in that order.
    ``torch.topk`` leaves both the choice and the order among ties
    unspecified, and ties are common (a bucket's zero padding, a parameter
    the loss does not reach, gaussian's zeroed entries when fewer than k
    clear its threshold), so `_topk_select` settles the ties at the k-th
    value by index and orders the k by a stable descending sort.
  - **Sign words.** JAX packs 32 signs per uint32 word: bit i of word j is
    coordinate 32j + i, set for ``x >= 0``, padding bits 0. torch and the
    collective libraries move int32, so the words are int32 with the same
    bits (``words.numpy().view(np.uint32)`` is JAX's word).

A reduction moves its payload in ONE collective per bucket (gTop-k: one
exchange per round): a sparse payload's fp32 values and int32 indices
travel as one int32 tensor, qint8's int8 words and fp32 scale as one int8
tensor. Each returns the dense mean over the ranks (the sign vote: ±1),
as the JAX package's does.

Divisions by a scale are by a 0-dim tensor on the input's device: PyTorch's
CUDA division by a Python number multiplies by its reciprocal, which would
round apart from the CPU.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch.comm import collectives as C

__all__ = [
    "Compressor", "QUANT", "SIGN", "SPARSE", "compressors", "get_compressor",
    "gtopk_sparse_allreduce", "int8_allreduce", "pack_signs", "packed_words",
    "sign_majority_vote_allreduce", "sparse_allreduce", "unpack_signs",
    "wire_ratio",
]


class Compressor(NamedTuple):
    """Pure compression triple over flat fp buffers.

    ``init(n, dtype, device=None)`` -> residual state (``()`` if
    stateless). ``compress(buf, state, density)`` -> ``(payload,
    new_state)``, where payload is a tensor or a dict of tensors whose
    shapes depend only on ``n`` and ``density``. ``decompress(payload, n,
    dtype)`` -> dense buffer."""

    name: str
    init: Callable[..., Any]
    compress: Callable[[torch.Tensor, Any, float], tuple]
    decompress: Callable[[Any, int, Any], torch.Tensor]


def _k_of(n: int, density: float) -> int:
    return max(int(n * density), 1)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# none
# ---------------------------------------------------------------------------


def _none_compressor() -> Compressor:
    return Compressor(
        name="none",
        init=lambda n, dtype=None, device=None: (),
        compress=lambda buf, state, density: (buf, state),
        decompress=lambda payload, n, dtype: payload,
    )


# ---------------------------------------------------------------------------
# top-k family (sparse payloads: values[k] + indices[k])
# ---------------------------------------------------------------------------


def _topk_select(x: torch.Tensor, k: int) -> tuple:
    """``lax.top_k(|x|, k)``'s choice and order: the k largest ``|x|``,
    the lower index first among equal values. Returns ``(x[idx], idx)``,
    idx int32. The k-th largest value comes from ``torch.topk``; every
    index above it is kept, and of those equal to it the lowest ones (in
    index order) fill the k; a stable descending sort of these k orders
    them. (A stable sort of all of ``|x|`` gives the same, ~6x slower on
    the CPU.)"""
    a = x.abs()
    if k >= a.shape[0]:
        idx = torch.sort(a, descending=True, stable=True).indices
    else:
        kth = torch.topk(a, k, sorted=False).values.min()
        above = (a > kth).nonzero().squeeze(1)
        ties = (a == kth).nonzero().squeeze(1)[:k - above.shape[0]]
        idx = torch.cat([above, ties])
        idx = idx[torch.sort(a[idx], descending=True, stable=True).indices]
    return x[idx], idx.to(torch.int32)


def _sparse_to_dense(values, indices, n, dtype) -> torch.Tensor:
    return torch.zeros((n,), dtype=dtype, device=values.device).index_add_(
        0, indices.long(), values.to(dtype))


def _sparse_decompress(payload, n, dtype) -> torch.Tensor:
    """The sparse wire format's decoder (topk, eftopk, gaussian), also of
    the reductions' gathered payloads."""
    return _sparse_to_dense(payload["values"], payload["indices"], n, dtype)


def _dequantize(q, scale, dtype) -> torch.Tensor:
    """qint8's decoder: ``q * scale`` in ``dtype`` (rows of gathered
    payloads with a scale each broadcast)."""
    return q.to(dtype) * scale.to(dtype)


def _zeroed_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    out[idx.long()] = 0.0
    return out


def _topk_compressor(error_feedback: bool) -> Compressor:
    """topk / eftopk (reference compression.py:23-108). eftopk carries the
    unsent coordinates as residual and adds them back before the next
    selection; plain topk is stateless, as in the JAX package."""

    def init(n, dtype=torch.float32, device=None):
        return (torch.zeros((n,), dtype=dtype, device=device)
                if error_feedback else ())

    def compress(buf, residual, density):
        k = _k_of(buf.shape[0], density)
        x = buf + residual if error_feedback else buf
        values, idx = _topk_select(x, k)
        new_state = _zeroed_at(x, idx) if error_feedback else ()
        return {"values": values, "indices": idx}, new_state

    return Compressor("eftopk" if error_feedback else "topk",
                      init, compress, _sparse_decompress)


_SQRT2 = math.sqrt(2.0)


def _normal_ppf(p: float, like: torch.Tensor) -> torch.Tensor:
    """Inverse CDF of the standard normal via erfinv, in ``like``'s dtype
    on its device (the JAX package's fp32 ``_normal_ppf``)."""
    return _SQRT2 * torch.special.erfinv(_scalar(2.0 * p - 1.0, like))


def _gaussian_threshold(x: torch.Tensor, density: float) -> torch.Tensor:
    """gaussian's threshold on ``|x|`` (a 0-dim tensor): the fitted normal's
    (1 - density/2) quantile, then three rounds of refinement toward
    2k/3 <= count <= 4k/3 (JAX compression.py:132-150)."""
    k = _k_of(x.shape[0], density)
    mean = x.mean()
    std = x.std(correction=0) + 1e-12
    thres = (mean + _normal_ppf(1.0 - density / 2.0, x) * std).abs()
    mag = x.abs()
    for _ in range(3):
        count = (mag > thres).sum()
        thres = torch.where(count < 2 * k / 3, thres * 0.5, thres)
        thres = torch.where(count > 4 * k / 3, thres * 1.5, thres)
    return thres


def _gaussian_compressor() -> Compressor:
    """gaussian (reference compression.py:210-255): error feedback, a
    threshold from fitting N(mean, std) to the gradient (the population
    std, as ``jnp.std``) at the (1 - density/2) quantile, three rounds of
    refinement toward 2k/3 <= count <= 4k/3, then the top-k of the
    thresholded tensor. Where fewer than k entries clear the threshold,
    the zeros top-k picks (the lowest indices among them) are the
    residual's zeroed coordinates too, as in the JAX package."""

    def init(n, dtype=torch.float32, device=None):
        return torch.zeros((n,), dtype=dtype, device=device)

    def compress(buf, residual, density):
        x = buf + residual
        mag = x.abs()
        masked = torch.where(mag > _gaussian_threshold(x, density), x,
                             torch.zeros_like(x))
        values, idx = _topk_select(masked, _k_of(x.shape[0], density))
        return {"values": values, "indices": idx}, _zeroed_at(x, idx)

    return Compressor("gaussian", init, compress, _sparse_decompress)


# ---------------------------------------------------------------------------
# sign family (1 bit per coordinate, 32 per word)
# ---------------------------------------------------------------------------


def packed_words(n: int) -> int:
    return (n + 31) // 32


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """Sign bits (1 = non-negative) packed 32 per int32 word, bit for bit
    the JAX package's uint32 words."""
    n = x.shape[0]
    bits = torch.zeros((packed_words(n) * 32,), dtype=torch.int64,
                       device=x.device)
    bits[:n] = (x >= 0).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    words = (bits.view(-1, 32) << shifts).sum(1)
    # [0, 2^32) -> the int32 of the same bits
    return (words - ((words >> 31) << 32)).to(torch.int32)


def unpack_signs(words: torch.Tensor, n: int,
                 dtype=torch.float32) -> torch.Tensor:
    """int32 words -> a ±1 tensor of length n."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, None] >> shifts) & 1
    one = torch.ones((), dtype=dtype, device=words.device)
    return torch.where(bits == 1, one, -one).reshape(-1)[:n]


def _sign_compressor(error_feedback: bool) -> Compressor:
    """signum / efsignum (reference compression.py:111-207): 1-bit signSGD
    payloads; the EF variant keeps ``x - sign(x)`` as residual."""

    def init(n, dtype=torch.float32, device=None):
        return (torch.zeros((n,), dtype=dtype, device=device)
                if error_feedback else ())

    def compress(buf, residual, density):
        x = buf + residual if error_feedback else buf
        new_state = (x - torch.where(x >= 0, 1.0, -1.0).to(x.dtype)
                     if error_feedback else residual)
        return pack_signs(x), new_state

    return Compressor("efsignum" if error_feedback else "signum",
                      init, compress, unpack_signs)


# ---------------------------------------------------------------------------
# int8 wire format (scaled symmetric quantization, error feedback)
# ---------------------------------------------------------------------------


def _qint8_compressor() -> Compressor:
    """qint8: int8 words plus one fp32 scale (``max|x| / 127``); error
    feedback carries the quantization error ``x - dequant(q)``. ``density``
    is ignored (every coordinate ships)."""

    def init(n, dtype=torch.float32, device=None):
        return torch.zeros((n,), dtype=dtype, device=device)

    def compress(buf, residual, density):
        x = buf + residual
        scale = x.abs().max() / _scalar(127.0, x) + 1e-30
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        deq = q.to(x.dtype) * scale
        return {"q": q, "scale": scale.float()}, x - deq

    return Compressor("qint8", init, compress,
                      lambda payload, n, dtype: _dequantize(
                          payload["q"], payload["scale"], dtype))


#: the reference's names (compression.py:258-267) plus the int8 wire format
compressors: dict = {
    "none": _none_compressor,
    None: _none_compressor,
    "topk": partial(_topk_compressor, False),
    "eftopk": partial(_topk_compressor, True),
    "gaussian": _gaussian_compressor,
    "signum": partial(_sign_compressor, False),
    "efsignum": partial(_sign_compressor, True),
    "qint8": _qint8_compressor,
}


def get_compressor(name: Optional[str]) -> Compressor:
    try:
        return compressors[name]()
    except KeyError:
        raise KeyError(
            f"unknown compressor {name!r}; have "
            f"{sorted(k for k in compressors if k)}") from None


SPARSE = ("topk", "eftopk", "gaussian")
SIGN = ("signum", "efsignum")
QUANT = ("qint8",)


def wire_ratio(name: Optional[str], n: int, density: float,
               itemsize: int = 4) -> float:
    """Compressed-to-dense wire-byte ratio for one flat buffer of ``n``
    elements: 1.0 dense; (value, int32 index) pairs for k kept
    coordinates; 32 coordinates per word for the signs; one byte per
    coordinate plus a scale for qint8; 1.0 for a compressor it does not
    know (never underestimates)."""
    if name in (None, "none"):
        return 1.0
    dense = n * itemsize
    if name in SPARSE:
        return (_k_of(n, density) * (itemsize + 4)) / dense
    if name in SIGN:
        return (packed_words(n) * 4) / dense
    if name in QUANT:
        return (n + 4) / dense
    return 1.0


# ---------------------------------------------------------------------------
# reductions over compressed payloads (every rank of ``group`` calls them
# in the same order)
# ---------------------------------------------------------------------------


def _sparse_wire(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """fp32 values and int32 indices as one int32 tensor of 2k words."""
    return torch.cat([values.float().view(torch.int32),
                      indices.to(torch.int32)])


def _sparse_unwire(wire: torch.Tensor) -> tuple:
    k = wire.shape[-1] // 2
    return wire[..., :k].contiguous().view(torch.float32), wire[..., k:]


def sparse_allreduce(payload, n: int, dtype, group=None) -> torch.Tensor:
    """Dense mean from every rank's sparse payload: all-gather (values,
    indices) and scatter-add (reference ``_sparse_allreduce_async``,
    wfbp/dopt.py:703-742). One all-gather of 2k words per rank."""
    world = dist.get_world_size(C._group(group))
    rows = C.all_gather(_sparse_wire(payload["values"], payload["indices"]),
                        group).view(world, -1)
    vals, idx = _sparse_unwire(rows)
    return _sparse_decompress({"values": vals.reshape(-1),
                               "indices": idx.reshape(-1)}, n, dtype) / world


def gtopk_sparse_allreduce(payload, n: int, dtype, k: int,
                           group=None) -> tuple:
    """gTop-k (reference ``gtopk_sparse_recursive_allreduce``,
    wfbp/dopt.py:50-107): round r exchanges the k-sparse sets with partner
    ``rank ^ 2^r`` (one `comm.collectives.send_recv` of 2k words), merges
    them by scatter-add (this rank's first) and keeps the top-k. After
    log2(world) rounds every rank holds the same set. Returns
    ``(dense_mean, kept_indices)``; the kept set is what error feedback
    needs to give a coordinate this rank sent but the global top-k
    rejected back to its residual. The world must be a power of two."""
    g = C._group(group)
    world = dist.get_world_size(g)
    if world & (world - 1):
        raise ValueError(f"gtopk needs a power-of-two world, got {world}")
    values, indices = payload["values"], payload["indices"]
    for r in range(world.bit_length() - 1):
        d = 1 << r
        other = C.send_recv(_sparse_wire(values, indices),
                            [i ^ d for i in range(world)], g)
        other_vals, other_idx = _sparse_unwire(other)
        merged = _sparse_decompress(
            {"values": torch.cat([values, other_vals]),
             "indices": torch.cat([indices, other_idx])}, n, dtype)
        values, indices = _topk_select(merged, k)
    return (_sparse_decompress({"values": values, "indices": indices}, n,
                               dtype) / world, indices)


def int8_allreduce(payload, n: int, dtype, group=None) -> torch.Tensor:
    """Dense mean from every rank's qint8 payload: all-gather the int8
    words with the fp32 scale (its 4 bytes after them, one collective) and
    dequantize-sum in ``dtype`` (int8 sums would overflow)."""
    world = dist.get_world_size(C._group(group))
    scale = payload["scale"].float().reshape(1).view(torch.int8)
    rows = C.all_gather(torch.cat([payload["q"], scale]), group).view(
        world, -1)
    q, s = rows[:, :n], rows[:, n:].contiguous().view(torch.float32)
    return _dequantize(q, s, dtype).sum(0) / world


def sign_majority_vote_allreduce(words: torch.Tensor, n: int, dtype,
                                 group=None) -> torch.Tensor:
    """signSGD with majority vote (reference ``majority_vote``,
    compression.py:159-175): all-gather the sign words, unpack to ±1,
    sum, take the sign; ties (an even world) go to +1."""
    world = dist.get_world_size(C._group(group))
    rows = C.all_gather(words, group).view(world, -1)
    tally = sum(unpack_signs(rows[r], n, dtype) for r in range(world))
    return torch.where(tally >= 0, 1.0, -1.0).to(dtype)
