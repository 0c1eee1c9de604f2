"""The ring collective matmul of ``--ring-projections`` in the port
(dear_pytorch_tpu_torch.ops.collective_matmul: K6 `ring_matmul`, K7
`ring_matmul_dx`, K8 `ring_matmul_dw`, `allgather_matmul` and
`make_ring_projection_impl`) against the JAX package's Pallas kernels, on
the CPU.

JAX runs `allgather_matmul` and its custom VJP in interpret mode on a
W-device sub-mesh of the emulated CPU devices, as tests/test_torch_ring.py
does; the port runs the stacked plain versions its wrappers take for CPU
tensors on a `LocalRing`. Every rank has its own activations (data
parallelism), so K8's cross-rank sum is exercised. The distributed form
(over gloo) is held to the stacked one bitwise in tests/test_torch_ring.py's
world-4 spawn, and a world-2 train step with ring projections in
tests/test_torch_dear.py's.

Tolerances are tests/test_collective_matmul.py's: FP32_TOL where both sides
sum fp32 products in different orders (XLA's dot against torch's matmul;
the round-by-round adds are the same); BF16_TOL where the outputs are
rounded to bf16 (one bf16 ulp is 2^-8 relative) after those fp32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.comm.backend import DP_AXIS
from dear_pytorch_tpu.ops import collective_matmul as JCM
from dear_pytorch_tpu_torch.comm.ring import LocalRing
from dear_pytorch_tpu_torch.models.bert import ProjDense
from dear_pytorch_tpu_torch.ops import collective_matmul as TCM
from tests.test_collective_matmul import BF16_TOL, FP32_TOL
from tests.test_torch_ring import _mesh, _spmd, _to_torch

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TOL = {"float32": FP32_TOL, "bfloat16": BF16_TOL}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _inputs(world, m, kc, n, dtype, seed):
    """Every rank's x [W, M, W*kc] and cotangent dy [W, M, N], the full
    weight [W*kc, N], as JAX arrays in ``dtype``."""
    rs = np.random.RandomState(seed)
    cast = _JDT[dtype]
    return (jnp.asarray(rs.randn(world, m, world * kc), jnp.float32
                        ).astype(cast),
            jnp.asarray(rs.randn(world * kc, n), jnp.float32).astype(cast),
            jnp.asarray(rs.randn(world, m, n), jnp.float32).astype(cast))


def _jax_ring_matmul(world, x, w, dy):
    """JAX's K6 output and its VJP (K7 dx, K8 dw_shard) per rank."""
    kc = w.shape[0] // world

    def fn(xs, ws, dys):
        y, vjp = jax.vjp(
            lambda a, b: JCM.allgather_matmul(a, b, DP_AXIS), xs[0], ws[0])
        dx, dw = vjp(dys[0])
        return y[None], dx[None], dw[None]

    call = _spmd(fn, _mesh(world), 3, n_out=3)
    return call(x, w.reshape(world, kc, -1), dy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("world", [2, 4])
def test_stacked_ring_matmul_kernels_match_jax(world, dtype):
    """K6, K7 and K8's stacked plain versions (ragged shapes: M, kc and N
    not multiples of any tile) against JAX's kernels, rank by rank."""
    m, kc, n = 13, 5, 11
    x, w, dy = _inputs(world, m, kc, n, dtype, seed=world)
    y_j, dx_j, dw_j = _jax_ring_matmul(world, x, w, dy)
    tx, tdy = _to_torch(x), _to_torch(dy)
    tws = _to_torch(w).reshape(world, kc, n)
    ring = LocalRing(world, "cpu", 1, cm_elems=kc * n)
    tol = _TOL[dtype]
    y = TCM.ring_matmul(tx, tws, ring)
    dx = TCM.ring_matmul_dx(tdy, tws, ring)
    dw = TCM.ring_matmul_dw(tx, tdy, ring)
    for got, want in ((y, y_j), (dx, dx_j), (dw, dw_j)):
        assert got.dtype == tx.dtype and got.shape == want.shape
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **tol)
    # the stacked plain versions are what the wrappers ran
    assert torch.equal(y, TCM.ring_matmul_stacked(tx, tws))
    assert torch.equal(dw, TCM.ring_matmul_dw_stacked(tx, tdy))


@pytest.mark.parametrize("world", [2, 4])
def test_allgather_matmul_autograd_matches_jax(world):
    """`allgather_matmul`'s torch.autograd.Function: the forward is K6,
    the gradients K7 and K8 (dw_shard summed over the ranks), as JAX's
    custom VJP."""
    m, kc, n = 9, 6, 7
    x, w, dy = _inputs(world, m, kc, n, "float32", seed=10 + world)
    y_j, dx_j, dw_j = _jax_ring_matmul(world, x, w, dy)
    tx = _to_torch(x).requires_grad_()
    tws = _to_torch(w).reshape(world, kc, n).requires_grad_()
    ring = LocalRing(world, "cpu", 1, cm_elems=kc * n)
    before = dict(TCM.ring_matmul_calls)
    y = TCM.allgather_matmul(tx, tws, ring)
    (y * _to_torch(dy)).sum().backward()
    for got, want in ((y, y_j), (tx.grad, dx_j), (tws.grad, dw_j)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **FP32_TOL)
    assert {k: TCM.ring_matmul_calls[k] - v for k, v in before.items()} \
        == {"fwd": 1, "dx": 1, "dw": 1}


def test_world1_and_rejections():
    """World 1 is the dense product (JAX :639-643, :656-663); mismatched
    dtypes, shapes and devices raise."""
    ring = LocalRing(1, "cpu", 1)
    x, w = torch.randn(1, 4, 6), torch.randn(1, 6, 3)
    torch.testing.assert_close(TCM.allgather_matmul(x, w, ring), x @ w)
    torch.testing.assert_close(TCM.ring_matmul(x, w, ring), x @ w)
    ring2 = LocalRing(2, "cpu", 1, cm_elems=9)
    with pytest.raises(ValueError, match="share a dtype"):
        TCM.ring_matmul(torch.randn(2, 4, 6), torch.randn(2, 3, 3)
                        .bfloat16(), ring2)
    with pytest.raises(ValueError, match="expected"):
        TCM.ring_matmul(torch.randn(2, 4, 5), torch.randn(2, 3, 3), ring2)
    with pytest.raises(ValueError, match="do not split"):
        TCM.ring_matmul_dw(torch.randn(2, 4, 5), torch.randn(2, 4, 3), ring2)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        TCM.ring_matmul(torch.randn(2, 4, 6, device="meta"),
                        torch.randn(2, 3, 3, device="meta"), ring2)


# ---------------------------------------------------------------------------
# the models' projection hook
# ---------------------------------------------------------------------------


def _impl_case(world, k, seed):
    rs = np.random.RandomState(seed)
    m, n = 6, 10
    return (jnp.asarray(rs.randn(world, m, k), jnp.float32),
            jnp.asarray(rs.randn(k, n), jnp.float32),
            jnp.asarray(rs.randn(n), jnp.float32),
            jnp.asarray(rs.randn(world, m, n), jnp.float32))


def _jax_impl(world, x, w, b, co, bound=True):
    """JAX's impl per rank: its output and the gradient of sum(y * co)
    with respect to the rank's full kernel; ``bound=False`` calls it
    outside shard_map (the axis unbound)."""
    impl = JCM.make_ring_projection_impl(DP_AXIS)
    if not bound:
        def one(i):
            f = lambda k_: jnp.sum(impl(x[i], k_, b, jnp.float32) * co[i])
            return impl(x[i], w, b, jnp.float32), jax.grad(f)(w)
        outs = [one(i) for i in range(world)]
        return (np.stack([np.asarray(o[0]) for o in outs]),
                np.stack([np.asarray(o[1]) for o in outs]))

    def fn(xs, ws, bs, cs):
        f = lambda k_: impl(xs[0], k_, bs[0], jnp.float32)
        y, vjp = jax.vjp(f, ws[0])
        return y[None], vjp(cs[0])[0][None]

    rep = lambda a: jnp.broadcast_to(a[None], (world,) + a.shape)  # noqa
    y, g = _spmd(fn, _mesh(world), 4, n_out=2)(x, rep(w), rep(b), co)
    return np.asarray(y), np.asarray(g)


@pytest.mark.parametrize("case", ["unbound", "indivisible", "bound"])
def test_ring_projection_impl_matches_jax(case):
    """``impl(x2d, kernel2d, bias1d, dtype)``: unbound -> the dense product;
    ``in % W != 0`` -> dense; bound -> this rank's row shard through the
    ring, plus the bias. The kernel's gradient is held too: under the ring
    it is the ranks' summed gradient at this rank's rows, zeros elsewhere."""
    world = 2
    k = 7 if case == "indivisible" else 8
    x, w, b, co = _impl_case(world, k, seed=len(case))
    want_y, want_g = _jax_impl(world, x, w, b, co, bound=case != "unbound")
    impl = TCM.make_ring_projection_impl()
    tx = _to_torch(x)
    tw = _to_torch(w).expand(world, -1, -1).clone().requires_grad_()
    tb = _to_torch(b).expand(world, -1)
    if case == "unbound":
        y = torch.stack([impl(tx[i], tw[i], tb[i], torch.float32)
                         for i in range(world)])
    else:
        before = TCM.ring_matmul_calls["fwd"]
        with TCM.bind_ring(LocalRing(world, "cpu", 1, cm_elems=k * 10)):
            y = impl(tx, tw, tb, torch.float32)
        ran = TCM.ring_matmul_calls["fwd"] - before
        assert ran == (1 if case == "bound" else 0)
    (y * _to_torch(co)).sum().backward()
    np.testing.assert_allclose(_np(y), want_y, **FP32_TOL)
    np.testing.assert_allclose(_np(tw.grad), want_g, **FP32_TOL)
    if case == "bound":    # rank i's gradient lives in its own rows only
        kc = k // world
        for i in range(world):
            rows = np.abs(_np(tw.grad[i])).sum(1) > 0
            assert rows.tolist() == [i * kc <= r < (i + 1) * kc
                                     for r in range(k)]


def test_proj_dense_flattens_and_keeps_dense_parameters():
    """`ProjDense` holds nn.Linear's parameters and hands the impl the
    matmul flattened to 2-D with the kernel as [in, out]."""
    seen = []

    def impl(x2, kernel2, bias1, dtype):
        seen.append((tuple(x2.shape), tuple(kernel2.shape), dtype))
        return x2.to(dtype) @ kernel2.to(dtype) + bias1.to(dtype)

    p = ProjDense(4, 6, impl=impl, compute_dtype=torch.float32,
                  device="cpu")
    assert [n for n, _ in p.named_parameters()] == ["weight", "bias"]
    x = torch.randn(2, 3, 4)
    torch.testing.assert_close(p(x), torch.nn.functional.linear(
        x, p.weight, p.bias))
    assert seen == [((6, 4), (4, 6), torch.float32)]


# ---------------------------------------------------------------------------
# K8's plan: its tile core and the split of the reduction over M
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype, world, kc, n, core", [
    (torch.bfloat16, 2, 384, 3072, "wgmma"),   # the main path
    (torch.bfloat16, 2, 24, 72, "wgmma"),
    (torch.bfloat16, 2, 5, 19, "mma"),         # rows TMA cannot address
    (torch.bfloat16, 3, 4, 8, "mma"),          # W*kc = 12
    (torch.float32, 2, 384, 768, "mma"),       # fp32: CUDA cores
])
def test_dw_core(dtype, world, kc, n, core):
    assert TCM.dw_core(dtype, world, kc, n) == core


@pytest.mark.parametrize("dtype, world, kc, n, route", [
    (torch.bfloat16, 2, 384, 768, "wgmma"),    # the main path: q, k, v
    (torch.bfloat16, 2, 384, 3072, "wgmma"),   # ... and mlp_in
    (torch.bfloat16, 8, 96, 3072, "wgmma"),    # W = 8: a box crosses kc
    (torch.bfloat16, 2, 4, 8, "mma"),          # W*kc = 8, kc = 4: K8's test
    (torch.bfloat16, 3, 8, 12, "mma"),         # kc ok, N ragged
    (torch.bfloat16, 2, 5, 19, "mma"),         # ragged bf16
    (torch.float32, 2, 384, 768, "mma"),       # fp32: CUDA cores
])
def test_cm_core(dtype, world, kc, n, route):
    """K6's and K7's route: wgmma where TMA can address every chunk (bf16,
    kc and N multiples of 8), where K8's `dw_core` looks at W*kc instead."""
    assert TCM.cm_core(dtype, world, kc, n) == route
    assert set(TCM.CM_TILE_N.values()) <= {128, 192, 256}


@pytest.mark.parametrize("m, kc, n, blocks, core, want", [
    (8192, 384, 768, 66, "wgmma", (54, 3, 64)),    # main path, LocalRing:
    (8192, 384, 3072, 66, "wgmma", (66, 2, 64)),   # 3 segments; stream-K
    (8192, 384, 768, 100, "wgmma", (90, 5, 64)),   # IPC Ring: SMs - 32
    (8192, 384, 3072, 100, "wgmma", (72, 1, 64)),
    (1000, 384, 768, 66, "wgmma", (54, 3, 64)),    # ragged M: a 40-row slab
    (37, 5, 19, 66, "mma", (1, 1, 64)),            # M below one slab
    (200, 24, 72, 66, "wgmma", (4, 4, 64)),        # fewer slabs than blocks
    (0, 4, 8, 66, "wgmma", (1, 1, 64)),            # no rows at all
    (8192, 2048, 8192, 66, "wgmma", (66, 2, 64)),  # tiles alone fill it
])
def test_dw_plan(m, kc, n, blocks, core, want):
    """K8's plan against a direct count: the runs [q T / R, (q + 1) T / R)
    of the T = tiles x slabs iterations are none empty, no more than the
    blocks, aligned to tiles when there are fewer tiles than blocks (equal
    segments), and ``contrib`` is the most runs touching one tile."""
    ranges, contrib, slab_rows = TCM.dw_plan(m, kc, n, blocks, core)
    assert (ranges, contrib, slab_rows) == want
    _, bm, bn = TCM.DW_CORES[core]
    tiles = -(-kc // bm) * -(-n // bn)
    slabs = max(1, -(-m // slab_rows))
    total = tiles * slabs
    bounds = [q * total // ranges for q in range(ranges + 1)]
    assert 1 <= ranges <= blocks and all(
        lo < hi for lo, hi in zip(bounds, bounds[1:]))
    touching = [{q for q in range(ranges)
                 if bounds[q] < (t + 1) * slabs and bounds[q + 1] > t * slabs}
                for t in range(tiles)]
    assert contrib == max(len(qs) for qs in touching)
    if tiles <= blocks:
        assert ranges % tiles == 0 and all(
            b % slabs == 0 for b in bounds[::ranges // tiles])


def test_cpu_ring_matmul_dw_launches_nothing():
    """On CPU tensors K8 takes its stacked plain version: no launch."""
    before = TCM.cm_dw_launches
    ring = LocalRing(2, "cpu", 1, cm_elems=48)
    x, dy = torch.randn(2, 10, 8).bfloat16(), torch.randn(2, 10, 12).bfloat16()
    got = TCM.ring_matmul_dw(x, dy, ring)
    torch.testing.assert_close(got, TCM.ring_matmul_dw_stacked(x, dy))
    assert TCM.cm_dw_launches == before == 0


@pytest.mark.parametrize("kind", ["fwd", "dx"])
def test_cpu_ring_matmul_launches_nothing(kind):
    """On CPU tensors K6 and K7 take their stacked plain versions (bf16
    shapes the wgmma route would take on the card): no launch, and no
    route counter moves."""
    before = (TCM.cm_fwd_launches, TCM.cm_dx_launches,
              {k: dict(v) for k, v in TCM.cm_route_launches.items()})
    ring = LocalRing(2, "cpu", 1, cm_elems=16 * 24)
    assert TCM.cm_core(torch.bfloat16, 2, 16, 24) == "wgmma"
    w = torch.randn(2, 16, 24).bfloat16()
    if kind == "fwd":
        x = torch.randn(2, 10, 32).bfloat16()
        got, want = TCM.ring_matmul(x, w, ring), TCM.ring_matmul_stacked(x, w)
    else:
        dy = torch.randn(2, 10, 24).bfloat16()
        got = TCM.ring_matmul_dx(dy, w, ring)
        want = TCM.ring_matmul_dx_stacked(dy, w)
    assert torch.equal(got, want)
    assert (TCM.cm_fwd_launches, TCM.cm_dx_launches,
            TCM.cm_route_launches) == before
    assert before[:2] == (0, 0)
