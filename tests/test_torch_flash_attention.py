"""The port's flash attention (dear_pytorch_tpu_torch.ops.flash_attention:
the forward K1 and the backward K2 and K3) against the JAX package's Pallas
kernels, which run in interpret mode on the CPU. On a CPU tensor the port
takes its plain versions; the Hopper kernels themselves are held against
those plain versions on the card by chip_smoke.py.

Tolerance: 1e-5 in fp32 (the two differ only in summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_pair_dkv as jax_flash_pair_dkv,
    flash_pair_dq as jax_flash_pair_dq,
    flash_pair_fwd as jax_flash_pair_fwd,
)
import dear_pytorch_tpu_torch.ops.flash_attention as FA

TOL = 1e-5


def _qkv(rs, B, Sq, Sk, H, D):
    return (rs.randn(B, Sq, H, D).astype(np.float32),
            rs.randn(B, Sk, H, D).astype(np.float32),
            rs.randn(B, Sk, H, D).astype(np.float32))


def _holey(rs, B, Sk):
    mask = rs.rand(B, Sk) > 0.3
    mask[:, 0] = True
    return mask


@pytest.mark.parametrize("S", [16, 13])
@pytest.mark.parametrize("holey", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax(causal, holey, S):
    rs = np.random.RandomState(S + 2 * holey + 4 * causal)
    q, k, v = _qkv(rs, 2, S, S, 2, 16)
    mask = _holey(rs, 2, S) if holey else None
    want = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_mask=None if mask is None else jnp.asarray(mask))
    got = FA.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (2, S, 2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_flash_attention_decode_shape_matches_jax():
    """The decode tick's shape: one query over a 16-slot cache under a
    per-row validity mask (rows at different fill levels)."""
    rs = np.random.RandomState(7)
    q, k, v = _qkv(rs, 3, 1, 16, 2, 16)
    mask = np.arange(16)[None, :] < np.array([[1], [9], [16]])
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), kv_mask=jnp.asarray(mask))
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_pair_fwd_out_f32_matches_jax(causal):
    """Folded [BH, S, D] operands in bf16 with fp32 output (ring
    attention's accumulation mode): o and lse agree."""
    rs = np.random.RandomState(11)
    BH, S, D = 4, 16, 16
    q, k, v = (rs.randn(BH, S, D).astype(np.float32) for _ in range(3))
    mask = _holey(rs, BH, S).astype(np.int32)
    scale = 0.3
    jo, jlse = jax_flash_pair_fwd(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(mask), scale, causal,
        out_dtype=jnp.float32)
    to = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    o, lse = FA.flash_pair_fwd(to(q), to(k), to(v), torch.from_numpy(mask),
                               scale, causal, out_dtype=torch.float32)
    assert o.dtype == torch.float32 and lse.shape == (BH, S)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                               rtol=TOL, atol=TOL)


def test_all_masked_row_gives_zero_and_floor_lse():
    """A row with no valid key: o == 0 and lse == -1e30 (the kernel's
    floors), never NaN — in the JAX kernel and in the port."""
    rs = np.random.RandomState(3)
    BH, S, D = 2, 13, 16
    q, k, v = (rs.randn(BH, S, D).astype(np.float32) for _ in range(3))
    mask = np.ones((BH, S), np.int32)
    mask[1] = 0
    jo, jlse = jax_flash_pair_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(mask),
                                  D ** -0.5, False)
    o, lse = FA.flash_pair_fwd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(mask),
                               D ** -0.5, False)
    for oo, ll in ((np.asarray(jo), np.asarray(jlse)),
                   (o.numpy(), lse.numpy())):
        assert np.all(oo[1] == 0.0)
        assert np.all(ll[1] == np.float32(-1e30))
        assert np.all(np.isfinite(oo[0]))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    # on the CPU the wrapper IS its plain version
    ref_o, ref_lse = FA.flash_pair_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), D ** -0.5, False)
    assert torch.equal(ref_o, o) and torch.equal(ref_lse, lse)


def test_cpu_calls_launch_no_kernel():
    before = FA.flash_fwd_launches
    x = torch.randn(1, 5, 2, 8, requires_grad=True)
    FA.flash_attention(x, x, x, causal=True).sum().backward()
    FA.flash_pair_fwd(x[:, :, 0], x[:, :, 0], x[:, :, 0], None, None, False)
    assert FA.flash_fwd_launches == before == 0
    assert FA.flash_bwd_dq_launches == FA.flash_bwd_dkv_launches == 0


def test_other_devices_and_bad_inputs_raise():
    m = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        FA.flash_attention(m, m, m)
    x = torch.randn(1, 4, 2, 8)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        FA.flash_attention(x, x.to(torch.bfloat16), x)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        FA.flash_attention(x.half(), x.half(), x.half())


def test_backward_raises_until_the_training_slice():
    """A gradient flows through `flash_attention` and equals the dense
    attention's. (The name dates from before the training slice, when the
    backward raised; the test kept it when the slice brought the backward,
    K2 and K3, so its history stays under one name.)"""
    rs = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(rs, 1, 4, 4, 2, 8))
    o = FA.flash_attention(q, k, v)
    w = torch.from_numpy(rs.randn(*o.shape).astype(np.float32))
    (o * w).sum().backward()
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q2, k2) / 8 ** 0.5
    dense = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v2)
    (dense * w).sum().backward()
    for got, want in ((q, q2), (k, k2), (v, v2)):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   rtol=TOL, atol=TOL)


def _pair_case(seed, BH, S, D, holey, dead_row=False):
    """Folded operands, a key mask, and lse/delta from the JAX forward."""
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(BH, S, D).astype(np.float32) for _ in range(4))
    mask = _holey(rs, BH, S) if holey else np.ones((BH, S), bool)
    mask = mask.astype(np.int32)
    if dead_row:
        mask[1] = 0
    return q, k, v, do, mask


@pytest.mark.parametrize("holey", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_pair_dq_dkv_match_jax(causal, holey):
    """The dQ and dK/dV legs on the same lse and delta."""
    q, k, v, do, mask = _pair_case(20 + 2 * causal + holey, 4, 16, 16, holey)
    scale = 16 ** -0.5
    jo, jlse = jax_flash_pair_fwd(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                  scale, causal)
    lse = np.asarray(jlse)
    delta = np.sum(do * np.asarray(jo), axis=-1)
    j = [jnp.asarray(a) for a in (q, k, v, mask, do, lse, delta)]
    jdq = jax_flash_pair_dq(*j, scale, causal)
    jdk, jdv = jax_flash_pair_dkv(*j, scale, causal)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, mask, do, lse,
                                                   delta)]
    dq = FA.flash_pair_dq(*t, scale, causal)
    dk, dv = FA.flash_pair_dkv(*t, scale, causal)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == torch.float32 and got.shape == (4, 16, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
    ref_dk, ref_dv = FA.flash_pair_dkv_reference(*t, scale, causal)
    assert torch.equal(ref_dk, dk) and torch.equal(ref_dv, dv)
    assert torch.equal(FA.flash_pair_dq_reference(*t, scale, causal), dq)


@pytest.mark.parametrize("S", [16, 32])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_grad(causal, S):
    """torch.autograd through `flash_attention` against jax.grad through
    the JAX package's (its custom VJP over the Pallas kernels), with a
    holey key mask."""
    rs = np.random.RandomState(30 + S + causal)
    q, k, v = _qkv(rs, 2, S, S, 2, 16)
    w = rs.randn(2, S, 2, 16).astype(np.float32)
    mask = _holey(rs, 2, S)

    def jloss(q_, k_, v_):
        o = jax_flash_attention(q_, k_, v_, causal=causal,
                                kv_mask=jnp.asarray(mask))
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = FA.flash_attention(tq, tk, tv, causal=causal,
                           kv_mask=torch.from_numpy(mask))
    (o * torch.from_numpy(w)).sum().backward()
    for got, exp in zip((tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(exp),
                                   rtol=TOL, atol=TOL)


def test_all_masked_row_backward_is_zero_not_nan():
    """A query row with no valid key (lse = -1e30) gets dq = 0; a key no
    query attends gets dk = dv = 0; nothing is NaN — in both packages."""
    q, k, v, do, mask = _pair_case(40, 3, 13, 16, True, dead_row=True)
    mask[2, 5] = 0                       # a key nobody may attend
    scale = 16 ** -0.5
    jo, jlse = jax_flash_pair_fwd(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                  scale, False)
    lse, o = np.asarray(jlse), np.asarray(jo)
    assert np.all(lse[1] == np.float32(-1e30))
    delta = np.sum(do * o, axis=-1)
    args = (q, k, v, mask, do, lse, delta)
    jdq = np.asarray(jax_flash_pair_dq(*map(jnp.asarray, args), scale, False))
    jdk, jdv = map(np.asarray, jax_flash_pair_dkv(*map(jnp.asarray, args),
                                                  scale, False))
    t = [torch.from_numpy(np.array(a)) for a in args]
    dq = FA.flash_pair_dq(*t, scale, False).numpy()
    dk, dv = (x.numpy() for x in FA.flash_pair_dkv(*t, scale, False))
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.all(dq[1] == 0) and np.all(jdq[1] == 0)
    assert np.all(dk[1] == 0) and np.all(dv[1] == 0)   # row 1: all keys dead
    assert np.all(dk[2, 5] == 0) and np.all(dv[2, 5] == 0)


def test_backward_rejects_other_devices_and_dtypes():
    m = torch.empty(2, 4, 8, device="meta")
    mask = torch.ones(2, 4, dtype=torch.int32, device="meta")
    lse = torch.empty(2, 4, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        FA.flash_pair_dq(m, m, m, mask, m, lse, lse, 0.5, False)
    x = torch.randn(2, 4, 8)
    ones = torch.ones(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        FA.flash_pair_dkv(x, x, x, ones, x.half(), x[..., 0], x[..., 0],
                          0.5, False)
    with pytest.raises(ValueError, match="out_dtype"):
        FA.flash_pair_dq(x, x, x, ones, x, x[..., 0], x[..., 0], 0.5, False,
                         out_dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# fp32 outputs of the backward legs; K1's routes and the split-K plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("holey", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_pair_dq_dkv_bf16_in_f32_out_match_jax(causal, holey):
    """Ring attention's call: bf16 operands, fp32 dQ, dK and dV
    (``out_dtype=float32``), against JAX's kernels asked the same. Both
    upcast the same bf16 values and sum in fp32, in different orders: TOL.
    lse and delta come from JAX's fp32-out forward on the same inputs."""
    q, k, v, do, mask = _pair_case(50 + 2 * causal + holey, 4, 16, 16,
                                   holey)
    scale = 16 ** -0.5
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    jo, jlse = jax_flash_pair_fwd(*jb, jnp.asarray(mask), scale, causal,
                                  out_dtype=jnp.float32)
    jdo = jnp.asarray(do, jnp.bfloat16)
    lse = np.array(jlse)
    delta = np.sum(np.asarray(jdo, np.float32) * np.asarray(jo), axis=-1)
    j = jb + [jnp.asarray(mask), jdo, jnp.asarray(lse), jnp.asarray(delta)]
    jdq = jax_flash_pair_dq(*j, scale, causal, out_dtype=jnp.float32)
    jdk, jdv = jax_flash_pair_dkv(*j, scale, causal, out_dtype=jnp.float32)
    bf = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
          for a in (jb[0], jb[1], jb[2], jdo)]
    t = bf[:3] + [torch.from_numpy(mask), bf[3], torch.from_numpy(lse),
                  torch.from_numpy(delta)]
    dq = FA.flash_pair_dq(*t, scale, causal, out_dtype=torch.float32)
    dk, dv = FA.flash_pair_dkv(*t, scale, causal, out_dtype=torch.float32)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
    # the plain versions are what the CPU ran, and another dtype still raises
    assert torch.equal(FA.flash_pair_dq_reference(
        *t, scale, causal, out_dtype=torch.float32), dq)
    with pytest.raises(ValueError, match="out_dtype"):
        FA.flash_pair_dkv(*t, scale, causal, out_dtype=torch.float16)


@pytest.mark.parametrize("sq, d, dtype, out_dtype, route", [
    (1024, 64, torch.bfloat16, torch.bfloat16, "tensor_core"),  # train step
    (13, 64, torch.bfloat16, torch.bfloat16, "tensor_core"),    # ragged
    (1, 64, torch.bfloat16, torch.bfloat16, "split_k"),        # decode tick
    (1, 64, torch.float32, torch.float32, "split_k"),
    (1, 64, torch.bfloat16, torch.float32, "split_k"),
    (1024, 64, torch.float32, torch.float32, "cuda_core"),     # fp32 step
    (1024, 64, torch.bfloat16, torch.float32, "cuda_core"),    # fp32 out
    (200, 128, torch.bfloat16, torch.bfloat16, "cuda_core"),   # other D
])
def test_fwd_route_picks_from_shape_and_dtypes(sq, d, dtype, out_dtype,
                                               route):
    assert FA.fwd_route(sq, d, dtype, out_dtype) == route


@pytest.mark.parametrize("d, dtype, out_dtype, route", [
    (64, torch.bfloat16, torch.bfloat16, "tensor_core"),   # train step
    (64, torch.float32, torch.float32, "cuda_core"),       # fp32 step
    (64, torch.bfloat16, torch.float32, "cuda_core"),      # fp32 out
    (128, torch.bfloat16, torch.bfloat16, "cuda_core"),    # other D
    (40, torch.bfloat16, torch.bfloat16, "cuda_core"),
], ids=["train", "fp32", "fp32-out", "d128", "d40"])
def test_bwd_route_picks_from_shape_and_dtypes(d, dtype, out_dtype, route):
    """K2's and K3's route depends on the head dim and the dtypes alone,
    never on the sequence lengths."""
    assert FA.bwd_route(d, dtype, out_dtype) == route


@pytest.mark.parametrize("rows, sk, want", [
    (48, 1024, (8, 128)),    # GPT-2 small's tick: 4 slots x 12 heads
    (48, 1, (1, 64)),        # a 1-key cache: one split
    (48, 300, (3, 128)),
    (1, 100000, (16, 6272)),  # one row over a long cache: the cap
    (2000, 1024, (1, 1024)),  # rows alone fill the card
])
def test_decode_splits_plan(rows, sk, want):
    """The split-K plan at 132 SMs: enough blocks, no empty split, split
    lengths a multiple of 64, at most SPLIT_MAX splits."""
    splits, split_keys = FA.decode_splits(rows, sk, 132)
    assert (splits, split_keys) == want
    assert splits * split_keys >= sk > (splits - 1) * split_keys
    assert split_keys % 64 == 0 and 1 <= splits <= FA.SPLIT_MAX
    assert splits == 1 or split_keys >= FA.SPLIT_MIN_KEYS


def test_cpu_calls_of_every_route_launch_nothing():
    """CPU tensors take the plain versions whatever route a card would
    take: no launch is counted, in total or by route."""
    FA.reset_launch_counts()
    for sq, dt, out in ((1, torch.bfloat16, None), (1, torch.float32, None),
                        (16, torch.bfloat16, None),
                        (16, torch.bfloat16, torch.float32),
                        (16, torch.float32, None)):
        x = torch.randn(2, sq, 2, 64).to(dt)
        kv = torch.randn(2, 16, 2, 64).to(dt)
        FA.flash_pair_fwd(x[:, :, 0], kv[:, :, 0], kv[:, :, 0], None, None,
                          sq > 1, out_dtype=out)
        FA.flash_attention(x, kv, kv, causal=sq > 1)
    b = torch.randn(2, 16, 64).bfloat16()
    lse, mask = torch.zeros(2, 16), torch.ones(2, 16, dtype=torch.int32)
    FA.flash_pair_dq(b, b, b, mask, b, lse, lse, 0.125, True,
                     out_dtype=torch.float32)
    FA.flash_pair_dkv(b, b, b, mask, b, lse, lse, 0.125, True,
                      out_dtype=torch.float32)
    # backward calls of both routes: bf16 at D = 64 (tensor cores on a
    # card), bf16 -> fp32, fp32 and D = 40 (CUDA cores), and autograd
    for dt, d, out in ((torch.bfloat16, 64, None),
                       (torch.bfloat16, 64, torch.float32),
                       (torch.float32, 64, None), (torch.bfloat16, 40, None)):
        x = torch.randn(2, 13, d).to(dt)
        FA.flash_pair_dq(x, x, x, mask[:, :13], x, lse[:, :13], lse[:, :13],
                         0.125, True, out_dtype=out)
        FA.flash_pair_dkv(x, x, x, mask[:, :13], x, lse[:, :13],
                          lse[:, :13], 0.125, False, out_dtype=out)
        xs = torch.randn(2, 13, 2, d).to(dt).requires_grad_()
        FA.flash_attention(xs, xs, xs, causal=True).sum().backward()
    assert FA.flash_fwd_launches == 0
    assert FA.flash_fwd_route_launches == dict.fromkeys(FA.FWD_ROUTES, 0)
    assert FA.flash_bwd_dq_launches == FA.flash_bwd_dkv_launches == 0
    assert FA.flash_bwd_route_launches == {
        which: dict.fromkeys(FA.BWD_ROUTES, 0) for which in ("dq", "dkv")}
