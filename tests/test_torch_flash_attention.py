"""The port's flash-attention forward (dear_pytorch_tpu_torch.ops.
flash_attention) against the JAX package's Pallas kernel, which runs in
interpret mode on the CPU. On a CPU tensor the port takes its plain
version; the Hopper kernel itself is held against that plain version on
the card by chip_smoke.py.

Tolerance: 1e-5 in fp32 (the two differ only in summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
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
    x = torch.randn(1, 5, 2, 8)
    FA.flash_attention(x, x, x, causal=True)
    FA.flash_pair_fwd(x[:, :, 0], x[:, :, 0], x[:, :, 0], None, None, False)
    assert FA.flash_fwd_launches == before == 0


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
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    o = FA.flash_attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="training slice"):
        o.sum().backward()
