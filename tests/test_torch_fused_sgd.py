"""The port's shard optimizers (dear_pytorch_tpu_torch.ops.fused_sgd: the
K5 epilogue's plain version on a CPU tensor) against the JAX package's
`fused_sgd` / `fused_adamw` over 3 steps on the same flat shard, against
``torch.optim.SGD`` / ``torch.optim.AdamW`` as a second oracle, and the
port's lr schedules against the JAX package's. The Hopper kernel itself is
held bitwise against the plain version on the card by chip_smoke.py.

The port's update takes the reduce-scatter output (a sum over ranks, in
the comm dtype) and divides by the world inside the epilogue; JAX's takes
the divided fp32 gradient. Tolerance 1e-6 in fp32: both are the same
sequence of IEEE operations, but JAX lets XLA fuse and reassociate."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.ops import fused_sgd as jopt
from dear_pytorch_tpu.ops import schedules as jsched
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.ops import schedules as tsched

TOL = 1e-6
N = 1037          # a ragged shard length


def _grads(seed, steps=3, bf16=False):
    rs = np.random.RandomState(seed)
    gs = [rs.randn(N).astype(np.float32) * 2 for _ in range(steps)]
    if bf16:
        gs = [torch.from_numpy(g).bfloat16().float().numpy() for g in gs]
    return rs.randn(N).astype(np.float32), gs


def _run_both(jo, to, seed, *, world=1, clip=None, bf16=False, steps=3):
    p0, gs = _grads(seed, steps, bf16)
    jp, js = jnp.asarray(p0), jo.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy())
    ts = to.init(tp)
    for step, g in enumerate(gs):
        rs_out = torch.from_numpy(g * world)
        if bf16:
            rs_out = rs_out.bfloat16()
        jg = jnp.asarray(rs_out.float().numpy()) / world
        clip_t = None
        if clip is not None:
            jg = jg * np.float32(clip)
            clip_t = torch.tensor(clip, dtype=torch.float32)
        kw = {"step": jnp.asarray(step, jnp.int32)} if jo.needs_step else {}
        jp, js = jo.update(jg, js, jp, **kw)
        tp2, ts = to.update(rs_out, ts, tp, mean_world=world,
                            clip_scale=clip_t, step=step)
        assert tp2 is tp                      # in place on the shard
    return np.asarray(jp), tp.numpy(), js, ts


@pytest.mark.parametrize("kw", [
    dict(lr=0.1),
    dict(lr=0.1, momentum=0.9),
    dict(lr=0.05, momentum=0.9, dampening=0.3),
    dict(lr=0.05, momentum=0.9, nesterov=True, weight_decay=1e-2),
    dict(lr=0.05, momentum=0.5, weight_decay=1e-3),
], ids=["plain", "momentum", "dampening", "nesterov_wd", "momentum_wd"])
@pytest.mark.parametrize("world,clip,bf16", [(1, None, False),
                                              (4, 0.37, True)],
                         ids=["f32", "world4_clip_bf16"])
def test_fused_sgd_matches_jax(kw, world, clip, bf16):
    jp, tp, js, ts = _run_both(jopt.fused_sgd(**kw), topt.fused_sgd(**kw),
                               1, world=world, clip=clip, bf16=bf16)
    np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL)
    if kw.get("momentum"):
        np.testing.assert_allclose(ts["buf"].numpy(), np.asarray(js[0]),
                                   rtol=TOL, atol=TOL)
        assert ts["initialized"] is True and bool(js[1])
    else:
        assert ts == {} and js == ()


def test_first_step_seeds_the_momentum_buffer():
    """torch semantics: the first step's buffer is d_p itself (no
    dampening applied), the second step blends."""
    opt = topt.fused_sgd(lr=1.0, momentum=0.9, dampening=0.5)
    p = torch.zeros(4)
    st = opt.init(p)
    g = torch.tensor([1.0, 2.0, 3.0, 4.0])
    opt.update(g, st, p)
    assert torch.equal(st["buf"], g) and torch.equal(p, -g)
    opt.update(g, st, p)
    assert torch.allclose(st["buf"], 0.9 * g + 0.5 * g)


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2),
    dict(lr=1e-2, weight_decay=0.0),
    dict(lr=3e-3, betas=(0.8, 0.99), eps=1e-6, weight_decay=0.1),
], ids=["default_wd", "no_wd", "custom"])
def test_fused_adamw_matches_jax(kw):
    jp, tp, js, ts = _run_both(jopt.fused_adamw(**kw),
                               topt.fused_adamw(**kw), 2)
    np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ts["exp_avg"].numpy(), np.asarray(js[0]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ts["exp_avg_sq"].numpy(), np.asarray(js[1]),
                               rtol=TOL, atol=TOL)
    assert ts["t"] == int(js[2]) == 3


def test_schedule_lr_reaches_the_update():
    sched = tsched.warmup_cosine(0.1, 1, 4)
    jp, tp, _, _ = _run_both(
        jopt.fused_sgd(jsched.warmup_cosine(0.1, 1, 4), momentum=0.9),
        topt.fused_sgd(sched, momentum=0.9), 3, steps=4)
    np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL)
    jp, tp, _, _ = _run_both(
        jopt.fused_adamw(jsched.warmup_linear(1e-2, 2, 5)),
        topt.fused_adamw(tsched.warmup_linear(1e-2, 2, 5)), 4, steps=4)
    np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", [
    dict(lr=0.1, momentum=0.9),
    dict(lr=0.05, momentum=0.9, nesterov=True, weight_decay=1e-2),
    dict(lr=0.05, momentum=0.8, dampening=0.1, weight_decay=1e-3),
])
def test_fused_sgd_matches_torch_optim(kw):
    p0, gs = _grads(5)
    ref = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    sgd = torch.optim.SGD([ref], **kw)
    opt = topt.fused_sgd(**kw)
    p = torch.from_numpy(p0.copy())
    st = opt.init(p)
    for g in gs:
        ref.grad = torch.from_numpy(g)
        sgd.step()
        opt.update(torch.from_numpy(g), st, p)
    np.testing.assert_allclose(p.numpy(), ref.detach().numpy(), rtol=TOL,
                               atol=TOL)


def test_fused_adamw_matches_torch_optim():
    p0, gs = _grads(6)
    ref = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    adamw = torch.optim.AdamW([ref], lr=1e-2, weight_decay=0.05)
    opt = topt.fused_adamw(lr=1e-2, weight_decay=0.05)
    p = torch.from_numpy(p0.copy())
    st = opt.init(p)
    for g in gs:
        ref.grad = torch.from_numpy(g)
        adamw.step()
        opt.update(torch.from_numpy(g), st, p)
    np.testing.assert_allclose(p.numpy(), ref.detach().numpy(), rtol=TOL,
                               atol=TOL)


def test_update_rejects_bad_inputs():
    opt = topt.fused_sgd(lr=0.1, momentum=0.9)
    p = torch.zeros(8)
    st = opt.init(p)
    with pytest.raises(ValueError, match="float32"):
        opt.update(torch.zeros(8), st, p.double())
    with pytest.raises(ValueError, match="shapes differ"):
        opt.update(torch.zeros(7), st, p)
    m = torch.zeros(8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        opt.update(m, opt.init(m), m)
    with pytest.raises(ValueError, match="nesterov"):
        topt.fused_sgd(lr=0.1, nesterov=True)
    with pytest.raises(ValueError, match="betas"):
        topt.fused_adamw(lr=0.1, betas=(1.0, 0.9))


def test_cpu_update_launches_no_kernel():
    opt = topt.fused_adamw(lr=1e-3)
    p = torch.ones(16)
    st = opt.init(p)
    opt.update(torch.ones(16), st, p)
    assert topt.fused_update_launches == 0


@pytest.mark.parametrize("name,args", [
    ("constant", (0.1,)),
    ("warmup_linear", (0.1, 3, 10)),
    ("warmup_linear", (0.1, 0, 7, 0.01)),
    ("warmup_cosine", (0.1, 3, 10)),
    ("warmup_cosine", (0.1, 2, 9, 0.02)),
    ("multistep", (0.1, (2, 5), 0.5)),
    ("multistep", (0.1, ())),
])
def test_schedules_match_jax(name, args):
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in range(0, 14):
        got, want = tf(step), float(jf(jnp.asarray(step, jnp.int32)))
        assert isinstance(got, np.float32)
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-9,
                                   err_msg=f"{name} step {step}")


def test_schedule_from_config():
    from dear_pytorch_tpu_torch.config import DearConfig

    assert tsched.from_config(DearConfig(lr=0.3)) == 0.3
    f = tsched.from_config(DearConfig(lr=0.3, lr_schedule="cosine",
                                      warmup_steps=2, total_steps=8))
    assert float(f(1)) == pytest.approx(0.15)
    with pytest.raises(ValueError, match="total_steps"):
        tsched.from_config(DearConfig(lr_schedule="linear"))
    with pytest.raises(ValueError, match="lr_milestones"):
        tsched.from_config(DearConfig(lr_schedule="multistep"))
    with pytest.raises(ValueError, match="must exceed"):
        tsched.warmup_cosine(0.1, 5, 5)
