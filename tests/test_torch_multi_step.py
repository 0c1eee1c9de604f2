"""The port's `TrainStep.multi_step` (dear_pytorch_tpu_torch.parallel.dear)
and the scanned bench protocol, on the CPU.

  - ``multi_step(4)`` equals four ``step()`` calls bit for bit — final
    state, last metrics and every launch counter — in ``dear``,
    ``allreduce``, ``fsdp`` and ``dear-fused``, with and without dropout
    (the n steps draw the generators of steps ``state.step`` to
    ``state.step + n - 1``);
  - against the JAX package's ``multi_step(4)`` (one ``lax.scan`` program)
    on the MLP of tests/test_dear_numerics.py (same weights and data, made
    from its PRNG keys): rtol 1e-6, atol 1e-7 (fp32 summation order only),
    with SGD-momentum and with AdamW under a cosine schedule;
  - ``dear.multi_step_compiles`` counts once per n;
  - ``--scan-steps 2`` through the GPT and ImageNet CLIs (the JAX runner's
    protocol: calls of k steps, times per step; the refused combinations
    with JAX's messages).
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dear_pytorch_tpu.ops import fused_sgd as jopt
from dear_pytorch_tpu.ops import schedules as jsched
from dear_pytorch_tpu.parallel import dear as jdear
from dear_pytorch_tpu_torch.benchmarks import runner
from dear_pytorch_tpu_torch.models import gpt as tgpt
from dear_pytorch_tpu_torch.observability import tracer as T
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.ops import schedules as tsched
from dear_pytorch_tpu_torch.parallel import dear as tdear

from tests.test_dear_numerics import _data, _loss_fn, _mlp_params

RTOL, ATOL = 1e-6, 1e-7
COUNTERS = ("rs_launches", "ag_launches", "ar_launches", "reduce_launches",
            "bcast_launches", "comp_launches", "update_launches", "cm_calls",
            "state_syncs")


@pytest.fixture(scope="module")
def group():
    from dear_pytorch_tpu_torch.comm import backend

    return backend.init("cpu")


# ---------------------------------------------------------------------------
# the models (shared with tests/test_torch_tuning.py)
# ---------------------------------------------------------------------------


class TorchMLP(nn.Module):
    """The MLP of tests/test_dear_numerics.py (tanh 12 -> 32 -> 16 -> 4)
    with the JAX parameters' values (``kernel`` transposed)."""

    def __init__(self, params):
        super().__init__()
        for name, (i, o) in (("dense1", (12, 32)), ("dense2", (32, 16)),
                             ("out", (16, 4))):
            lin = nn.Linear(i, o)
            with torch.no_grad():
                lin.weight.copy_(torch.from_numpy(
                    np.asarray(params[name]["kernel"]).T.copy()))
                lin.bias.copy_(torch.from_numpy(
                    np.array(params[name]["bias"])))
            setattr(self, name, lin)

    @property
    def device(self):
        return self.dense1.weight.device

    def forward(self, x):
        h = torch.tanh(self.dense1(x))
        h = torch.tanh(self.dense2(h))
        return self.out(h)


def mlp_loss(m, batch):
    x, y = batch["x"], batch["y"]
    logp = torch.log_softmax(m(x), dim=-1)
    return -logp.gather(1, y[:, None]).squeeze(1).mean()


def mlp_problem(n_batches=1):
    """JAX's MLP parameters and ``n_batches`` data batches (keys 50, ...)
    as numpy."""
    params = jax.tree.map(np.asarray, _mlp_params(jax.random.PRNGKey(0)))
    batches = [tuple(np.asarray(t) for t in _data(jax.random.PRNGKey(50 + i)))
               for i in range(n_batches)]
    return params, batches


def torch_batch(b):
    return {"x": torch.from_numpy(np.array(b[0])),
            "y": torch.from_numpy(np.array(b[1])).long()}


def gpt_config(dropout: float = 0.0, layers: int = 2):
    return tgpt.GptConfig(
        vocab_size=61, hidden_size=32, num_hidden_layers=layers,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=32, embd_dropout_prob=dropout,
        hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout,
        dtype=torch.float32)


def gpt_model(dropout: float = 0.0, layers: int = 2):
    return tgpt.GptLmHeadModel(gpt_config(dropout, layers), device="cpu",
                               seed=0)


def gpt_loss(m, batch, generator=None):
    logits = m(batch["input_ids"], train=True, generator=generator)
    return tgpt.gpt_lm_loss(logits, batch["input_ids"], vocab_size=61)


def gpt_batch(seed=5, B=4, S=16):
    return {"input_ids": torch.from_numpy(
        np.random.RandomState(seed).randint(0, 61, (B, S)))}


def masters(ts, state) -> dict:
    return {k: v.clone() for k, v in ts.gather_params(state).items()}


# ---------------------------------------------------------------------------
# multi_step(n) == n step() calls, bit for bit
# ---------------------------------------------------------------------------


def _run(mode, dropout, group, scanned):
    model = gpt_model(dropout)
    ts = tdear.build_train_step(
        gpt_loss, model, group=group, device="cpu", mode=mode,
        threshold_mb=0.02, optimizer=topt.fused_sgd(lr=0.05, momentum=0.9),
        rng_seed=3 if dropout else None)
    state = ts.init()
    batch = gpt_batch()
    if scanned:
        state, m = ts.multi_step(4)(state, batch)
    else:
        for _ in range(4):
            state, m = ts.step(state, batch)
    out = (state.step, float(m["loss"]), masters(ts, state),
           [opt["buf"].clone() for opt in state.opt_state],
           {c: getattr(ts, c) for c in COUNTERS}, ts.plan.num_buckets)
    ts.close()
    return out


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["plain", "dropout"])
@pytest.mark.parametrize("mode", ["dear", "allreduce", "fsdp", "dear-fused"])
def test_multi_step_equals_steps_bitwise(mode, dropout, group):
    seq = _run(mode, dropout, group, scanned=False)
    scan = _run(mode, dropout, group, scanned=True)
    assert seq[0] == scan[0] == 4
    assert seq[1] == scan[1]                         # the last loss
    assert sorted(seq[2]) == sorted(scan[2])
    for name in seq[2]:
        assert torch.equal(seq[2][name], scan[2][name]), name
    for a, b in zip(seq[3], scan[3]):
        assert torch.equal(a, b)                     # momentum buffers
    assert seq[4] == scan[4]                         # every launch counter
    assert seq[4]["update_launches"] == 4 * seq[5]


def test_multi_step_draws_each_steps_generator(group):
    """With dropout the four steps of one call differ from each other (a
    fresh generator per step), and the next call continues the sequence:
    two calls of 2 equal one call of 4."""
    def run(calls):
        model = gpt_model(0.1)
        ts = tdear.build_train_step(
            gpt_loss, model, group=group, device="cpu", threshold_mb=0.02,
            rng_seed=3)
        state = ts.init()
        for n in calls:
            state, m = ts.multi_step(n)(state, gpt_batch())
        out = masters(ts, state), float(m["loss"])
        ts.close()
        return out

    a, la = run([2, 2])
    b, lb = run([4])
    assert la == lb
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_multi_step_counts_one_compile_per_n(group):
    old = T.get_tracer()
    live = T.Tracer([T.MemoryExporter()])
    T.set_tracer(live)
    try:
        ts = tdear.build_train_step(mlp_loss, TorchMLP(mlp_problem()[0]),
                                    group=group, device="cpu")
        state = ts.init()
        b = torch_batch(mlp_problem()[1][0])
        for n in (2, 2, 3):
            state, _ = ts.multi_step(n)(state, b)
        c = live.counters()
        assert c["dear.multi_step_compiles"] == 2
        assert c["dear.steps"] == 7 and c["dear.plan_builds"] == 1
        spans = [s for s in live._exporters[0].spans if s.name == "dear.step"]
        assert len(spans) == 7
        ts.close()
    finally:
        T.set_tracer(old)


# ---------------------------------------------------------------------------
# against the JAX package's multi_step
# ---------------------------------------------------------------------------


def _jax_multi_step(opt, params, batch, n=4):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    ts = jdear.build_train_step(_loss_fn, jax.tree.map(jnp.asarray, params),
                                mesh=mesh, optimizer=opt,
                                threshold_mb=0.0008, donate=False)
    state = ts.init(jax.tree.map(jnp.asarray, params))
    state, m = ts.multi_step(n)(state, tuple(jnp.asarray(t) for t in batch))
    full = jax.tree.map(np.asarray, ts.gather_params(state))
    return float(m["loss"]), full


def _port_multi_step(opt, params, batch, group, n=4):
    ts = tdear.build_train_step(mlp_loss, TorchMLP(params), group=group,
                                device="cpu", optimizer=opt,
                                threshold_mb=0.0008)
    state, m = ts.multi_step(n)(ts.init(), torch_batch(batch))
    out = float(m["loss"]), masters(ts, state), ts.plan.num_buckets
    ts.close()
    return out


def _compare_mlp(port, jax_out):
    loss, final, nb = port
    jloss, jfull = jax_out
    assert nb == 3                           # one bucket per layer
    np.testing.assert_allclose(loss, jloss, rtol=RTOL, atol=ATOL)
    for layer in ("dense1", "dense2", "out"):
        np.testing.assert_allclose(
            final[f"{layer}.weight"].numpy(), jfull[layer]["kernel"].T,
            rtol=RTOL, atol=ATOL, err_msg=layer)
        np.testing.assert_allclose(
            final[f"{layer}.bias"].numpy(), jfull[layer]["bias"],
            rtol=RTOL, atol=ATOL, err_msg=layer)


def test_multi_step_matches_jax_sgd_momentum(group):
    params, (batch,) = mlp_problem()
    _compare_mlp(
        _port_multi_step(topt.fused_sgd(lr=0.05, momentum=0.9), params,
                         batch, group),
        _jax_multi_step(jopt.fused_sgd(lr=0.05, momentum=0.9), params,
                        batch))


def test_multi_step_matches_jax_adamw_cosine(group):
    params, (batch,) = mlp_problem()
    _compare_mlp(
        _port_multi_step(topt.fused_adamw(
            lr=tsched.warmup_cosine(1e-2, 1, 4), weight_decay=0.01),
            params, batch, group),
        _jax_multi_step(jopt.fused_adamw(
            lr=jsched.warmup_cosine(1e-2, 1, 4), weight_decay=0.01),
            params, batch))


# ---------------------------------------------------------------------------
# the scanned protocol through the CLIs
# ---------------------------------------------------------------------------


def test_scan_steps_validation_and_step_source():
    ns = argparse.Namespace
    assert runner.validate_scan_steps(ns(scan_steps=1, autotune=None)) == 1
    assert runner.validate_scan_steps(ns(scan_steps=3, autotune=None)) == 3
    with pytest.raises(SystemExit, match="--autotune are incompatible"):
        runner.validate_scan_steps(ns(scan_steps=2, autotune="bo"))
    with pytest.raises(SystemExit, match="--pipeline"):
        runner.validate_scan_steps(ns(scan_steps=2, autotune=None,
                                      pipeline="synthetic"))
    assert runner._ceil_div_keep_zero(0, 4) == 0
    assert runner._ceil_div_keep_zero(5, 4) == 2

    class Stub:
        def multi_step(self, n):
            return lambda s, b: (s + n, {"loss": b})

    holder = {"state": 0, "batch": 7}
    args = ns(batch_size=3, num_warmup_batches=5, num_batches_per_iter=10,
              num_iters=2)
    fn, kw = runner.make_step_source(args, 4, Stub(), None, holder, None)
    fn()
    assert holder["state"] == 4 and holder["metrics"] == {"loss": 7}
    assert kw == dict(batch_size=12, num_warmup_batches=2,
                      num_batches_per_iter=3, num_iters=2, steps_per_call=4)


def test_gpt_cli_scan_steps(capsys):
    from dear_pytorch_tpu_torch.benchmarks import gpt

    res = gpt.main(["--device", "cpu", "--num-hidden-layers", "1",
                    "--batch-size", "2", "--sequence-len", "16",
                    "--num-warmup-batches", "2", "--num-batches-per-iter",
                    "4", "--num-iters", "1", "--scan-steps", "2"])
    out = capsys.readouterr().out
    assert "Scanned protocol: 2 steps per dispatch" in out
    ts = res.train_step
    # 1 warmup call and 2 timed calls of 2 steps, every one on the batch
    assert len(res.losses) == 3 and res.state.step == 6
    assert ts.update_launches == 6 * ts.plan.num_buckets
    assert len(res.iter_times) == 1
    ts.close()
    with pytest.raises(SystemExit, match="incompatible"):
        gpt.main(["--device", "cpu", "--scan-steps", "2", "--autotune",
                  "bo"])


def test_imagenet_cli_scan_steps():
    from dear_pytorch_tpu_torch.benchmarks import imagenet

    res = imagenet.main(["--device", "cpu", "--model", "mnistnet",
                         "--batch-size", "2", "--num-warmup-batches", "0",
                         "--num-batches-per-iter", "2", "--num-iters", "2",
                         "--scan-steps", "2"])
    ts = res.train_step
    assert res.state.step == 4 and len(res.losses) == 2
    assert ts.update_launches == 4 * ts.plan.num_buckets
    assert all(np.isfinite(res.losses))
    ts.close()
