"""LAMB with exact shard trust ratios, the ``torch.optim`` adapter and
activation recomputation in the port (dear_pytorch_tpu_torch.ops.fused_sgd
``fused_lamb`` / ``from_torch_optim``, ``build_train_step(remat="full")``,
``GptConfig.remat`` and ``checkpointed_causal_attention_impl``) against
the JAX package's, on the CPU.

- `fused_lamb` on a bucket whose second parameter spans the shard
  boundary: 3 updates at world 1 (the whole padded bucket) and world 2
  (two jax-free ranks, their segment sums all-reduced) against JAX's
  `fused_lamb` with ``lax.psum`` under ``shard_map`` (1e-5); the sharded
  result equals the unsharded one (the trust ratios are exact).
- 3 DeAR steps of the small GPT (tests/test_torch_dear.py's) with LAMB at
  worlds 1 and 2 against JAX's (1e-5; the key bias, whose gradient is
  rounding noise that LAMB's normalisation scales up, held small, as
  tests/test_torch_dear.py does for AdamW), one all-reduce of the segment
  sums per bucket per step at world 2.
- `from_torch_optim(torch.optim.Adam)` against JAX's
  ``from_optax(optax.adam)`` on one shard (1e-6).
- ``remat="full"`` and ``GptConfig.remat`` against JAX's ``remat="full"``
  and ``cfg.remat`` (1e-5), and against the port without remat with
  dropout on: equal, bit for bit (the recompute replays the dropout
  generator); `checkpointed_causal_attention_impl` against JAX's, forward
  and gradients (1e-5), and its refusal of dropout with JAX's message.
- ResNet under ``remat="full"``: the BatchNorm buffers equal the run
  without remat (updated once per microbatch), bit for bit.
- ``remat="full"`` under ``dear-fused`` with ring projections at world 2:
  equal to the run without remat, K6 issued once more per projection.
"""

import dataclasses
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dear_pytorch_tpu.comm import collectives as jC
from dear_pytorch_tpu.ops import fused_sgd as jopt
from dear_pytorch_tpu.parallel import dear as jdear
from dear_pytorch_tpu_torch.models import gpt as tgpt
from dear_pytorch_tpu_torch.models.convert import gpt_params_from_jax
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from tests import test_torch_dear as TD
from tests import test_torch_dear_resnet as TR

STEPS, TOL = TD.STEPS, TD.TOL
#: a bucket of four parameters and one padding element (34); at world 2
#: its shard is 17 elements, so the second parameter ([7, 20)) spans the
#: boundary
LAMB_SIZES = (7, 13, 5, 8)
LAMB_WORLD = 2


def _lamb_inputs():
    """The bucket's parameters, 3 steps of gradients and the segment ids
    (the padding in the dummy last segment, zero, as the train step's)."""
    rng = np.random.default_rng(8)
    n = sum(LAMB_SIZES) + 1
    param = rng.normal(size=n).astype(np.float32)
    grads = rng.normal(size=(STEPS, n)).astype(np.float32)
    param[-1] = grads[:, -1] = 0.0
    offsets = np.cumsum((0,) + LAMB_SIZES[:-1])
    seg = np.searchsorted(offsets, np.arange(n), side="right") - 1
    seg[-1] = len(LAMB_SIZES)
    return param, grads, seg.astype(np.int32)


def _jax_lamb(world):
    """JAX's `fused_lamb` over the bucket's ``world`` shards, its segment
    sums completed by ``lax.psum``: the updated shards, stacked."""
    param, grads, seg = _lamb_inputs()
    shard = param.shape[0] // world
    opt = jopt.fused_lamb(lr=0.01)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("dp",))

    def fn(p, g, s):
        state = opt.init(p)
        for i in range(STEPS):
            p, state = opt.update(g[i], state, p, s, len(LAMB_SIZES) + 1,
                                  lambda x: jax.lax.psum(x, "dp"))
        return p

    def stack(a):
        return jnp.asarray(a.reshape(world, shard))

    g = jnp.asarray(grads.reshape(STEPS, world, shard).transpose(1, 0, 2))
    return np.asarray(jC.spmd_call(fn, stack(param), g, stack(seg),
                                   mesh=mesh))


# the port's sides; the world-2 worker runs their source in a jax-free
# process, so they import what they need themselves
def run_lamb(group, rank, world, param, grads, seg, sizes):
    import torch
    from dear_pytorch_tpu_torch.comm import collectives as C
    from dear_pytorch_tpu_torch.ops import fused_sgd as topt

    shard = param.shape[0] // world
    sl = slice(rank * shard, (rank + 1) * shard)
    p = torch.from_numpy(param[sl].copy())
    s = torch.from_numpy(seg[sl].copy())
    opt = topt.fused_lamb(lr=0.01)
    state = opt.init(p)
    calls = []

    def psum(x):
        calls.append(x.shape)
        return C.all_reduce(x, group) if world > 1 else x

    for i in range(grads.shape[0]):
        opt.update(torch.from_numpy(grads[i, sl].copy()), state, p, s,
                   len(sizes) + 1, psum)
    assert state["t"] == grads.shape[0]
    assert calls == [(2, len(sizes) + 1)] * grads.shape[0]
    return p.numpy()


def run_gpt(opts, group, rank, world, state_dict, ids, cfg):
    """3 steps of the small GPT with ``opts``: ``mode``, ``lamb``,
    ``remat`` (the step's), ``cfg_remat`` (the model's), ``dropout``
    (rates 0.1 and a seeded generator), ``ring_proj``."""
    import dataclasses

    import torch
    from dear_pytorch_tpu_torch.models import gpt as tgpt
    from dear_pytorch_tpu_torch.ops import collective_matmul as tcm
    from dear_pytorch_tpu_torch.ops import fused_sgd as topt
    from dear_pytorch_tpu_torch.parallel import dear as tdear

    if opts.get("dropout"):
        cfg = dataclasses.replace(cfg, hidden_dropout_prob=0.1,
                                  embd_dropout_prob=0.1,
                                  attention_probs_dropout_prob=0.1)
    cfg = dataclasses.replace(cfg, remat=bool(opts.get("cfg_remat")))
    model = tgpt.GptLmHeadModel(
        cfg, device="cpu", projection_impl=tcm.make_ring_projection_impl()
        if opts.get("ring_proj") else None)
    model.load_state_dict(state_dict)

    def loss_fn(m, batch, generator=None):
        logits = m(batch["input_ids"], train=True, generator=generator)
        return tgpt.gpt_lm_loss(logits, batch["input_ids"],
                                vocab_size=cfg.vocab_size)

    opt = (topt.fused_lamb(lr=0.01) if opts.get("lamb")
           else topt.fused_sgd(lr=0.05, momentum=0.9))
    ts = tdear.build_train_step(
        loss_fn, model, optimizer=opt, group=group, device="cpu",
        mode=opts.get("mode", "dear"), threshold_mb=0.02,
        remat=opts.get("remat"),
        rng_seed=7 if opts.get("dropout") else None)
    per = ids.shape[0] // world
    batch = {"input_ids": torch.from_numpy(ids[rank * per:(rank + 1) * per])}
    state = ts.init()
    losses = []
    for _ in range(3):
        state, m = ts.step(state, batch)
        losses.append(float(m["loss"]))
    final = {k: v.numpy() for k, v in ts.gather_params(state).items()}
    counts = [ts.plan.num_buckets, ts.rs_launches, ts.ag_launches,
              ts.ar_launches, ts.update_launches, ts.cm_calls]
    ts.close()
    return losses, final, counts


_WORKER = '''
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.models import gpt as tgpt
{run_lamb}
{run_gpt}
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store")
group = backend.init("cpu")
inputs = np.load(out + "/inputs.npz")
np.save(f"{{out}}/lamb.rank{{rank}}.npy", run_lamb(
    group, rank, world, inputs["param"], inputs["grads"], inputs["seg"],
    json.loads(open(out + "/sizes.json").read())))
state_dict = {{k[3:]: torch.from_numpy(inputs[k]) for k in inputs.files
               if k.startswith("sd.")}}
cfg = tgpt.GptConfig(**json.loads(open(out + "/cfg.json").read()))
for name, opts in sorted(json.loads(open(out + "/cases.json").read()).items()):
    losses, final, counts = run_gpt(opts, group, rank, world, state_dict,
                                    inputs["ids"], cfg)
    np.savez(f"{{out}}/{{name}}.rank{{rank}}.npz", losses=np.array(losses),
             counts=np.array(counts),
             **{{"p." + k: v for k, v in final.items()}})
backend.shutdown()
'''

#: the GPT runs at world 2
WORLD2_CASES = {
    "lamb": {"lamb": True},
    "fused_ring_proj": {"mode": "dear-fused", "ring_proj": True},
    "fused_ring_proj_remat": {"mode": "dear-fused", "ring_proj": True,
                              "remat": "full"},
    "fused_ring_proj_cfg_remat": {"mode": "dear-fused", "ring_proj": True,
                                  "cfg_remat": True},
}
#: the GPT runs at world 1 (in this process)
WORLD1_CASES = {
    "lamb": {"lamb": True},
    "plain": {},
    "remat": {"remat": "full"},
    "cfg_remat": {"cfg_remat": True},
    "dropout": {"dropout": True},
    "dropout_remat": {"dropout": True, "remat": "full"},
    "dropout_cfg_remat": {"dropout": True, "cfg_remat": True},
}


@pytest.fixture(scope="module")
def jax_params():
    return TD._init_params()


@pytest.fixture(scope="module")
def state_dict(jax_params):
    return gpt_params_from_jax(jax.tree.map(np.asarray, jax_params),
                               TD._torch_config())


@pytest.fixture(scope="module")
def world1(state_dict):
    from dear_pytorch_tpu_torch.comm import backend

    group = backend.init("cpu")
    return {name: run_gpt(opts, group, 0, 1, state_dict, TD._ids(),
                          TD._torch_config())
            for name, opts in WORLD1_CASES.items()}


@pytest.fixture(scope="module")
def world2(tmp_path_factory, state_dict):
    out = str(tmp_path_factory.mktemp("remat_lamb_world2"))
    param, grads, seg = _lamb_inputs()
    np.savez(os.path.join(out, "inputs.npz"), param=param, grads=grads,
             seg=seg, ids=TD._ids(),
             **{"sd." + k: v.numpy() for k, v in state_dict.items()})
    cfg = dataclasses.asdict(TD._torch_config())
    cfg = {k: v for k, v in cfg.items() if k not in ("dtype",
                                                     "kv_cache_dtype")}
    for fname, obj in (("cfg.json", cfg), ("sizes.json", list(LAMB_SIZES)),
                       ("cases.json", WORLD2_CASES)):
        with open(os.path.join(out, fname), "w") as f:
            json.dump(obj, f)
    TD.spawn_ranks(_WORKER.format(root=TD.ROOT,
                                  run_lamb=inspect.getsource(run_lamb),
                                  run_gpt=inspect.getsource(run_gpt)),
                   LAMB_WORLD, out)
    return out


def _rank0(out, case):
    ranks = [np.load(os.path.join(out, f"{case}.rank{r}.npz"))
             for r in range(LAMB_WORLD)]
    for r in ranks:
        for key in r.files:
            np.testing.assert_array_equal(r[key], ranks[0][key], key)
    r0 = ranks[0]
    return (list(r0["losses"]),
            {k[2:]: r0[k] for k in r0.files if k.startswith("p.")},
            [int(c) for c in r0["counts"]])


# ---------------------------------------------------------------------------
# LAMB
# ---------------------------------------------------------------------------


def test_fused_lamb_on_shards_matches_jax(world2):
    param, grads, seg = _lamb_inputs()
    n = param.shape[0]
    assert seg[n // 2 - 1] == seg[n // 2] == 1   # leaf 1 spans the boundary
    whole = run_lamb(None, 0, 1, param, grads, seg, LAMB_SIZES)
    np.testing.assert_allclose(whole, _jax_lamb(1)[0], rtol=TOL, atol=TOL)
    shards = np.concatenate([
        np.load(os.path.join(world2, f"lamb.rank{r}.npy"))
        for r in range(LAMB_WORLD)])
    np.testing.assert_allclose(shards, _jax_lamb(LAMB_WORLD).reshape(-1),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(shards, whole, rtol=1e-6, atol=1e-7)
    assert np.abs(whole - param).max() > 100 * TOL


def _run_jax(world, params, *, lamb=False, remat=None, cfg_remat=False):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("dp",))
    model = TD.jgpt.GptLmHeadModel(
        dataclasses.replace(TD._jax_config(), remat=cfg_remat))

    def loss_fn(p, batch):
        logits = model.apply({"params": p}, batch["input_ids"], train=True)
        return TD.jgpt.gpt_lm_loss(logits, batch["input_ids"],
                                   vocab_size=TD.VOCAB)

    opt = (jopt.fused_lamb(lr=0.01) if lamb
           else jopt.fused_sgd(lr=0.05, momentum=0.9))
    ts = jdear.build_train_step(loss_fn, params, optimizer=opt, mesh=mesh,
                                threshold_mb=TD.THRESHOLD_MB, remat=remat)
    state = ts.init(jax.tree.map(jnp.copy, params))
    losses = []
    for _ in range(STEPS):
        state, m = ts.step(state, {"input_ids": jnp.asarray(TD._ids())})
        losses.append(float(m["loss"]))
    final = gpt_params_from_jax(
        jax.tree.map(np.asarray, ts.gather_params(state)),
        TD._torch_config())
    return losses, {k: v.numpy() for k, v in final.items()}


def _compare(got, want, init, *, noise_bias=False):
    losses, final = got[:2]
    jlosses, jfinal = want
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
    assert losses[-1] < losses[0]
    assert sorted(final) == sorted(jfinal)
    for name, p in final.items():
        if noise_bias and name.endswith(".key.bias"):
            # no gradient in exact arithmetic: both packages' are rounding
            # noise, which LAMB's normalisation scales up; held small
            assert np.abs(p).max() < 1e-3 and np.abs(jfinal[name]).max() < 1e-3
            continue
        np.testing.assert_allclose(p, jfinal[name], rtol=TOL, atol=TOL,
                                   err_msg=name)
    moved = max(float(np.abs(p - init[k].numpy()).max())
                for k, p in final.items())
    assert moved > 100 * TOL


@pytest.mark.parametrize("world", [1, 2])
def test_dear_steps_with_lamb_match_jax(world, world1, world2, jax_params,
                                        state_dict):
    got = (world1["lamb"] if world == 1 else _rank0(world2, "lamb"))
    _compare(got, _run_jax(world, jax_params, lamb=True), state_dict,
             noise_bias=True)
    n_buckets, rs, ag, ar, upd, _ = got[2]
    assert n_buckets >= 3 and rs == upd == STEPS * n_buckets
    # the two segment sums in one all-reduce per bucket (none at world 1)
    assert ar == (STEPS * n_buckets if world > 1 else 0)


def test_from_torch_optim_matches_from_optax():
    rng = np.random.default_rng(9)
    param = rng.normal(size=37).astype(np.float32)
    grads = rng.normal(size=(STEPS, 37)).astype(np.float32)
    jo = jopt.from_optax(optax.adam(0.01))
    jp, js = jnp.asarray(param), jo.init(jnp.asarray(param))
    to = topt.from_torch_optim(torch.optim.Adam, lr=0.01)
    tp = torch.from_numpy(param.copy())
    ts = to.init(tp)
    for g in grads:
        jp, js = jo.update(jnp.asarray(g), js, jp)
        # the shard update divides the reduced sum by mean_world
        to.update(torch.from_numpy(2 * g), ts, tp, mean_world=2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    assert np.abs(tp.numpy() - param).max() > 1e-2
    with pytest.raises(ValueError, match="another shard"):
        to.update(torch.zeros(37), ts, tp.clone())
    with pytest.raises(NotImplementedError, match="from_torch_optim"):
        topt.from_optax(optax.adam(0.01))


@pytest.mark.parametrize("span", ["bucket", "shards"])
def test_lamb_segment_ids_are_the_plans(span):
    """The segment ids the layerwise update makes on every step (a
    searchsorted over the parameters' starts) are `FusionPlan.segment_ids`
    (the JAX plan's, tests/test_torch_fusion.py), over whole buckets and
    over every rank's slice of a 3-way split with its padding."""
    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.parallel import dear as tdear

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Linear(7, 3),
                                torch.nn.Linear(3, 2))
    model.device = torch.device("cpu")
    ts = tdear.build_train_step(
        lambda m, b: m(b).square().mean(), model,
        optimizer=topt.fused_lamb(lr=0.01), group=backend.init("cpu"),
        device="cpu", threshold_mb=1e-4)
    try:
        assert max(len(b.leaf_ids) for b in ts.plan.buckets) >= 2
        for b in ts.plan.buckets:
            want = ts.plan.segment_ids(b.index)
            if span == "bucket":
                cuts = [0, b.padded_size]
                seg, nseg, psum = ts._segments(b.index)
                assert nseg == len(b.leaf_ids) + 1
                np.testing.assert_array_equal(seg.numpy(), want)
                assert psum(seg) is seg
                assert ts._segment_lengths(b.index) == np.bincount(
                    want, minlength=nseg).tolist()
            else:
                cuts = [b.padded_size * r // 3 for r in range(4)]
            for lo, hi in zip(cuts[:-1], cuts[1:]):
                got = ts._segment_ids(b.index, lo, hi)
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got.numpy(), want[lo:hi])
    finally:
        ts.close()


@pytest.mark.parametrize("scale", [1e-6, 1e-8])
def test_lamb_segment_sums_keep_a_small_parameter_after_a_large_one(scale):
    """A bucket of a 2^20-element weight (0.02), a small bias (``scale``,
    as early in training) and a zero one (a key bias: its gradient is
    zero): every segment's sum within 1e-6 of its exact fp64 sum (the zero
    one exactly 0), with and without the host's segment lengths, and
    LAMB's trust ratios on two shards (the biases in the second, the
    segment sums added as the all-reduce would) equal the whole bucket's.
    Differences of one running sum lost the small bias to the weight's
    prefix (relative errors of 5.6e-3 at 1e-6, ~1 at 1e-8), and on the
    card read the zero one as +-1e-13."""
    rng = np.random.default_rng(0)
    n_w, n_b = 2**20, 1024
    w = torch.from_numpy((rng.standard_normal(n_w) * 0.02).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(n_b) * scale)
                         .astype(np.float32))
    x = torch.cat([w, b, torch.zeros(n_b + 4)])   # a zero bias, the padding
    seg = torch.cat([torch.zeros(n_w, dtype=torch.int32),
                     torch.ones(n_b, dtype=torch.int32),
                     torch.full((n_b,), 2, dtype=torch.int32),
                     torch.full((4,), 3, dtype=torch.int32)])
    sq = x * x
    sqn = sq.double().numpy()
    want = np.array([sqn[:n_w].sum(), sqn[n_w:n_w + n_b].sum(), 0.0, 0.0])
    for pieces in (None, topt.segment_pieces([n_w, n_b, n_b, 4], "cpu")):
        got = topt._segment_sums(sq, seg, 4, pieces).double().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the trust ratios: the whole bucket against two shards, the second
    # holding the bias and the weight's tail; rank 0's psum records its
    # sums, rank 1's adds them (the all-reduce)
    grad = torch.from_numpy(rng.standard_normal(x.numel())
                            .astype(np.float32)) * 1e-3
    grad[-4:] = 0.0
    lamb = topt.fused_lamb(lr=0.01)
    full = lamb.init(x.clone())
    grad[n_w + n_b:] = 0.0    # the zero bias stays zero: trust 1
    lamb.update(grad, full, x.clone(), seg, 4, lambda v: v)
    cut, rank0 = n_w - 100, {}
    lamb.update(grad[:cut], lamb.init(x[:cut].clone()), x[:cut].clone(),
                seg[:cut], 4, lambda v: rank0.setdefault("sums", v))
    st1 = lamb.init(x[cut:].clone())
    lamb.update(grad[cut:], st1, x[cut:].clone(), seg[cut:], 4,
                lambda v: rank0["sums"] + v)
    assert float(full["trust"][2]) == 1.0
    np.testing.assert_allclose(st1["trust"].numpy(), full["trust"].numpy(),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,jax_kw", [
    ("remat", {"remat": "full"}), ("cfg_remat", {"cfg_remat": True})])
def test_remat_matches_jax(case, jax_kw, world1, jax_params, state_dict):
    _compare(world1[case], _run_jax(1, jax_params, **jax_kw), state_dict)


@pytest.mark.parametrize("case", ["remat", "cfg_remat", "dropout_remat",
                                  "dropout_cfg_remat"])
def test_remat_equals_the_run_without(case, world1):
    """The recompute rebuilds the forward's saved tensors bit for bit, the
    dropout masks included (the generator is replayed), so the gradients,
    losses and parameters are the run's without remat."""
    base = world1["dropout" if case.startswith("dropout") else "plain"]
    got = world1[case]
    assert got[0] == base[0]
    for name, p in got[1].items():
        np.testing.assert_array_equal(p, base[1][name], err_msg=name)
    assert got[2] == base[2]
    if case.startswith("dropout"):   # dropout was on
        assert got[0] != world1["plain"][0]


def test_checkpointed_attention_matches_jax():
    rng = np.random.default_rng(10)
    q, k, v = (rng.normal(size=(2, 8, 2, 4)).astype(np.float32)
               for _ in range(3))
    dy = rng.normal(size=(2, 8, 2, 4)).astype(np.float32)
    jimpl = TD.jgpt.checkpointed_causal_attention_impl()

    def jloss(q_, k_, v_):
        return jnp.sum(jimpl(q_, k_, v_, None) * dy)

    jout = np.asarray(jimpl(*(jnp.asarray(a) for a in (q, k, v)), None))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    timpl = tgpt.checkpointed_causal_attention_impl()
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    out = timpl(*ts, None)
    (out * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=TOL, atol=TOL)
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=TOL,
                                   atol=TOL)
    with pytest.raises(ValueError) as port_err:
        timpl(*ts, None, dropout_rate=0.1, generator=torch.Generator())
    with pytest.raises(ValueError) as jax_err:
        jimpl(*(jnp.asarray(a) for a in (q, k, v)), None, dropout_rate=0.1,
              dropout_rng=jax.random.PRNGKey(0))
    assert str(port_err.value) == str(jax_err.value)


def test_resnet_remat_updates_bn_once():
    """A recomputed ResNet forward would update BatchNorm's running
    statistics a second time; under ``remat="full"`` the buffers (and the
    parameters) after 3 steps equal the run's without remat. The port's
    own init, every BN's scale and bias redrawn from a seed (no branch
    switched off by a zero last-BN scale)."""
    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.models import resnet as tres
    from dear_pytorch_tpu_torch.models.data import softmax_xent
    from dear_pytorch_tpu_torch.parallel import dear as tdear

    group = backend.init("cpu")
    x, y = TR._batch()
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}
    runs, rn_sd = {}, None
    for remat in (None, "full"):
        model = tres.ResNet(TR.CFG["stages"], tres.BottleneckBlock,
                            num_classes=TR.CFG["classes"],
                            width=TR.CFG["width"], device="cpu", seed=3)
        if rn_sd is None:
            gen = torch.Generator().manual_seed(10)
            rn_sd = {k: v.clone() for k, v in model.state_dict().items()}
            for k, v in rn_sd.items():
                if k.split(".")[-2].startswith("bn") and k.endswith(
                        ("weight", "bias")):
                    v.copy_(torch.rand(v.shape, generator=gen)
                            + (0.5 if k.endswith("weight") else -0.5))
        model.load_state_dict(rn_sd)
        ts = tdear.build_train_step(
            lambda m, b: softmax_xent(m(b["image"]), b["label"]), model,
            optimizer=topt.fused_sgd(lr=0.01, momentum=0.9), group=group,
            device="cpu", threshold_mb=0.02, remat=remat)
        state = ts.init()
        losses = []
        for _ in range(STEPS):
            state, m = ts.step(state, batch)
            losses.append(float(m["loss"]))
        runs[remat] = (losses, {k: v.numpy().copy() for k, v in
                                model.named_buffers()},
                       {k: v.numpy() for k, v in
                        ts.gather_params(state).items()})
        ts.close()
    (l0, b0, p0), (l1, b1, p1) = runs[None], runs["full"]
    assert l1 == l0
    assert sorted(b1) == sorted(b0)
    for name in b0:
        np.testing.assert_array_equal(b1[name], b0[name], err_msg=name)
        if name.endswith("num_batches_tracked"):
            assert int(b1[name]) == STEPS
    for name in p0:
        np.testing.assert_array_equal(p1[name], p0[name], err_msg=name)
    moved = [n for n in b0 if n.endswith("running_mean")
             and np.abs(b0[n]).max() > 0]
    assert moved


@pytest.mark.parametrize("case", ["fused_ring_proj_remat",
                                  "fused_ring_proj_cfg_remat"])
def test_remat_under_dear_fused_ring_projections(case, world2):
    """At world 2 the recompute issues K6 (the ring matmul's forward) again
    inside the backward, in the same order on both ranks: the run equals
    the one without remat, and each microbatch makes one more forward call
    per projection (2 layers x 4 projections x 3 steps)."""
    base = _rank0(world2, "fused_ring_proj")
    got = _rank0(world2, case)
    assert got[0] == base[0]
    for name, p in got[1].items():
        np.testing.assert_array_equal(p, base[1][name], err_msg=name)
    assert base[2][5] == STEPS * 2 * 4 * 3
    assert got[2][5] == STEPS * 2 * 4 * 4
    assert got[2][:5] == base[2][:5]


def test_guards_match_jax():
    """remat's and LAMB's guards, with JAX's messages: ``remat`` must be
    None, ``"none"`` or ``"full"``; ``fsdp`` refuses it; ``dear-fused``
    refuses LAMB. Every other mode builds LAMB and remat."""
    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.parallel import dear as tdear

    group = backend.init("cpu")
    model = tgpt.GptLmHeadModel(TD._torch_config(), device="cpu")
    params = TD._init_params()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    for kw, jkw in (
            (dict(remat="half"), None),
            (dict(mode="fsdp", remat="full"), None),
            (dict(mode="dear-fused", optimizer=topt.fused_lamb(lr=0.1)),
             dict(mode="dear-fused", optimizer=jopt.fused_lamb(lr=0.1)))):
        with pytest.raises(ValueError) as port_err:
            tdear.build_train_step(lambda m, b: m(b).sum(), model,
                                   group=group, device="cpu", **kw)
        with pytest.raises(ValueError) as jax_err:
            jdear.build_train_step(lambda p, b: 0.0, params, mesh=mesh,
                                   **(jkw or kw))
        assert str(port_err.value) == str(jax_err.value)
    for mode in ("dear", "allreduce", "rsag", "rb", "bytescheduler",
                 "fsdp"):
        ts = tdear.build_train_step(
            lambda m, b: m(b).sum(), model, group=group, device="cpu",
            mode=mode, optimizer=topt.fused_lamb(lr=0.1),
            remat=None if mode == "fsdp" else "full")
        assert ts.layerwise
        ts.close()
