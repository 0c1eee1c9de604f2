"""The port's tuning (dear_pytorch_tpu_torch.tuning) against the JAX
package's, on the CPU.

  - the BO optimizer's suggestions and the step-driven `Tuner`'s proposals
    under one fake clock, `wait_time_flags`, the layer-time estimate,
    MG-WFBP, ASC and MGS-SGD on one layer sequence (numpy seed), and the
    `PlanTuner`'s picks, prunes and retirements for one cost surface: the
    JAX package's decisions, exactly (the same numpy arithmetic);
  - `repack_state` exact per parameter (bitwise, by name) for SGD
    momentum, AdamW, LAMB and eftopk with momentum correction, in the
    sharded and the replicated modes, and the JAX package's
    ``test_repack_preserves_numerics`` procedure at rtol 1e-5;
  - `AutoTuner` bo and wait_time on a tiny GPT: the rebuilt runs' losses
    equal the untuned run's at 1e-5; the plan strategy's sandbox reverts a
    diverging trial and the baseline modes are refused;
  - one spawned world-2 gloo run: ranks with different clocks and tuner
    seeds adopt rank 0's plans, and ``multi_step`` equals the eager steps
    there;
  - ``--autotune bo`` through the GPT and ImageNet CLIs, ``--mgwfbp``
    through the GPT CLI.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.tuning import bo as jbo
from dear_pytorch_tpu.tuning import mgwfbp as jmg
from dear_pytorch_tpu.tuning import planspace as jps
from dear_pytorch_tpu.tuning import sparse_groups as jsg
from dear_pytorch_tpu.tuning import wait_time as jwt
from dear_pytorch_tpu.ops import fused_sgd as jopt
from dear_pytorch_tpu.parallel import dear as jdear
from dear_pytorch_tpu.tuning.autotune import repack_state as jrepack
from dear_pytorch_tpu_torch.ops import compression as Z
from dear_pytorch_tpu_torch.ops import fusion as F
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.parallel import dear as tdear
from dear_pytorch_tpu_torch.tuning import autotune as TA
from dear_pytorch_tpu_torch.tuning import bo as tbo
from dear_pytorch_tpu_torch.tuning import mgwfbp as tmg
from dear_pytorch_tpu_torch.tuning import planspace as tps
from dear_pytorch_tpu_torch.tuning import sparse_groups as tsg
from dear_pytorch_tpu_torch.tuning import wait_time as twt

from tests.test_dear_numerics import _loss_fn
from tests.test_torch_multi_step import (
    TorchMLP,
    gpt_batch,
    gpt_loss,
    gpt_model,
    mlp_loss,
    mlp_problem,
    torch_batch,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def group():
    from dear_pytorch_tpu_torch.comm import backend

    return backend.init("cpu")


# ---------------------------------------------------------------------------
# the decisions, against JAX's
# ---------------------------------------------------------------------------


def test_bayesian_optimizer_suggestions_match_jax():
    f = lambda x: 0.1 + ((x - 70.0) / 100.0) ** 2   # noqa: E731
    ours, theirs = tbo.BayesianOptimizer((1.0, 256.0), seed=3), \
        jbo.BayesianOptimizer((1.0, 256.0), seed=3)
    x = y = 25.0
    for _ in range(10):
        ours.register(x, f(x))
        theirs.register(y, f(y))
        x, y = ours.suggest(), theirs.suggest()
        assert x == y
    assert ours.best == theirs.best


def _drive_bo(mod, seed):
    state = {"t": 0.0, "x": 25.0}
    tuner = mod.Tuner(x=25.0, bound=(1.0, 256.0), max_num_steps=6,
                      interval=5, log=lambda s: None,
                      clock=lambda: state["t"], seed=seed)
    proposals = []
    for _ in range(200):
        if tuner.finished:
            break
        state["t"] += 0.1 + abs(state["x"] - 64.0) / 640.0
        p = tuner.step()
        if p is not None:
            proposals.append(p)
            state["x"] = p
    return proposals, tuner.finished, tuner.budget_steps


@pytest.mark.parametrize("seed", [0, 4])
def test_bo_tuner_proposals_match_jax(seed):
    ours, theirs = _drive_bo(tbo, seed), _drive_bo(jbo, seed)
    assert ours == theirs
    assert ours[1] and len(ours[0]) >= 2


def test_wait_time_flags_and_layer_estimate_match_jax():
    rng = np.random.RandomState(0)
    for n in (1, 9, 40):
        times = list(rng.uniform(1e-4, 4e-3, n))
        prev = list(rng.uniform(1e-4, 4e-3, n))
        for cycle in (1e-3, 5e-3):
            assert twt.wait_time_flags(times, cycle) == \
                jwt.wait_time_flags(times, cycle)
            assert twt.wait_time_flags(times, cycle, ema_prev=prev) == \
                jwt.wait_time_flags(times, cycle, ema_prev=prev)
    # one layer sequence on both sides (JAX sorts keys; these are sorted)
    sizes = rng.randint(1, 5000, 12)
    jparams = {f"l{i:02d}": {"w": np.zeros((int(s),), np.float32)}
               for i, s in enumerate(sizes)}
    tparams = [(f"l{i:02d}.w", (int(s),), torch.float32)
               for i, s in enumerate(sizes)]
    ours = twt.estimate_layer_backward_times(tparams)
    assert ours == jwt.estimate_layer_backward_times(jparams)
    flags = twt.wait_time_flags(ours, 1e-8 * 3000)
    assert F.plan_by_flags(tparams, 4, flags).num_buckets == sum(flags)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mgwfbp_asc_mgs_match_jax(seed):
    rng = np.random.RandomState(seed)
    L = 16
    sizes = list(rng.choice([1e3, 3e4, 2e5, 4e6], L).astype(float))
    times = list(rng.uniform(1e-5, 2e-3, L))
    alpha, beta = 3e-5, 1e-9 * (seed + 1)
    assert tmg.mgwfbp_layer_groups(sizes, times, alpha, beta) == \
        jmg.mgwfbp_layer_groups(sizes, times, alpha, beta)
    assert tsg.asc_layer_groups(sizes, times, alpha, beta) == \
        jsg.asc_layer_groups(sizes, times, alpha, beta)
    elems = [s / 4 for s in sizes]
    for density in (0.01, 0.1):
        assert tsg.mgs_layer_groups(elems, times, alpha, beta, world=4,
                                    density=density) == \
            jsg.mgs_layer_groups(elems, times, alpha, beta, world=4,
                                 density=density)


def test_plan_mgwfbp_on_the_mlp_matches_jax():
    """The MLP's layers in module order are JAX's sorted order too
    (dense1, dense2, out): the plans bucket the same layers."""
    params, _ = mlp_problem()
    model = TorchMLP(params)
    times = twt.estimate_layer_backward_times(model)
    assert times == jwt.estimate_layer_backward_times(params)
    for alpha, beta in ((1e-3, 1e-9), (1e-7, 1e-6)):
        for fn_t, fn_j, kw in ((tmg.plan_mgwfbp, jmg.plan_mgwfbp, {}),
                               (tsg.plan_asc, jsg.plan_asc, {}),
                               (tsg.plan_mgs, jsg.plan_mgs,
                                {"density": 0.1})):
            ours = fn_t(model, 2, layer_times=times, alpha=alpha,
                        beta=beta, **kw)
            theirs = fn_j(params, 2, layer_times=times, alpha=alpha,
                          beta=beta, **kw)

            def layers(plan):
                return [sorted({plan.leaves[i].name.replace("/", ".")
                               .rsplit(".", 1)[0] for i in b.leaf_ids})
                        for b in plan.buckets]

            assert layers(ours) == layers(theirs)
            assert [b.padded_size for b in ours.buckets] == \
                [b.padded_size for b in theirs.buckets]


class _FakeTracer:
    enabled = True

    def __init__(self):
        self.counts: dict = {}

    def count(self, name, value=1):
        self.counts[name] = self.counts.get(name, 0) + value

    def event(self, name, **kw):
        pass


def _drive_plan(mod, space_kw, iter_time_of, tuner_kw, cost=None,
                infeasible=None):
    space = mod.PlanSpace(**space_kw)
    tracer = _FakeTracer()
    clock = {"t": 0.0}
    kw = dict(tuner_kw)
    if cost is not None:
        cm = mod.CostModel(lambda thr: None, alpha=0.0, beta=0.0)
        cm.comm = cost
        kw["cost_model"] = cm
    tuner = mod.PlanTuner(space, log=lambda s: None,
                          clock=lambda: clock["t"], tracer=tracer, **kw)
    if infeasible is not None:
        tuner.mark_infeasible(mod.PlanConfig(**infeasible),
                              revert_to=mod.PlanConfig(), fatal=True,
                              why="build raised ValueError")
    proposals = []
    for _ in range(400):
        if tuner.finished:
            break
        clock["t"] += iter_time_of(tuner.current)
        p = tuner.step()
        if p is not None:
            proposals.append(p.to_dict())
    return proposals, tuner.summary(), tracer.counts


def _fast_bf16(cfg):
    base = 0.02
    if cfg.comm_dtype == "bf16":
        base -= 0.008
    if cfg.compressor == "eftopk":
        base += 0.005
    return base + 1e-5 * cfg.threshold_mb


PLAN_CASES = {
    "finds_fast_arm": (dict(modes=("dear",), compressors=(None, "eftopk"),
                            comm_dtypes=(None, "bf16"), gather_dtypes=(None,),
                            remats=(None,), threshold_bound=(1.0, 64.0)),
                       _fast_bf16, dict(max_trials=8, interval=5, seed=0),
                       None, None),
    "prunes": (dict(modes=("dear",), compressors=(None, "eftopk"),
                    comm_dtypes=(None,), gather_dtypes=(None,),
                    remats=(None,), density=0.9,
                    threshold_bound=(0.0005, 0.02)),
               lambda cfg: 0.01,
               dict(max_trials=6, interval=5, prune_margin=0.25,
                    min_obs_to_prune=1),
               lambda cfg: 10.0 if cfg.compressor else 1e-4, None),
    "retires_fatal": (dict(modes=("dear", "dear-fused"), compressors=(None,),
                           comm_dtypes=(None,), gather_dtypes=(None,),
                           remats=(None,)),
                      lambda cfg: 0.01 + (cfg.mode == "dear") * 0.001,
                      dict(max_trials=6, interval=5), None,
                      dict(mode="dear-fused", threshold_mb=25.0)),
    "full_space": (dict(), _fast_bf16, dict(max_trials=12, interval=4,
                                            seed=3, explore=0.3), None,
                   None),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_tuner_decisions_match_jax(case):
    space_kw, surface, tuner_kw, cost, infeasible = PLAN_CASES[case]
    ours = _drive_plan(tps, space_kw, surface, tuner_kw, cost, infeasible)
    theirs = _drive_plan(jps, space_kw, surface, tuner_kw, cost, infeasible)
    assert ours[0] == theirs[0]          # every proposal, in order
    assert ours[1] == theirs[1]          # trials, best, pruned, dead, ...
    assert ours[2] == theirs[2]          # tune.* counters
    if case == "prunes":
        assert ours[2]["tune.prunes"] == 1 and ours[1]["pruned"]
    if case == "retires_fatal":
        assert ours[1]["dead"] and ours[2]["tune.infeasible"] == 1


def test_plan_space_tokens_and_env(monkeypatch):
    assert tps.dtype_token(torch.bfloat16) == "bf16"
    assert tps.dtype_token(torch.float16) == "f16"
    assert tps.dtype_token(torch.float32) is None
    assert tps.dtype_token("bfloat16") == "bf16"
    with pytest.raises(ValueError):
        tps.dtype_token("int7")
    kw = tps.PlanConfig(comm_dtype="bf16").build_kwargs()
    assert kw["comm_dtype"] is torch.bfloat16 and kw["gather_dtype"] is None
    monkeypatch.setenv("DEAR_TUNE_MODES", "dear")
    monkeypatch.setenv("DEAR_TUNE_COMPRESSORS", "none,eftopk")
    monkeypatch.setenv("DEAR_TUNE_DTYPES", "none")
    monkeypatch.setenv("DEAR_TUNE_REMAT", "none")
    space = tps.PlanSpace.from_env()
    assert [c.to_dict() for c in space.configs()] == \
        [c.to_dict() for c in jps.PlanSpace.from_env().configs()]
    with pytest.raises(ValueError, match="mode axis"):
        tps.PlanSpace(modes=("allreduce",))
    monkeypatch.setenv("DEAR_TUNE_LOG", "/nonexistent/log.jsonl")
    with pytest.raises(NotImplementedError, match="item 12"):
        tps.PlanTuner(space)


# ---------------------------------------------------------------------------
# repack_state: exact per parameter
# ---------------------------------------------------------------------------


REPACK_CASES = {
    "sgd_dear": dict(optimizer=lambda: topt.fused_sgd(lr=0.1, momentum=0.9)),
    "sgd_allreduce": dict(mode="allreduce",
                          optimizer=lambda: topt.fused_sgd(lr=0.1,
                                                           momentum=0.9)),
    "sgd_fsdp": dict(mode="fsdp",
                     optimizer=lambda: topt.fused_sgd(lr=0.1, momentum=0.9)),
    "adamw": dict(optimizer=lambda: topt.fused_adamw(lr=1e-2)),
    "lamb": dict(optimizer=lambda: topt.fused_lamb(lr=1e-2)),
    "eftopk_mc": dict(compressor="eftopk", density=0.25,
                      momentum_correction=0.9,
                      optimizer=lambda: topt.fused_sgd(lr=0.1)),
    "eftopk_allreduce": dict(mode="allreduce", compressor="eftopk",
                             density=0.25,
                             optimizer=lambda: topt.fused_sgd(lr=0.1,
                                                              momentum=0.9)),
}


def _equal_images(a, b):
    assert a["step"] == b["step"]
    assert a["opt_scalars"] == b["opt_scalars"]
    for part in ("params", "opt", "comp"):
        pa, pb = a[part], b[part]
        if part == "params":
            pa, pb = {"": pa}, {"": pb}
        assert sorted(pa) == sorted(pb), part
        for k in pa:
            assert sorted(pa[k]) == sorted(pb[k])
            for name in pa[k]:
                assert torch.equal(pa[k][name], pb[k][name]), (part, k, name)


@pytest.mark.parametrize("case", sorted(REPACK_CASES))
def test_repack_state_is_exact_per_parameter(case, group):
    opts = dict(REPACK_CASES[case])
    make_opt = opts.pop("optimizer")
    params, batches = mlp_problem(4)
    model = TorchMLP(params)
    ts1 = tdear.build_train_step(mlp_loss, model, group=group, device="cpu",
                                 optimizer=make_opt(), nearby_layers=1,
                                 **opts)
    ts2 = tdear.build_train_step(mlp_loss, model, group=group, device="cpu",
                                 optimizer=make_opt(), threshold_mb=None,
                                 **opts)
    assert (ts1.plan.num_buckets, ts2.plan.num_buckets) == (3, 1)
    state = ts1.init()
    for b in batches[:3]:
        state, _ = ts1.step(state, torch_batch(b))
    before = TA.export_state(state, ts1)
    if "eftopk" in case:
        assert any(float(t.abs().sum()) > 0
                   for t in before["comp"]["res"].values())
    if case == "lamb":
        assert before["opt_scalars"]["t"] == 3
    state2 = TA.repack_state(state, ts1, ts2)
    assert not ts1._hooks                      # the old step is closed
    after = TA.export_state(state2, ts2)
    _equal_images(before, after)
    # the model is the new step's: its parameters view ts2's buckets
    w = model.dense1.weight
    assert w.untyped_storage().data_ptr() == \
        ts2._full[0].untyped_storage().data_ptr()
    state2, m = ts2.step(state2, torch_batch(batches[3]))
    assert np.isfinite(float(m["loss"]))
    ts2.close()


def test_repack_refuses_an_optimizer_it_cannot_carry(group):
    params, _ = mlp_problem()
    opt = topt.from_torch_optim(torch.optim.SGD, lr=0.1)
    with pytest.raises(NotImplementedError, match="from_torch_optim"):
        TA.AutoTuner(mlp_loss, TorchMLP(params), group=group, device="cpu",
                     optimizer=opt)


def test_repack_preserves_numerics_like_jax(group):
    """The JAX package's test_repack_preserves_numerics procedure on both
    sides: 3 steps on one bucket, repack to one bucket per layer, 3 more;
    the six losses agree at rtol 1e-5."""
    params, batches = mlp_problem(6)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    jp = jax.tree.map(jax.numpy.asarray, params)
    jts1 = jdear.build_train_step(_loss_fn, jp, mesh=mesh, donate=False,
                                  optimizer=jopt.fused_sgd(0.1, 0.9),
                                  threshold_mb=None)
    jts2 = jdear.build_train_step(_loss_fn, jp, mesh=mesh, donate=False,
                                  optimizer=jopt.fused_sgd(0.1, 0.9),
                                  nearby_layers=1)
    js, jlosses = jts1.init(jp), []
    for i, b in enumerate(batches):
        if i == 3:
            js = jrepack(js, jts1, jts2)
        js, m = (jts1 if i < 3 else jts2).step(js, b)
        jlosses.append(float(m["loss"]))
    model = TorchMLP(params)
    kw = dict(group=group, device="cpu",
              optimizer=topt.fused_sgd(lr=0.1, momentum=0.9))
    ts1 = tdear.build_train_step(mlp_loss, model, threshold_mb=None, **kw)
    ts2 = tdear.build_train_step(mlp_loss, model, nearby_layers=1, **kw)
    s, losses = ts1.init(), []
    for i, b in enumerate(batches):
        if i == 3:
            s = TA.repack_state(s, ts1, ts2)
            assert s.step == 3
        s, m = (ts1 if i < 3 else ts2).step(s, torch_batch(b))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-6)
    ts2.close()


# ---------------------------------------------------------------------------
# AutoTuner on a tiny GPT
# ---------------------------------------------------------------------------


def _counting_clock():
    t = {"t": 0.0}

    def clock():
        t["t"] += 0.01
        return t["t"]

    return clock


def _plain_losses(group, steps, **kw):
    ts = tdear.build_train_step(
        gpt_loss, gpt_model(), group=group, device="cpu",
        optimizer=topt.fused_sgd(lr=0.05, momentum=0.9), **kw)
    s, out = ts.init(), []
    for _ in range(steps):
        s, m = ts.step(s, gpt_batch())
        out.append(float(m["loss"]))
    ts.close()
    return out


def _tuned(group, steps, patch=None, **kw):
    at = TA.AutoTuner(gpt_loss, gpt_model(), group=group, device="cpu",
                      optimizer=topt.fused_sgd(lr=0.05, momentum=0.9), **kw)
    if patch is not None:
        patch(at)
    s, out, buckets = at.init(), [], []
    for _ in range(steps):
        s, m = at.step(s, gpt_batch())
        out.append(float(m["loss"]))
        buckets.append(at.ts.plan.num_buckets)
    at.close()
    return at, out, buckets


def test_autotuner_bo_losses_match_the_untuned_run(group):
    from dear_pytorch_tpu_torch.observability import tracer as T

    old = T.get_tracer()
    live = T.Tracer([T.MemoryExporter()])
    T.set_tracer(live)
    try:
        at, losses, buckets = _tuned(
            group, 24, strategy="bo", threshold_mb=0.001,
            bound=(0.001, 0.05), max_trials=3, interval=4,
            clock=_counting_clock(), tuner_seed=0)
    finally:
        T.set_tracer(old)
    assert at.tuner.finished and at.rebuilds >= 2
    assert len(set(buckets)) >= 2               # real re-bucketings
    np.testing.assert_allclose(
        losses, _plain_losses(group, 24, threshold_mb=0.001),
        rtol=1e-5, atol=1e-6)
    c = live.counters()
    assert c["autotune.rebuilds"] == at.rebuilds
    assert c["dear.plan_builds"] == 1 + at.rebuilds
    assert c["dear.steps"] == 24 and c["autotune.trials"] >= 2
    names = {s.name for s in live._exporters[0].spans}
    assert {"dear.step", "autotune.rebuild"} <= names


@pytest.mark.parametrize("where", ["build", "repack"])
def test_autotuner_bo_rebuild_failure(where, group, monkeypatch):
    """A trial whose step fails to BUILD is infeasible and the run goes on
    on the live step (its losses still those of the untuned run); a
    failure once the repack has begun (the old step is closed by then)
    raises out of the step."""
    def failing(real):
        calls = {"n": 0}

        def fn(*args, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError(f"{where} failed")
            return real(*args, **kw)
        return fn

    def patch(at):
        if where == "build":
            monkeypatch.setattr(at, "_build", failing(at._build))
        else:
            monkeypatch.setattr(TA, "install_state",
                                failing(TA.install_state))

    kw = dict(strategy="bo", threshold_mb=0.001, bound=(0.001, 0.05),
              max_trials=3, interval=4, clock=_counting_clock(),
              tuner_seed=0)
    if where == "repack":
        with pytest.raises(RuntimeError, match="repack failed"):
            _tuned(group, 24, patch=patch, **kw)
        return
    from dear_pytorch_tpu_torch.observability import tracer as T

    old, live = T.get_tracer(), T.Tracer([T.MemoryExporter()])
    T.set_tracer(live)
    try:
        at, losses, _ = _tuned(group, 24, patch=patch, **kw)
    finally:
        T.set_tracer(old)
    assert at.tuner.finished
    assert live.counters()["autotune.trial_failures"] == 1
    np.testing.assert_allclose(
        losses, _plain_losses(group, 24, threshold_mb=0.001),
        rtol=1e-5, atol=1e-6)


def test_autotuner_wait_time_losses_match_the_untuned_run(group):
    n_layers = len(F.layer_sizes(gpt_model()))
    at, losses, buckets = _tuned(
        group, 6, strategy="wait_time", warmup_steps=2,
        cycle_time_s=2e-3, layer_times=[1e-3] * n_layers)
    assert buckets[0] == 1 and buckets[-1] == n_layers // 2 + n_layers % 2
    assert at.rebuilds == 1
    np.testing.assert_allclose(
        losses, _plain_losses(group, 6, nearby_layers=-1),
        rtol=1e-5, atol=1e-6)


def test_autotuner_rejects_what_it_cannot_tune(group):
    with pytest.raises(ValueError, match="dear/dear-fused"):
        TA.AutoTuner(gpt_loss, gpt_model(), strategy="plan", group=group,
                     device="cpu", mode="allreduce")
    with pytest.raises(ValueError, match="unknown strategy"):
        TA.AutoTuner(gpt_loss, gpt_model(), strategy="grid", group=group,
                     device="cpu")
    with pytest.raises(ValueError, match="owns the fusion plan"):
        TA.AutoTuner(gpt_loss, gpt_model(), group=group, device="cpu",
                     nearby_layers=2)
    at = TA.AutoTuner(gpt_loss, gpt_model(), group=group, device="cpu")
    with pytest.raises(ValueError, match="MembershipView"):
        at.rescale(4)
    at.close()


def test_autotuner_plan_reverts_a_diverging_trial(group, monkeypatch):
    """A trial whose wire format diverges (qint8 with a poisoned scale:
    NaN gradients) is marked infeasible and reverted — plan, masters,
    momentum and step count back to the pre-trial snapshot — and the
    caller sees a finite loss; the run then finishes the search on the
    good arm."""
    def nan8():
        base = Z.compressors["qint8"]()

        def compress(buf, state, density):
            payload, st = base.compress(buf, state, density)
            return dict(payload, scale=payload["scale"] * float("nan")), st

        return Z.Compressor("qint8", base.init, compress, base.decompress)

    monkeypatch.setitem(Z.compressors, "nan8", nan8)
    space = tps.PlanSpace(threshold_bound=(0.001, 0.05), modes=("dear",),
                          compressors=(None, "nan8"), comm_dtypes=(None,),
                          gather_dtypes=(None,), remats=(None,))
    at = TA.AutoTuner(gpt_loss, gpt_model(), strategy="plan",
                      threshold_mb=0.005, space=space, max_trials=4,
                      interval=4, group=group, device="cpu",
                      optimizer=topt.fused_sgd(lr=0.05, momentum=0.9),
                      clock=_counting_clock())
    s = at.init()
    reverted, losses = [], []
    for _ in range(60):
        pre = at._trial_backup
        s, m = at.step(s, gpt_batch())
        losses.append(float(m["loss"]))
        if m.get("tuner_reverted"):
            assert not np.isfinite(m["trial_loss"].item())
            reverted.append((pre[0], TA.export_state(s, at.ts)))
        if at.planner.finished:
            break
    assert reverted, "no trial diverged"
    for saved, after in reverted:      # plan AND state back, bit for bit
        _equal_images(saved, after)
    assert all(np.isfinite(losses))
    assert at.planner.finished and at._trial_backup is None
    assert at._live_config.compressor is None
    summary = at.planner.summary()
    assert summary["best"]["compressor"] is None
    at.close()


def test_autotuner_plan_revert_restores_the_snapshot_exactly(group,
                                                              monkeypatch):
    """`_revert_trial` installs the snapshot bit for bit: masters,
    momentum, step count."""
    at = TA.AutoTuner(gpt_loss, gpt_model(), strategy="plan",
                      threshold_mb=0.005, group=group, device="cpu",
                      space=tps.PlanSpace(modes=("dear",),
                                          compressors=(None,),
                                          comm_dtypes=(None,),
                                          gather_dtypes=(None,),
                                          remats=(None,)),
                      optimizer=topt.fused_sgd(lr=0.05, momentum=0.9))
    s = at.init()
    for _ in range(2):
        s, _ = at.step(s, gpt_batch())
    snap = TA.export_state(s, at.ts)
    at._trial_backup = (snap, 1.25)
    for _ in range(2):
        s, m = at.ts.step(s, gpt_batch())
    s, out = at._revert_trial(s, m, "test")
    assert out["loss"] == 1.25 and out["tuner_reverted"]
    _equal_images(snap, TA.export_state(s, at.ts))
    at.close()


# ---------------------------------------------------------------------------
# world 2: rank 0 decides
# ---------------------------------------------------------------------------


_WORKER = '''
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.models import gpt as tgpt
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.parallel import dear as tdear
from dear_pytorch_tpu_torch.tuning import AutoTuner

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store")
group = backend.init("cpu")
cfg = tgpt.GptConfig(vocab_size=61, hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=64,
                     max_position_embeddings=32, embd_dropout_prob=0.0,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0, dtype=torch.float32)
ids = np.random.RandomState(5).randint(0, 61, (4, 16))
batch = {{"input_ids": torch.from_numpy(ids[rank * 2:(rank + 1) * 2])}}


def loss(m, b):
    return tgpt.gpt_lm_loss(m(b["input_ids"], train=True), b["input_ids"],
                            vocab_size=61)


t = {{"t": 0.0}}
at = AutoTuner(loss, tgpt.GptLmHeadModel(cfg, device="cpu", seed=0),
               strategy="bo", threshold_mb=0.001, bound=(0.001, 0.05),
               max_trials=4, interval=4, clock=lambda: t["t"],
               tuner_seed=rank, group=group, device="cpu",
               optimizer=topt.fused_sgd(lr=0.05, momentum=0.9))
local = []
step = at.tuner.step
def recording_step():
    p = step()
    local.append(p)
    return p
at.tuner.step = recording_step
s = at.init()
plans, losses = [], []
for i in range(36):
    t["t"] += 0.01 + 0.003 * rank * (i % 5)     # a clock of its own
    s, m = at.step(s, batch)
    plans.append([list(b.leaf_ids) for b in at.ts.plan.buckets])
    losses.append(float(m["loss"]))
final = {{k: v.numpy().tolist() for k, v in at.ts.gather_params(s).items()}}
at.close()

def run(scanned):
    ts = tdear.build_train_step(
        loss, tgpt.GptLmHeadModel(cfg, device="cpu", seed=0), group=group,
        device="cpu", threshold_mb=0.02,
        optimizer=topt.fused_sgd(lr=0.05, momentum=0.9))
    st = ts.init()
    if scanned:
        st, m = ts.multi_step(3)(st, batch)
    else:
        for _ in range(3):
            st, m = ts.step(st, batch)
    p = {{k: v.clone() for k, v in ts.gather_params(st).items()}}
    counts = (ts.rs_launches, ts.ag_launches, ts.update_launches)
    ts.close()
    return float(m["loss"]), p, counts

a, b = run(False), run(True)
ms_equal = (a[0] == b[0] and a[2] == b[2]
            and all(torch.equal(a[1][k], b[1][k]) for k in a[1]))
json.dump(dict(plans=plans, losses=losses, rebuilds=at.rebuilds,
               local=[None if p is None else float(p) for p in local],
               final=final, ms_equal=bool(ms_equal), ms_counts=a[2]),
          open(f"{{out}}/rank{{rank}}.json", "w"))
backend.shutdown()
'''


def test_world2_ranks_adopt_rank0_plans_and_multi_step(tmp_path):
    from tests.test_torch_dear import spawn_ranks

    out = str(tmp_path)
    spawn_ranks(_WORKER.format(root=ROOT), 2, out)
    r0, r1 = (json.load(open(os.path.join(out, f"rank{r}.json")))
              for r in range(2))
    assert r0["rebuilds"] == r1["rebuilds"] >= 2
    assert r0["plans"] == r1["plans"]          # one plan per step, agreed
    assert len({len(p) for p in r0["plans"]}) >= 2
    assert r0["losses"] == r1["losses"]
    assert r0["final"] == r1["final"]
    # rank 1's own tuner (another seed, another clock) proposed otherwise
    assert r0["local"] != r1["local"]
    assert r0["ms_equal"] and r1["ms_equal"]
    assert r0["ms_counts"][2] == r1["ms_counts"][2] > 0


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_gpt_cli_autotune_bo_and_mgwfbp(capsys, monkeypatch):
    from dear_pytorch_tpu_torch.benchmarks import gpt

    monkeypatch.setenv("DEAR_BO_INTERVAL", "4")
    monkeypatch.setenv("DEAR_BO_TRIALS", "2")
    monkeypatch.setenv("DEAR_BO_BOUND", "0.5,64")
    base = ["--device", "cpu", "--num-hidden-layers", "1", "--batch-size",
            "2", "--sequence-len", "16", "--num-warmup-batches", "1",
            "--num-batches-per-iter", "2", "--num-iters", "1",
            "--threshold", "1"]
    res = gpt.main(base + ["--autotune", "bo", "--tune-steps", "30"])
    out = capsys.readouterr().out
    assert "Pre-tuning: up to 30 steps" in out and "BO Tuning" in out
    assert res.stepper.tuner.finished and res.stepper.rebuilds >= 1
    assert res.train_step is res.stepper.ts
    assert all(np.isfinite(res.losses))
    res.stepper.close()
    res = gpt.main(base + ["--mgwfbp"])
    out = capsys.readouterr().out
    assert "MG-WFBP: measured alpha=" in out and "MG-WFBP plan:" in out
    alpha, beta = res.train_step.alpha_beta
    assert alpha >= 0 and beta >= 0
    res.train_step.close()
    with pytest.raises(SystemExit, match="mutually exclusive"):
        gpt.main(base + ["--mgwfbp", "--autotune", "bo"])


def test_imagenet_cli_autotune_bo(monkeypatch):
    from dear_pytorch_tpu_torch.benchmarks import imagenet

    monkeypatch.setenv("DEAR_BO_INTERVAL", "4")
    monkeypatch.setenv("DEAR_BO_TRIALS", "2")
    monkeypatch.setenv("DEAR_BO_BOUND", "0.01,1")
    res = imagenet.main(["--device", "cpu", "--model", "mnistnet",
                         "--batch-size", "2", "--num-warmup-batches", "2",
                         "--num-batches-per-iter", "2", "--num-iters", "1",
                         "--autotune", "bo", "--tune-steps", "30",
                         "--threshold", "0.05"])
    assert res.stepper.tuner.finished and res.stepper.rebuilds >= 1
    assert all(np.isfinite(res.losses))
    res.stepper.close()
