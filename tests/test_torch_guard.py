"""The port's `GuardedTrainer` (dear_pytorch_tpu_torch.utils.guard) against
the JAX package's, on the CPU.

  - the same fault schedule (``nan@3,exc@5,ckpt_corrupt@7``, and with
    ``nan@8`` after it so the restore walks past the corrupted step) with
    ``checkpoint_every=2`` and ``check_every=1``, over the same batches of
    the MLP of tests/test_dear_numerics.py, through JAX's guard and the
    port's: the losses per attempt at 1e-5, the restored steps, the
    ``guard.rollbacks`` / ``guard.restores`` / ``guard.steps_skipped``
    counters, the final step and the final masters by name at 1e-5;
  - port only: a SIGTERM (the ``preempt`` fault) at step k leaves a
    verified emergency step that a fresh step resumes from, ending bitwise
    equal to the uninterrupted run; the ``hang`` fault fires the watchdog
    once, with the last good step; async checkpoints under the guard;
  - world 2, one spawn of two gloo ranks: ``nan@3:r1`` rolls both ranks
    back to the same step (shared storage: one ``rank_<r>/`` blob each,
    which `elastic_restore` then re-packs into a world-1 step here); with
    per-host storage and rank 0's newest step corrupted, both ranks
    restore the newest common step; under ``DEAR_SDC`` a flip on rank 0's
    replica is caught as a desync and rolled back on both (two voters
    cannot localize it: JAX's rule, resilience/sdc.py:26-28; the vote of
    three is in tests/test_torch_resilience.py);
  - the entry points: the production example recovers from
    ``nan@6,exc@9`` with checkpoints every 4 steps and resumes (with its
    own defaults, as JAX's, it stops with DivergenceError: nothing to
    restore at step 9), the MNIST example's ``--checkpoint-dir`` and
    ``--resume``, and both raise without a card unless told ``cpu``.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.observability import tracer as JT
from dear_pytorch_tpu.ops import fused_sgd as jopt
from dear_pytorch_tpu.parallel import dear as jdear
from dear_pytorch_tpu.resilience import inject as JINJ
from dear_pytorch_tpu.utils import guard as JG
from dear_pytorch_tpu_torch.observability import tracer as T
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.parallel import dear as tdear
from dear_pytorch_tpu_torch.resilience import inject as INJ
from dear_pytorch_tpu_torch.resilience.preempt import PreemptionHandler
from dear_pytorch_tpu_torch.resilience.watchdog import StepWatchdog
from dear_pytorch_tpu_torch.utils import checkpoint as ckpt
from dear_pytorch_tpu_torch.utils.guard import GuardedTrainer

from tests.test_dear_numerics import _loss_fn
from tests.test_torch_checkpoint import (
    assert_bitwise, bn_batches, bn_step, snapshot)
from tests.test_torch_dear import ROOT, spawn_ranks
from tests.test_torch_multi_step import (
    TorchMLP, mlp_loss, mlp_problem, torch_batch)

TOL = 1e-5
COUNTERS = ("guard.rollbacks", "guard.restores", "guard.steps_skipped")
ATTEMPTS = 12


@pytest.fixture(scope="module")
def group():
    from dear_pytorch_tpu_torch.comm import backend

    return backend.init("cpu")


@pytest.fixture(scope="module")
def problem():
    return mlp_problem(ATTEMPTS)


def _jax_guarded(faults, directory, params, batches):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    jp = jax.tree.map(jnp.asarray, params)
    ts = jdear.build_train_step(_loss_fn, jp, mesh=mesh,
                                optimizer=jopt.fused_sgd(lr=0.1,
                                                         momentum=0.9),
                                threshold_mb=0.0008, donate=False)
    old = JT.get_tracer()
    JT.set_tracer(JT.Tracer())
    try:
        restored = []
        guard = JG.GuardedTrainer(
            ts, directory, jp, check_every=1, checkpoint_every=2,
            injector=JINJ.FaultInjector(JINJ.parse_faults(faults)),
            on_rollback=lambda c, s: restored.append(s))
        state = ts.init(jp)
        losses = []
        for b in batches:
            state, m = guard.step(state, tuple(jnp.asarray(t) for t in b))
            losses.append(float(m["loss"]))
        guard.finalize()
        counters = {k: JT.get_tracer().counters().get(k, 0)
                    for k in COUNTERS}
    finally:
        JT.set_tracer(old)
    full = jax.tree.map(np.asarray, ts.gather_params(state))
    return losses, restored, counters, int(state.step), full


def _port_guarded(faults, directory, params, batches, group):
    ts = tdear.build_train_step(mlp_loss, TorchMLP(params), group=group,
                                device="cpu",
                                optimizer=topt.fused_sgd(lr=0.1,
                                                         momentum=0.9),
                                threshold_mb=0.0008)
    old = T.get_tracer()
    T.set_tracer(T.Tracer())
    try:
        restored = []
        state = ts.init()
        guard = GuardedTrainer(
            ts, directory, check_every=1, checkpoint_every=2,
            injector=INJ.FaultInjector(INJ.parse_faults(faults)),
            on_rollback=lambda c, s: restored.append(s))
        losses = []
        for b in batches:
            state, m = guard.step(state, torch_batch(b))
            losses.append(float(m["loss"]))
        guard.finalize()
        counters = {k: T.get_tracer().counters().get(k, 0) for k in COUNTERS}
    finally:
        T.set_tracer(old)
    final = {k: v.numpy() for k, v in ts.gather_params(state).items()}
    ts.close()
    return losses, restored, counters, int(state.step), final


@pytest.mark.parametrize("faults", ["nan@3,exc@5,ckpt_corrupt@7",
                                    "nan@3,exc@5,ckpt_corrupt@7,nan@8"])
def test_guard_matches_jax(faults, problem, group, tmp_path):
    params, batches = problem
    got = _port_guarded(faults, str(tmp_path / "port"), params, batches,
                        group)
    want = _jax_guarded(faults, str(tmp_path / "jax"), params, batches)
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    assert got[1] == want[1] and got[1]          # the restored steps
    assert got[2] == want[2] and got[2]["guard.rollbacks"] >= 2
    assert got[3] == want[3]                     # the final step
    final, jfull = got[4], want[4]
    for layer in ("dense1", "dense2", "out"):
        np.testing.assert_allclose(final[f"{layer}.weight"],
                                   jfull[layer]["kernel"].T, rtol=TOL,
                                   atol=TOL, err_msg=layer)
        np.testing.assert_allclose(final[f"{layer}.bias"],
                                   jfull[layer]["bias"], rtol=TOL, atol=TOL,
                                   err_msg=layer)
    if "nan@8" in faults:                        # walked past the corrupt 5
        assert got[1][-1] == 3


# ---------------------------------------------------------------------------
# port only: preemption, the watchdog, async checkpoints
# ---------------------------------------------------------------------------


def test_preemption_leaves_a_step_a_relaunch_resumes_from(tmp_path, group):
    n, k = 7, 4
    batches = bn_batches(n)
    ts = bn_step(group)
    state = ts.init()
    for b in batches:
        state, _ = ts.step(state, b)
    want = snapshot(ts, state)
    ts.close()

    d = str(tmp_path / "ckpts")
    ts = bn_step(group)
    state = ts.init()
    with PreemptionHandler() as pre:
        guard = GuardedTrainer(
            ts, d, check_every=1, checkpoint_every=3, preemption=pre,
            injector=INJ.FaultInjector(INJ.parse_faults(f"preempt@{k}")))
        for b in batches:
            state, m = guard.step(state, b)
            if m.get("preempted"):
                break
        guard.finalize()
    assert pre.requested and m["preempt_checkpoint_step"] == k
    assert ckpt.latest_valid_step(d) == k and ckpt.verify_checkpoint(d, k)
    assert ckpt.read_sidecar(d, k)["manifest"]
    ts.close()

    ts = bn_step(group)                      # the relaunch
    state = ckpt.restore_checkpoint(d, ts, step=ckpt.latest_valid_step(d),
                                    template=ts.init())
    for b in batches[state.step:]:
        state, _ = ts.step(state, b)
    assert_bitwise(snapshot(ts, state), want)
    ts.close()


def test_hang_fires_the_watchdog_once_with_the_last_good_step(tmp_path,
                                                              group):
    reports = []
    ts = bn_step(group)
    state = ts.init()
    # a deadline well above a step's (ms) and the save's, so a loaded
    # machine does not fire it early; the hang well above the deadline
    dog = StepWatchdog(0.5, on_timeout=reports.append, poll_s=0.02)
    with dog:
        guard = GuardedTrainer(
            ts, str(tmp_path / "c"), check_every=1, checkpoint_every=2,
            watchdog=dog,
            injector=INJ.FaultInjector(INJ.parse_faults("hang@5:1.5")))
        for b in bn_batches(6):
            state, _ = guard.step(state, b)
    ts.close()
    assert dog.fired == 1 and len(reports) == 1
    rep = reports[0]
    assert rep.beat_info == {"step": 4, "last_good_step": 4}
    assert rep.faults == "" and rep.waited_s >= 0.5


def test_async_checkpoints_under_the_guard(tmp_path, group):
    """Async saves every 2 steps, a NaN at attempt 5 (batch 4): the
    rollback to the async step 4 and the replay end bitwise equal to plain
    steps over the batches less batch 4, and so does a fresh step restored
    from the newest async save (its manifest backfilled by finalize)."""
    batches = bn_batches(8)
    ts = bn_step(group)
    state = ts.init()
    for i, b in enumerate(batches):
        if i != 4:
            state, _ = ts.step(state, b)
    want = snapshot(ts, state)
    ts.close()
    d = str(tmp_path / "c")
    ts = bn_step(group)
    state = ts.init()
    with GuardedTrainer(ts, d, check_every=1, checkpoint_every=2,
                        async_checkpoints=True,
                        injector=INJ.FaultInjector(
                            INJ.parse_faults("nan@5"))) as guard:
        for b in batches:
            state, _ = guard.step(state, b)
    assert_bitwise(snapshot(ts, state), want)
    assert ckpt.valid_steps(d)[:3] == [7, 5, 4]
    assert ckpt.read_sidecar(d, 7)["manifest"]   # backfilled by finalize
    ts.close()
    ts = bn_step(group)
    state = ckpt.restore_checkpoint(d, ts, template=ts.init())
    assert_bitwise(snapshot(ts, state), want)
    ts.close()


# ---------------------------------------------------------------------------
# world 2
# ---------------------------------------------------------------------------

_WORKER = '''
import json, os, sys
import numpy as np
import torch
from torch import nn
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.observability import tracer as T
from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd
from dear_pytorch_tpu_torch.parallel import dear as D
from dear_pytorch_tpu_torch.resilience import inject as INJ
from dear_pytorch_tpu_torch.utils.guard import DivergenceError, GuardedTrainer

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store",
                  DEAR_CLUSTER_TIMEOUT_SECS="60")
g = backend.init("cpu")


class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.dense1, self.out = nn.Linear(12, 16), nn.Linear(16, 4)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)

    @property
    def device(self):
        return self.out.weight.device

    def forward(self, x):
        return self.out(torch.tanh(self.dense1(x)))


def loss_fn(m, b):
    return nn.functional.cross_entropy(m(b["x"]), b["y"])


def batch(i):
    rng = np.random.RandomState(100 + i)
    x = rng.randn(8 * world, 12).astype(np.float32)
    y = rng.randint(0, 4, 8 * world)
    sl = slice(8 * rank, 8 * (rank + 1))
    return {{"x": torch.from_numpy(x[sl]), "y": torch.from_numpy(y[sl])}}


def run(name, mode, faults, shared, sdc, attempts):
    os.environ["DEAR_CKPT_SHARED"] = "1" if shared else "0"
    os.environ["DEAR_SDC"] = "1" if sdc else ""
    d = os.path.join(out, name) if shared else os.path.join(
        out, name, "rank%d" % rank)
    T.set_tracer(T.Tracer())
    ts = D.build_train_step(loss_fn, MLP(), group=g, device="cpu",
                            mode=mode, threshold_mb=0.0005,
                            optimizer=fused_sgd(lr=0.1, momentum=0.9))
    state = ts.init()
    restored, losses, error = [], [], ""
    guard = GuardedTrainer(ts, d, check_every=1, checkpoint_every=2,
                           max_keep=10,
                           injector=INJ.FaultInjector(
                               INJ.parse_faults(faults)),
                           on_rollback=lambda c, s: restored.append(s))
    try:
        for i in range(attempts):
            state, m = guard.step(state, batch(i))
            losses.append(float(m["loss"]))
    except DivergenceError as exc:
        error = str(exc)
    guard.finalize()
    params = {{k: v.numpy() for k, v in ts.gather_params(state).items()}}
    res = {{"restored": restored, "losses": losses, "step": int(state.step),
           "error": error, "buckets": ts.plan.num_buckets,
           "counters": {{k: v for k, v in T.get_tracer().counters().items()
                        if k.startswith(("guard.", "cluster.", "sdc."))}},
           "suspects": guard._sdc.last_suspects if guard._sdc else None}}
    with open(os.path.join(out, "%s.rank%d.json" % (name, rank)), "w") as f:
        json.dump(res, f)
    np.savez(os.path.join(out, "%s.rank%d.npz" % (name, rank)), **params)
    ts.close()


for case in json.load(open(os.path.join(out, "cases.json"))):
    run(**case)
'''

WORLD2_CASES = [
    dict(name="nan_r1", mode="dear", faults="nan@3:r1", shared=True,
         sdc=False, attempts=6),
    dict(name="per_host", mode="dear", faults="ckpt_corrupt@5:r0,nan@5",
         shared=False, sdc=False, attempts=6),
    dict(name="flip", mode="allreduce", faults="flip@4:0:r0", shared=True,
         sdc=True, attempts=5),
]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("guard_world2"))
    with open(os.path.join(out, "cases.json"), "w") as f:
        json.dump(WORLD2_CASES, f)
    spawn_ranks(_WORKER.format(root=ROOT), 2, out)

    def load(name):
        return [(json.load(open(os.path.join(out, f"{name}.rank{r}.json"))),
                 dict(np.load(os.path.join(out, f"{name}.rank{r}.npz"))))
                for r in range(2)]

    return out, load


def _same_on_both(ranks):
    (r0, p0), (r1, p1) = ranks
    assert r0["restored"] == r1["restored"] and r0["step"] == r1["step"]
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


def test_world2_one_ranks_nan_rolls_both_back(world2, group):
    out, load = world2
    ranks = load("nan_r1")
    _same_on_both(ranks)
    r0 = ranks[0][0]
    assert r0["restored"] == [2] and r0["step"] == 5
    assert r0["counters"]["cluster.unhealthy_detected"] == 1
    assert r0["counters"]["guard.rollbacks"] == 1
    d = os.path.join(out, "nan_r1")
    assert sorted(os.listdir(os.path.join(d, "step_0000000005"))) == [
        "rank_00000", "rank_00001"]
    # the world-2 step, re-packed into a world-1 step by parameter name
    ts = _world2_mlp_at_world1(group)
    ts.init()
    with pytest.raises(ckpt.PlanMismatchError):
        ckpt.restore_checkpoint(d, ts, step=5)
    state = ckpt.elastic_restore(d, ts, step=5)
    assert state.step == 5
    got = ts.gather_params(state)
    for k, v in ranks[0][1].items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    ts.close()


def _world2_mlp_at_world1(group):
    """The worker's MLP and step, at world 1."""
    from torch import nn

    class MLP(nn.Module):
        def __init__(self):
            super().__init__()
            self.dense1, self.out = nn.Linear(12, 16), nn.Linear(16, 4)

        @property
        def device(self):
            return self.out.weight.device

        def forward(self, x):
            return self.out(torch.tanh(self.dense1(x)))

    return tdear.build_train_step(
        lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"]),
        MLP(), group=group, device="cpu", threshold_mb=0.0005,
        optimizer=topt.fused_sgd(lr=0.1, momentum=0.9))


def test_world2_per_host_corruption_restores_the_common_step(world2):
    _, load = world2
    ranks = load("per_host")
    _same_on_both(ranks)
    assert ranks[0][0]["restored"] == [2] == ranks[1][0]["restored"]
    assert ranks[0][0]["counters"]["guard.restores"] == 1


def test_world2_flip_is_a_desync_two_voters_cannot_localize(world2):
    _, load = world2
    ranks = load("flip")
    for res, _ in ranks:
        assert res["restored"]      # (|= 1 lands when the low bit was 0)
        assert res["counters"]["cluster.desync_detected"] >= 1
        assert res["suspects"] == []
        assert res["counters"].get("sdc.votes", 0) == 0
    assert ranks[0][0]["restored"] == ranks[1][0]["restored"]


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def test_production_example_recovers_and_resumes(tmp_path, group,
                                                 monkeypatch, capsys):
    from dear_pytorch_tpu_torch.examples import production

    from dear_pytorch_tpu_torch.utils.guard import DivergenceError

    monkeypatch.setenv("DEAR_FAULTS", "nan@6,exc@9")
    # the example's own defaults (as JAX's: its first checkpoint at step
    # 20) have nothing to restore at step 9, and stop as JAX's does
    with pytest.raises(DivergenceError, match="before the first checkpoint"):
        production.main(["--steps", "12", "--workdir",
                         str(tmp_path / "defaults"), "--device", "cpu"])
    work = str(tmp_path / "run")
    flags = ["--workdir", work, "--device", "cpu", "--checkpoint-every",
             "4", "--log-every", "2"]
    loss = production.main(["--steps", "16"] + flags)
    out = capsys.readouterr().out
    assert np.isfinite(loss) and "done at step 16" in out
    monkeypatch.delenv("DEAR_FAULTS")
    d = os.path.join(work, "ckpts")
    newest = ckpt.latest_valid_step(d)
    assert newest is not None and ckpt.read_sidecar(d, newest)["manifest"]
    loss = production.main(["--steps", "20"] + flags)
    out = capsys.readouterr().out
    assert f"resumed from checkpoint step {newest}" in out
    assert "done at step 20" in out and np.isfinite(loss)
    steps = [r["step"] for r in map(json.loads, open(
        os.path.join(work, "metrics.jsonl"))) if "step" in r]
    assert steps == sorted(set(steps)) and steps[-1] == 20


def test_mnist_example_checkpoint_and_resume(tmp_path, group, capsys):
    from dear_pytorch_tpu_torch.examples import mnist

    d = str(tmp_path / "mnist")
    flags = ["--device", "cpu", "--data", "synthetic", "--train-size",
             "256", "--test-size", "64", "--batch-size", "64",
             "--epochs", "1", "--checkpoint-dir", d]
    mnist.main(flags)
    assert ckpt.valid_steps(d) == [4]
    mnist.main(flags + ["--resume"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert ckpt.valid_steps(d) == [8, 4]


def test_examples_need_the_card_unless_told_otherwise(tmp_path,
                                                      monkeypatch):
    from dear_pytorch_tpu_torch.examples import mnist, production
    from dear_pytorch_tpu_torch.resilience import sdc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        production.main(["--steps", "2", "--workdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mnist.main(["--data", "synthetic", "--checkpoint-dir",
                    str(tmp_path / "m"), "--resume"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sdc.probation_selftest(steps=2)
    assert sdc.probation_selftest(steps=2, device="cpu")["ok"]
