"""The port's elastic membership downstream of a committed view, on the
CPU: `comm.backend.regroup` (one process group per membership epoch),
`AutoTuner.rescale`, the guard's elastic branches, per-host checkpoints
that hold the whole state, and the object-store tier.

  - regroup at 3 -> 2 -> 3 gloo ranks: a rank SIGKILLs itself holding a
    pending reduce-scatter; the survivors' step raises within the peer
    timeout, `TrainStep.abandon` lets `quiesce`/`close` return without
    the group, the survivors regroup at epoch 1 and a relaunched process
    forms its first group at epoch 2;
  - `AutoTuner.rescale` at 3 -> 2 -> 3 ranks with the live state carried
    (the leaver exports, then leaves; the joiner receives it), against
    JAX's single process with a mesh of the same worlds on the same
    global batches: losses and fp32 masters by name at 1e-5; in the same
    spawn, a per-host step saved at world 3 restores at world 2 from one
    rank's directory alone, equal to the shared-storage restore; a failed
    rebuild leaves the previous step installed;
  - the guard against JAX's guard under the same scripted coordinators
    (tests/test_elastic.py :1092, :1147, :1193, :1657): the transition
    order, a second failure during the restore, `elastic_resume`'s
    cadence, the drain on preemption;
  - the streamer's four JAX cases (:1271-1413) on the port's checkpoints.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from dear_pytorch_tpu.observability import tracer as JT
from dear_pytorch_tpu.ops import fused_sgd as jopt
from dear_pytorch_tpu.parallel import dear as jdear
from dear_pytorch_tpu.runtime import pipeline as JP
from dear_pytorch_tpu.utils import guard as JG
from dear_pytorch_tpu_torch.observability import tracer as T
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.parallel import dear as tdear
from dear_pytorch_tpu_torch.resilience.preempt import PreemptionHandler
from dear_pytorch_tpu_torch.runtime import build as RB
from dear_pytorch_tpu_torch.runtime import pipeline as P
from dear_pytorch_tpu_torch.utils import checkpoint as ckpt
from dear_pytorch_tpu_torch.utils.guard import GuardedTrainer
from dear_pytorch_tpu_torch.utils.objectstore import LocalObjectStore

from tests.test_dear_numerics import _data, _loss_fn, _mlp_params
from tests.test_elastic import _DrainStub, _ElasticStub
from tests.test_torch_dear import ROOT, spawn_ranks
from tests.test_torch_multi_step import TorchMLP, mlp_loss, torch_batch

TOL = 1e-5
_ROWS = 48   # global rows: they shard over worlds 2 and 3


@pytest.fixture(scope="module")
def group():
    from dear_pytorch_tpu_torch.comm import backend

    return backend.init("cpu")


def _spawn(code, world, tmp_path):
    """`spawn_ranks` with the repo root importable in the ranks."""
    os.environ["PORT_TEST_ROOT"] = str(ROOT)
    try:
        spawn_ranks(code, world, str(tmp_path), timeout=240)
    finally:
        os.environ.pop("PORT_TEST_ROOT", None)


def _params():
    return jax.tree.map(np.asarray, _mlp_params(jax.random.PRNGKey(0)))


def _batch(i, n=64):
    return tuple(np.asarray(t) for t in _data(jax.random.PRNGKey(i), n=n))


# -- regroup: a rank dies holding a pending reduce-scatter --------------------

_REGROUP = r'''
import os, signal, sys, time, json
import torch, torch.distributed as dist
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.resilience.membership import MembershipView
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.parallel import dear as tdear
from tests.test_torch_multi_step import TorchMLP, mlp_loss, mlp_problem, torch_batch

rank, life, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
store = dist.FileStore(os.path.join(out, "store"), -1)
res = {}

def view(epoch, members):
    return MembershipView(epoch=epoch, members=tuple(members), rank=rank,
                          index=members.index(rank), world=len(members))

def ssum(world):
    x = torch.ones(2) * (rank + 1)
    dist.all_reduce(x)
    return x.tolist()

params, batches = mlp_problem(2)
if life == 1:
    backend.regroup(view(0, [0, 1, 2]), device="cpu", store=store)
    ts = tdear.build_train_step(mlp_loss, TorchMLP(params), device="cpu",
                                optimizer=topt.fused_sgd(lr=0.1),
                                threshold_mb=0.0008)
    state = ts.init()
    state, _ = ts.step(state, torch_batch(batches[0]))
    if rank == 2:
        reduce = ts._reduce
        def die(g):
            reduce(g)   # the reduce-scatter is in flight...
            os.kill(os.getpid(), signal.SIGKILL)
        ts._reduce = die
    t0 = time.monotonic()
    try:
        ts.step(state, torch_batch(batches[1]))
        res["raised"] = None
    except RuntimeError as exc:
        res["raised"] = type(exc).__name__
    res["error_s"] = time.monotonic() - t0
    ts.abandon()
    t0 = time.monotonic()
    ts.quiesce()
    ts.close()
    res["close_s"] = time.monotonic() - t0
    backend.regroup(view(1, [0, 1]), store=store)
    res["e1"] = [backend.epoch(), backend.rank(), backend.size(), ssum(2),
                 backend.host_group() is not None]
    with open(os.path.join(out, f"r{rank}.ready"), "w") as f:
        f.write("1")
backend.regroup(view(2, [0, 1, 2]), device="cpu", store=store)
res["e2"] = [backend.epoch(), backend.rank(), backend.size(), ssum(3)]
dist.barrier(group=backend.host_group())
with open(os.path.join(out, f"res{rank}.{life}.json"), "w") as f:
    json.dump(res, f)
backend.shutdown()
'''


def test_regroup_three_two_three_with_a_rank_dying_mid_reduce_scatter(
        tmp_path):
    """The data plane's timeout is a quarter of the peer timeout (8 s
    here): the survivors' step raises well inside it; the relaunched rank
    2 forms its first group at epoch 2."""
    path = tmp_path / "regroup.py"
    path.write_text(_REGROUP)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DEAR_", "JAX_", "XLA_"))}
    env.update(OMP_NUM_THREADS="1", DEAR_CLUSTER_TIMEOUT_SECS="8",
               PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))

    def start(r, life):
        log = open(tmp_path / f"rank{r}.{life}.log", "w")
        return subprocess.Popen(
            [sys.executable, str(path), str(r), str(life), str(tmp_path)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))

    procs = [start(r, 1) for r in range(3)]
    try:
        assert procs[2].wait(timeout=120) == -signal.SIGKILL
        deadline = time.monotonic() + 120
        while not all((tmp_path / f"r{r}.ready").exists() for r in (0, 1)):
            assert time.monotonic() < deadline, "survivors never regrouped"
            assert all(p.poll() in (None, 0) for p in procs[:2])
            time.sleep(0.1)
        procs.append(start(2, 2))
        codes = [p.wait(timeout=120) for p in procs[:2] + procs[3:]]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = "".join(f"--- {f.name}\n{f.read_text()}"
                   for f in sorted(tmp_path.glob("rank*.log")))
    assert codes == [0, 0, 0], logs
    res = {r: json.loads((tmp_path / f"res{r}.{1 if r < 2 else 2}.json")
                         .read_text()) for r in range(3)}
    for r in (0, 1):
        assert res[r]["raised"] == "RuntimeError", logs
        assert res[r]["error_s"] < 8.0, res[r]   # within the peer timeout
        assert res[r]["close_s"] < 0.5, res[r]   # no wait on the lost group
        assert res[r]["e1"] == [1, r, 2, [3.0, 3.0], True]
    for r in range(3):
        assert res[r]["e2"] == [2, r, 3, [6.0, 6.0]]


# -- rescale across worlds, with the state carried, against JAX ---------------

_SCHEDULE = ((0, 3, (0, 1, 2)), (1, 2, (0, 1)), (2, 2, (0, 1, 2)))
#: (epoch, steps, members) per phase

_RESCALE = r'''
import json, os, sys
sys.path.insert(0, os.environ["PORT_TEST_ROOT"])
import numpy as np, torch, torch.distributed as dist
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.resilience.membership import MembershipView
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.tuning.autotune import AutoTuner
from dear_pytorch_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_multi_step import TorchMLP, mlp_loss

rank, out = int(sys.argv[1]), sys.argv[3]
spec = json.load(open(os.path.join(out, "spec.json")))
params = {k: {kk: np.asarray(vv, np.float32) for kk, vv in v.items()}
          for k, v in spec["params"].items()}
batches = [(np.asarray(x, np.float32), np.asarray(y)) for x, y
           in spec["batches"]]
store = dist.FileStore(os.path.join(out, "store"), -1)

def view(epoch, members):
    return MembershipView(epoch=epoch, members=tuple(members), rank=rank,
                          index=members.index(rank) if rank in members
                          else -1, world=len(members))

def shard(b, members):
    n = len(b[0]) // len(members)
    i = members.index(rank)
    return {"x": torch.from_numpy(b[0][i * n:(i + 1) * n]),
            "y": torch.from_numpy(b[1][i * n:(i + 1) * n]).long()}

backend.regroup(view(0, [0, 1, 2]), device="cpu", store=store)
tuner = AutoTuner(mlp_loss, TorchMLP(params), strategy="bo",
                  threshold_mb=0.0008, interval=10**9, device="cpu",
                  optimizer=topt.fused_sgd(lr=0.05, momentum=0.9))
state = tuner.init()
losses, k, res = [], 0, {}
for epoch, steps, members in spec["schedule"]:
    if epoch:
        state = tuner.rescale(view(epoch, members), state=state,
                              store=store)
    if rank not in members:   # the global batches go on without it
        k += steps
        continue
    for _ in range(steps):
        state, m = tuner.step(state, shard(batches[k], members))
        losses.append(float(m["loss"]))
        k += 1
    if epoch == 0:
        # one step, saved per host (every blob whole) and shared
        for shared, d in (("0", "host%d" % rank), ("1", "shared")):
            os.environ["DEAR_CKPT_SHARED"] = shared
            ckpt.save_checkpoint(os.path.join(out, d), state, tuner.ts)
        os.environ["DEAR_CKPT_SHARED"] = "1"
    if epoch == 1:
        # world 2: the per-host step of rank 2's directory alone, and the
        # shared one, restored into this plan
        probe = AutoTuner(mlp_loss, TorchMLP(params), strategy="bo",
                          threshold_mb=0.0008, interval=10**9,
                          device="cpu",
                          optimizer=topt.fused_sgd(lr=0.05, momentum=0.9))
        probe.init()
        mine = {}
        for d in ("host2", "shared"):
            os.environ["DEAR_CKPT_SHARED"] = "0" if d == "host2" else "1"
            st = ckpt.elastic_restore(os.path.join(out, d), probe.ts,
                                      step=3)
            mine[d] = [np.asarray(t).tolist() for t in
                       [*st.shards, *[o["buf"] for o in st.opt_state]]]
        os.environ["DEAR_CKPT_SHARED"] = "1"
        res["restore_equal"] = mine["host2"] == mine["shared"]
        res["restore_world"] = probe.ts.world
        probe.close()
masters = {n: t.numpy().tolist() for n, t in
           tuner.ts.gather_params(state).items()}
res.update(losses=losses, masters=masters, plan=[tuner.ts.plan.world,
           tuner.ts.plan.epoch], step=int(state.step))
json.dump(res, open(os.path.join(out, "res%d.json" % rank), "w"))
tuner.close()
backend.shutdown()
'''


def _jax_rescaled(params, batches):
    """JAX's AutoTuner over meshes of the schedule's worlds, the state
    carried by `rescale` (tests/test_elastic.py:676)."""
    from dear_pytorch_tpu.resilience.membership import MembershipView
    from dear_pytorch_tpu.tuning.autotune import AutoTuner

    devs = jax.devices()
    jp = jax.tree.map(jax.numpy.asarray, params)
    tuner = AutoTuner(
        _loss_fn, jp, strategy="bo", threshold_mb=0.0008, interval=10**9,
        donate=False, mesh=jax.sharding.Mesh(np.asarray(devs[:3]), ("dp",)),
        optimizer=jopt.fused_sgd(lr=0.05, momentum=0.9))
    state = tuner.init(jp)
    losses, k = [], 0
    for epoch, steps, members in _SCHEDULE:
        if epoch:
            v = MembershipView(epoch=epoch, members=members, rank=0,
                               index=0, world=len(members))
            state = tuner.rescale(v, state=state, mesh=jax.sharding.Mesh(
                np.asarray(devs[:len(members)]), ("dp",)))
        for _ in range(steps):
            b = tuple(jax.numpy.asarray(t) for t in batches[k])
            state, m = tuner.step(state, b)
            losses.append(float(m["loss"]))
            k += 1
    full = jax.tree.map(np.asarray, tuner.ts.gather_params(state))
    return losses, full, int(state.step), tuner.ts.plan


def _torch_name(jname):
    layer, leaf = jname
    return f"{layer}.{'weight' if leaf == 'kernel' else 'bias'}"


def test_rescale_three_two_three_carries_state_like_jax(tmp_path):
    """JAX oracle: tests/test_elastic.py::
    test_autotuner_rescale_carries_state_across_worlds, here at
    3 -> 2 -> 3 on the same global batches (48 rows, sharded by member
    position). The per-host step saved at world 3 (whole state in every
    blob) restores at world 2 from rank 2's directory alone, equal to the
    shared-storage restore."""
    if len(jax.devices()) < 3:
        pytest.skip("needs 3 JAX CPU devices for the mesh oracle")
    params = _params()
    n_steps = sum(s for _, s, _ in _SCHEDULE)
    batches = [_batch(100 + i, _ROWS) for i in range(n_steps)]
    spec = {"params": {k: {kk: vv.tolist() for kk, vv in v.items()}
                       for k, v in params.items()},
            "batches": [[x.tolist(), y.tolist()] for x, y in batches],
            "schedule": [[e, s, list(m)] for e, s, m in _SCHEDULE]}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    _spawn(_RESCALE, 3, tmp_path)
    res = {r: json.loads((tmp_path / f"res{r}.json").read_text())
           for r in range(3)}
    jlosses, jfull, jstep, jplan = _jax_rescaled(params, batches)
    assert jplan.world == 3 and jplan.epoch == 2
    for r in (0, 1):
        assert res[r]["restore_equal"] and res[r]["restore_world"] == 2
    for r in range(3):
        assert res[r]["plan"] == [3, 2] and res[r]["step"] == jstep
        assert res[r]["masters"] == res[0]["masters"]
    np.testing.assert_allclose(res[0]["losses"], jlosses, rtol=TOL,
                               atol=TOL)
    for layer, leaves in jfull.items():
        for leaf, want in leaves.items():
            got = np.asarray(res[0]["masters"][_torch_name((layer, leaf))])
            want = np.asarray(want)
            np.testing.assert_allclose(got, want.T if want.ndim == 2
                                       else want, rtol=TOL, atol=TOL)


_RESCALE_FAILS = r'''
import json, os, sys
sys.path.insert(0, os.environ["PORT_TEST_ROOT"])
import torch.distributed as dist
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.observability import tracer as T
from dear_pytorch_tpu_torch.resilience.membership import MembershipView
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.tuning import autotune as AT
from tests.test_torch_multi_step import TorchMLP, mlp_loss, mlp_problem

out = sys.argv[3]
T.set_tracer(T.Tracer())
backend.regroup(MembershipView(epoch=0, members=(0,), rank=0, index=0,
                               world=1), device="cpu",
                store=dist.HashStore())
params, _ = mlp_problem(1)
tuner = AT.AutoTuner(mlp_loss, TorchMLP(params), strategy="bo",
                     threshold_mb=0.0008, interval=10**9, device="cpu",
                     optimizer=topt.fused_sgd(lr=0.05, momentum=0.9))
tuner.init()
before = tuner.ts

def boom(*a, **k):
    raise RuntimeError("build exploded")

AT.D.build_train_step = boom
res = {}
try:
    tuner.rescale(MembershipView(epoch=1, members=(0,), rank=0, index=0,
                                 world=1), store=dist.HashStore())
except RuntimeError as exc:
    res["raised"] = str(exc)
res["kept"] = tuner.ts is before and tuner.ts.plan.epoch == 0
res["failures"] = T.get_tracer().counters().get("autotune.rescale_failures")
res["rescales"] = T.get_tracer().counters().get("autotune.rescales", 0)
try:
    tuner.rescale(4)
except ValueError as exc:
    res["bare_world"] = "MembershipView" in str(exc)
json.dump(res, open(os.path.join(out, "res.json"), "w"))
tuner.close()
backend.shutdown()
'''


def test_rescale_failure_keeps_the_previous_step(tmp_path):
    """tests/test_elastic.py::test_autotuner_rescale_failure_keeps_
    previous_plan: a failing build counts ``autotune.rescale_failures``,
    raises, and leaves the previous step installed."""
    _spawn(_RESCALE_FAILS, 1, tmp_path)
    res = json.loads((tmp_path / "res.json").read_text())
    assert res == {"raised": "build exploded", "kept": True, "failures": 1,
                   "rescales": 0, "bare_world": True}


_RESCALE_FAILS_WORLD2 = r'''
import json, os, sys
sys.path.insert(0, os.environ["PORT_TEST_ROOT"])
import torch.distributed as dist
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.observability import tracer as T
from dear_pytorch_tpu_torch.resilience.membership import MembershipView
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.tuning import autotune as AT
from tests.test_torch_multi_step import (TorchMLP, mlp_loss, mlp_problem,
                                         torch_batch)

rank, out = int(sys.argv[1]), sys.argv[3]
T.set_tracer(T.Tracer())
store = dist.FileStore(os.path.join(out, "store"), -1)

def view(epoch):
    return MembershipView(epoch=epoch, members=(0, 1), rank=rank,
                          index=rank, world=2)

backend.regroup(view(0), device="cpu", store=store)
params, batches = mlp_problem(1)
tuner = AT.AutoTuner(mlp_loss, TorchMLP(params), strategy="bo",
                     threshold_mb=0.0008, interval=10**9, device="cpu",
                     optimizer=topt.fused_sgd(lr=0.05, momentum=0.9))
state = tuner.init()
state, _ = tuner.ts.step(state, torch_batch(batches[0]))
before = tuner.ts

def boom(*a, **k):
    raise RuntimeError("build exploded")

AT.D.build_train_step = boom
res = {}
try:
    tuner.rescale(view(1), store=store)
except RuntimeError as exc:
    res["raised"] = str(exc)
res["kept"] = tuner.ts is before and tuner.ts.plan.epoch == 0
res["failures"] = T.get_tracer().counters().get("autotune.rescale_failures")
try:
    tuner.ts.step(state, torch_batch(batches[0]))
    res["refused"] = None
except RuntimeError as exc:
    res["refused"] = "abandoned" in str(exc) and "relaunch" in str(exc)
res["epoch"] = [backend.epoch(), backend.size()]
json.dump(res, open(os.path.join(out, "res%d.json" % rank), "w"))
tuner.close()
backend.shutdown()
'''


def test_rescale_failure_at_world2_refuses_the_previous_step(tmp_path):
    """At world > 1 the failed rescale has already released the previous
    epoch's group (the default group is re-formed per epoch): the
    previous step stays installed, the failure is counted and raised, and
    a step on it is refused, naming the relaunch."""
    _spawn(_RESCALE_FAILS_WORLD2, 2, tmp_path)
    for r in (0, 1):
        res = json.loads((tmp_path / f"res{r}.json").read_text())
        assert res == {"raised": "build exploded", "kept": True,
                       "failures": 1, "refused": True, "epoch": [1, 2]}


# -- the guard's elastic branches against JAX's, scripted coordinators --------


def _spec():
    return (JP.SyntheticSpec((JP.Field("x", (8, 4), 0, 0.0, 1.0),)),
            P.SyntheticSpec((P.Field("x", (8, 4), RB.KIND_NORMAL_F32, 0.0,
                                     1.0),)))


def _guard_story(port: bool, group, directory, *, bumps=False, resume=False):
    """The scripted shrink of tests/test_elastic.py:1092/:1147 (or the
    rejoiner's resume of :1193) through one guard; returns its record."""
    params = _params()
    tr_mod = T if port else JT
    tracer = tr_mod.Tracer()
    old = tr_mod.get_tracer()
    tr_mod.set_tracer(tracer)
    try:
        if port:
            ts = tdear.build_train_step(
                mlp_loss, TorchMLP(params), group=group, device="cpu",
                optimizer=topt.fused_sgd(lr=0.05, momentum=0.9),
                threshold_mb=0.0008)
            state = ts.init()
            pipe = P.NumpyPipeline(_spec()[1], seed=5, shard=0,
                                   num_shards=3)
        else:
            jp = jax.tree.map(jax.numpy.asarray, params)
            ts = jdear.build_train_step(
                _loss_fn, jp, threshold_mb=0.0008, donate=False,
                mesh=jax.sharding.Mesh(np.asarray(jax.devices()[:1]),
                                       ("dp",)),
                optimizer=jopt.fused_sgd(lr=0.05, momentum=0.9))
            state = ts.init(jp)
            pipe = JP.NumpyPipeline(_spec()[0], seed=5, shard=0,
                                    num_shards=3)
        co = _ElasticStub()
        co.shrink_at = None if resume else 6
        if bumps:
            co.restore_bumps_to = (2, (0,))
        events = []
        cls = GuardedTrainer if port else JG.GuardedTrainer
        args = () if port else (jax.tree.map(jax.numpy.asarray, params),)
        guard = cls(ts, directory, *args, check_every=1,
                    checkpoint_every=2 if resume else 4, coordinator=co,
                    pipeline=pipe,
                    on_membership_change=lambda v: events.append(
                        ("hook", v.epoch, v.world)))
        guard.on_rollback = lambda c, at: events.append(("rollback", at))

        def batch(i):
            b = _batch(i)
            return torch_batch(b) if port else tuple(
                jax.numpy.asarray(t) for t in b)

        losses = []
        for i in range(4 if resume else 8):
            state, m = guard.step(state, batch(i))
            losses.append(float(m["loss"]))
        rec = {"events": events, "losses": losses}
        if resume:
            co.epoch, co.members = 2, (0, 1)
            state, step = guard.elastic_resume({"steps_seen": 11})
            rec["resume"] = [step, guard.steps_seen, int(state.step),
                             guard._last_good_step]
            state, m = guard.step(state, batch(11))
            rec["after"] = [guard.steps_seen, float(m["loss"])]
        else:
            rec["pipe"] = [pipe.shard, pipe.num_shards, pipe._epoch]
            rec["sidecar"] = [ckpt.read_mem_epoch(directory, 6),
                              ckpt.read_pipeline_state(directory, 6)
                              .get("num_shards")]
        c = tracer.counters()
        rec["counters"] = {k: c.get(k, 0) for k in (
            "guard.membership_changes", "pipeline.resumes",
            "pipeline.reshards", "guard.rollbacks")}
        rec["restore_calls"] = co.restore_calls
        return rec
    finally:
        tr_mod.set_tracer(old)


@pytest.mark.parametrize("story", ["transition_order", "second_failure",
                                   "elastic_resume"])
def test_guard_elastic_branches_match_jax(story, group, tmp_path):
    """Hook BEFORE the restore with the committed view, the pipeline's
    sidecar resume then its reshard, later sidecars with the new epoch,
    ``guard.membership_changes``; a second move during the restore
    re-fires the hook; a rejoiner's `elastic_resume` adopts the fleet's
    cadence. Event order, counters, pipeline and sidecars equal JAX's;
    losses at 1e-5."""
    kw = {"bumps": story == "second_failure",
          "resume": story == "elastic_resume"}
    jrec = _guard_story(False, group, str(tmp_path / "jax"), **kw)
    trec = _guard_story(True, group, str(tmp_path / "torch"), **kw)
    np.testing.assert_allclose(trec.pop("losses"), jrec.pop("losses"),
                               rtol=TOL, atol=TOL)
    if "after" in jrec:
        np.testing.assert_allclose(trec["after"][1], jrec["after"][1],
                                   rtol=TOL, atol=TOL)
        trec["after"][1] = jrec["after"][1]
    assert trec == jrec
    if story == "transition_order":
        assert [e[0] for e in jrec["events"]] == ["hook", "rollback"]


def test_guard_drain_on_preempt_matches_jax(group, tmp_path, monkeypatch):
    """tests/test_elastic.py:1657: a SIGTERM under a drain-speaking
    coordinator is announced as ``draining=True`` and the self-draining
    verdict ends in the emergency save without a rollback;
    ``DEAR_PREEMPT_DRAIN=0`` keeps the fleet-wide propagation."""
    monkeypatch.setenv("DEAR_PREEMPT_GRACE_S", "25")
    params = _params()
    out = {}
    for port in (False, True):
        monkeypatch.delenv("DEAR_PREEMPT_DRAIN", raising=False)
        if port:
            ts = tdear.build_train_step(
                mlp_loss, TorchMLP(params), group=group, device="cpu",
                optimizer=topt.fused_sgd(lr=0.05, momentum=0.9),
                threshold_mb=0.0008)
            make = (lambda d, co, pre: GuardedTrainer(
                ts, d, check_every=1, checkpoint_every=100,
                coordinator=co, preemption=pre))
            init = ts.init
            batch = (lambda i: torch_batch(_batch(i)))
            Pre = PreemptionHandler
        else:
            from dear_pytorch_tpu.resilience.preempt import (
                PreemptionHandler as Pre)
            jp = jax.tree.map(jax.numpy.asarray, params)
            ts = jdear.build_train_step(
                _loss_fn, jp, threshold_mb=0.0008, donate=False,
                mesh=jax.sharding.Mesh(np.asarray(jax.devices()[:1]),
                                       ("dp",)),
                optimizer=jopt.fused_sgd(lr=0.05, momentum=0.9))
            make = (lambda d, co, pre: JG.GuardedTrainer(
                ts, d, jp, check_every=1, checkpoint_every=100,
                coordinator=co, preemption=pre))
            init = (lambda: ts.init(jp))
            batch = (lambda i: tuple(jax.numpy.asarray(t)
                                     for t in _batch(i)))
        d = str(tmp_path / f"{port}")
        co, rollbacks = _DrainStub(), []
        with Pre() as pre:
            guard = make(d, co, pre)
            guard.on_rollback = lambda c, at: rollbacks.append(at)
            state = init()
            state, m = guard.step(state, batch(0))
            os.kill(os.getpid(), signal.SIGTERM)
            state, m = guard.step(state, batch(1))
        rec = [list(co.saw_draining), bool(m.get("preempted")), rollbacks,
               m.get("preempt_checkpoint_step"), ckpt.latest_valid_step(d)
               if port else None]
        monkeypatch.setenv("DEAR_PREEMPT_DRAIN", "0")
        co2 = _DrainStub()
        with Pre() as pre2:
            guard2 = make(d + "2", co2, pre2)
            state = init()
            os.kill(os.getpid(), signal.SIGTERM)
            guard2.step(state, batch(0))
        rec.append(list(co2.saw_draining))
        out[port] = rec
    assert out[True][4] == 2
    out[True][4] = None
    assert out[True] == out[False]
    assert out[False][:2] == [[False, True], True]


# -- the object-store tier: the streamer's four JAX cases ---------------------


def _saved_run(directory, group, n=3):
    """tests/test_elastic.py's `_saved_run` on the port: n steps, each
    saved with its pipeline state and epoch 0."""
    ts = tdear.build_train_step(
        mlp_loss, TorchMLP(_params()), group=group, device="cpu",
        optimizer=topt.fused_sgd(lr=0.05, momentum=0.9), threshold_mb=0.0008)
    state = ts.init()
    for i in range(n):
        state, _ = ts.step(state, torch_batch(_batch(i)))
        ckpt.save_checkpoint(str(directory), state, ts,
                             pipeline_state={"backend": "numpy",
                                             "produced": i + 1},
                             mem_epoch=0)
    return ts


class _FailingStore:
    """An object store whose writes always fail (a dead bucket)."""

    def __init__(self):
        self.attempts = 0

    def put_file(self, key, path):
        self.attempts += 1
        raise OSError("bucket is down")

    def put_bytes(self, key, data):
        raise OSError("bucket is down")

    def list(self, prefix):
        return []

    def delete_prefix(self, prefix):
        pass


def _streamer_case(case, group, tmp_path):
    local = tmp_path / "ckpts"
    tracer = T.Tracer()
    old = T.get_tracer()
    T.set_tracer(tracer)
    try:
        if case == "uploads_and_cold_restores":
            ts = _saved_run(local, group)
            store = LocalObjectStore(str(tmp_path / "remote"))
            with ckpt.CheckpointStreamer(str(local), store,
                                         pin_last=2) as streamer:
                assert all(streamer.enqueue(s) for s in (1, 2, 3))
                assert streamer.flush(30.0)
            assert streamer.uploaded == [1, 2, 3] and not streamer.failed
            assert ckpt.remote_steps(store) == [3, 2]
            c = tracer.counters()
            assert c.get("ckpt.uploads") == 3
            assert "ckpt.upload_errors" not in c
            cold = tmp_path / "cold"
            assert ckpt.restore_from_object_store(store, str(cold)) == 3
            assert ckpt.verify_checkpoint(str(cold), 3)
            assert ckpt.read_pipeline_state(str(cold), 3)["produced"] == 3
            assert ckpt.read_mem_epoch(str(cold), 3) == 0
            state = ckpt.restore_checkpoint(str(cold), ts, step=3)
            assert int(state.step) == 3
            assert tracer.counters().get("ckpt.remote_restores") == 1
        elif case == "upload_every_and_archive":
            _saved_run(local, group, n=4)
            store = LocalObjectStore(str(tmp_path / "remote"))
            with ckpt.CheckpointStreamer(str(local), store, upload_every=2,
                                         pin_last=2,
                                         keep_every=4) as streamer:
                assert not streamer.enqueue(1)
                assert streamer.enqueue(2)
                assert streamer.enqueue(3, force=True)
                assert streamer.enqueue(4)
                assert streamer.flush(30.0)
            assert ckpt.remote_steps(store) == [4, 3]
        elif case == "retry_exhaustion_local_only":
            ts = _saved_run(local, group)
            store = _FailingStore()
            with ckpt.CheckpointStreamer(str(local), store, attempts=3,
                                         base_delay_s=0.01,
                                         max_delay_s=0.02) as streamer:
                assert streamer.enqueue(2)
                assert streamer.flush(30.0)
                assert streamer.failed == [2] and not streamer.uploaded
                assert store.attempts == 3
                assert streamer.enqueue(3)
                assert streamer.flush(30.0)
                assert streamer.failed == [2, 3]
            c = tracer.counters()
            assert c.get("ckpt.upload_errors") == 2
            assert c.get("retry.giveups", 0) >= 2
            state = ckpt.restore_checkpoint(str(local), ts, step=3)
            assert int(state.step) == 3
        else:   # remote_restore_walks_past_corruption
            _saved_run(local, group)
            store = LocalObjectStore(str(tmp_path / "remote"))
            with ckpt.CheckpointStreamer(str(local), store,
                                         pin_last=3) as s:
                for n in (2, 3):
                    s.enqueue(n)
                assert s.flush(30.0)
            files = [k for k in store.list(ckpt._remote_step_key(3))
                     if "/files/" in k]
            victim = max(files, key=lambda k: len(store.get_bytes(k)))
            blob = bytearray(store.get_bytes(victim))
            blob[len(blob) // 2] ^= 0xFF
            store.put_bytes(victim, bytes(blob))
            assert ckpt.restore_from_object_store(
                store, str(tmp_path / "cold")) == 2
            assert ckpt.verify_checkpoint(str(tmp_path / "cold"), 2)
            store.put_bytes(f"{ckpt._remote_step_key(3)}/MANIFEST.json",
                            json.dumps({"step": 3, "files": {}}).encode())
            assert ckpt.restore_from_object_store(
                store, str(tmp_path / "cold2")) == 2
    finally:
        T.set_tracer(old)


@pytest.mark.parametrize("case", [
    "uploads_and_cold_restores", "upload_every_and_archive",
    "retry_exhaustion_local_only", "remote_restore_walks_past_corruption"])
def test_checkpoint_streamer_matches_jax_cases(case, group, tmp_path):
    """tests/test_elastic.py:1271-1413, each case's assertions on the
    port's checkpoints."""
    _streamer_case(case, group, tmp_path)
