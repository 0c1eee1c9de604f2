"""A step error with every member alive, on an elastic fleet of gloo ranks.

One rank's step raises after it dispatched (its loss function fails
before the backward, so it issues none of the step's reduce-scatters);
its peers' collectives then time out on the data plane. No member left,
yet the epoch's group is out of step: the members re-form it at a new
epoch with the same members (`ElasticCluster.health_check`'s
``group_failed``), roll back through the guard's transition, and train on
in lockstep to the same parameters as a run without the fault. The JAX
package has no counterpart: its elastic drills hold the whole world in one
process, where a step error leaves no process group behind.
"""

from __future__ import annotations

import json

from tests.test_torch_elastic import _spawn

_STEPS = 8

_WORKER = r'''
import json, os, sys
sys.path.insert(0, os.environ["PORT_TEST_ROOT"])
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_CKPT_SHARED="0", DEAR_CLUSTER_TIMEOUT_SECS="8",
                  DEAR_ELASTIC_DIR=os.path.join(out, "elastic"))
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.observability import tracer as T
from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd
from dear_pytorch_tpu_torch.resilience import membership as M
from dear_pytorch_tpu_torch.resilience.cluster import FileTransport
from dear_pytorch_tpu_torch.scripts import chaos_check as CK
from dear_pytorch_tpu_torch.scripts import elastic_harness as EH
from dear_pytorch_tpu_torch.tuning.autotune import AutoTuner
from dear_pytorch_tpu_torch.utils.guard import GuardedTrainer

T.set_tracer(T.Tracer())
cluster = M.ElasticCluster(rank=rank, world=world, transport=FileTransport(
    os.path.join(out, "elastic", "membership")))
backend.regroup(cluster.view(), device="cpu")


def tuner_over(loss_fn):
    model, loss, batch_at, kw, thr = CK._workload("mlp", "cpu")
    return AutoTuner(loss_fn or loss, model, strategy="bo", threshold_mb=thr,
                     interval=10**9, device="cpu",
                     optimizer=fused_sgd(lr=0.05, momentum=0.9), **kw), \
        loss, batch_at


failed = []


def loss_fn(m, b):
    if rank == 1 and guard.steps_seen + 1 == 4 and not failed:
        failed.append(1)
        raise RuntimeError("a local failure mid-step")
    return plain_loss(m, b)


tuner, plain_loss, batch_at = tuner_over(loss_fn)
guard = GuardedTrainer(tuner.ts, os.path.join(out, f"rank{rank}"),
                       check_every=1, checkpoint_every=2, max_recoveries=3,
                       coordinator=cluster)
EH.attach_elastic(guard, tuner)
rollbacks = []
guard.on_rollback = lambda c, at: rollbacks.append(at)
state = tuner.init()
while int(state.step) < STEPS and guard.steps_seen < 3 * STEPS:
    state, m = guard.step(state, batch_at(int(state.step), cluster.index,
                                          cluster.world))
guard.finalize()
res = {"step": int(state.step), "loss": float(m["loss"]),
       "epoch": cluster.epoch, "members": list(cluster.members),
       "plan": [guard.ts.plan.world, guard.ts.plan.epoch],
       "group_epoch": backend.epoch(), "rollbacks": rollbacks,
       "counters": {k: v for k, v in T.get_tracer().counters().items()
                    if k in ("cluster.reforms", "cluster.reconfigs",
                             "guard.membership_changes", "guard.rollbacks",
                             "guard.step_errors")}}
mine = {n: t.tolist() for n, t in guard.ts.gather_params(state).items()}
views = cluster.exchange("verdict", json.dumps([res["step"], res["loss"]]))
res["lockstep"] = all(v == views[0] for v in views)
# the same steps without the fault, on the re-formed group
ref, _, _ = tuner_over(None)
rstate = ref.init()
for i in range(STEPS):
    rstate, _ = ref.ts.step(rstate, batch_at(i, cluster.index, cluster.world))
res["equal_to_fault_free"] = mine == {
    n: t.tolist() for n, t in ref.ts.gather_params(rstate).items()}
json.dump(res, open(os.path.join(out, f"res{rank}.json"), "w"))
ref.close()
tuner.close()
backend.shutdown()
'''.replace("STEPS", str(_STEPS))


def test_dispatched_error_with_every_member_alive_reforms_the_group(
        tmp_path):
    _spawn(_WORKER, 3, tmp_path)
    res = [json.loads((tmp_path / f"res{r}.json").read_text())
           for r in range(3)]
    for r, v in enumerate(res):
        assert v["lockstep"] and v["step"] == _STEPS, (r, v)
        assert v["epoch"] == 1 and v["members"] == [0, 1, 2], (r, v)
        assert v["plan"] == [3, 1] and v["group_epoch"] == 1, (r, v)
        assert v["rollbacks"] == [2], (r, v)
        c = v["counters"]
        assert c.get("cluster.reforms") == 1, (r, c)
        assert c.get("cluster.reconfigs", 0) == 0, (r, c)
        assert c.get("guard.membership_changes") == 1, (r, c)
        assert c.get("guard.rollbacks") == 1, (r, c)
        assert v["equal_to_fault_free"], r
