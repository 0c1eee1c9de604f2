"""The port's DeAR train step with model state (BatchNorm's running
statistics) against the JAX package's ``build_train_step(...,
model_state_template=...)`` on the CPU: a small bottleneck ResNet (width 8,
stages (1, 1, 1), 5 classes) with the same seeded flax weights and
statistics on both sides (`models.convert.resnet_params_from_jax`), the
same numpy batch of 4 images of 33 px, 3 steps of the ResNet bench's
optimizer, SGD at lr 0.01 with momentum 0.9 (bench.py `bench_resnet`); then
the per-step losses, the gathered master parameters and the BN running
buffers compared by name.

World 1 runs in this process over a single-rank gloo group; world 2 as two
fresh jax-free Python processes (one spawn for every case,
tests/test_torch_dear.py's `spawn_ranks`), each training on its half of
the batch, against JAX on a 2-device sub-mesh. The last stage's map is 3x3,
so each rank's batch statistics there are over 18 or 36 values: a running
variance updated with the unbiased batch variance, or left unsynced across
the ranks, would be far outside the tolerance (the ``unsynced`` case shows
that the ranks' statistics differ without the sync).

Tolerances: 1e-5 in fp32 (summation order only); 2e-4 where gradients
travel in bf16 (``comm_dtype``): fp32 gradients that differ in their last
bits can round to neighbouring bf16 values (tests/test_torch_dear.py), and
such a flip moves that parameter by lr x one bf16 ulp (2^-8 relative) of
its gradient x up to 2.71 (three steps of momentum 0.9); the stem's
gradients here reach ~0.3, so a flip costs up to ~1e-4 at lr 0.01 (5x
that at lr 0.05, where 3.2e-4 was seen).
"""

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.models import data as jdata
from dear_pytorch_tpu.models import resnet as jres
from dear_pytorch_tpu.ops import fused_sgd as jopt
from dear_pytorch_tpu.parallel import dear as jdear
from dear_pytorch_tpu_torch.models.convert import resnet_params_from_jax
from tests.test_torch_dear import ROOT, spawn_ranks

STEPS, B, SIZE = 3, 4, 33
CFG = {"stages": [1, 1, 1], "width": 8, "classes": 5}
THRESHOLD_MB = 0.02      # ~20 KB buckets: several of them
TOL, TOL_BF16 = 1e-5, 2e-4

CASES = {
    "dear": {},
    "comm_bf16": {"comm": "bf16"},
    "accum2": {"accum_steps": 2},
}
WORLD2_CASES = {
    "dear": {},
    "dear-fused": {"mode": "dear-fused"},
    "unsynced": {"template": []},       # no model state: no sync
}


def _flax_model():
    return jres.ResNet(stage_sizes=tuple(CFG["stages"]),
                       block=jres.BottleneckBlock,
                       num_classes=CFG["classes"], width=CFG["width"])


def _variables():
    """Flax init with every BN's scale, bias, mean and var redrawn from a
    numpy seed (no branch switched off by a zero last-BN scale)."""
    v = _flax_model().init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    rs = np.random.RandomState(10)

    def redraw(tree, ranges):
        if isinstance(tree, dict):
            return {k: (rs.uniform(*ranges[k], x.shape).astype(np.float32)
                        if k in ranges else redraw(x, ranges))
                    for k, x in tree.items()}
        return np.asarray(tree)

    params = redraw(jax.tree.map(np.asarray, v["params"]),
                    {"scale": (0.5, 1.5), "bias": (-0.3, 0.3)})
    stats = redraw(jax.tree.map(np.asarray, v["batch_stats"]),
                   {"mean": (-0.2, 0.2), "var": (0.6, 1.4)})
    return params, stats


def _batch():
    rs = np.random.RandomState(5)
    return (rs.randn(B, 3, SIZE, SIZE).astype(np.float32),
            rs.randint(0, CFG["classes"], B))


def _tol(opts):
    return TOL_BF16 if opts.get("comm") else TOL


def _run_jax(opts, world, params, stats, x, y):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("dp",))
    model = _flax_model()

    def loss_fn(p, ms, b):
        logits, new = model.apply({"params": p, **ms}, b["image"],
                                  train=True, mutable=["batch_stats"])
        return jdata.softmax_xent(logits, b["label"]), new

    ts = jdear.build_train_step(
        loss_fn, params, optimizer=jopt.fused_sgd(lr=0.01, momentum=0.9),
        mesh=mesh, mode=opts.get("mode", "dear"), threshold_mb=THRESHOLD_MB,
        comm_dtype=jnp.bfloat16 if opts.get("comm") else None,
        accum_steps=opts.get("accum_steps", 1),
        model_state_template={"batch_stats": stats})
    state = ts.init(jax.tree.map(jnp.copy, params),
                    {"batch_stats": jax.tree.map(jnp.copy, stats)})
    batch = {"image": jnp.asarray(x.transpose(0, 2, 3, 1)),
             "label": jnp.asarray(y)}
    losses = []
    for _ in range(STEPS):
        state, m = ts.step(state, batch)
        losses.append(float(m["loss"]))
    final = resnet_params_from_jax(
        jax.tree.map(np.asarray, ts.gather_params(state)),
        jax.tree.map(np.asarray, state.model_state["batch_stats"]),
        stage_sizes=CFG["stages"])
    return losses, {k: v.numpy() for k, v in final.items()}


# the port's side: build, init, 3 steps, gather. The world-2 worker below
# runs its source in a jax-free process, so it imports what it needs itself
def run_port(opts, group, rank, world, state_dict, x, y, cfg):
    import torch
    from dear_pytorch_tpu_torch.models import resnet as tres
    from dear_pytorch_tpu_torch.models.data import softmax_xent
    from dear_pytorch_tpu_torch.ops import fused_sgd as topt
    from dear_pytorch_tpu_torch.parallel import dear as tdear

    model = tres.ResNet(cfg["stages"], tres.BottleneckBlock,
                        num_classes=cfg["classes"], width=cfg["width"],
                        device="cpu")
    model.load_state_dict(state_dict)

    def loss_fn(m, b):
        return softmax_xent(m(b["image"]), b["label"])

    ts = tdear.build_train_step(
        loss_fn, model, optimizer=topt.fused_sgd(lr=0.01, momentum=0.9),
        group=group, device="cpu", mode=opts.get("mode", "dear"),
        threshold_mb=0.02,
        comm_dtype=torch.bfloat16 if opts.get("comm") else None,
        accum_steps=opts.get("accum_steps", 1),
        model_state_template=opts.get("template"))
    per = x.shape[0] // world
    batch = {"image": torch.from_numpy(x[rank * per:(rank + 1) * per]),
             "label": torch.from_numpy(y[rank * per:(rank + 1) * per])}
    state = ts.init()
    losses = []
    for _ in range(3):
        state, m = ts.step(state, batch)
        losses.append(float(m["loss"]))
    final = {k: v.numpy() for k, v in ts.gather_params(state).items()}
    final.update({k: v.numpy() for k, v in model.named_buffers()})
    counts = (ts.plan.num_buckets, ts.rs_launches, ts.ag_launches,
              ts.update_launches, ts.state_syncs)
    ts.close()
    return losses, final, counts


@pytest.fixture(scope="module")
def variables():
    return _variables()


@pytest.fixture(scope="module")
def state_dict(variables):
    return resnet_params_from_jax(*variables, stage_sizes=CFG["stages"])


@pytest.fixture(scope="module")
def group():
    from dear_pytorch_tpu_torch.comm import backend

    return backend.init("cpu")


def _compare(opts, losses, final, want, init, tracked):
    tol = _tol(opts)
    jlosses, jfinal = want
    np.testing.assert_allclose(losses, jlosses, rtol=tol, atol=tol)
    assert losses[-1] < losses[0]
    counters = {k for k in final if k.endswith("num_batches_tracked")}
    assert sorted(set(final) - counters) == sorted(k for k in jfinal if k
                                                   not in counters)
    for k in counters:     # flax keeps no count: the port counts forwards
        assert int(final[k]) == tracked, k
    moved = {"param": 0.0, "stat": 0.0}
    for name in set(final) - counters:
        np.testing.assert_allclose(final[name], jfinal[name], rtol=tol,
                                   atol=tol, err_msg=name)
        kind = "stat" if ".running_" in name else "param"
        moved[kind] = max(moved[kind], float(np.abs(
            final[name] - init[name].numpy()).max()))
    # the comparison is not of the init
    assert min(moved.values()) > 100 * tol, moved


@pytest.mark.parametrize("case", sorted(CASES))
def test_world1_matches_jax(case, variables, state_dict, group):
    opts = CASES[case]
    x, y = _batch()
    losses, final, counts = run_port(opts, group, 0, 1, state_dict, x, y,
                                     CFG)
    want = _run_jax(opts, 1, *variables, x, y)
    _compare(opts, losses, final, want, state_dict,
             STEPS * opts.get("accum_steps", 1))
    n_buckets, rs, ag, upd, syncs = counts
    assert n_buckets >= 3
    assert rs == upd == STEPS * n_buckets      # one of each per bucket
    assert ag == (STEPS + 1) * n_buckets       # + init's gathers
    assert syncs == 0                          # world 1: nothing to sync


_WORKER = '''
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.comm import backend
{port_run}
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store")
group = backend.init("cpu")
assert backend.size() == world and backend.rank() == rank
inputs = np.load(out + "/inputs.npz")
state_dict = {{k[3:]: torch.from_numpy(inputs[k]) for k in inputs.files
               if k.startswith("sd.")}}
cfg = json.loads(open(out + "/cfg.json").read())
cases = json.loads(open(out + "/cases.json").read())
for name, opts in sorted(cases.items()):
    losses, final, counts = run_port(opts, group, rank, world, state_dict,
                                     inputs["x"], inputs["y"], cfg)
    np.savez(f"{{out}}/{{name}}.rank{{rank}}.npz", losses=np.array(losses),
             counts=np.array(counts),
             **{{"p." + k: v for k, v in final.items()}})
backend.shutdown()
'''


@pytest.fixture(scope="module")
def world2_results(tmp_path_factory, state_dict):
    out = str(tmp_path_factory.mktemp("dear_resnet_world2"))
    x, y = _batch()
    np.savez(os.path.join(out, "inputs.npz"), x=x, y=y,
             **{"sd." + k: v.numpy() for k, v in state_dict.items()})
    with open(os.path.join(out, "cfg.json"), "w") as f:
        json.dump(CFG, f)
    with open(os.path.join(out, "cases.json"), "w") as f:
        json.dump(WORLD2_CASES, f)
    code = _WORKER.format(root=ROOT, port_run=inspect.getsource(run_port))
    spawn_ranks(code, 2, out)

    def load(case):
        ranks = [np.load(os.path.join(out, f"{case}.rank{r}.npz"))
                 for r in range(2)]
        return [{k: r[k] for k in r.files} for r in ranks]

    return {case: load(case) for case in WORLD2_CASES}


@pytest.mark.parametrize("case", ["dear", "dear-fused"])
def test_world2_matches_jax(case, world2_results, variables, state_dict):
    opts = WORLD2_CASES[case]
    r0, r1 = world2_results[case]
    for key in r0:   # every rank reports the same loss, params and stats
        np.testing.assert_array_equal(r1[key], r0[key], err_msg=key)
    final = {k[2:]: v for k, v in r0.items() if k.startswith("p.")}
    x, y = _batch()
    want = _run_jax(opts, 2, *variables, x, y)
    _compare(opts, list(r0["losses"]), final, want, state_dict, STEPS)
    n_buckets, rs, ag, upd, syncs = r0["counts"]
    assert n_buckets >= 3 and rs == upd == STEPS * n_buckets
    assert syncs == STEPS                      # one collective per step


def test_world2_without_model_state_the_ranks_statistics_differ(
        world2_results):
    """``model_state_template=[]``: no sync runs, the parameters still
    agree (they follow the reduced gradients) and each rank keeps the
    statistics of its own half of the batch; their mean is the synced
    run's."""
    r0, r1 = world2_results["unsynced"]
    assert r0["counts"][4] == 0
    stats = [k for k in r0 if ".running_" in k]
    params = [k for k in r0 if k.startswith("p.") and k not in stats]
    for k in params:
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)
    assert max(float(np.abs(r0[k] - r1[k]).max()) for k in stats) > 1e-3
    # the running update is linear and the parameters do not depend on
    # it, so the synced run's statistics are the mean of the unsynced ranks'
    synced = world2_results["dear"][0]
    for k in stats:
        np.testing.assert_allclose(synced[k], (r0[k] + r1[k]) / 2,
                                   rtol=TOL, atol=TOL, err_msg=k)
