"""The port's DeAR train step on a DenseNet and VGG-11 against the JAX
package's ``build_train_step`` on the CPU: 3 steps of the CNN bench's
optimizer (SGD, lr 0.01, momentum 0.9) on the same weights (drawn from a
numpy seed at flax's shapes, tests/test_torch_zoo.py's `draw_variables`,
carried across by `models.convert.densenet_params_from_jax` /
`vgg_params_from_jax`) and the same numpy batch of 4 images, then the
per-step losses, the gathered master parameters and (DenseNet) the BN
running buffers compared by name.

The DenseNet is cut to two dense blocks of three layers (full widths:
growth 32, 64 stem features, a transition between), 32 px images, 10
classes, its BN statistics the step's model state. DenseNet-121 itself is
chaotic at a size the CPU can train here: at 64 px (last map 2x2, B = 4)
the port's own step-3 loss moved by 3.8e-3 when its input was scaled by
1 + 1e-6, and by 2e-5 with flax's BN init, so no fp32 implementation can
be held to 1e-5 there (the CPU run of the DenseNet-121 bench and the card
run train it at full depth). VGG-11 runs on 32 px (fc1 reads a 1x1x512
map), 10 classes, with dropout off (``train=False`` in flax, no generator
in the port): dropout is held to its statistics in tests/test_torch_zoo.py,
not to JAX's masks. World 1 runs in this process over a single-rank gloo
group; world 2 as two jax-free processes (tests/test_torch_dear.py's
`spawn_ranks`, one spawn for every case), each on its half of the batch,
against JAX on a 2-device mesh.

Tolerances (ROADMAP Queue 3's, as tests/test_torch_dear_resnet.py): 1e-5
in fp32; 2e-4 where gradients travel in bf16 (``comm_bf16``, at lr 0.05 so
that the parameters move well past the tolerance).
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
from dear_pytorch_tpu.models import densenet as jdense
from dear_pytorch_tpu.models import vgg as jvgg
from dear_pytorch_tpu.ops import fused_sgd as jopt
from dear_pytorch_tpu.parallel import dear as jdear
from dear_pytorch_tpu_torch.models import convert as tconvert
from tests import test_torch_zoo as zoo
from tests.test_torch_zoo import few_threads  # noqa: F401 (autouse)
from tests.test_torch_dear import ROOT, spawn_ranks

STEPS, B, CLASSES = 3, 4, 10
THRESHOLD_MB = 1.0       # several buckets
TOL, TOL_BF16 = 1e-5, 2e-4

#: model -> (flax model, image size)
MODELS = {"densenet": (lambda: jdense.DenseNet((3, 3), num_classes=CLASSES),
                       32),
          "vgg11": (lambda: jvgg.VGG11(num_classes=CLASSES), 32)}
CASES = {"densenet": {}, "vgg11": {}, "vgg11-comm_bf16": {"comm": "bf16", "lr": 0.05}}
WORLD2_CASES = {"densenet": {}, "vgg11": {}}


def _model(case):
    return case.split("-")[0]


@pytest.fixture(scope="module")
def variables():
    """Per model the weights of tests/test_torch_zoo.py's `flax_variables`
    at this test's image size, and the port's state_dict of them."""
    out = {}
    for name, (jm, size) in MODELS.items():
        params, stats = zoo.draw_variables(jm, size, 3,
                                           name.startswith("densenet"))
        sd = (tconvert.densenet_params_from_jax(params, stats) if stats
              else tconvert.vgg_params_from_jax(params))
        out[name] = (params, stats, sd)
    return out


def _batch(name):
    size = MODELS[name][1]
    rs = np.random.RandomState(5)
    return (rs.randn(B, 3, size, size).astype(np.float32),
            rs.randint(0, CLASSES, B))


def _run_jax(name, opts, world, params, stats, x, y):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("dp",))
    model = MODELS[name][0]()
    kw = {}
    if stats is not None:
        def loss_fn(p, ms, b):
            logits, new = model.apply({"params": p, **ms}, b["image"],
                                      train=True, mutable=["batch_stats"])
            return jdata.softmax_xent(logits, b["label"]), new
        kw["model_state_template"] = {"batch_stats": stats}
    else:
        def loss_fn(p, b):   # VGG: train=False is dropout off (no BN)
            return jdata.softmax_xent(
                model.apply({"params": p}, b["image"], train=False),
                b["label"])
    ts = jdear.build_train_step(
        loss_fn, params, optimizer=jopt.fused_sgd(lr=opts.get("lr", 0.01),
                                                  momentum=0.9),
        mesh=mesh, mode="dear", threshold_mb=THRESHOLD_MB,
        comm_dtype=jnp.bfloat16 if opts.get("comm") else None, **kw)
    state = (ts.init(jax.tree.map(jnp.copy, params),
                     {"batch_stats": jax.tree.map(jnp.copy, stats)})
             if stats is not None else ts.init(jax.tree.map(jnp.copy,
                                                            params)))
    batch = {"image": jnp.asarray(x.transpose(0, 2, 3, 1)),
             "label": jnp.asarray(y)}
    losses = []
    for _ in range(STEPS):
        state, m = ts.step(state, batch)
        losses.append(float(m["loss"]))
    gathered = jax.tree.map(np.asarray, ts.gather_params(state))
    final = (tconvert.densenet_params_from_jax(
        gathered, jax.tree.map(np.asarray,
                               state.model_state["batch_stats"]))
             if stats is not None else tconvert.vgg_params_from_jax(gathered))
    return losses, {k: v.numpy() for k, v in final.items()}


# the port's side: build, init, 3 steps, gather. The world-2 worker below
# runs its source in a jax-free process, so it imports what it needs itself
def run_port(name, opts, group, rank, world, state_dict, x, y):
    import torch
    from dear_pytorch_tpu_torch.models import densenet, vgg
    from dear_pytorch_tpu_torch.models.data import softmax_xent
    from dear_pytorch_tpu_torch.ops import fused_sgd as topt
    from dear_pytorch_tpu_torch.parallel import dear as tdear

    if name == "densenet":
        model = densenet.DenseNet((3, 3), num_classes=10, device="cpu")
    else:
        model = vgg.VGG11(num_classes=10, image_size=x.shape[-1],
                          device="cpu")
    model.load_state_dict(state_dict)

    def loss_fn(m, b):
        return softmax_xent(m(b["image"]), b["label"])

    ts = tdear.build_train_step(
        loss_fn, model, optimizer=topt.fused_sgd(lr=opts.get("lr", 0.01),
                                                 momentum=0.9),
        group=group, device="cpu", mode="dear", threshold_mb=1.0,
        comm_dtype=torch.bfloat16 if opts.get("comm") else None)
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
    counts = (ts.plan.num_buckets, ts.rs_launches, ts.update_launches,
              ts.state_syncs)
    ts.close()
    return losses, final, counts


@pytest.fixture(scope="module")
def group():
    from dear_pytorch_tpu_torch.comm import backend

    return backend.init("cpu")


def _compare(opts, losses, final, want, init, has_bn):
    tol = TOL_BF16 if opts.get("comm") else TOL
    jlosses, jfinal = want
    np.testing.assert_allclose(losses, jlosses, rtol=tol, atol=tol)
    assert losses[-1] < losses[0]
    counters = {k for k in final if k.endswith("num_batches_tracked")}
    assert sorted(set(final) - counters) == sorted(k for k in jfinal
                                                   if k not in counters)
    assert all(int(final[k]) == STEPS for k in counters)
    moved = {"param": 0.0, "stat": 0.0 if has_bn else 1.0}
    for name in set(final) - counters:
        np.testing.assert_allclose(final[name], jfinal[name], rtol=tol,
                                   atol=tol, err_msg=name)
        kind = "stat" if ".running_" in name else "param"
        moved[kind] = max(moved[kind], float(np.abs(
            final[name] - init[name].numpy()).max()))
    assert min(moved.values()) > 100 * tol, moved   # not the init


@pytest.mark.parametrize("case", sorted(CASES))
def test_world1_matches_jax(case, variables, group):
    name, opts = _model(case), CASES[case]
    params, stats, sd = variables[name]
    x, y = _batch(name)
    losses, final, counts = run_port(name, opts, group, 0, 1, sd, x, y)
    want = _run_jax(name, opts, 1, params, stats, x, y)
    _compare(opts, losses, final, want, sd, stats is not None)
    n_buckets, rs, upd, syncs = counts
    assert n_buckets >= 2 and rs == upd == STEPS * n_buckets
    assert syncs == 0


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
cases = json.loads(open(out + "/cases.json").read())
for case, opts in sorted(cases.items()):
    name = case.split("-")[0]
    inputs = np.load(out + f"/{{name}}.npz")
    state_dict = {{k[3:]: torch.from_numpy(inputs[k]) for k in inputs.files
                   if k.startswith("sd.")}}
    losses, final, counts = run_port(name, opts, group, rank, world,
                                     state_dict, inputs["x"], inputs["y"])
    np.savez(f"{{out}}/{{case}}.rank{{rank}}.npz", losses=np.array(losses),
             counts=np.array(counts),
             **{{"p." + k: v for k, v in final.items()}})
backend.shutdown()
'''


@pytest.fixture(scope="module")
def world2_results(tmp_path_factory, variables):
    out = str(tmp_path_factory.mktemp("dear_zoo_world2"))
    for name in MODELS:
        x, y = _batch(name)
        np.savez(os.path.join(out, f"{name}.npz"), x=x, y=y,
                 **{"sd." + k: v.numpy()
                    for k, v in variables[name][2].items()})
    with open(os.path.join(out, "cases.json"), "w") as f:
        json.dump(WORLD2_CASES, f)
    code = _WORKER.format(root=ROOT, port_run=inspect.getsource(run_port))
    spawn_ranks(code, 2, out)

    def load(case):
        ranks = [np.load(os.path.join(out, f"{case}.rank{r}.npz"))
                 for r in range(2)]
        return [{k: r[k] for k in r.files} for r in ranks]

    return {case: load(case) for case in WORLD2_CASES}


@pytest.mark.parametrize("case", sorted(WORLD2_CASES))
def test_world2_matches_jax(case, world2_results, variables):
    name, opts = _model(case), WORLD2_CASES[case]
    params, stats, sd = variables[name]
    r0, r1 = world2_results[case]
    for key in r0:   # every rank reports the same loss, params and stats
        np.testing.assert_array_equal(r1[key], r0[key], err_msg=key)
    final = {k[2:]: v for k, v in r0.items() if k.startswith("p.")}
    x, y = _batch(name)
    want = _run_jax(name, opts, 2, params, stats, x, y)
    _compare(opts, list(r0["losses"]), final, want, sd, stats is not None)
    n_buckets, rs, upd, syncs = r0["counts"]
    assert n_buckets >= 2 and rs == upd == STEPS * n_buckets
    assert syncs == (STEPS if stats is not None else 0)
