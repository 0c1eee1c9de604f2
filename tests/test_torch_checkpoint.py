"""The port's checkpoints (dear_pytorch_tpu_torch.utils.checkpoint) against
the JAX package's, on the CPU.

  - the local format both ways: a blob the port's `local_save` writes
    loads through JAX's `local_restore` bit for bit (fp32, bf16, int64,
    int32, bool, 0-dim), and a JAX-written blob loads through the port's;
  - both packages build the same manifest over the same step directory,
    and their `valid_steps` / `latest_valid_step` walk past the same
    corrupted step of a port-written directory;
  - `plan_fingerprint` and `plan_desc` of a port plan over the MLP's
    leaves in JAX's leaf order equal JAX's;
  - port only: k steps, a checkpoint, a fresh `TrainStep`, a restore and
    N - k more steps end bitwise equal to N straight steps — the masters,
    the momentum, the BN buffers of a one-BN-layer CNN and the
    error-feedback residual and velocity of ``eftopk`` with momentum
    correction; an asynchronous save at step k holds step k's masters
    although step k + 1 updated them in place before the writer ran (the
    writer held back with an event); `elastic_restore` across a threshold
    change; the sidecar's pipeline state; the 9c refusals.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dear_pytorch_tpu.ops import fusion as jF
from dear_pytorch_tpu.utils import checkpoint as jckpt
from dear_pytorch_tpu_torch.ops import fusion as F
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.parallel import dear as tdear
from dear_pytorch_tpu_torch.resilience import inject as INJ
from dear_pytorch_tpu_torch.utils import checkpoint as ckpt

from tests.test_dear_numerics import _mlp_params
from tests.test_torch_multi_step import TorchMLP, mlp_loss, mlp_problem


@pytest.fixture(scope="module")
def group():
    from dear_pytorch_tpu_torch.comm import backend

    return backend.init("cpu")


class BNNet(nn.Module):
    """A one-BN-layer CNN: conv 3x3 (1 -> 4), BatchNorm, ReLU, mean pool,
    linear (4 -> 3)."""

    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.conv = nn.Conv2d(1, 4, 3)
        self.bn = nn.BatchNorm2d(4)
        self.fc = nn.Linear(4, 3)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)

    @property
    def device(self):
        return self.fc.weight.device

    def forward(self, x):
        h = torch.relu(self.bn(self.conv(x)))
        return self.fc(h.mean((2, 3)))


def bn_loss(m, b):
    return nn.functional.cross_entropy(m(b["x"]), b["y"])


def bn_batches(n, seed=3):
    rng = np.random.RandomState(seed)
    return [{"x": torch.from_numpy(rng.randn(8, 1, 6, 6).astype(np.float32)),
             "y": torch.from_numpy(rng.randint(0, 3, 8))} for _ in range(n)]


def bn_step(group, **kw):
    kw.setdefault("optimizer", topt.fused_sgd(lr=0.1, momentum=0.9))
    kw.setdefault("threshold_mb", 0.00005)
    return tdear.build_train_step(bn_loss, BNNet(), group=group,
                                  device="cpu", **kw)


def snapshot(ts, state) -> dict:
    """Everything a resume must carry, as CPU copies."""
    out = {f"shard{g}": s.clone() for g, s in enumerate(state.shards)}
    for g, o in enumerate(state.opt_state):
        for k, v in o.items():
            out[f"opt{g}.{k}"] = v.clone() if torch.is_tensor(v) else v
    for g, c in enumerate(state.comp_state):
        for k, v in (c.items() if isinstance(c, dict) else [("res", c)]):
            out[f"comp{g}.{k}"] = v.clone()
    for n, b in ts.model.named_buffers():
        out[f"buf.{n}"] = b.clone()
    out["step"] = int(state.step)
    return out


def assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# the local format, both ways
# ---------------------------------------------------------------------------


def _leaves():
    rng = np.random.RandomState(1)
    return [torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
            torch.from_numpy(rng.randn(7).astype(np.float32)).bfloat16(),
            torch.from_numpy(rng.randint(-9, 9, (2, 2)).astype(np.int64)),
            torch.from_numpy(rng.randint(-9, 9, (4,)).astype(np.int32)),
            torch.tensor([True, False, True]),
            torch.tensor(7, dtype=torch.int64)]


def _raw(x) -> bytes:
    if torch.is_tensor(x):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def test_port_local_save_loads_in_jax_bitwise(tmp_path):
    leaves = _leaves()
    d = str(tmp_path / "step_0000000001")
    ckpt.local_save(d, leaves)
    # host (numpy) template leaves: JAX restores them as numpy, in the
    # blob's own dtypes (a jax.Array template would narrow int64 to int32)
    back = jckpt.local_restore(d, [np.zeros(())] * len(leaves))
    for t, j in zip(leaves, back):
        j = np.asarray(j)
        assert j.shape == tuple(t.shape) and _raw(j) == _raw(t)
        assert str(j.dtype) == str(t.dtype)[6:]


def test_jax_local_save_loads_in_port_bitwise(tmp_path):
    rng = np.random.RandomState(2)
    tree = {"a": jnp.asarray(rng.randn(4, 3).astype(np.float32)),
            "b": jnp.asarray(rng.randn(5).astype(np.float32)).astype(
                jnp.bfloat16),
            "c": jnp.asarray(rng.randint(0, 9, (6,)).astype(np.int32)),
            "d": jnp.asarray(np.int32(3))}
    d = str(tmp_path / "step_0000000002")
    jckpt.local_save(d, tree)
    flat = jax.tree_util.tree_leaves(tree)
    template = [torch.zeros(x.shape, dtype=getattr(torch, str(x.dtype)))
                for x in flat]
    back = ckpt.local_restore(d, template)
    for j, t in zip(flat, back):
        assert tuple(t.shape) == j.shape and _raw(t) == _raw(np.asarray(j))


def test_local_restore_rejects_structure_mismatch(tmp_path):
    d = str(tmp_path / "s")
    ckpt.local_save(d, _leaves())
    with pytest.raises(ValueError, match="different model/optimizer"):
        ckpt.local_restore(d, _leaves()[:2])


# ---------------------------------------------------------------------------
# manifests and the corruption walk
# ---------------------------------------------------------------------------


def _three_checkpoints(tmp_path, group):
    d = str(tmp_path / "ckpts")
    ts = bn_step(group)
    state = ts.init()
    for b in bn_batches(6):
        state, _ = ts.step(state, b)
        if state.step % 2 == 0:
            ckpt.save_checkpoint(d, state, ts)
    ts.close()
    return d


def test_manifest_and_corruption_walk_match_jax(tmp_path, group):
    d = _three_checkpoints(tmp_path, group)
    for s in (2, 4, 6):
        meta = ckpt.read_sidecar(d, s)
        step_dir = os.path.join(d, f"step_{s:010d}")
        assert meta["manifest"] == jckpt._build_manifest(step_dir)
        assert ckpt._build_manifest(step_dir) == jckpt._build_manifest(
            step_dir)
        assert sorted(meta["manifest"]) == ["dear_local.bin",
                                            "dear_local.json"]
    assert ckpt.valid_steps(d) == jckpt.valid_steps(d) == [6, 4, 2]
    assert INJ.corrupt_latest_checkpoint(d) == 6
    assert ckpt.valid_steps(d) == jckpt.valid_steps(d) == [4, 2]
    assert ckpt.latest_valid_step(d) == jckpt.latest_valid_step(d) == 4
    assert ckpt.latest_valid_step(d, below=4) == 2
    assert ckpt.latest_step(d) == jckpt.latest_step(d) == 6
    assert ckpt.prune_future_steps(d, above=4) == [6]
    ckpt.prune_checkpoints(d, max_keep=1)
    assert sorted(os.listdir(d)) == ["meta_0000000004.json",
                                     "step_0000000004"]


def test_plan_fingerprint_in_jax_leaf_order_equals_jax():
    params = _mlp_params(jax.random.PRNGKey(0))
    for world, thr in ((1, 0.0008), (2, 0.0008), (4, None)):
        jplan = jF.make_plan(params, world, threshold_mb=thr)
        leaves = [(s.name, s.shape, torch.float32) for s in jplan.leaves]
        plan = F.make_plan(leaves, world, threshold_mb=thr)
        assert ckpt.plan_fingerprint(plan) == jckpt.plan_fingerprint(jplan)
        assert ckpt.plan_desc(plan) == jckpt.plan_desc(jplan)
        back = ckpt.plan_from_desc(ckpt.plan_desc(plan))
        assert ckpt.plan_fingerprint(back) == ckpt.plan_fingerprint(plan)


# ---------------------------------------------------------------------------
# resume, async snapshots, elastic restore (port only)
# ---------------------------------------------------------------------------

RESUME_KW = {
    "sgd": {},
    "eftopk_mc": {"compressor": "eftopk", "density": 0.5,
                  "momentum_correction": 0.9},
}


@pytest.mark.parametrize("case", sorted(RESUME_KW))
def test_resume_is_bitwise_the_uninterrupted_run(case, tmp_path, group):
    n, k = 6, 3
    batches = bn_batches(n)
    ts = bn_step(group, **RESUME_KW[case])
    state = ts.init()
    for b in batches:
        state, _ = ts.step(state, b)
    want = snapshot(ts, state)
    ts.close()

    d = str(tmp_path / "ckpts")
    ts = bn_step(group, **RESUME_KW[case])
    state = ts.init()
    for b in batches[:k]:
        state, _ = ts.step(state, b)
    ckpt.save_checkpoint(d, state, ts)
    ts.close()

    ts = bn_step(group, **RESUME_KW[case])   # a fresh model and step
    state = ckpt.restore_checkpoint(d, ts, template=ts.init())
    assert state.step == k
    for b in batches[k:]:
        state, _ = ts.step(state, b)
    got = snapshot(ts, state)
    ts.close()
    assert any(k.startswith("buf.bn.running") for k in got)
    if case != "sgd":
        assert any(k.startswith("comp") for k in got)
    assert_bitwise(got, want)


def test_async_save_holds_its_own_step(tmp_path, group):
    d = str(tmp_path / "ckpts")
    batches = bn_batches(3)
    ts = bn_step(group)
    state = ts.init()
    state, _ = ts.step(state, batches[0])
    state, _ = ts.step(state, batches[1])
    at_k = snapshot(ts, state)
    ac = ckpt._get_async_checkpointer()
    ac.hold = threading.Event()
    try:
        ckpt.save_checkpoint(d, state, ts, asynchronous=True)
        assert ckpt.has_async_checkpointer()
        assert not os.path.isdir(os.path.join(d, "step_0000000002"))
        state, _ = ts.step(state, batches[2])   # updates the masters
        assert not torch.equal(state.shards[0], at_k["shard0"])
    finally:
        ac.hold.set()
        ac.hold = None
    ckpt.wait_for_checkpoints()
    assert ckpt.read_sidecar(d, 2)["manifest"] is None   # eager sidecar
    assert ckpt.write_manifest(d, 2) and ckpt.verify_checkpoint(d, 2)
    saved = ckpt._read_rank(os.path.join(d, "step_0000000002"), 0)
    for g in range(len(state.shards)):
        assert torch.equal(saved[f"shards.{g}"], at_k[f"shard{g}"])
        assert torch.equal(saved[f"opt.{g}.buf"], at_k[f"opt{g}.buf"])
    assert int(saved["step"]) == 2
    # the restore puts step 2 back into the live step, in place
    live = state.shards[0]
    state = ckpt.restore_checkpoint(d, ts)
    assert state.shards[0] is live and state.step == 2
    assert_bitwise(snapshot(ts, state),
                   {**at_k, **{k: v for k, v in snapshot(ts, state).items()
                               if k.startswith("buf.")}})
    ts.close()


def test_elastic_restore_across_a_threshold_change(tmp_path, group):
    params, _ = mlp_problem()
    rng = np.random.RandomState(4)
    batches = [{"x": torch.from_numpy(rng.randn(16, 12).astype(np.float32)),
                "y": torch.from_numpy(rng.randint(0, 4, 16))}
               for _ in range(4)]
    opt = topt.fused_sgd(lr=0.05, momentum=0.9)

    def build(thr):
        return tdear.build_train_step(mlp_loss, TorchMLP(params),
                                      group=group, device="cpu",
                                      optimizer=opt, threshold_mb=thr)

    ts = build(0.0008)
    state = ts.init()
    for b in batches:
        state, _ = ts.step(state, b)
    want = ts.gather_params(state)
    ts.close()

    d = str(tmp_path / "ckpts")
    ts = build(0.0008)
    state = ts.init()
    for b in batches[:2]:
        state, _ = ts.step(state, b)
    ckpt.save_checkpoint(d, state, ts)
    ts.close()
    ts = build(None)   # one bucket
    assert ts.plan.num_buckets == 1
    state = ts.init()
    with pytest.raises(ckpt.PlanMismatchError):
        ckpt.restore_checkpoint(d, ts)
    state = ckpt.elastic_restore(d, ts)
    assert state.step == 2 and state.opt_state[0]["initialized"] is True
    for b in batches[2:]:
        state, _ = ts.step(state, b)
    got = ts.gather_params(state)
    ts.close()
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_elastic_restore_carries_the_compressor_state_by_name(tmp_path,
                                                              group):
    """At the same world the residual and velocity of ``eftopk`` with
    momentum correction move to the new plan by parameter name, as do the
    masters, the momentum and the BN buffers."""
    kw = RESUME_KW["eftopk_mc"]
    d = str(tmp_path / "ckpts")
    ts = bn_step(group, **kw)
    state = ts.init()
    for b in bn_batches(2):
        state, _ = ts.step(state, b)
    ckpt.save_checkpoint(d, state, ts)

    def named(ts, state) -> dict:
        out = {f"p.{k}": v for k, v in F.unpack_all(
            list(state.shards), ts.plan, cast=False).items()}
        out.update({f"m.{k}": v for k, v in F.unpack_all(
            [o["buf"] for o in state.opt_state], ts.plan,
            cast=False).items()})
        for key in ("res", "vel"):
            out.update({f"{key}.{k}": v for k, v in F.unpack_all(
                [c[key] for c in state.comp_state], ts.plan,
                cast=False).items()})
        out.update({f"buf.{k}": v.clone()
                    for k, v in ts.model.named_buffers()})
        return {k: v.clone() for k, v in out.items()}

    want = named(ts, state)
    ts.close()
    ts = bn_step(group, threshold_mb=None, **kw)
    assert ts.plan.num_buckets == 1
    state = ckpt.elastic_restore(d, ts, template=ts.init())
    got = named(ts, state)
    ts.close()
    assert state.step == 2 and got.keys() == want.keys()
    assert any(v.abs().sum() > 0 for k, v in got.items()
               if k.startswith("res."))
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_sidecar_carries_pipeline_state_and_epoch(tmp_path, group):
    from dear_pytorch_tpu_torch.runtime import pipeline as P

    from dear_pytorch_tpu_torch.runtime import build as RB

    pipe = P.NumpyPipeline(P.SyntheticSpec((
        P.Field("x", (3,), RB.KIND_NORMAL_F32, 0.0, 1.0),)), seed=5)
    pipe.next()
    ts = bn_step(group)
    state = ts.init()
    d = str(tmp_path / "ckpts")
    ckpt.save_checkpoint(d, state, ts, pipeline_state=pipe.state_dict(),
                         mem_epoch=0)
    ts.close()
    assert ckpt.read_pipeline_state(d, 0) == json.loads(
        json.dumps(pipe.state_dict()))
    assert ckpt.read_mem_epoch(d, 0) == 0
    meta = ckpt.read_sidecar(d, 0)
    assert meta["plan"] == ckpt.plan_fingerprint(ts.plan)


def test_unported_tier_names_item_9b(tmp_path, group):
    """Item 9b ported the object-store tier (an empty store lists no step
    and restores nothing); the DCN state still raises, naming item 9c."""
    from dear_pytorch_tpu_torch.utils.objectstore import LocalObjectStore

    store = LocalObjectStore(str(tmp_path / "remote"))
    assert ckpt.remote_steps(store) == []
    assert ckpt.restore_from_object_store(store, str(tmp_path / "c")) is None
    with pytest.raises(NotImplementedError, match="item 9c"):
        ckpt.read_dcn_state(str(tmp_path), 0)
    ts = bn_step(group)
    with pytest.raises(NotImplementedError, match="item 9c"):
        ckpt.save_checkpoint(str(tmp_path), ts.init(), ts,
                             dcn_state={"residual": 1})
    ts.close()
