"""The port's hierarchical (multi-slice) step, ``build_train_step(...,
dcn=)``, against the JAX package's on the CPU.

  - four fresh jax-free gloo ranks form 2 slices x 2 ranks
    (`comm.backend.form_slice_groups`) and train JAX's MLP
    (tests/test_multislice.py:40-71, converted) for 5 steps over a
    `FileTransport` DCN leg; the losses and the gathered parameters are
    held within 1e-5 against JAX's hierarchical step at 2 x 2 (four of the
    eight CPU devices, ``local_slices=(0, 1)`` on a `LocalTransport`) and
    against the port's flat ``dear`` at world 4, run in the same spawn;
  - the build guards give JAX's messages, in JAX's order
    (tests/test_multislice.py:115-152), and ``multi_step`` refuses;
  - the dropout streams fold ``slice * world + rank``: rank r's generator
    of the hierarchical step is the flat step's rank-r generator, so the
    same position of two slices draws different masks;
  - a ``dcn`` sidecar written by either package reads back in the other;
  - `AutoTuner.rescale` to slice 0 alone and back keeps each survivor's
    shards bitwise, counts ``dcn.renorms`` and rebinds the step to the new
    epoch's slice group; the fleet trains on after a common restore;
  - one ICI rank's `DcnPeerTimeout` raises on both ranks of its slice, and
    its peer issues no update, while the other slice steps on; an
    exchange error that is not a `DcnError` (an `OSError`) is one
    `DcnError` on both ranks of its slice;
  - the guard re-raises `DcnSelfEvict` and defers a `DcnError`.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dear_pytorch_tpu.comm import dcn as jdcn
from dear_pytorch_tpu.ops.fused_sgd import fused_sgd as jfused_sgd
from dear_pytorch_tpu.parallel import dear as jD
from dear_pytorch_tpu.resilience import cluster as jCL
from dear_pytorch_tpu.utils import checkpoint as jckpt
from dear_pytorch_tpu_torch.comm import dcn as tdcn
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.parallel import dear as tdear
from dear_pytorch_tpu_torch.resilience import cluster as tCL
from dear_pytorch_tpu_torch.utils import checkpoint as ckpt

from tests.test_multislice import _loss_fn, _mlp_params
from tests.test_torch_dear import ROOT, spawn_ranks

#: the port's tolerance for fp32 DeAR steps (ROADMAP)
TOL = 1e-5
STEPS = 5
THRESHOLD_MB, PARTITION_MB = 0.0002, 0.0001


class SliceMLP(nn.Module):
    """JAX's multislice MLP (tanh 12 -> 16 -> 4, the squared output's
    mean) with JAX's parameter names and values."""

    def __init__(self, params, buffer=False):
        super().__init__()
        for k in sorted(params):
            setattr(self, k, nn.Parameter(torch.from_numpy(
                np.array(params[k], np.float32))))
        if buffer:
            self.register_buffer("n", torch.zeros(()))

    @property
    def device(self):
        return self.w1.device

    def forward(self, x):
        h = torch.tanh(x @ self.w1 + self.b1)
        return torch.mean(torch.square(h @ self.w2 + self.b2))


def slice_loss(m, b):
    return m(b["x"])


def _params_np():
    return {k: np.asarray(v) for k, v in
            _mlp_params(jax.random.PRNGKey(0)).items()}


def _batch_np():
    return np.asarray(jax.random.normal(jax.random.PRNGKey(7), (16, 12)))


@pytest.fixture(scope="module")
def jax_hier():
    """JAX's hierarchical step at 2 slices x 2 ICI devices: per step the
    loss, then the gathered parameters."""
    params = _mlp_params(jax.random.PRNGKey(0))
    devs = np.asarray(jax.devices()[:4])
    dcn = jdcn.DcnExchanger(jCL.LocalTransport(), local_slices=(0, 1),
                            slices=(0, 1), partition_mb=PARTITION_MB)
    ts = jD.build_train_step(
        _loss_fn, params,
        mesh=jax.sharding.Mesh(devs.reshape(2, 2), ("slice", "ici")),
        axis_name="ici", threshold_mb=THRESHOLD_MB, donate=False,
        optimizer=jfused_sgd(lr=0.05, momentum=0.9), dcn=dcn,
        dcn_slice_axis="slice", partition_mb=PARTITION_MB)
    state = ts.init(params)
    batch = {"x": jnp.asarray(_batch_np())}
    losses = []
    from dear_pytorch_tpu.observability import tracer as jT

    prev = jT._tracer
    tracer = jT.Tracer([jT.MemoryExporter()])
    jT.set_tracer(tracer)
    try:
        for _ in range(STEPS):
            state, m = ts.step(state, batch)
            losses.append(float(m["loss"]))
    finally:
        jT.set_tracer(prev)
    final = {k: np.asarray(v)
             for k, v in jax.device_get(ts.gather_params(state)).items()}
    assert dcn.exchanges == STEPS
    counters = {k: v for k, v in tracer.counters().items()
                if k.startswith(("dear.", "dcn.exchanges", "dcn.chunks"))}
    return losses, final, ts, state, counters


_WORKER = '''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import dcn as tdcn
from dear_pytorch_tpu_torch.observability import tracer as T
from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd
from dear_pytorch_tpu_torch.parallel import dear as D
from dear_pytorch_tpu_torch.resilience.cluster import FileTransport
from dear_pytorch_tpu_torch.resilience.membership import MembershipView
from dear_pytorch_tpu_torch.tuning.autotune import AutoTuner
from torch import nn
{model_src}
def slice_loss(m, b, g=None):
    return m(b["x"])
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store",
                  DEAR_ELASTIC_RANKS_PER_SLICE="2")
tracer = T.Tracer([T.MemoryExporter()])
T.set_tracer(tracer)
inp = np.load(out + "/inputs.npz")
params = {{k[2:]: inp[k] for k in inp.files if k.startswith("p.")}}
x = torch.from_numpy(inp["x"][4 * rank:4 * rank + 4])
batch = {{"x": x}}
res = {{}}


def run(ts, n):
    state, losses = ts.init(), []
    for _ in range(n):
        state, m = ts.step(state, batch)
        losses.append(float(m["loss"]))
    return state, losses


def gathered(ts, state):
    return {{k: v.numpy() for k, v in ts.gather_params(state).items()}}


group = backend.init("cpu")
opt = dict(optimizer=fused_sgd(lr=0.05, momentum=0.9),
           threshold_mb={thr}, device="cpu")
# the flat dear step at world 4
flat = D.build_train_step(slice_loss, SliceMLP(params), group=group,
                          rng_seed=3, **opt)
state, res["flat_losses"] = run(flat, {steps})
for k, v in gathered(flat, state).items():
    res["flat." + k] = v
res["flat_draw"] = torch.rand(4, generator=flat._generator(0, 0)).numpy()
flat.close()
# the hierarchical step at 2 slices x 2 ranks
sg = backend.form_slice_groups(2)
sid = backend.slice_id()
assert sid == rank // 2 and backend.ici_index() == rank % 2
dcn = tdcn.DcnExchanger(FileTransport(out + "/dcn"), local_slices=(sid,),
                        slices=(0, 1), partition_mb={part}, timeout_s=60)
tuner = AutoTuner(slice_loss, SliceMLP(params), strategy="bo",
                  interval=10**9, dcn=dcn, partition_mb={part}, rng_seed=3,
                  **opt)
ts = tuner.ts
assert ts.group is sg and ts.world == 2 and ts.rank == rank % 2
before = dict(tracer.counters())
state, res["hier_losses"] = run(ts, {steps})
res["counters"] = {{k: v - before.get(k, 0)
                   for k, v in tracer.counters().items()
                   if k.startswith(("dear.", "dcn.exchanges", "dcn.chunks"))
                   and v - before.get(k, 0)}}
for k, v in gathered(ts, state).items():
    res["hier." + k] = v
res["hier_draw"] = torch.rand(4, generator=ts._generator(0, 0)).numpy()
res["exchanges"] = dcn.exchanges
res["counts"] = [ts.rs_launches, ts.ag_launches, ts.update_launches]
res["dcn_bytes"] = ts.dcn_bytes
try:
    ts.multi_step(2)
except ValueError as exc:
    res["multi_step"] = str(exc)

# rescale to slice 0 alone (epoch 1), then back to both slices (epoch 2)
saved = ([s.clone() for s in state.shards],
         [{{k: (v.clone() if torch.is_tensor(v) else v) for k, v in o.items()}}
          for o in state.opt_state])
store = dist.FileStore(out + "/elastic_store", -1)
renorms0 = tracer.counters().get("dcn.renorms", 0)
if sid == 0:
    v1 = MembershipView(epoch=1, members=(0, 1), rank=rank, index=rank,
                        world=2, slices=(0,), slice_id=0)
    before = [s.clone() for s in tuner.ts.last_state.shards]
    assert tuner.rescale(v1, store=store) is None
    assert tuner.ts is ts and ts.group is backend.slice_group()
    assert ts.plan.epoch == 1 and dcn.slices == (0,) and dcn.epoch == 1
    res["e1_bitwise"] = all(torch.equal(a, b) for a, b in
                            zip(before, ts.last_state.shards))
    _, m = ts.step(ts.last_state, batch)   # degraded: slice 0 alone
    res["e1_loss"] = float(m["loss"])
v2 = MembershipView(epoch=2, members=(0, 1, 2, 3), rank=rank, index=rank,
                    world=4, slices=(0, 1), slice_id=sid)
before = [s.clone() for s in ts.last_state.shards]
assert tuner.rescale(v2, store=store) is None
assert tuner.ts is ts and ts.group is backend.slice_group()
assert ts.plan.epoch == 2 and dcn.slices == (0, 1) and dcn.epoch == 2
res["e2_bitwise"] = all(torch.equal(a, b) for a, b in
                        zip(before, ts.last_state.shards))
res["renorms"] = tracer.counters().get("dcn.renorms", 0) - renorms0
# the guard's restore: every rank back at step {steps}, then one more step
state = ts.load_state(ts.last_state, shards=saved[0], opt_state=saved[1],
                      step={steps})
state, m = ts.step(state, batch)
res["e2_loss"] = float(m["loss"])

# one ICI rank's exchange fails: both ranks of slice 0 raise, rank 0
# having fetched its means, and neither updates; slice 1 steps on
if rank == 1:
    def failing(*a, **k):
        raise tdcn.DcnPeerTimeout("slice 1 never published (injected)")
    dcn.exchange = failing
shards = [s.clone() for s in state.shards]
u0 = ts.update_launches
try:
    ts.step(state, batch)
    res["fail"] = None
except tdcn.DcnError as exc:
    res["fail"] = [type(exc).__name__, str(exc)]
res["fail_updates"] = ts.update_launches - u0
res["fail_untouched"] = all(torch.equal(a, b)
                            for a, b in zip(shards, state.shards))

# an exchange error that is not a DcnError (a transport's OSError) on
# rank 0 while rank 1's exchange returns: both raise a DcnError, rank 0's
# wrapping its OSError, and neither updates (slice 0 steps alone here)
if sid == 0:
    real = [np.zeros(b.padded_size, np.float32) for b in ts.plan.buckets]
    def transport_fails(*a, **k):
        if rank == 0:
            raise OSError("FileTransport write failed (injected)")
        return real, 0.0
    dcn.exchange = transport_fails
    u0 = ts.update_launches
    try:
        ts.step(state, batch)
        res["os_fail"] = None
    except tdcn.DcnError as exc:
        res["os_fail"] = [type(exc).__name__, str(exc),
                          type(exc.__cause__).__name__]
    res["os_fail_updates"] = ts.update_launches - u0
    res["os_fail_untouched"] = all(torch.equal(a, b)
                                   for a, b in zip(shards, state.shards))
tuner.close()
with open(out + "/rank%d.json" % rank, "w") as f:
    json.dump({{k: (v.tolist() if isinstance(v, np.ndarray) else v)
               for k, v in res.items()}}, f)
backend.shutdown()
'''


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The four ranks' results (one spawn: the flat and the hierarchical
    runs, the rescale, the failed exchange)."""
    import inspect

    out = str(tmp_path_factory.mktemp("multislice"))
    np.savez(os.path.join(out, "inputs.npz"), x=_batch_np(),
             **{"p." + k: v for k, v in _params_np().items()})
    code = _WORKER.format(root=ROOT, model_src=inspect.getsource(SliceMLP),
                          thr=THRESHOLD_MB, part=PARTITION_MB, steps=STEPS)
    spawn_ranks(code, 4, out, timeout=240)
    runs = []
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            runs.append(json.load(f))
    return runs


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_hier_matches_jax_hier(port_runs, jax_hier):
    """Losses and parameters of the port's 2 x 2 hierarchical step within
    1e-5 of JAX's for 5 steps; every rank ends with the same parameters."""
    j_losses, j_final, _, _, _ = jax_hier
    for r, run in enumerate(port_runs):
        _close(run["hier_losses"], j_losses)
        for k, v in j_final.items():
            _close(run["hier." + k], v)
        assert run["exchanges"] == STEPS


def test_hier_matches_flat_dear(port_runs):
    """The port's hierarchical step against its own flat ``dear`` at world
    4 (JAX's test_hier_matches_flat_dear), and the per-step counts: B
    reduce-scatters, 2B all-gathers (the reduced buckets and the updated
    shards; the first gathers come from ``init``) and B updates."""
    for run in port_runs:
        _close(run["hier_losses"], run["flat_losses"])
        for k in ("w1", "b1", "w2", "b2"):
            _close(run["hier." + k], run["flat." + k])
        rs, ag, up = run["counts"]
        b = rs // STEPS
        assert rs == STEPS * b and up == STEPS * b and ag == (2 * STEPS + 1) * b
        # the host payload: the fp32 reduced buckets of the slice
        assert run["dcn_bytes"] > 0 and run["dcn_bytes"] % 4 == 0


def test_hier_step_counts_jax_counters(port_runs, jax_hier):
    """With the tracer on, the hierarchical step counts JAX's ``dear.*``
    counters (the steps and the per-leg bytes, the cross-slice ``dcn``
    leg at the build's slice count) and the exchanger JAX's exchanges and
    chunks."""
    want = jax_hier[4]
    assert want.get("dear.steps") == STEPS and "dear.dcn_bytes" in want
    for run in port_runs:
        assert run["counters"] == want


def test_dropout_index_differs_between_slices(port_runs):
    """Rank r of the hierarchical step draws flat rank r's stream: ranks
    at the same position of the two slices draw different masks."""
    for run in port_runs:
        np.testing.assert_array_equal(run["hier_draw"], run["flat_draw"])
    assert not np.array_equal(port_runs[0]["hier_draw"],
                              port_runs[2]["hier_draw"])


def test_multi_step_refuses_with_jax_message(port_runs, jax_hier):
    _, _, jts, _, _ = jax_hier
    with pytest.raises(ValueError) as exc:
        jts.multi_step(2)
    assert all(run["multi_step"] == str(exc.value) for run in port_runs)


def test_rescale_to_one_slice_and_back(port_runs):
    """Slice 0's ranks rescale to epoch 1 (slice 0 alone), take a degraded
    step, and every rank rescales to epoch 2: the rebinds keep the shards
    bitwise, slice 0 counts two renorms and slice 1 none (its slice set
    never moved), and after a common restore the four ranks step on
    together to one loss."""
    for r, run in enumerate(port_runs):
        assert run["e2_bitwise"], r
        if r < 2:
            assert run["e1_bitwise"] and np.isfinite(run["e1_loss"])
            assert run["renorms"] == 2
        else:
            assert run["renorms"] == 0
    assert len({run["e2_loss"] for run in port_runs}) == 1
    assert np.isfinite(port_runs[0]["e2_loss"])


def test_one_ranks_exchange_failure_stops_its_slice(port_runs):
    """Rank 1's exchange raises DcnPeerTimeout: rank 0, whose own exchange
    succeeded, raises it too (the slice's agreement) and neither updates;
    slice 1 completes its step."""
    for r in (0, 1):
        run = port_runs[r]
        assert run["fail"][0] == "DcnPeerTimeout", run["fail"]
        assert "injected" in run["fail"][1]
        assert run["fail_updates"] == 0 and run["fail_untouched"]
    for r in (2, 3):
        assert port_runs[r]["fail"] is None
        assert port_runs[r]["fail_updates"] > 0


def test_a_non_dcn_exchange_error_is_one_dcn_error_on_its_slice(port_runs):
    """Rank 0's exchange raises an OSError (not a DcnError) while rank 1's
    returns: both ranks raise the one class ``DcnError`` naming the
    OSError (rank 0's chained from it), so the guard takes the DCN branch
    on both, and neither updates."""
    for r in (0, 1):
        run = port_runs[r]
        name, msg, cause = run["os_fail"]
        assert name == "DcnError", run["os_fail"]
        assert "OSError" in msg and "injected" in msg
        assert cause == ("OSError" if r == 0 else "NoneType")
        assert run["os_fail_updates"] == 0 and run["os_fail_untouched"]


# -- in-process: the guards, the sidecar, the guard's DCN branches ------------


class _FakeDcn:
    local_slices = (0,)
    num_slices = 2


_GUARD_CASES = [
    ("dear-fused", dict(mode="dear-fused")),
    ("compression", dict(compressor="eftopk", density=0.1)),
    ("clip_norm", dict(clip_norm=1.0)),
    ("model_state", dict(model_state=True)),
    ("has_aux", dict(has_aux=True)),
    ("hierarchical", dict(mode="allreduce")),
    ("mode first", dict(mode="allreduce", compressor="eftopk",
                        density=0.1, clip_norm=1.0)),
    ("compression before clip", dict(compressor="eftopk", density=0.1,
                                     clip_norm=1.0)),
]


@pytest.mark.parametrize("name,kw", _GUARD_CASES,
                         ids=[c[0] for c in _GUARD_CASES])
def test_build_guards_match_jax(name, kw):
    """Each multislice-illegal combination raises JAX's ValueError with
    JAX's message, and the first guard in JAX's order wins."""
    params = _mlp_params(jax.random.PRNGKey(0))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 4),
                             ("slice", "ici"))
    jdcn_ = jdcn.DcnExchanger(jCL.LocalTransport(), local_slices=(0, 1),
                              slices=(0, 1))
    kw = dict(kw)
    with_state = kw.pop("model_state", False)
    jkw = dict(kw, mesh=mesh, axis_name="ici", dcn=jdcn_,
               dcn_slice_axis="slice", threshold_mb=THRESHOLD_MB,
               donate=False)
    if with_state:
        jkw["model_state_template"] = {"n": jnp.zeros(())}
    with pytest.raises(ValueError) as jexc:
        jD.build_train_step(_loss_fn, params, **jkw)
    with pytest.raises(ValueError) as texc:
        tdear.build_train_step(slice_loss, SliceMLP(_params_np(),
                                                    buffer=with_state),
                               dcn=_FakeDcn(), device="cpu", **kw)
    assert str(texc.value) == str(jexc.value)


def test_port_guards_one_local_slice_and_its_group():
    """The JAX package's nested-mesh guards become the port's: one local
    slice, and the slice groups formed."""
    model = SliceMLP(_params_np())
    with pytest.raises(ValueError, match="exactly one local slice"):
        tdear.build_train_step(slice_loss, model, device="cpu",
                               dcn=object())
    with pytest.raises(ValueError, match="form the slice groups first"):
        tdear.build_train_step(slice_loss, model, device="cpu",
                               dcn=_FakeDcn())
    with pytest.raises(ValueError, match="one rank of ONE slice"):
        tdcn.DcnExchanger(tCL.LocalTransport(), local_slices=(0, 1),
                          slices=(0, 1))


def _residual_exchanger(mod, CL):
    ex = mod.DcnExchanger(CL.LocalTransport(), local_slices=(0,),
                          slices=(0, 1), staleness=2)
    rng = np.random.default_rng(5)
    ex._residual = {0: [rng.normal(size=n).astype(np.float32)
                        for n in (12, 5)]}
    ex._staleness = {0: 1, 1: 0}
    return ex


def test_dcn_sidecar_reads_across_packages(tmp_path, jax_hier):
    """A ``dcn`` sidecar JAX writes reads back through the port's
    `read_dcn_state` into a port exchanger bit for bit, and one the port
    writes reads back through JAX's."""
    from dear_pytorch_tpu_torch.comm import backend

    _, _, jts, jstate, _ = jax_hier
    jex = _residual_exchanger(jdcn, jCL)
    d = str(tmp_path / "jax")
    jckpt.save_checkpoint(d, jstate, jts.plan, dcn_state=jex.state_dict())
    step = STEPS
    got = ckpt.read_dcn_state(d, step)
    assert got == json.loads(json.dumps(jex.state_dict()))
    tex = tdcn.DcnExchanger(tCL.LocalTransport(), local_slices=(0,),
                            slices=(0, 1), staleness=2)
    tex.load_state_dict(got)
    for a, b in zip(jex._residual[0], tex._residual[0]):
        np.testing.assert_array_equal(a, b)
    assert tex._staleness == {0: 1, 1: 0}

    group = backend.init("cpu")
    ts = tdear.build_train_step(slice_loss, SliceMLP(_params_np()),
                                group=group, device="cpu",
                                threshold_mb=THRESHOLD_MB)
    tex2 = _residual_exchanger(tdcn, tCL)
    d2 = str(tmp_path / "port")
    ckpt.save_checkpoint(d2, ts.init(), ts, dcn_state=tex2.state_dict())
    assert jckpt.read_dcn_state(d2, 0) == ckpt.read_dcn_state(d2, 0)
    jex2 = jdcn.DcnExchanger(jCL.LocalTransport(), local_slices=(0,),
                             slices=(0, 1), staleness=2)
    jex2.load_state_dict(jckpt.read_dcn_state(d2, 0))
    for a, b in zip(tex2._residual[0], jex2._residual[0]):
        np.testing.assert_array_equal(a, b)
    ts.close()


class _StubTs:
    """A world-1 step whose ``step`` raises the given exception."""

    world, rank, plan, group_lost = 1, 0, None, False

    def __init__(self, exc):
        self.exc, self.abandoned = exc, False
        self.dcn = None

    def step(self, state, batch):
        raise self.exc

    def abandon(self):
        self.abandoned = True


class _StopSync(Exception):
    pass


class _StubCoordinator:
    process_count, supports_membership = 2, True

    def health_check(self, **kw):
        self.kw = kw
        raise _StopSync()


@pytest.mark.parametrize("exc_cls", ["DcnSelfEvict", "DcnPeerTimeout"])
def test_guard_self_evicts_and_defers_a_dcn_error(tmp_path, exc_cls):
    """`DcnSelfEvict` leaves the guard's step (exit for relaunch); a
    dispatched `DcnError` under a coordinator defers to the health sync as
    unhealthy without abandoning the step (JAX guard.py:770-800)."""
    from dear_pytorch_tpu_torch.utils.guard import GuardedTrainer

    exc = getattr(tdcn, exc_cls)("injected")
    ts = _StubTs(exc)
    coord = _StubCoordinator()
    guard = GuardedTrainer(ts, str(tmp_path), check_every=1,
                           coordinator=coord)
    if exc_cls == "DcnSelfEvict":
        with pytest.raises(tdcn.DcnSelfEvict):
            guard.step(None, None)
        assert not hasattr(coord, "kw")
        return
    with pytest.raises(_StopSync):
        guard.step(None, None)
    assert coord.kw["ok"] is False and "group_failed" not in coord.kw
    assert guard._pending_error is exc and not ts.abandoned
    assert guard.steps_seen == 1
