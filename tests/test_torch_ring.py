"""The ring collectives of ``mode="dear-fused"`` in the port
(dear_pytorch_tpu_torch.ops.collective_matmul over comm.ring, and
comm.collectives' send_recv / ring_shift) against the JAX package's Pallas
ring kernels, on the CPU; its world-4 spawn also holds the ring matmul's
distributed plain versions (tests/test_torch_ring_matmul.py) to the
stacked ones.

JAX runs its kernels in interpret mode on a W-device sub-mesh of the
emulated CPU devices (tests/conftest.py), as tests/test_collective_matmul.py
does; the port runs the plain versions its wrappers take for CPU tensors:
the *stacked* form (all W ranks in one process, on a `LocalRing`) and the
*distributed* form (the same hops over gloo, one rank per process).

Tolerances:
  - the all-gather is data movement: bitwise, fp32 and bf16;
  - the reduce-scatter + update: the ring sum is the same fp32 adds in the
    same order in both packages, and the update the same IEEE operations,
    so the result would be bitwise if XLA kept the order. It keeps the
    sum's: SGD at lr 1 (``p - 1.0 * g`` rounds once, FMA or not) is
    bitwise, fp32 and bf16 gradients alike. It does not keep the update's:
    XLA on the CPU contracts products into sums (SGD with momentum, and
    nesterov with weight decay, differ by a few ulp), and some scalars are
    computed differently (the lr schedule: in fp32 on the device in JAX,
    in float64 on the host in the port; AdamW's bias corrections: XLA's
    fp32 pow against numpy's). There the parameters agree within
    FP32_TOL of tests/test_collective_matmul.py:26, bf16 gradients too:
    their conversion to fp32 is exact, so the arithmetic compared is the
    fp32 cases' own;
  - the distributed form against the stacked one: bitwise (the same fp32
    adds on the same CPU).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.comm.backend import DP_AXIS
from dear_pytorch_tpu.ops import collective_matmul as JCM
from dear_pytorch_tpu.ops import fused_sgd as jopt
from dear_pytorch_tpu.ops import schedules as jsched
from dear_pytorch_tpu_torch.comm.ring import LocalRing
from dear_pytorch_tpu_torch.ops import collective_matmul as TCM
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.ops import schedules as tsched
from tests.test_torch_dear import spawn_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_TOL = dict(rtol=2e-5, atol=2e-6)
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mesh(world):
    return jax.sharding.Mesh(np.array(jax.devices()[:world]), (DP_AXIS,))


def _spmd(fn, mesh, n_in, n_out=1):
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(jax.P(DP_AXIS),) * n_in,
        out_specs=(jax.P(DP_AXIS),) * n_out if n_out > 1 else jax.P(DP_AXIS),
        check_vma=False))


def _to_torch(a) -> torch.Tensor:
    """A JAX/numpy array as a torch tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.view(torch.int32).numpy()


# ---------------------------------------------------------------------------
# K4: the ring all-gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_stacked_ring_all_gather_is_bitwise_jax(world, dtype):
    mesh = _mesh(world)
    gather = _spmd(lambda s: JCM.ring_all_gather(s[0], DP_AXIS)[None],
                   mesh, 1)
    for n in (8, 24, 129):
        shards = jnp.asarray(np.random.RandomState(n).randn(world, n)
                             .astype(np.float32)).astype(_JDT[dtype])
        want = _to_torch(gather(shards))
        ts = _to_torch(shards)
        got = TCM.ring_all_gather_stacked(ts)
        assert got.dtype == _TDT[dtype] and got.shape == (world, world * n)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        # the wrapper on a LocalRing takes the stacked plain version
        ring = LocalRing(world, "cpu", n)
        np.testing.assert_array_equal(
            _bits(TCM.ring_all_gather(ts, ring)), _bits(want))


# ---------------------------------------------------------------------------
# K5 ring: the reduce-scatter + update
# ---------------------------------------------------------------------------

#: name -> (JAX optimizer, port optimizer, step, bitwise?)
_OPTS = {
    # p - 1.0 * g rounds once with or without an FMA: the ring sum bare
    "sgd_lr1": (jopt.fused_sgd(lr=1.0), topt.fused_sgd(lr=1.0), None, True),
    "sgd_momentum": (jopt.fused_sgd(lr=0.05, momentum=0.9),
                     topt.fused_sgd(lr=0.05, momentum=0.9), None, False),
    "nesterov_wd": (
        jopt.fused_sgd(lr=0.05, momentum=0.9, nesterov=True,
                       weight_decay=1e-4),
        topt.fused_sgd(lr=0.05, momentum=0.9, nesterov=True,
                       weight_decay=1e-4), None, False),
    "adamw": (jopt.fused_adamw(lr=1e-3, weight_decay=0.01),
              topt.fused_adamw(lr=1e-3, weight_decay=0.01), None, False),
    "cosine_step": (
        jopt.fused_sgd(lr=jsched.warmup_cosine(0.1, 2, 10), momentum=0.9),
        topt.fused_sgd(lr=tsched.warmup_cosine(0.1, 2, 10), momentum=0.9),
        5, False),
}


def _jax_rs_update(jo, world, gstack, p0, step):
    """Two calls of JAX's fused_reduce_scatter_update (the momentum's first
    and second step) on the W-device mesh; the params after each."""
    ss = p0.shape[0] // world
    state = jo.init(p0)
    treedef = jax.tree_util.tree_structure(state)
    kw = {} if step is None else {"step": jnp.asarray(step, jnp.int32)}

    def fn(g, p, *leaves):
        st = jax.tree_util.tree_unflatten(treedef, [x[0] for x in leaves])
        new_p, new_s = JCM.fused_reduce_scatter_update(
            g[0], p[0], st, jo, DP_AXIS, mean_world=world, **kw)
        return tuple([new_p[None]] + [
            jnp.broadcast_to(x, (1,) + jnp.shape(x))
            for x in jax.tree_util.tree_flatten(new_s)[0]])

    def stage(x):
        if getattr(x, "ndim", 0) == 1:
            return jnp.reshape(x, (world, ss))
        return jnp.broadcast_to(jnp.asarray(x)[None], (world,))

    leaves = [stage(x) for x in jax.tree_util.tree_flatten(state)[0]]
    call = _spmd(fn, _mesh(world), 2 + len(leaves), n_out=1 + len(leaves))
    p = p0.reshape(world, ss)
    out = []
    for g in gstack:
        res = call(g, p, *leaves)
        p, leaves = res[0], list(res[1:])
        out.append(np.asarray(p, np.float32).reshape(-1))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("optname", sorted(_OPTS))
def test_stacked_fused_rs_update_matches_jax(optname, world, dtype):
    jo, to, step, bitwise = _OPTS[optname]
    ss = 37                                   # a ragged shard
    rs = np.random.RandomState(world)
    gstack = [jnp.asarray(rs.randn(world, world * ss).astype(np.float32))
              .astype(_JDT[dtype]) for _ in range(2)]
    p0 = jnp.asarray(rs.randn(world * ss).astype(np.float32))
    want = _jax_rs_update(jo, world, gstack, p0, step)

    params = _to_torch(p0).reshape(world, ss).clone()
    states = [to.init(params[i]) for i in range(world)]
    ring = LocalRing(world, "cpu", ss)
    for g, w in zip(gstack, want):
        TCM.fused_reduce_scatter_update(_to_torch(g), params, states, to,
                                        ring, mean_world=world, step=step)
        got = params.reshape(-1).numpy()
        if bitwise:
            np.testing.assert_array_equal(got.view(np.int32),
                                          w.view(np.int32))
        else:
            np.testing.assert_allclose(got, w, **FP32_TOL)
    if to.kind == "adamw":
        assert all(st["t"] == 2 for st in states)
    elif to.momentum:
        assert all(st["initialized"] for st in states)


def test_fused_rs_update_rejects_lamb_and_odd_state():
    """LAMB (a LayerwiseShardOptimizer) and a state leaf that is not
    shard-shaped raise the JAX package's ValueError (collective_matmul.py
    :280), and a gradient buffer of the wrong length its own."""
    ring = LocalRing(2, "cpu", 8)
    g, p = torch.zeros(2, 16), torch.zeros(2, 8)
    lamb = topt.LayerwiseShardOptimizer(init=None, update=None)
    with pytest.raises(ValueError, match="LAMB"):
        TCM.fused_reduce_scatter_update(g, p, [{}, {}], lamb, ring,
                                        mean_world=2)
    sgd = topt.fused_sgd(lr=0.1)
    bad = [{"x": torch.zeros(4, 4)}] * 2
    with pytest.raises(ValueError, match="can only fuse.*LAMB"):
        TCM.fused_reduce_scatter_update(g, p, bad, sgd, ring, mean_world=2)
    with pytest.raises(ValueError, match="world\\*shard"):
        TCM.fused_reduce_scatter_update(torch.zeros(2, 15), p, [{}, {}],
                                        sgd, ring, mean_world=2)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        TCM.ring_all_gather(torch.zeros(2, 8, device="meta"), ring)


def test_world1_short_cuts():
    """At world 1 the gather is the shard and the update the plain shard
    update, as the JAX package's (:248, :417)."""
    ring = LocalRing(1, "cpu", 5)
    x = torch.arange(5.0)[None]
    assert TCM.ring_all_gather(x, ring) is x
    opt = topt.fused_sgd(lr=0.5)
    p = torch.ones(1, 5)
    TCM.fused_reduce_scatter_update(torch.full((1, 5), 2.0), p, [{}], opt,
                                    ring, mean_world=1)
    assert torch.equal(p, torch.zeros(1, 5))


# ---------------------------------------------------------------------------
# the distributed plain version against the stacked one (gloo)
# ---------------------------------------------------------------------------

#: (name, world, dtype, optimizer, shard size): one spawned world of 4
#: ranks runs them all, the world-2 cases on the sub-group of ranks 0 and 1
_DIST_CASES = [
    ("w2_bf16_sgd", 2, "bfloat16", "sgd_momentum", 37),
    ("w2_f32_adamw", 2, "float32", "adamw", 16),
    ("w4_bf16_adamw", 4, "bfloat16", "adamw", 37),
    ("w4_f32_nesterov", 4, "float32", "nesterov_wd", 24),
]

#: optimizer -> (factory in ops.fused_sgd, its arguments)
_DIST_OPTS = {
    "sgd_momentum": ("fused_sgd", dict(lr=0.05, momentum=0.9)),
    "adamw": ("fused_adamw", dict(lr=1e-3, weight_decay=0.01)),
    "nesterov_wd": ("fused_sgd", dict(lr=0.05, momentum=0.9, nesterov=True,
                                      weight_decay=1e-4)),
}


#: (name, world, dtype, M, kc, N): the ring matmul (K6, K7, K8) in the
#: same spawn
_CM_DIST_CASES = [
    ("cm_w2_bf16", 2, "bfloat16", 9, 8, 16),
    ("cm_w4_f32", 4, "float32", 7, 3, 5),
]


def _cm_inputs(case_index, world, m, kc, n):
    """Every rank's x [W, M, W*kc], its shard [W, kc, N] and its dy."""
    rs = np.random.RandomState(100 + case_index)
    return (rs.randn(world, m, world * kc).astype(np.float32),
            rs.randn(world, kc, n).astype(np.float32),
            rs.randn(world, m, n).astype(np.float32))


def _dist_inputs(case_index, world, ss):
    """Two steps' gradient buffers of every rank, and every rank's shard."""
    rs = np.random.RandomState(case_index)
    return (rs.randn(2, world, world * ss).astype(np.float32),
            rs.randn(world, ss).astype(np.float32))


_WORKER = '''
import os, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import collectives as C
from dear_pytorch_tpu_torch.comm.ring import Ring
from dear_pytorch_tpu_torch.ops import collective_matmul as TCM
from dear_pytorch_tpu_torch.ops import fused_sgd as topt

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store")
groups = {{4: backend.init("cpu"), 2: dist.new_group([0, 1])}}
{inputs}
res = {{}}
# send_recv over a permutation that is not a ring shift
peer_of = [2, 3, 1, 0]
got = C.send_recv(torch.full((3,), float(rank)), peer_of)
res["send_recv"] = got.numpy()
for i, (name, w, dtype, opt, ss) in enumerate({cases!r}):
    if rank >= w:
        continue
    dt = getattr(torch, dtype)
    ring = Ring(groups[w], "cpu", ss)
    gsteps, p0 = _dist_inputs(i, w, ss)
    param = torch.from_numpy(p0[rank]).clone()
    factory, kwargs = {opts!r}[opt]
    optimizer = getattr(topt, factory)(**kwargs)
    state = optimizer.init(param)
    for g in gsteps:
        TCM.fused_reduce_scatter_update(
            torch.from_numpy(g[rank]).to(dt), param, state, optimizer, ring,
            mean_world=w)
    res[name + ".param"] = param.numpy()
    full = TCM.ring_all_gather(param.to(dt), ring)
    res[name + ".gather"] = full.view(torch.int16 if dt == torch.bfloat16
                                      else torch.int32).numpy()
    # a registered output on the CPU: a plain tensor, the plain gather
    reg = ring.register_outputs([w * ss], dt)[0]
    res[name + ".registered_zero"] = np.array(
        [ring.direct_links(reg) is None and not reg.any()])
    got = TCM.ring_all_gather(param.to(dt), ring, out=reg, direct=True)
    res[name + ".gather_registered"] = got.view(
        torch.int16 if dt == torch.bfloat16 else torch.int32).numpy()
for i, (name, w, dtype, m, kc, n) in enumerate({cm_cases!r}):
    if rank >= w:
        continue
    dt = getattr(torch, dtype)
    ring = Ring(groups[w], "cpu", 1, cm_elems=kc * n)
    x, ws, dy = (torch.from_numpy(a).to(dt) for a in _cm_inputs(i, w, m, kc,
                                                                n))
    for kind, got in (("fwd", TCM.ring_matmul(x[rank], ws[rank], ring)),
                      ("dx", TCM.ring_matmul_dx(dy[rank], ws[rank], ring)),
                      ("dw", TCM.ring_matmul_dw(x[rank], dy[rank], ring))):
        res[f"{{name}}.{{kind}}"] = got.view(
            torch.int16 if dt == torch.bfloat16 else torch.int32).numpy()
np.savez(f"{{out}}/rank{{rank}}.npz", **res)
backend.shutdown()
'''


@pytest.fixture(scope="module")
def dist_results(tmp_path_factory):
    import inspect

    out = str(tmp_path_factory.mktemp("ring_world4"))
    code = _WORKER.format(root=ROOT, inputs=inspect.getsource(_dist_inputs)
                          + inspect.getsource(_cm_inputs),
                          cases=_DIST_CASES, opts=_DIST_OPTS,
                          cm_cases=_CM_DIST_CASES)
    spawn_ranks(code, 4, out)
    return [np.load(os.path.join(out, f"rank{r}.npz")) for r in range(4)]


def test_send_recv_pairs_ranks(dist_results):
    for r, res in enumerate(dist_results):
        src = [2, 3, 1, 0].index(r)
        np.testing.assert_array_equal(res["send_recv"], np.full(3, src))


@pytest.mark.parametrize("index", range(len(_DIST_CASES)),
                         ids=[c[0] for c in _DIST_CASES])
def test_distributed_plain_equals_stacked(index, dist_results):
    name, world, dtype, opt, ss = _DIST_CASES[index]
    dt = _TDT[dtype]
    factory, kwargs = _DIST_OPTS[opt]
    optimizer = getattr(topt, factory)(**kwargs)
    gsteps, p0 = _dist_inputs(index, world, ss)
    params = torch.from_numpy(p0).clone()
    states = [optimizer.init(params[i]) for i in range(world)]
    for g in gsteps:
        TCM.fused_reduce_scatter_update_stacked(
            torch.from_numpy(g).to(dt), params, states, optimizer,
            mean_world=world)
    full = TCM.ring_all_gather_stacked(params.to(dt))
    for r in range(world):
        got = dist_results[r]
        np.testing.assert_array_equal(
            got[name + ".param"].view(np.int32),
            params[r].numpy().view(np.int32))
        np.testing.assert_array_equal(got[name + ".gather"], _bits(full[r]))


@pytest.mark.parametrize("index", range(len(_DIST_CASES)),
                         ids=[c[0] for c in _DIST_CASES])
def test_distributed_registered_gather_is_plain(index, dist_results):
    """On the CPU a `Ring` registers nothing: its registered outputs are
    zeroed plain tensors and the gather into them, the direct route
    demanded, is the plain one, bitwise."""
    name = _DIST_CASES[index][0]
    for res in dist_results[:_DIST_CASES[index][1]]:
        assert res[name + ".registered_zero"].all()
        np.testing.assert_array_equal(res[name + ".gather_registered"],
                                      res[name + ".gather"])


@pytest.mark.parametrize("index", range(len(_CM_DIST_CASES)),
                         ids=[c[0] for c in _CM_DIST_CASES])
def test_distributed_ring_matmul_equals_stacked(index, dist_results):
    """K6, K7 and K8's distributed plain versions (hops over gloo) are
    bitwise their stacked ones: the same fp32 products and adds."""
    name, world, dtype, m, kc, n = _CM_DIST_CASES[index]
    dt = _TDT[dtype]
    x, ws, dy = (torch.from_numpy(a).to(dt)
                 for a in _cm_inputs(index, world, m, kc, n))
    want = {"fwd": TCM.ring_matmul_stacked(x, ws),
            "dx": TCM.ring_matmul_dx_stacked(dy, ws),
            "dw": TCM.ring_matmul_dw_stacked(x, dy)}
    for r in range(world):
        for kind, ref in want.items():
            np.testing.assert_array_equal(
                dist_results[r][f"{name}.{kind}"], _bits(ref[r]),
                err_msg=f"{name} {kind} rank {r}")
