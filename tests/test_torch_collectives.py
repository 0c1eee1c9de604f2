"""The port's collectives (dear_pytorch_tpu_torch.comm.collectives) and
broadcast helpers (dear_pytorch_tpu_torch.api) against the JAX package's,
at world 2 and 4: each rank is a fresh Python process (no jax in it) in a
gloo group that meets at a FileStore through the launcher variables of
`comm.backend`; the ranks write their results as .npz and this process runs
the JAX collectives on the same per-rank inputs over a sub-mesh of the
emulated CPU devices. Sums of a few fp32 values: tolerance 1e-6 (the two
may add in another order); bf16 sums of small integers are exact."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.comm import backend as jB
from dear_pytorch_tpu.comm import collectives as jC
from dear_pytorch_tpu_torch.comm import backend as tB
from dear_pytorch_tpu_torch.comm import collectives as tC
from tests.test_torch_dear import spawn_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 13            # divides by neither world: exercises the padding
TOL = 1e-6


def _inputs(world):
    rs = np.random.RandomState(world)
    return (rs.randn(world, N).astype(np.float32),
            rs.randn(world, 3, 5).astype(np.float32),
            rs.randint(-8, 8, (world, 2 * world)).astype(np.float32))


_WORKER = '''
import os, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch import api
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import collectives as C

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store")
g = backend.init("cpu")
assert (backend.rank(), backend.size()) == (rank, world)
assert api.world_info()["process_count"] == world
inp = np.load(out + "/inputs.npz")
x = torch.from_numpy(inp["x"][rank])
m = torch.from_numpy(inp["m"][rank])
ints = torch.from_numpy(inp["ints"][rank])
res = {{}}
padded = C.pad_to_multiple(x, world)
res["rs"] = C.reduce_scatter(padded).numpy()
shard, work = C.reduce_scatter(padded, g, async_op=True)
work.wait()
res["rs_async"] = shard.numpy()
res["ag"] = C.all_gather(shard, g).numpy()
full, work = C.all_gather(shard, g, async_op=True)
work.wait()
res["ag_async"] = full.numpy()
res["ar"] = C.all_reduce(x, g).numpy()
res["ar_mean"] = C.all_reduce_mean(x, g).numpy()
res["rsag"] = C.all_reduce_rsag(m, g).numpy()
res["ar_m"] = C.all_reduce(m, g).numpy()
res["rs_bf16"] = C.reduce_scatter(ints.bfloat16(), g).float().numpy()
try:
    C.reduce_scatter(torch.zeros(world + 1), g)
    res["indivisible_raised"] = np.array(0)
except ValueError:
    res["indivisible_raised"] = np.array(1)
# broadcast: every rank builds its own module; rank 0's values win
torch.manual_seed(100 + rank)
mod = torch.nn.Linear(4, 3)
api.broadcast_parameters(mod)
res["bcast_w"] = mod.weight.detach().numpy()
state = {{"buf": torch.full((5,), float(rank)), "t": [torch.tensor(rank)]}}
api.broadcast_optimizer_state(state)
res["bcast_state"] = np.concatenate([state["buf"].numpy(),
                                     state["t"][0].numpy()[None]])
np.savez(f"{{out}}/rank{{rank}}.npz", **res)
backend.barrier()
backend.shutdown()
'''


def _spawn(world, out):
    spawn_ranks(_WORKER.format(root=ROOT), world, out)
    return [np.load(os.path.join(out, f"rank{r}.npz")) for r in range(world)]


def _jax(fn, world, *stacked):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("dp",))
    return np.asarray(jC.spmd_call(fn, *stacked, mesh=mesh))


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_jax(world, tmp_path):
    x, m, ints = _inputs(world)
    np.savez(tmp_path / "inputs.npz", x=x, m=m, ints=ints)
    ranks = _spawn(world, str(tmp_path))

    def rs_fn(a):
        return jC.reduce_scatter(jC.pad_to_multiple(a, world))

    def ag_fn(a):
        return jC.all_gather(jC.reduce_scatter(jC.pad_to_multiple(a, world)))

    jrs = _jax(rs_fn, world, x)
    jag = _jax(ag_fn, world, x)
    jar = _jax(jC.all_reduce, world, x)
    jrsag = _jax(jC.all_reduce_rsag, world, m)
    jrs_bf16 = _jax(jC.reduce_scatter, world, jnp.asarray(ints, jnp.bfloat16))
    pad = jC.padded_length(N, world)
    assert tC.padded_length(N, world) == pad and pad > N
    for r, got in enumerate(ranks):
        assert got["rs"].shape == (pad // world,)
        np.testing.assert_allclose(got["rs"], jrs[r], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got["rs_async"], got["rs"])
        np.testing.assert_allclose(got["ag"], jag[r], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got["ag_async"], got["ag"])
        assert np.all(got["ag"][N:] == 0)           # the pad reduces to 0
        np.testing.assert_allclose(got["ar"], jar[r], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["ar_mean"], jar[r] / world, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["rsag"], jrsag[r], rtol=TOL, atol=TOL)
        # the decoupled all-reduce is the all-reduce
        np.testing.assert_allclose(got["rsag"], got["ar_m"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(got["rs_bf16"],
                                      np.asarray(jrs_bf16[r], np.float32))
        assert int(got["indivisible_raised"]) == 1
        np.testing.assert_array_equal(got["bcast_w"], ranks[0]["bcast_w"])
        np.testing.assert_array_equal(got["bcast_state"],
                                      [0.0] * 5 + [0.0])
    torch.manual_seed(100)   # rank 0's module
    np.testing.assert_array_equal(ranks[0]["bcast_w"],
                                  torch.nn.Linear(4, 3).weight.detach())


@pytest.mark.parametrize("n,world", [(0, 3), (7, 1), (7, 7), (13, 4)])
def test_padding_matches_jax(n, world):
    x = np.arange(n, dtype=np.float32) + 1
    got = tC.pad_to_multiple(torch.from_numpy(x), world)
    want = np.asarray(jC.pad_to_multiple(jnp.asarray(x), world))
    assert tC.padded_length(n, world) == jC.padded_length(n, world)
    np.testing.assert_array_equal(got.numpy(), want)


_LOCAL_SIZE_NAMES = ("DEAR_LOCAL_SIZE", "LOCAL_WORLD_SIZE",
                     "OMPI_COMM_WORLD_LOCAL_SIZE", "SLURM_NTASKS_PER_NODE")


@pytest.mark.parametrize("name", (None,) + _LOCAL_SIZE_NAMES)
def test_local_size_reads_the_jax_names(name, monkeypatch):
    """`backend.local_size` reads the JAX package's variables and defaults
    to 1 as it does; ranks share a card only where the launcher says a
    host holds more ranks than cards: a 2-host x 8-card world of 16 with
    no local size set keeps a card per rank (NCCL)."""
    for k in _LOCAL_SIZE_NAMES:
        monkeypatch.delenv(k, raising=False)
    if name is not None:
        monkeypatch.setenv(name, "2")
    assert tB.local_size() == jB.local_size() == (1 if name is None else 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert not tB._shares_card(16)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tB._shares_card(2) == (name is not None)
    assert not tB._shares_card(1)


#: the collectives of the baseline schedules and the `Communicator`, on
#: per-rank inputs of N elements (padded inside `all_reduce_rsag`) and of
#: 2 * world (divisible); `multi_bcast` over two tensors above its size
#: filter (owners rank 0, then rank 1) and one below it
_MODES_WORKER = '''
import os, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch import Communicator
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import collectives as C

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store")
g = backend.init("cpu")
inp = np.load(out + "/inputs.npz")
x = torch.from_numpy(inp["x"][rank])
ints = torch.from_numpy(inp["ints"][rank])
big = [torch.from_numpy(inp[k][rank]) for k in ("b0", "small", "b1")]
keep = x.clone()
res = {{}}
for root in (0, world - 1):
    res[f"reduce{{root}}"] = C.reduce(x, root, g).numpy()
    buf = x.clone()
    o, w = C.reduce(x, root, g, async_op=True, out=buf)
    w.wait()
    assert o is buf
    res[f"reduce_async{{root}}"] = buf.numpy()
    res[f"rb{{root}}"] = C.all_reduce_rb(x, root, g).numpy()
    o, w = C.all_reduce_rb(x, root, g, async_op=True)
    w.wait()
    res[f"rb_async{{root}}"] = o.numpy()
assert torch.equal(x, keep)         # out= copies: the input is untouched
buf = x.clone()
o, w = C.all_reduce(buf, g, async_op=True, out=buf)
w.wait()
res["ar_inplace"] = buf.numpy()
o, w = C.broadcast(x, world - 1, g, async_op=True, out=torch.empty_like(x))
w.wait()
res["bcast_async"] = o.numpy()
for name, t in (("rsag_pad", x), ("rsag_even", ints)):
    o, w = C.all_reduce_rsag(t, g, async_op=True, out=torch.empty_like(t))
    w.wait()
    res[name] = o.numpy()
    res[name + "_sync"] = C.all_reduce_rsag(t, g).numpy()
res["multi"] = np.concatenate([t.numpy() for t in C.multi_bcast(
    big, lambda t: t * 2.0 + 1.0, min_elems=8, group=g)])
peers = [(i + 1) % world for i in range(world)]
o, w = C.send_recv(x, peers, g, async_op=True)
w.wait()
res["sendrecv"] = o.numpy()
if world == 2:   # the Communicator: JAX's TestCommunicator cases
    comm = Communicator(nstreams=2)
    o, h = comm.allReduce(x)
    assert 0 <= h < 2
    comm.synchronize()
    res["comm_ar"] = o.numpy()
    comm3 = Communicator(nstreams=3)
    handles = [comm3.allReduce(x)[1] for _ in range(5)]
    assert handles == [0, 1, 2, 0, 1], handles
    comm3.syncStream(0)
    comm3.synchronize()
    assert comm3.getNumOfFreeStreams() == 3
    one = Communicator(nstreams=1)
    _, h0 = one.allReduce(x)
    _, h1 = one.allReduce(x)
    assert h0 == h1 == 0 and len(one._pending[0]) == 2
    one.synchronize()
    assert not one._pending
    one.destroy()
    try:
        one.allReduce(x)
        res["destroyed_raised"] = np.array(0)
    except RuntimeError:
        res["destroyed_raised"] = np.array(1)
    one.reload()
    o, _ = one.allReduce(x)
    one.synchronize()
    res["comm_ar_reloaded"] = o.numpy()
    shards, _ = comm.reduceScatter(ints)
    comm.synchronize()
    gathered, _ = comm.allGather(shards)
    outs = {{"reduce": comm.reduce(x, 1), "bcast": comm.bcast(x, 1),
            "rb": comm.allReduceRB(x), "rsag": comm.allReduceRSAG(x),
            "sendrecv": comm.sendrecv(x, peers)}}
    multi, h = comm.multiBcast(big, lambda t: t * 2.0 + 1.0, min_elems=8)
    comm.synchronize()
    assert comm.getNumOfFreeStreams() == 2
    res["comm_rs"] = shards.numpy()
    res["comm_ag"] = gathered.numpy()
    for k, (o, _) in outs.items():
        res["comm_" + k] = o.numpy()
    res["comm_multi"] = np.concatenate([t.numpy() for t in multi])
    assert torch.equal(x, keep)
    for c in (comm, comm3, one):
        c.destroy()
np.savez(f"{{out}}/rank{{rank}}.npz", **res)
backend.barrier()
backend.shutdown()
'''


@pytest.mark.parametrize("world", [2, 4])
def test_mode_collectives_match_jax(world, tmp_path):
    """`reduce` (every non-root rank keeps its input, also on gloo, where
    the reduction runs in a copy), `all_reduce_rb`, `multi_bcast`, and
    ``async_op=True`` with ``out=`` on `all_reduce`, `reduce`,
    `broadcast`, `all_reduce_rsag` and `send_recv`, against the JAX
    package's collectives on the same per-rank inputs; at world 2 also the
    `Communicator` (nstreams 1, 2 and 3) against JAX's `TestCommunicator`
    cases (tests/test_collectives.py:125-187; the jit-cache case has no
    analog): round-robin handles, the fences, destroy and reload, and
    every method's result equal to JAX's."""
    rs = np.random.RandomState(10 + world)
    x = rs.randn(world, N).astype(np.float32)
    ints = rs.randint(-8, 8, (world, 2 * world)).astype(np.float32)
    big = {"b0": rs.randn(world, 20).astype(np.float32),
           "small": rs.randn(world, 4).astype(np.float32),
           "b1": rs.randn(world, 20).astype(np.float32)}
    np.savez(tmp_path / "inputs.npz", x=x, ints=ints, **big)
    spawn_ranks(_MODES_WORKER.format(root=ROOT), world, str(tmp_path))
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]

    def multi(*ts):
        return jnp.concatenate(jC.multi_bcast(
            list(ts), lambda t: t * 2.0 + 1.0, min_elems=8))

    peers = [(i + 1) % world for i in range(world)]
    want = {"ar_inplace": _jax(jC.all_reduce, world, x),
            "bcast_async": _jax(lambda t: jC.broadcast(t, world - 1),
                                world, x),
            "rsag_pad": _jax(jC.all_reduce_rsag, world, x),
            "rsag_even": _jax(jC.all_reduce_rsag, world, ints),
            "multi": _jax(multi, world, big["b0"], big["small"], big["b1"]),
            "sendrecv": _jax(lambda t: jC.send_recv(t, peers), world, x)}
    for root in (0, world - 1):
        red = _jax(lambda t, r=root: jC.reduce(t, r), world, x)
        rb = _jax(lambda t, r=root: jC.all_reduce_rb(t, r), world, x)
        want.update({f"reduce{root}": red, f"reduce_async{root}": red,
                     f"rb{root}": rb, f"rb_async{root}": rb})
        for r in range(world):   # the JAX package's own semantics
            if r != root:
                np.testing.assert_array_equal(red[r], x[r])
    want["rsag_pad_sync"], want["rsag_even_sync"] = (want["rsag_pad"],
                                                     want["rsag_even"])
    if world == 2:
        want.update({
            "comm_ar": want["ar_inplace"],
            "comm_ar_reloaded": want["ar_inplace"],
            "comm_rs": _jax(jC.reduce_scatter, world, ints),
            "comm_ag": _jax(lambda t: jC.all_gather(jC.reduce_scatter(t)),
                            world, ints),
            "comm_reduce": _jax(lambda t: jC.reduce(t, 1), world, x),
            "comm_bcast": _jax(lambda t: jC.broadcast(t, 1), world, x),
            "comm_rb": _jax(lambda t: jC.all_reduce_rb(t, 0), world, x),
            "comm_rsag": want["rsag_pad"], "comm_sendrecv": want["sendrecv"],
            "comm_multi": want["multi"]})
    for r, got in enumerate(ranks):
        assert sorted(k for k in got.files if k != "destroyed_raised") \
            == sorted(want)
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w[r], rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} {key}")
        for root in (0, world - 1):
            if r != root:    # bitwise: the input itself, not a sum
                np.testing.assert_array_equal(got[f"reduce{root}"], x[r])
                np.testing.assert_array_equal(got[f"reduce_async{root}"],
                                              x[r])
        if world == 2:
            assert int(got["destroyed_raised"]) == 1
