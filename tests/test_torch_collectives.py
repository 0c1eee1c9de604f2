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
