"""The port's sequence-parallel attention (dear_pytorch_tpu_torch.parallel.
ring_attention) and its differentiable collectives against the JAX
package's, on the CPU.

The JAX side runs in this process under ``shard_map`` on a W-device
sub-mesh of the emulated CPU devices (tests/conftest.py), the flash rings'
Pallas kernels in interpret mode, as tests/test_ring_attention.py does.
The port's side runs in ONE spawned world of 4 jax-free ranks over gloo
(the world-2 cases on ``dist.new_group([0, 1])``), the flash kernels'
plain versions on CPU tensors; it starts first and runs while JAX
computes.

Each case feeds the same numpy inputs to both, takes the output and the
gradients of ``sum(out * w)`` with respect to q, k and v, and holds them at
JAX's own tolerances (tests/test_ring_attention.py): outputs 2e-5,
gradients 5e-4 relative / 5e-5 absolute. The collectives' forward and
backward (`ad_permute`, `ad_all_to_all`, `ad_psum`, `ad_all_gather`) are
held against ``jax.vjp`` of the JAX op under ``shard_map(check_vma=False)``
(the JAX package's setting), exactly: data movement and fp32 sums of the
same four terms. Dropout in the dense ring is held to its statistics only
(a ``torch.Generator`` cannot draw JAX's masks).
"""

import inspect
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from dear_pytorch_tpu.parallel import ring_attention as JRA
from tests.test_torch_dear import spawn_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, H, D = 2, 32, 4, 16
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)

#: (world, scheme, causal, masked)
CASES = [
    (4, "ring", True, False),
    (4, "ring_flash", False, False), (4, "ring_flash", True, False),
    (4, "ulysses", False, False), (4, "ulysses", True, False),
    (4, "zigzag", True, False),
    (4, "ring", False, True), (4, "ring_flash", False, True),
    (4, "ulysses", False, True),
    (2, "ring_flash", True, False), (2, "zigzag", True, False),
]
#: the collectives at world 4: (name, perm or dims)
COLLECTIVES = [("permute_ring", [(i, (i + 1) % 4) for i in range(4)]),
               ("permute_partial", [(0, 2), (2, 1)]),
               ("all_to_all", (2, 1)), ("psum", None), ("all_gather", None)]
DROPOUT_RATE, DROPOUT_DRAWS = 0.3, 48


def _case_id(case):
    world, scheme, causal, masked = case
    return (f"w{world}-{scheme}" + ("-causal" if causal else "")
            + ("-masked" if masked else ""))


def _inputs():
    rng = np.random.RandomState(0)
    q, k, v, w = rng.standard_normal((4, B, S, H, D)).astype(np.float32)
    mask = np.ones((B, S), bool)
    mask[:, S - 10:] = False
    return q, k, v, w, mask


def _coll_input(name):
    """Every rank's input and the cotangent of every rank's output, each
    stacked on a leading axis of 4."""
    shape, out = (3, 5), (3, 5)
    if name == "all_to_all":
        shape, out = (B, 8, H, 3), (B, 32, H // 4, 3)
    elif name == "all_gather":
        out = (12, 5)
    rng = np.random.RandomState(len(name))
    return (rng.standard_normal((4,) + shape).astype(np.float32),
            rng.standard_normal((4,) + out).astype(np.float32))


def _layout(case, arrays):
    """The inputs in the case's sequence layout (zigzag: permuted)."""
    world, scheme = case[:2]
    if scheme != "zigzag":
        return arrays
    perm = JRA.zigzag_permutation(S, world)
    return [a[:, perm] for a in arrays]


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _mesh(world):
    return jax.sharding.Mesh(np.array(jax.devices()[:world]), ("dp",))


def _shard(x, world):
    b, s = x.shape[:2]
    return x.reshape((b, world, s // world) + x.shape[2:]).swapaxes(0, 1)


def _unshard(y):
    return y.swapaxes(0, 1).reshape((y.shape[1], -1) + y.shape[3:])


def _jax_case(case, q, k, v, w, mask):
    world, scheme, causal, masked = case

    def attend(qb, kb, vb, mb):
        kvm = mb if masked else None
        if scheme == "ring":
            return JRA.ring_attention(qb, kb, vb, "dp", causal=causal,
                                      kv_mask=kvm)
        if scheme == "ring_flash":
            return JRA.ring_flash_attention(qb, kb, vb, "dp", causal=causal,
                                            kv_mask=kvm)
        if scheme == "zigzag":
            return JRA.zigzag_ring_flash_attention(qb, kb, vb, "dp")
        impl = JRA.make_ulysses_attention_impl("dp", causal)
        add = (jnp.where(mb, 0.0, -1e9)[:, None, None, :] if masked
               else None)
        return impl(qb, kb, vb, add)

    def body(qs, ks, vs, ws, ms):
        o = attend(qs[0], ks[0], vs[0], ms[0])
        return o[None], jnp.sum(o * ws[0])[None]

    mapped = jax.shard_map(body, mesh=_mesh(world),
                           in_specs=(jax.P("dp"),) * 5,
                           out_specs=(jax.P("dp"), jax.P("dp")),
                           check_vma=False)

    def loss(q_, k_, v_):
        o, parts = mapped(*(_shard(x, world) for x in (q_, k_, v_, w, mask)))
        return jnp.sum(parts), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(_unshard(o)), [np.asarray(g) for g in grads]


def _jax_collective(name, arg, x, ct):
    def body(xb):
        y = xb[0]
        if name.startswith("permute"):
            y = lax.ppermute(y, "dp", arg)
        elif name == "all_to_all":
            y = lax.all_to_all(y, "dp", arg[0], arg[1], tiled=True)
        elif name == "psum":
            y = lax.psum(y, "dp")
        else:
            y = lax.all_gather(y, "dp", axis=0, tiled=True)
        return y[None]

    mapped = jax.shard_map(body, mesh=_mesh(4), in_specs=jax.P("dp"),
                           out_specs=jax.P("dp"), check_vma=False)
    out, vjp = jax.vjp(mapped, jnp.asarray(x))
    (grad,) = vjp(jnp.asarray(ct))
    return np.asarray(out), np.asarray(grad)


# ---------------------------------------------------------------------------
# the port's side: one world of 4 jax-free ranks
# ---------------------------------------------------------------------------


def run_case(case, group, rank, q, k, v, w, mask):
    """The port's output block and gradient blocks on this rank."""
    import torch
    from dear_pytorch_tpu_torch.parallel import ring_attention as TRA

    world, scheme, causal, masked = case
    n = S // world
    sl = slice(rank * n, (rank + 1) * n)
    qb, kb, vb = (torch.from_numpy(x[:, sl].copy()).requires_grad_()
                  for x in (q, k, v))
    kvm = torch.from_numpy(mask[:, sl].copy()) if masked else None
    if scheme == "ring":
        o = TRA.ring_attention(qb, kb, vb, group, causal=causal, kv_mask=kvm)
    elif scheme == "ring_flash":
        o = TRA.ring_flash_attention(qb, kb, vb, group, causal=causal,
                                     kv_mask=kvm)
    elif scheme == "zigzag":
        o = TRA.zigzag_ring_flash_attention(qb, kb, vb, group)
    else:
        impl = TRA.make_ulysses_attention_impl(group, causal)
        add = (torch.where(kvm, 0.0, -1e9)[:, None, None, :] if masked
               else None)
        o = impl(qb, kb, vb, add)
    (o * torch.from_numpy(w[:, sl].copy())).sum().backward()
    return [t.detach().numpy() for t in (o, qb.grad, kb.grad, vb.grad)]


def run_collective(name, arg, group, rank, x, ct):
    import torch
    from dear_pytorch_tpu_torch.comm import collectives as C

    xb = torch.from_numpy(x[rank].copy()).requires_grad_()
    if name.startswith("permute"):
        y = C.ad_permute(xb, arg, group)
    elif name == "all_to_all":
        y = C.ad_all_to_all(xb, arg[0], arg[1], group)
    elif name == "psum":
        y = C.ad_psum(xb, group)
    else:
        y = C.ad_all_gather(xb, group)
    y.backward(torch.from_numpy(ct[rank].copy()))
    return y.detach().numpy(), xb.grad.numpy()


def run_dropout(group, rank, q, k, v):
    """The dense ring's mean output over draws with attention dropout, the
    draws' standard deviation, and the output without dropout."""
    import torch
    from dear_pytorch_tpu_torch.parallel import ring_attention as TRA

    n = S // 4
    sl = slice(rank * n, (rank + 1) * n)
    qb, kb, vb = (torch.from_numpy(x[:, sl].copy()) for x in (q, k, v))
    gen = torch.Generator().manual_seed(100 + rank)
    draws = torch.stack([
        TRA.ring_attention(qb, kb, vb, group, generator=gen,
                           dropout_rate=DROPOUT_RATE)
        for _ in range(DROPOUT_DRAWS)])
    ref = TRA.ring_attention(qb, kb, vb, group)
    return [draws.mean(0).numpy(), draws.std(0).numpy(), ref.numpy(),
            np.array([float((draws[0] != draws[1]).float().mean())])]


_WORKER = '''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.comm import backend
B, S = {B}, {S}
DROPOUT_RATE, DROPOUT_DRAWS = {rate}, {draws}
{fns}
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store")
groups = {{4: backend.init("cpu"), 2: dist.new_group([0, 1])}}
inp = np.load(out + "/inputs.npz")
res = {{}}
for i, case in enumerate({cases!r}):
    if rank >= case[0]:
        continue
    arrays = [inp[f"c{{i}}.{{n}}"] for n in ("q", "k", "v", "w")]
    got = run_case(tuple(case), groups[case[0]], rank, *arrays, inp["mask"])
    for n, a in zip(("o", "dq", "dk", "dv"), got):
        res[f"c{{i}}.{{n}}"] = a
for name, arg in {colls!r}:
    y, g = run_collective(name, arg, groups[4], rank, inp[name + ".x"],
                          inp[name + ".ct"])
    res[name + ".y"], res[name + ".g"] = y, g
for n, a in zip(("mean", "std", "ref", "differ"),
                run_dropout(groups[4], rank, inp["q"], inp["k"], inp["v"])):
    res["dropout." + n] = a
from dear_pytorch_tpu_torch.parallel import ring_attention as TRA
for w in (4, 2):
    if rank < w:
        res[f"zz_pos.w{{w}}"] = TRA.zigzag_positions(S // w, groups[w]).numpy()
np.savez(f"{{out}}/rank{{rank}}.npz", **res)
backend.shutdown()
'''


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX's results, the ranks' results): the ranks run in a thread
    while this process computes JAX's."""
    out = str(tmp_path_factory.mktemp("ring_attention"))
    q, k, v, w, mask = _inputs()
    arrays = {"q": q, "k": k, "v": v, "mask": mask}
    for i, case in enumerate(CASES):
        for n, a in zip("qkvw", _layout(case, [q, k, v, w])):
            arrays[f"c{i}.{n}"] = a
    for name, _ in COLLECTIVES:
        arrays[name + ".x"], arrays[name + ".ct"] = _coll_input(name)
    np.savez(os.path.join(out, "inputs.npz"), **arrays)
    fns = "\n\n".join(inspect.getsource(f)
                      for f in (run_case, run_collective, run_dropout))
    code = _WORKER.format(root=ROOT, B=B, S=S, rate=DROPOUT_RATE,
                          draws=DROPOUT_DRAWS, fns=fns,
                          cases=[list(c) for c in CASES],
                          colls=COLLECTIVES)
    failure = []

    def ranks():
        try:
            spawn_ranks(code, 4, out)
        except BaseException as e:   # re-raised below, in the test thread
            failure.append(e)

    t = threading.Thread(target=ranks)
    t.start()
    try:
        want = {}
        for i, case in enumerate(CASES):
            want[i] = _jax_case(case, *(arrays[f"c{i}.{n}"] for n in "qkvw"),
                                mask)
        for name, arg in COLLECTIVES:
            want[name] = _jax_collective(name, arg, arrays[name + ".x"],
                                         arrays[name + ".ct"])
    finally:
        t.join()
    if failure:
        raise failure[0]
    got = [np.load(os.path.join(out, f"rank{r}.npz")) for r in range(4)]
    return want, got


@pytest.mark.parametrize("index", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_attention_matches_jax(index, results):
    """Output and the q, k, v gradients of every scheme, assembled over the
    ranks' blocks, against JAX's sharded run of the same scheme."""
    want, got = results
    world = CASES[index][0]
    o, grads = want[index]

    def assemble(n):
        return np.concatenate([got[r][f"c{index}.{n}"]
                               for r in range(world)], axis=1)

    np.testing.assert_allclose(assemble("o"), o, **OUT_TOL)
    for n, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(assemble(n), g, **GRAD_TOL, err_msg=n)


@pytest.mark.parametrize("name", [c[0] for c in COLLECTIVES])
def test_differentiable_collectives_match_jax_vjp(name, results):
    """Forward and backward of each differentiable collective against
    ``jax.vjp`` of the JAX op (the transpose JAX takes)."""
    want, got = results
    y, g = want[name]
    for r in range(4):
        np.testing.assert_allclose(got[r][name + ".y"], y[r], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got[r][name + ".g"], g[r], rtol=0,
                                   atol=1e-6)


def test_dense_ring_dropout_statistics(results):
    """Inverted attention dropout in the dense ring: the mean over draws
    tends to the output without dropout (every element within 6 standard
    errors of it), two draws differ, and a draw's spread is the rate's."""
    _, got = results
    for r in range(4):
        mean, std, ref = (got[r]["dropout." + n]
                          for n in ("mean", "std", "ref"))
        se = std / np.sqrt(DROPOUT_DRAWS)
        assert np.all(np.abs(mean - ref) <= 6 * se + 1e-6)
        assert float(got[r]["dropout.differ"][0]) > 0.5
        assert 0.0 < float(np.median(std)) < 1.0


def test_zigzag_permutation_and_positions_match_jax(results):
    """`zigzag_permutation` is JAX's (and its refusal); each rank's
    `zigzag_positions` are its block of the permutation."""
    from dear_pytorch_tpu_torch.parallel import ring_attention as TRA

    for seq, world in ((32, 2), (32, 4), (48, 3)):
        np.testing.assert_array_equal(TRA.zigzag_permutation(seq, world),
                                      JRA.zigzag_permutation(seq, world))
    with pytest.raises(ValueError, match="must divide by 2"):
        TRA.zigzag_permutation(30, 4)
    _, got = results
    for world in (4, 2):
        perm = JRA.zigzag_permutation(S, world).reshape(world, -1)
        for r in range(world):
            np.testing.assert_array_equal(got[r][f"zz_pos.w{world}"],
                                          perm[r])
