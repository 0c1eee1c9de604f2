"""The routes of the ring collectives of ``mode="dear-fused"`` in the port
(dear_pytorch_tpu_torch.ops.collective_matmul, comm.ring), on the CPU:

  - K4's route chooser `ag_route` (direct into an output the ring
    registered, or through the slots; vector or scalar width) and the K5
    ring's `rs_route` (vector or scalar), with the cases each refuses;
  - registering gather outputs with a ring on the CPU, where it registers
    nothing and the gather into them is the plain one, on a `LocalRing`,
    a one-rank `Ring` and the dear-fused train step;
  - `_rs_update_hops`, the plain twin of the K5 ring's dataflow (the first
    hop in the gradient's own dtype, widened on receipt): bitwise equal to
    `fused_reduce_scatter_update_stacked`, and
    to JAX's interpret-mode `fused_reduce_scatter_update` as far as
    tests/test_torch_ring.py finds the two packages bitwise — SGD at lr 1,
    where the ring sum is compared bare — and within its FP32_TOL where
    XLA on the CPU contracts the update's products into sums (momentum,
    AdamW).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.ops import fused_sgd as jopt
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm.ring import LocalRing, Ring
from dear_pytorch_tpu_torch.models import gpt as tgpt
from dear_pytorch_tpu_torch.ops import collective_matmul as TCM
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.parallel import dear as tdear
from tests.test_torch_dear import _torch_config
from tests.test_torch_ring import (
    _JDT, _TDT, FP32_TOL, _bits, _jax_rs_update, _to_torch,
)

_A = 1 << 20   # an aligned pointer


# ---------------------------------------------------------------------------
# the route choosers
# ---------------------------------------------------------------------------

#: (id, n, element bytes, pointers, registered, direct demanded, slot
#: elements, the route or the refusal's message)
_AG_CASES = [
    ("direct_vector", 1024, 4, [_A, _A + 4096], True, False, 2048,
     ("direct", "vector")),
    ("direct_needs_no_slot", 4096, 4, [_A], True, False, 2048,
     ("direct", "vector")),
    ("direct_demanded", 1024, 2, [_A], True, True, 2048,
     ("direct", "vector")),
    ("unregistered_slot", 1024, 4, [_A], False, False, 2048,
     ("slot", "vector")),
    ("ragged_direct_scalar", 1023, 4, [_A], True, False, 2048,
     ("direct", "scalar")),
    ("bf16_8_bytes_scalar", 4, 2, [_A], False, False, 8, ("slot", "scalar")),
    ("bf16_16_bytes_vector", 8, 2, [_A], False, False, 8, ("slot", "vector")),
    ("offset_pointer_scalar", 1024, 4, [_A, _A + 8], False, False, 2048,
     ("slot", "scalar")),
    ("main_path_shard", 3248640, 4, [_A], True, True, 19301376,
     ("direct", "vector")),
    ("fp64_refused", 1024, 8, [_A], False, False, 2048,
     "float32 or bfloat16"),
    ("direct_unregistered_refused", 1024, 4, [_A], False, True, 2048,
     "registered with the ring"),
    ("slot_too_large_refused", 4096, 4, [_A], False, False, 2048,
     "does not fit"),
]


@pytest.mark.parametrize("case", _AG_CASES, ids=[c[0] for c in _AG_CASES])
def test_ag_route(case):
    _, n, esize, ptrs, registered, direct, max_elems, want = case
    kw = dict(registered=registered, direct=direct, max_elems=max_elems)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            TCM.ag_route(n, esize, ptrs, **kw)
    else:
        assert TCM.ag_route(n, esize, ptrs, **kw) == want


#: (id, n, gradient bytes, pointers, slot elements, the width or the
#: refusal's message)
_RS_CASES = [
    ("bf16_vector", 1024, 2, [_A, _A + 2048], 2048, "vector"),
    ("fp32_vector", 1024, 4, [_A], 2048, "vector"),
    ("bf16_8_bytes_scalar", 4, 2, [_A], 8, "scalar"),
    ("fp32_16_bytes_vector", 4, 4, [_A], 8, "vector"),
    ("ragged_scalar", 37, 4, [_A], 64, "scalar"),
    ("offset_state_scalar", 1024, 4, [_A, _A + 4], 2048, "scalar"),
    ("main_path_shard", 3248640, 2, [_A], 19301376, "vector"),
    ("fp64_refused", 1024, 8, [_A], 2048, "float32 or bfloat16"),
    ("too_large_refused", 4096, 2, [_A], 2048, "does not fit"),
]


@pytest.mark.parametrize("case", _RS_CASES, ids=[c[0] for c in _RS_CASES])
def test_rs_route(case):
    _, n, gsize, ptrs, max_elems, want = case
    if want not in ("vector", "scalar"):
        with pytest.raises(ValueError, match=want):
            TCM.rs_route(n, gsize, ptrs, max_elems=max_elems)
    else:
        assert TCM.rs_route(n, gsize, ptrs, max_elems=max_elems) == want


# ---------------------------------------------------------------------------
# registration on the CPU: a no-op, the gather the plain one
# ---------------------------------------------------------------------------


def _launch_counts():
    return (TCM.ring_ag_launches, TCM.ring_rs_launches,
            str(TCM.ring_ag_route_launches), str(TCM.ring_rs_route_launches))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("world", [2, 4])
def test_local_ring_registration_on_cpu_is_plain(world, dtype):
    dt, n = _TDT[dtype], 24
    ring = LocalRing(world, "cpu", n)
    outs = ring.register_outputs([world * n, world * 8], dt)
    assert [tuple(o.shape) for o in outs] == [(world, world * n),
                                              (world, world * 8)]
    assert all(o.dtype == dt and not o.any() for o in outs)
    assert ring.direct_links(outs[0]) is None
    shards = torch.from_numpy(np.random.RandomState(world).randn(
        world, n).astype(np.float32)).to(dt)
    before = _launch_counts()
    got = TCM.ring_all_gather(shards, ring, out=outs[0], direct=True)
    assert got is outs[0] and _launch_counts() == before
    np.testing.assert_array_equal(
        _bits(got), _bits(TCM.ring_all_gather_stacked(shards)))


@pytest.fixture(scope="module")
def group():
    return backend.init("cpu")


def test_one_rank_ring_and_train_step_register_plain_tensors(group):
    """A one-rank `Ring` on the CPU hands out plain zeroed tensors; the
    dear-fused train step's gather buffers are such tensors, its gathers
    (the direct route demanded) are the shards themselves, and `close`
    leaves the model's parameters in place."""
    ring = Ring(group, "cpu", 16)
    outs = ring.register_outputs([16, 40], torch.bfloat16)
    assert [tuple(o.shape) for o in outs] == [(16,), (40,)]
    assert all(o.dtype == torch.bfloat16 and not o.any() for o in outs)
    assert ring.direct_links(outs[0]) is None
    ring.close()

    torch.manual_seed(0)
    model = tgpt.GptLmHeadModel(_torch_config(), device="cpu")
    want = {k: v.clone() for k, v in model.state_dict().items()}

    def loss_fn(m, batch):
        return tgpt.gpt_lm_loss(m(batch, train=True), batch,
                                vocab_size=m.config.vocab_size)

    ts = tdear.build_train_step(loss_fn, model, group=group, device="cpu",
                                mode="dear-fused", threshold_mb=0.02)
    assert ts.plan.num_buckets > 1
    state = ts.init()
    for b, full in zip(ts.plan.buckets, ts._full):
        assert tuple(full.shape) == (b.padded_size,)
        assert ts.ring.direct_links(full) is None
    got = model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, 64, (2, 8))).long()
    state, metrics = ts.step(state, ids)
    assert np.isfinite(float(metrics["loss"]))
    params = {k: v.clone() for k, v in model.named_parameters()}
    ts.close()
    for k, v in model.named_parameters():
        assert torch.equal(v, params[k]), k


# ---------------------------------------------------------------------------
# the K5 ring's dataflow: the first hop in the gradient's dtype
# ---------------------------------------------------------------------------

def _rs_update_hops(gbufs, params, states, optimizer, *, mean_world):
    """The K5 ring's dataflow in plain PyTorch over all W ranks (arguments
    and result as `fused_reduce_scatter_update_stacked`): each round's hop
    in the dtype the kernel sends it in — round 0 the local chunk in the
    gradient's own dtype, later rounds fp32 partials — widened to fp32 on
    receipt, before the receiver adds its own chunk."""
    world, ss = params.shape
    chunks = gbufs.reshape(world, world, ss)       # [rank, chunk, ss]
    hop = [chunks[i, (i - 1) % world] for i in range(world)]
    for r in range(1, world):
        recv = [hop[(i - 1) % world] for i in range(world)]
        hop = [recv[i].float() + chunks[i, (i - 1 - r) % world].float()
               for i in range(world)]
    for i in range(world):                         # hop[i] is chunk i
        TCM._update_plain(optimizer, hop[i], states[i], params[i],
                          mean_world, 0)
    return params, states


#: name -> (JAX optimizer, port optimizer, bitwise against JAX?)
_TWIN_OPTS = {
    # p - 1.0 * g rounds once with or without an FMA: the ring sum bare
    "sgd": (jopt.fused_sgd(lr=1.0), topt.fused_sgd(lr=1.0), True),
    "sgd_momentum": (jopt.fused_sgd(lr=0.05, momentum=0.9),
                     topt.fused_sgd(lr=0.05, momentum=0.9), False),
    "adamw": (jopt.fused_adamw(lr=1e-3, weight_decay=0.01),
              topt.fused_adamw(lr=1e-3, weight_decay=0.01), False),
}


@pytest.mark.parametrize("optname", sorted(_TWIN_OPTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("world", [2, 4])
def test_hops_twin_is_the_stacked_version_and_jax(world, dtype, optname):
    jo, to, jax_bitwise = _TWIN_OPTS[optname]
    ss = 40
    rs = np.random.RandomState(10 + world)
    gstack = [jnp.asarray(rs.randn(world, world * ss).astype(np.float32))
              .astype(_JDT[dtype]) for _ in range(2)]
    p0 = jnp.asarray(rs.randn(world * ss).astype(np.float32))
    want = _jax_rs_update(jo, world, gstack, p0, None)
    hp = _to_torch(p0).reshape(world, ss).clone()
    sp = hp.clone()
    hs = [to.init(hp[i]) for i in range(world)]
    ss_ = [to.init(sp[i]) for i in range(world)]
    for g, w in zip(gstack, want):
        tg = _to_torch(g)
        _rs_update_hops(tg, hp, hs, to, mean_world=world)
        TCM.fused_reduce_scatter_update_stacked(tg, sp, ss_, to,
                                                mean_world=world)
        np.testing.assert_array_equal(_bits(hp), _bits(sp))
        for a, b in zip(hs, ss_):
            assert a.keys() == b.keys()
            for k in a:
                if torch.is_tensor(a[k]):
                    np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]))
                else:
                    assert a[k] == b[k]
        got = hp.reshape(-1).numpy()
        if jax_bitwise:
            np.testing.assert_array_equal(got.view(np.int32),
                                          w.view(np.int32))
        else:
            np.testing.assert_allclose(got, w, **FP32_TOL)
