"""The port's tensor fusion (dear_pytorch_tpu_torch.ops.fusion) against the
JAX package's: given the same leaf list in the same order (JAX's sorted-key
pytree order, passed to the port explicitly), every planner gives the same
buckets, offsets, padded and shard sizes. Pack and unpack round-trip, and
unpacked leaves are views into the flat buffer. Plans are integers: the
comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.ops import fusion as jF
from dear_pytorch_tpu_torch.ops import fusion as tF

_DT = {jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _tree():
    """A params pytree with ragged sizes, mixed dtypes and 7 layers."""
    rs = np.random.RandomState(0)
    shapes = {
        "embed": {"embedding": (61, 32)},
        "h_0": {"attn": {"kernel": (32, 96), "bias": (96,)},
                "ln": {"scale": (32,), "bias": (32,)}},
        "h_1": {"attn": {"kernel": (32, 96), "bias": (96,)},
                "mlp": {"kernel": (32, 129), "bias": (129,)}},
        "head": {"kernel": (32, 7)},
        "tiny": {"bias": (3,)},
    }

    def build(d, path=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = build(v, path + k)
            else:
                dt = jnp.bfloat16 if "mlp" in path else jnp.float32
                out[k] = jnp.asarray(rs.randn(*v), dt)
        return out

    return build(shapes)


def _leaves(jplan):
    return [(s.name, s.shape, _DT[jnp.dtype(s.dtype)]) for s in jplan.leaves]


def _same(tplan, jplan):
    assert tplan.world == jplan.world and tplan.epoch == jplan.epoch
    assert [(s.name, s.layer, tuple(s.shape), s.size) for s in tplan.leaves] \
        == [(s.name, s.layer, tuple(s.shape), s.size) for s in jplan.leaves]
    assert [(b.index, b.leaf_ids, b.offsets, b.size, b.padded_size,
             b.shard_size) for b in tplan.buckets] == \
        [(b.index, b.leaf_ids, b.offsets, b.size, b.padded_size,
          b.shard_size) for b in jplan.buckets]
    for b in range(tplan.num_buckets):
        np.testing.assert_array_equal(tplan.segment_ids(b),
                                      jplan.segment_ids(b))
    for i in range(len(tplan.leaves)):
        assert tplan.bucket_of_leaf(i) == jplan.bucket_of_leaf(i)
    assert tplan.describe() == jplan.describe()
    assert tplan.total_size == jplan.total_size


@pytest.mark.parametrize("world", [1, 2, 3, 8])
@pytest.mark.parametrize("threshold", [None, 0.004, 0.02, 25.0])
def test_plan_by_threshold_matches_jax(world, threshold):
    tree = _tree()
    jplan = jF.plan_by_threshold(tree, world, threshold)
    _same(tF.plan_by_threshold(_leaves(jplan), world, threshold), jplan)
    _same(tF.make_plan(_leaves(jplan), world, threshold_mb=threshold), jplan)
    assert tF.layer_sizes(_leaves(jplan)) == jF.layer_sizes(tree)
    assert tF.layer_sizes(_leaves(jplan), in_bytes=False) == \
        jF.layer_sizes(tree, in_bytes=False)
    assert tF.layer_sizes(_leaves(jplan), comm_itemsize=2) == \
        jF.layer_sizes(tree, comm_itemsize=2)


@pytest.mark.parametrize("k", [1, 2, 3, -1])
def test_plan_by_nearby_layers_matches_jax(k):
    tree = _tree()
    jplan = jF.plan_by_nearby_layers(tree, 4, k)
    _same(tF.plan_by_nearby_layers(_leaves(jplan), 4, k), jplan)
    _same(tF.make_plan(_leaves(jplan), 4, nearby_layers=k), jplan)
    with pytest.raises(ValueError):
        tF.plan_by_nearby_layers(_leaves(jplan), 4, 0)


def test_plan_by_flags_and_groups_match_jax():
    tree = _tree()
    n_layers = len(jF.layer_sizes(tree))
    flags = [1, 0, 0, 1, 0, 1, 1][:n_layers]
    jplan = jF.plan_by_flags(tree, 2, flags)
    leaves = _leaves(jplan)
    _same(tF.plan_by_flags(leaves, 2, flags), jplan)
    _same(tF.make_plan(leaves, 2, threshold_mb=0.001, nearby_layers=2,
                       flags=flags), jplan)     # flags win
    groups = [[0, 1], [2], [3, 4, 5, 6]]
    _same(tF.plan_by_groups(leaves, 3, groups),
          jF.plan_by_groups(tree, 3, groups))
    with pytest.raises(ValueError, match="entries"):
        tF.plan_by_flags(leaves, 2, [1])


@pytest.mark.parametrize("n,itemsize,mb", [
    (0, 4, 1.0), (10, 4, None), (10, 4, 0), (1000, 4, 0.001),
    (1 << 20, 2, 0.5), (7, 4, 1e-9)])
def test_chunk_bounds_match_jax(n, itemsize, mb):
    assert tF.chunk_bounds(n, itemsize, mb) == jF.chunk_bounds(n, itemsize,
                                                               mb)


@pytest.mark.parametrize("world", [1, 3, 5])
def test_rescale_plan_matches_jax(world):
    tree = _tree()
    jplan = jF.plan_by_threshold(tree, 2, 0.004)
    tplan = tF.plan_by_threshold(_leaves(jplan), 2, 0.004)
    _same(tF.rescale_plan(tplan, world, epoch=3),
          jF.rescale_plan(jplan, world, epoch=3))
    _same(tF.rescale_plan(tplan, world), jF.rescale_plan(jplan, world))
    assert tF.rescale_plan(tplan, 2) is tplan


def test_pack_unpack_round_trip_and_views():
    tree = _tree()
    jplan = jF.plan_by_threshold(tree, 3, 0.004)
    plan = tF.plan_by_threshold(_leaves(jplan), 3, 0.004)
    flat = {s.name: torch.from_numpy(np.array(x, np.float32)).to(
        _DT[jnp.dtype(x.dtype)])
        for s, x in zip(jplan.leaves, jax.tree_util.tree_leaves(tree))}
    bufs = tF.pack_all(flat, plan, dtype=torch.float32)
    jbufs = jF.pack_all(tree, jplan, dtype=jnp.float32)
    for b, jb in zip(bufs, jbufs):
        assert b.dtype == torch.float32 and b.shape[0] % 3 == 0
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    back = tF.unpack_all(bufs, plan)
    for name, x in flat.items():
        assert back[name].dtype == x.dtype
        assert torch.equal(back[name], x), name
    views = tF.unpack_all(bufs, plan, cast=False)
    for b, buf in zip(plan.buckets, bufs):
        for leaf_id in b.leaf_ids:
            v = views[plan.leaves[leaf_id].name]
            assert v.untyped_storage().data_ptr() == \
                buf.untyped_storage().data_ptr()
    # a write through a view lands in the flat buffer (what the train step
    # relies on: parameters live inside the gathered buffer)
    name = plan.leaves[plan.buckets[0].leaf_ids[0]].name
    views[name].fill_(7.0)
    assert float(bufs[0][0]) == 7.0
    # pack into a given buffer zeroes its pad
    out = torch.full((plan.buckets[0].padded_size,), 9.0)
    tF.pack_bucket(flat, plan, 0, out=out)
    assert float(out[plan.buckets[0].size:].abs().sum()) == 0.0


def test_module_order_plan():
    """By default a plan follows ``named_parameters()``: module order."""
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.LayerNorm(3),
                                torch.nn.Linear(3, 2))
    plan = tF.make_plan(model, 2, threshold_mb=None)
    assert [s.name for s in plan.leaves] == [n for n, _ in
                                             model.named_parameters()]
    assert [s.layer for s in plan.leaves] == [0, 0, 1, 1, 2, 2]
    assert plan.num_buckets == 1 and plan.buckets[0].size == 4 * 3 + 3 + 3 \
        + 3 + 3 * 2 + 2
    plan3 = tF.make_plan(model, 1, nearby_layers=1)
    assert plan3.num_buckets == 3
    with pytest.raises(ValueError, match="world"):
        tF.plan_by_threshold(model, 0)
