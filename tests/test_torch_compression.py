"""The port's gradient compression (dear_pytorch_tpu_torch.ops.compression
and the compressed schedules of parallel.dear) against the JAX package's,
on the CPU.

- Every compressor's payload, residual and decompression on the same numpy
  input, bitwise: random values, and ties (zero padding, equal magnitudes
  of both signs, a density that makes top-k pick zeros; gaussian with
  fewer than k entries over its threshold). gaussian's statistics (mean,
  population std, the erfinv quantile, the refined threshold) are held to
  1e-6 of JAX's, and the inputs keep every |x| clear of the threshold, so
  its payload is held bitwise too. The sign words equal JAX's uint32
  words bit for bit.
- The four reductions at worlds 2 and 4 (one spawn of four jax-free ranks;
  world 2 on ``dist.new_group([0, 1])``) against JAX's under ``shard_map``
  (1e-6: sums in another order); gTop-k's kept indices exactly; gTop-k's
  re-added residual through the train step.
- 3 steps of the small GPT (tests/test_torch_dear.py's) with each
  compressor on ``dear`` and ``allreduce`` at worlds 1 and 2, and at world
  2 eftopk with gTop-k, with momentum correction, and with bf16 gradients
  (at density 1: see `WORLD2_CASES`):
  per step the losses, the gathered parameters by name and every rank's
  residual (and velocity) by name. The port trains on a plan in JAX's
  leaf order (the same buckets, so the same per-bucket selections), and
  JAX's step trains the parameters in the port's layout (`_port_layout`),
  so that every element sits at the same place in both packages' buckets:
  where gaussian passes fewer than k entries, the zeros top-k picks are
  the lowest indices, which depends on that order.
  Tolerances: 1e-5 in fp32, 2e-4 with bf16 gradients
  (tests/test_torch_dear.py's reasoning). Under the sign compressors the
  key bias is left out of the elementwise comparison: its gradient is 0
  in exact arithmetic (softmax is invariant to one shift of a score row),
  so both packages send the signs of rounding noise; it is held to its
  bound instead. qint8's rounding is discontinuous: an element on a
  rounding boundary may round to neighbouring levels in the two packages;
  it is recognised and set aside (`_compare`), at most two per run.
- The build-time guards, with JAX's messages.
"""

import dataclasses
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.comm import collectives as jC
from dear_pytorch_tpu.ops import compression as J
from dear_pytorch_tpu.ops import fused_sgd as jopt
from dear_pytorch_tpu.ops import fusion as jF
from dear_pytorch_tpu.parallel import dear as jdear
from dear_pytorch_tpu_torch.models import gpt as tgpt
from dear_pytorch_tpu_torch.models.convert import gpt_params_from_jax
from dear_pytorch_tpu_torch.ops import compression as T
from dear_pytorch_tpu_torch.parallel import dear as tdear
from tests import test_torch_dear as TD

NAMES = ("topk", "eftopk", "gaussian", "signum", "efsignum", "qint8")
STEPS = TD.STEPS
TOL, TOL_BF16, TOL_RED = TD.TOL, TD.TOL_BF16, 1e-6


# ---------------------------------------------------------------------------
# the compressors, one buffer
# ---------------------------------------------------------------------------


def _leaves(payload):
    """A payload's tensors in key order, as numpy (sign words as uint32)."""
    parts = ([payload[k] for k in sorted(payload)]
             if isinstance(payload, dict) else [payload])
    out = []
    for p in parts:
        a = p.numpy() if torch.is_tensor(p) else np.asarray(p)
        out.append(a.view(np.uint32) if a.dtype == np.int32
                   and isinstance(payload, (torch.Tensor, jax.Array)) else a)
    return out


def _inputs(case):
    """(x, residual, density): ``random``; ``ties`` (zero padding, equal
    magnitudes of both signs, k past the nonzeros); ``gauss_few`` (fewer
    than k entries over gaussian's threshold)."""
    rng = np.random.default_rng({"random": 1, "ties": 2, "gauss_few": 3}[case])
    n = 1000
    if case == "random":
        x = rng.normal(size=n).astype(np.float32)
        return x, (0.1 * rng.normal(size=n)).astype(np.float32), 0.05
    if case == "ties":
        x = rng.normal(size=n).astype(np.float32)
        x[n - 120:] = 0.0                       # the bucket's padding
        x[[3, 30, 300, 600]] = 5.0              # equal magnitudes, both signs
        x[[7, 70, 700]] = -5.0
        x[[11, 111]] = 0.0                      # a parameter with no gradient
        return x, np.zeros(n, np.float32), 0.95
    x = (1e-4 * rng.normal(size=n)).astype(np.float32)
    x[rng.choice(n, 80, replace=False)] = rng.choice([-1.0, 1.0], 80) * \
        rng.uniform(5.0, 10.0, 80).astype(np.float32)
    return x, np.zeros(n, np.float32), 0.1


def _jax_threshold(x, density):
    """JAX's gaussian threshold, step for step (compression.py:128-150)."""
    k = J._k_of(x.shape[0], density)
    mean, std = jnp.mean(x), jnp.std(x) + 1e-12
    thres = jnp.abs(mean + J._normal_ppf(1.0 - density / 2.0) * std)
    for _ in range(3):
        count = jnp.sum(jnp.abs(x) > thres)
        thres = jnp.where(count < 2 * k / 3, thres * 0.5, thres)
        thres = jnp.where(count > 4 * k / 3, thres * 1.5, thres)
    return float(mean), float(std), float(thres)


@pytest.mark.parametrize("case", ["random", "ties", "gauss_few"])
@pytest.mark.parametrize("name", NAMES)
def test_compressor_matches_jax(name, case):
    x, res0, density = _inputs(case)
    n = x.shape[0]
    jc, tc = J.get_compressor(name), T.get_compressor(name)
    jres, tres = jc.init(n, jnp.float32), tc.init(n, torch.float32)
    stateful = not isinstance(jres, tuple)
    assert stateful == torch.is_tensor(tres)
    if stateful:
        jres, tres = jnp.asarray(res0), torch.from_numpy(res0.copy())
    xt = torch.from_numpy(x.copy())
    jp, js = jc.compress(jnp.asarray(x), jres, density)
    tp, ts = tc.compress(xt, tres, density)
    assert torch.equal(xt, torch.from_numpy(x))   # inputs are not written
    for got, want in zip(_leaves(tp), _leaves(jp), strict=True):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if stateful:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    else:
        assert ts == js == ()
    np.testing.assert_array_equal(
        tc.decompress(tp, n, torch.float32).numpy(),
        np.asarray(jc.decompress(jp, n, jnp.float32)))
    if name == "gaussian":
        x_in = x + res0
        want = _jax_threshold(jnp.asarray(x_in), density)
        xt_in = torch.from_numpy(x_in)
        got = (float(xt_in.mean()), float(xt_in.std(correction=0) + 1e-12),
               float(T._gaussian_threshold(xt_in, density)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        thres, mag = want[2], np.abs(x_in)
        assert np.min(np.abs(mag - thres)) > 1e-4 * thres   # clear of it
        count, k = int(np.sum(mag > thres)), T._k_of(n, density)
        idx = tp["indices"].numpy()
        assert len(idx) == k
        # the sent values are x over the threshold, else 0; the residual is
        # x off the sent indices and 0 on them
        np.testing.assert_array_equal(
            tp["values"].numpy(), np.where(mag[idx] > thres, x_in[idx], 0.0))
        off = np.setdiff1d(np.arange(n), idx)
        np.testing.assert_array_equal(ts.numpy()[off], x_in[off])
        assert not ts.numpy()[idx].any()
        if case == "gauss_few":   # top-k picked zeros: the lowest indices
            assert 2 * k / 3 <= count < k
            zeros = idx[count:]
            below = np.flatnonzero(mag <= thres)
            np.testing.assert_array_equal(zeros, below[:k - count])
    if case == "ties" and name in ("topk", "eftopk"):
        idx = tp["indices"].numpy()   # |5.0|: the lower index first
        assert idx[:7].tolist() == [3, 7, 30, 70, 300, 600, 700]


def test_sign_words_are_jax_bits():
    x = np.random.default_rng(4).normal(size=70).astype(np.float32)
    x[[0, 31, 32, 69]] = [0.0, -0.0, -1.0, 5.0]
    words = T.pack_signs(torch.from_numpy(x))
    assert words.dtype == torch.int32 and words.shape == (T.packed_words(70),)
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(J.pack_signs(jnp.asarray(x))))
    np.testing.assert_array_equal(
        T.unpack_signs(words, 70).numpy(),
        np.asarray(J.unpack_signs(J.pack_signs(jnp.asarray(x)), 70)))


def test_registry_and_wire_ratio_match_jax():
    assert sorted(T.compressors, key=str) == sorted(J.compressors, key=str)
    assert (T.SPARSE, T.SIGN, T.QUANT) == (J.SPARSE, J.SIGN, J.QUANT)
    for name in (None, "none", *NAMES, "custom"):
        for n in (1, 1000, 4097):
            for density in (0.001, 0.01, 0.5, 1.0):
                assert T.wire_ratio(name, n, density) == \
                    J.wire_ratio(name, n, density)
    with pytest.raises(KeyError) as port_err:
        T.get_compressor("zstd")
    with pytest.raises(KeyError) as jax_err:
        J.get_compressor("zstd")
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# the reductions and the GPT runs at world 2 and 4: one spawn of 4 ranks
# ---------------------------------------------------------------------------

N_RED, DENSITY_RED = 100, 0.1
GTOPK_N = 32


def _red_inputs():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, N_RED)).astype(np.float32)
    x[:, 90:] = 0.0                            # ties: a zero tail
    return x


def _gtopk_grads(world):
    """Rank d's gradient: d + 1 at {2d, 2d + 1} (the JAX test's): each rank
    sends its two; the global top-2 keeps the last rank's only."""
    c = np.zeros((world, GTOPK_N), np.float32)
    for d in range(world):
        c[d, 2 * d:2 * d + 2] = d + 1.0
    return c


# the port's side of the reductions and of the gTop-k step, per world; the
# worker below runs its source in a jax-free process
def run_reductions(group, rank, world, x, c):
    import torch
    from dear_pytorch_tpu_torch.ops import compression as Z
    from dear_pytorch_tpu_torch.ops import fused_sgd as topt
    from dear_pytorch_tpu_torch.parallel import dear as tdear

    xr = torch.from_numpy(x[rank].copy())
    n, f32 = xr.shape[0], torch.float32
    k = Z._k_of(n, 0.1)
    out = {}
    p, _ = Z.get_compressor("topk").compress(xr, (), 0.1)
    out["sparse"] = Z.sparse_allreduce(p, n, f32, group).numpy()
    p, _ = Z.get_compressor("eftopk").compress(xr, torch.zeros(n), 0.1)
    dense, kept = Z.gtopk_sparse_allreduce(p, n, f32, k, group)
    out["gtopk"], out["gtopk_kept"] = dense.numpy(), kept.numpy()
    p, _ = Z.get_compressor("qint8").compress(xr, torch.zeros(n), 1.0)
    out["int8"] = Z.int8_allreduce(p, n, f32, group).numpy()
    p, _ = Z.get_compressor("signum").compress(xr, (), 1.0)
    out["sign"] = Z.sign_majority_vote_allreduce(p, n, f32, group).numpy()

    class Vec(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(c.shape[1]))

        @property
        def device(self):
            return self.w.device

    ts = tdear.build_train_step(
        lambda m, b: (m.w * b).sum(), Vec(), group=group, device="cpu",
        mode="allreduce", compressor="eftopk", density=2 / c.shape[1],
        gtopk=True, threshold_mb=None, optimizer=topt.fused_sgd(lr=0.1))
    state, _ = ts.step(ts.init(), torch.from_numpy(c[rank].copy()))
    out["gtopk_residual"] = state.comp_state[0].numpy()
    out["gtopk_w"] = ts.gather_params(state)["w"].numpy()
    out["gtopk_comp_launches"] = np.array(ts.comp_launches)
    ts.close()
    return out


def run_comp(opts, group, rank, world, state_dict, ids, cfg, names):
    """3 steps of the small GPT with ``opts``' compression on a plan over
    ``names`` (JAX's leaf order); per step the loss, the gathered
    parameters and this rank's residual and velocity by name."""
    import torch
    from dear_pytorch_tpu_torch.models import gpt as tgpt
    from dear_pytorch_tpu_torch.ops import fused_sgd as topt
    from dear_pytorch_tpu_torch.ops import fusion as tF
    from dear_pytorch_tpu_torch.parallel import dear as tdear

    model = tgpt.GptLmHeadModel(cfg, device="cpu")
    model.load_state_dict(state_dict)
    params = dict(model.named_parameters())
    plan = tF.make_plan([(n, tuple(params[n].shape), params[n].dtype)
                         for n in names], world, threshold_mb=0.02)

    def loss_fn(m, batch):
        logits = m(batch["input_ids"], train=True)
        return tgpt.gpt_lm_loss(logits, batch["input_ids"],
                                vocab_size=cfg.vocab_size)

    mc = opts.get("mc", 0.0)
    ts = tdear.build_train_step(
        loss_fn, model, group=group, device="cpu", mode=opts["mode"],
        optimizer=topt.fused_sgd(lr=opts["lr"], momentum=0.0 if mc else 0.9),
        plan=plan, comm_dtype=torch.bfloat16 if opts.get("comm") else None,
        compressor=opts["compressor"], density=opts["density"],
        gtopk=opts.get("gtopk", False), momentum_correction=mc)
    per = ids.shape[0] // world
    batch = {"input_ids": torch.from_numpy(ids[rank * per:(rank + 1) * per])}
    state = ts.init()
    out = {"losses": []}
    for step in range(3):
        state, m = ts.step(state, batch)
        out["losses"].append(float(m["loss"]))
        for k, v in ts.gather_params(state).items():
            out[f"s{step}.p.{k}"] = v.numpy().copy()
        for part in ("res", "vel"):
            bufs = [e.get(part, ()) if isinstance(e, dict)
                    else (e if part == "res" else ())
                    for e in state.comp_state]
            if bufs and all(torch.is_tensor(b) for b in bufs):
                for k, v in tF.unpack_all(bufs, plan).items():
                    out[f"s{step}.{part}.{k}"] = v.numpy().copy()
    out["counts"] = [ts.comp_launches, ts.rs_launches, ts.ag_launches,
                     ts.ar_launches, ts.update_launches, ts.plan.num_buckets]
    ts.close()
    return out


_WORKER = '''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.models import gpt as tgpt
{run_reductions}
{run_comp}
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store")
g4 = backend.init("cpu")
g2 = dist.new_group([0, 1])
g3 = dist.new_group([0, 1, 2])
inputs = np.load(out + "/inputs.npz")
if rank < 3:    # gTop-k refuses a world that is not a power of two
    from dear_pytorch_tpu_torch.ops import compression as Z
    from dear_pytorch_tpu_torch.parallel import dear as tdear
    msgs = []
    for call in (lambda: Z.gtopk_sparse_allreduce(
                     {{"values": torch.ones(2), "indices":
                       torch.arange(2, dtype=torch.int32)}}, 4,
                     torch.float32, 2, g3),
                 lambda: tdear.build_train_step(
                     lambda m, b: m(b).sum(),
                     tgpt.GptLmHeadModel(tgpt.GptConfig(
                         vocab_size=8, hidden_size=8, num_hidden_layers=1,
                         num_attention_heads=1, intermediate_size=8,
                         max_position_embeddings=8), device="cpu"),
                     group=g3, device="cpu", mode="allreduce",
                     compressor="topk", gtopk=True)):
        try:
            call()
            msgs.append("")
        except ValueError as e:
            msgs.append(str(e))
    with open(f"{{out}}/gtopk3.rank{{rank}}.json", "w") as f:
        json.dump(msgs, f)
for w, g in ((4, g4), (2, g2)):
    if rank < w:
        got = run_reductions(g, rank, w, inputs["x"], inputs[f"c{{w}}"])
        np.savez(f"{{out}}/red{{w}}.rank{{rank}}.npz", **got)
if rank < 2:
    state_dict = {{k[3:]: torch.from_numpy(inputs[k]) for k in inputs.files
                   if k.startswith("sd.")}}
    from dear_pytorch_tpu_torch.models import gpt as tgpt
    cfg = tgpt.GptConfig(**json.loads(open(out + "/cfg.json").read()))
    names = json.loads(open(out + "/names.json").read())
    cases = json.loads(open(out + "/cases.json").read())
    for name, opts in sorted(cases.items()):
        got = run_comp(opts, g2, rank, 2, state_dict, inputs["ids"], cfg,
                       names)
        np.savez(f"{{out}}/{{name}}.rank{{rank}}.npz", **got)
dist.barrier()
backend.shutdown()
'''

#: the GPT runs: name -> options, at worlds 1 and 2
CASES = {f"{mode}_{name}": {"mode": mode, "compressor": name,
                            "density": 0.05,
                            "lr": 0.003 if name in T.SIGN else 0.05}
         for mode in ("dear", "allreduce") for name in NAMES}
#: world 2 only
WORLD2_CASES = {
    "allreduce_eftopk_gtopk": {"mode": "allreduce", "compressor": "eftopk",
                               "density": 0.05, "lr": 0.05, "gtopk": True},
    "allreduce_eftopk_mc": {"mode": "allreduce", "compressor": "eftopk",
                            "density": 0.05, "lr": 0.05, "mc": 0.9},
    "dear_eftopk_gtopk_mc": {"mode": "dear", "compressor": "eftopk",
                             "density": 0.05, "lr": 0.05, "gtopk": True,
                             "mc": 0.9},
    # bf16 gradients: the two packages' can differ by one bf16 step (2^-8
    # relative), enough to move an element across the k-th largest value,
    # so this case sends everything (k = n): the bf16 gradient's way
    # through the compressed leg, held to 2e-4
    "dear_eftopk_bf16": {"mode": "dear", "compressor": "eftopk",
                         "density": 1.0, "lr": 0.05, "comm": "bf16"},
}


def _port_name(jname: str) -> str:
    parts = jname.split("/")
    last = {"kernel": "weight", "scale": "weight",
            "embedding": "weight"}.get(parts[-1], parts[-1])
    return ".".join(parts[:-1] + [last])


@pytest.fixture(scope="module")
def jax_params():
    return TD._init_params()


@pytest.fixture(scope="module")
def state_dict(jax_params):
    return gpt_params_from_jax(jax.tree.map(np.asarray, jax_params),
                               TD._torch_config())


@pytest.fixture(scope="module")
def leaf_names(jax_params):
    """The port's parameter names in the JAX package's leaf order."""
    plan = jF.make_plan(jax_params, 1, threshold_mb=TD.THRESHOLD_MB)
    names = [_port_name(s.name) for s in plan.leaves]
    model = tgpt.GptLmHeadModel(TD._torch_config(), device="cpu")
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())
    return names


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, state_dict, leaf_names):
    out = str(tmp_path_factory.mktemp("compression_world4"))
    np.savez(os.path.join(out, "inputs.npz"), x=_red_inputs(),
             c2=_gtopk_grads(2), c4=_gtopk_grads(4), ids=TD._ids(),
             **{"sd." + k: v.numpy() for k, v in state_dict.items()})
    cfg = dataclasses.asdict(TD._torch_config())
    cfg = {k: v for k, v in cfg.items() if k not in ("dtype",
                                                     "kv_cache_dtype")}
    for fname, obj in (("cfg.json", cfg), ("names.json", leaf_names),
                       ("cases.json", {**CASES, **WORLD2_CASES})):
        with open(os.path.join(out, fname), "w") as f:
            json.dump(obj, f)
    code = _WORKER.format(root=TD.ROOT,
                          run_reductions=inspect.getsource(run_reductions),
                          run_comp=inspect.getsource(run_comp))
    TD.spawn_ranks(code, 4, out)
    return out


def _load(out, name, world):
    return [dict(np.load(os.path.join(out, f"{name}.rank{r}.npz")))
            for r in range(world)]


def _jax_reductions(world):
    x = jnp.asarray(_red_inputs()[:world])
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("dp",))
    n, f32 = N_RED, jnp.float32

    def fn(t):
        p, _ = J.get_compressor("topk").compress(t, (), DENSITY_RED)
        sparse = J.sparse_allreduce(p, n, f32, "dp")
        p, _ = J.get_compressor("eftopk").compress(t, jnp.zeros(n),
                                                   DENSITY_RED)
        gtopk, kept = J.gtopk_sparse_allreduce(
            p, n, f32, "dp", J._k_of(n, DENSITY_RED))
        p, _ = J.get_compressor("qint8").compress(t, jnp.zeros(n), 1.0)
        int8 = J.int8_allreduce(p, n, f32, "dp")
        p, _ = J.get_compressor("signum").compress(t, (), 1.0)
        sign = J.sign_majority_vote_allreduce(p, n, f32, "dp")
        return sparse, gtopk, kept, int8, sign

    outs = jC.spmd_call(fn, x, mesh=mesh)
    return dict(zip(("sparse", "gtopk", "gtopk_kept", "int8", "sign"),
                    (np.asarray(o) for o in outs)))


def _jax_gtopk_residual(world):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("dp",))
    params = {"w": jnp.zeros((GTOPK_N,), jnp.float32)}
    ts = jdear.build_train_step(
        lambda p, b: jnp.sum(p["w"] * b[0]), params, mesh=mesh,
        mode="allreduce", compressor="eftopk", density=2 / GTOPK_N,
        gtopk=True, threshold_mb=None, donate=False,
        optimizer=jopt.fused_sgd(lr=0.1))
    state, _ = ts.step(ts.init(params), jnp.asarray(_gtopk_grads(world)))
    return (np.asarray(state.comp_state[0]),
            np.asarray(ts.gather_params(state)["w"]))


@pytest.mark.parametrize("world", [2, 4])
def test_reductions_match_jax(world, spawned):
    ranks = _load(spawned, f"red{world}", world)
    want = _jax_reductions(world)
    x = _red_inputs()[:world]
    for r, got in enumerate(ranks):
        for key in ("sparse", "gtopk", "int8", "sign"):
            np.testing.assert_allclose(got[key], want[key][r], rtol=TOL_RED,
                                       atol=TOL_RED, err_msg=key)
            np.testing.assert_array_equal(got[key], ranks[0][key])
        np.testing.assert_array_equal(got["gtopk_kept"], want["gtopk_kept"][r])
    # the definitions: at density 1 nothing is dropped; the int8 mean is
    # within the ranks' quantization error; the vote is the sign of the sum
    np.testing.assert_allclose(ranks[0]["int8"], x.mean(0),
                               atol=float(np.abs(x).max()) / 127.0)
    np.testing.assert_array_equal(ranks[0]["sign"],
                                  np.where(np.sign(np.where(
                                      x >= 0, 1.0, -1.0)).sum(0) >= 0,
                                      1.0, -1.0))


@pytest.mark.parametrize("world", [2, 4])
def test_gtopk_readds_rejected_mass(world, spawned):
    """A coordinate a rank sent that the global top-k rejected returns to
    its residual (reference wfbp/dopt.py:726-728), as in JAX's step: the
    rows equal JAX's, and hold the JAX test's invariants."""
    ranks = _load(spawned, f"red{world}", world)
    res, w = _jax_gtopk_residual(world)
    c = _gtopk_grads(world)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["gtopk_residual"][:GTOPK_N],
                                   res[r][:GTOPK_N], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["gtopk_w"], w, rtol=1e-6, atol=1e-7)
        assert int(got["gtopk_comp_launches"]) == world.bit_length() - 1
    for d in range(world - 1):
        np.testing.assert_array_equal(
            ranks[d]["gtopk_residual"][2 * d:2 * d + 2],
            c[d, 2 * d:2 * d + 2])
    last = world - 1
    assert not ranks[last]["gtopk_residual"].any()


def test_gtopk_refuses_a_world_not_a_power_of_two(spawned):
    """At world 3 the reduction raises JAX's ValueError, and the build
    raises it before any step."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:3]), ("dp",))
    payload = {"values": jnp.ones((3, 2)),
               "indices": jnp.zeros((3, 2), jnp.int32)}
    with pytest.raises(ValueError) as jax_err:
        jC.spmd_call(lambda v, i: J.gtopk_sparse_allreduce(
            {"values": v, "indices": i}, 4, jnp.float32, "dp", 2),
            payload["values"], payload["indices"], mesh=mesh)
    for r in range(3):
        with open(os.path.join(spawned, f"gtopk3.rank{r}.json")) as f:
            assert json.load(f) == [str(jax_err.value)] * 2


# ---------------------------------------------------------------------------
# the GPT runs against JAX's
# ---------------------------------------------------------------------------


def _port_layout(params):
    """JAX's parameter tree with every leaf in the port's layout (a kernel
    ``[in, ...]`` as the ``[out, in]`` weight; a ``[nh, d]`` bias flat), and
    the function that maps such a tree back. JAX's step trains the same
    function over these leaves (SGD is elementwise), and its buckets then
    hold every element where the port's do: which zeros top-k picks when
    gaussian passes fewer than k (the lowest indices) is a property of the
    bucket's element order."""
    sd = gpt_params_from_jax(jax.tree.map(np.asarray, params),
                             TD._torch_config())
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    names = [_port_name(jF._path_str(path)) for path, _ in flat]
    shapes = [leaf.shape for _, leaf in flat]
    kernel = [name.endswith(".weight") and len(shape) > 1
              and not name.startswith(("wte", "wpe"))
              for name, shape in zip(names, shapes)]
    tree = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(sd[name].numpy()) for name in names])

    def back(t):
        leaves = jax.tree_util.tree_leaves(t)
        return jax.tree_util.tree_unflatten(treedef, [
            (x.T if k else x).reshape(shape)
            for x, k, shape in zip(leaves, kernel, shapes)])

    return tree, back


def _named(tree) -> dict:
    """A tree in the port's layout, by the port's names."""
    return {_port_name(jF._path_str(path)): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _run_jax(opts, world, params, ids):
    """JAX's 3 steps over the parameters in the port's layout: per step the
    loss, the parameters and every rank's residual and velocity, by the
    port's names."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("dp",))
    model = TD.jgpt.GptLmHeadModel(TD._jax_config())
    tree, back = _port_layout(params)

    def loss_fn(p, batch):
        logits = model.apply({"params": back(p)}, batch["input_ids"],
                             train=False)
        return TD.jgpt.gpt_lm_loss(logits, batch["input_ids"],
                                   vocab_size=TD.VOCAB)

    mc = opts.get("mc", 0.0)
    ts = jdear.build_train_step(
        loss_fn, tree, mesh=mesh, mode=opts["mode"],
        optimizer=jopt.fused_sgd(lr=opts["lr"], momentum=0.0 if mc else 0.9),
        threshold_mb=TD.THRESHOLD_MB,
        comm_dtype=jnp.bfloat16 if opts.get("comm") else None,
        compressor=opts["compressor"], density=opts["density"],
        gtopk=opts.get("gtopk", False), momentum_correction=mc)
    state = ts.init(jax.tree.map(jnp.copy, tree))
    steps = []
    for _ in range(STEPS):
        state, m = ts.step(state, {"input_ids": jnp.asarray(ids)})
        got = {"loss": float(m["loss"]),
               "p": _named(ts.gather_params(state))}
        for part in ("res", "vel"):
            bufs = [e.get(part, ()) if isinstance(e, dict)
                    else (e if part == "res" else ())
                    for e in state.comp_state]
            if not all(isinstance(b, jax.Array) for b in bufs):
                continue
            got[part] = [_named(jF.unpack_all([b[r] for b in bufs], ts.plan))
                         for r in range(world)]
        steps.append(got)
    return steps, ts.plan.num_buckets


def _noise_only(opts, name):
    """The key bias under a sign compressor: the signs of rounding noise."""
    return opts["compressor"] in T.SIGN and name.endswith(".key.bias")


def _rounded_apart(mine, want, tol):
    """qint8's residual elements where the two packages' roundings of
    ``x / scale`` went to neighbouring levels: ``x`` on a rounding boundary
    (the residual at half a level, the leaf's largest), where inputs that
    differ in their last bits round apart. There the residuals mirror each
    other: ``+q/2`` and ``-q/2``."""
    top = np.abs(want).max()
    return ((np.abs(mine + want) <= tol) & (np.abs(mine - want) > tol)
            & (np.minimum(np.abs(mine), np.abs(want)) >= (1 - 1e-3) * top))


def _close(got, want, tol, skip, msg):
    if skip is not None:
        got, want = got[~skip], want[~skip]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


def _compare(opts, ranks, want, nb, world):
    """Per step the losses, the parameters and every rank's residual and
    velocity. qint8 is a discontinuous function of the gradient: an element
    whose ``x / scale`` lies on a rounding boundary can round to
    neighbouring levels in the two packages (their fp32 gradients differ in
    the last bits). Such an element is recognised in the residuals
    (`_rounded_apart`) and left out of the comparisons from then on, its
    parameter and residual differing by the effect of one level; at most
    two per run, everything else to the tolerance."""
    tol = TOL_BF16 if opts.get("comm") else TOL
    got = ranks[0]
    for mine in ranks[1:]:   # every rank reports the same losses and params
        for key in got:
            if key == "losses" or ".p." in key:
                np.testing.assert_array_equal(mine[key], got[key], key)
    np.testing.assert_allclose(got["losses"], [s["loss"] for s in want],
                               rtol=tol, atol=tol)
    bound = 3 * sum(0.9 ** i for i in range(STEPS)) * opts["lr"]
    apart: dict = {}
    for step, ws in enumerate(want):
        for part in ("res", "vel"):
            assert (part in ws) == any(k.startswith(f"s{step}.{part}.")
                                       for k in got)
            for r in range(world if part in ws else 0):
                for name, v in ws[part][r].items():
                    if _noise_only(opts, name):
                        continue
                    mine = ranks[r][f"s{step}.{part}.{name}"]
                    if opts["compressor"] in T.QUANT:
                        apart[name] = apart.get(name, False) | \
                            _rounded_apart(mine, v, tol)
                    _close(mine, v, tol, apart.get(name),
                           f"step {step} {part} rank {r} {name}")
        names = sorted(k[len(f"s{step}.p."):] for k in got
                       if k.startswith(f"s{step}.p."))
        assert names == sorted(ws["p"])
        for name in names:
            p = got[f"s{step}.p.{name}"]
            if _noise_only(opts, name):
                assert np.abs(p).max() <= bound + 1e-6
                continue
            _close(p, ws["p"][name], tol, apart.get(name),
                   f"step {step} {name}")
    assert sum(int(np.sum(m)) for m in apart.values()) <= 2, apart
    comp, rs, ag, ar, upd, n_buckets = (int(c) for c in got["counts"])
    assert n_buckets == nb >= 3
    per = (world.bit_length() - 1) if opts.get("gtopk") else 1
    assert (comp, rs, ar, upd) == (STEPS * nb * per, 0, 0, STEPS * nb)
    assert ag == ((STEPS + 1) * nb if opts["mode"] == "dear" else 0)
    if opts["compressor"] not in T.SIGN and not opts.get("mc"):
        assert got["losses"][-1] < got["losses"][0]


@pytest.fixture(scope="module")
def world1(state_dict, leaf_names):
    from dear_pytorch_tpu_torch.comm import backend

    group = backend.init("cpu")
    return {name: run_comp(opts, group, 0, 1, state_dict, TD._ids(),
                           TD._torch_config(), leaf_names)
            for name, opts in CASES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_world1_matches_jax(case, world1, jax_params):
    opts = CASES[case]
    want, nb = _run_jax(opts, 1, jax_params, TD._ids())
    _compare(opts, [world1[case]], want, nb, 1)


@pytest.mark.parametrize("case", sorted({**CASES, **WORLD2_CASES}))
def test_world2_matches_jax(case, spawned, jax_params):
    opts = {**CASES, **WORLD2_CASES}[case]
    want, nb = _run_jax(opts, 2, jax_params, TD._ids())
    _compare(opts, _load(spawned, case, 2), want, nb, 2)


# ---------------------------------------------------------------------------
# the guards
# ---------------------------------------------------------------------------


def test_guards_match_jax():
    """Compression's build-time guards, in JAX's order and with its
    messages: dear-fused, the other schedules, ``exclude_parts``, gTop-k
    without a top-k compressor, ``clip_norm``, momentum correction without
    a sparse compressor; an unknown name is JAX's KeyError."""
    from dear_pytorch_tpu_torch.comm import backend

    group = backend.init("cpu")
    model = tgpt.GptLmHeadModel(TD._torch_config(), device="cpu")
    params = TD._init_params()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    cases = [dict(mode="dear-fused", compressor="eftopk"),
             *[dict(mode=m, compressor="topk")
               for m in ("rsag", "rb", "bytescheduler", "fsdp")],
             dict(compressor="eftopk", exclude_parts=("allgather",)),
             dict(mode="allreduce", compressor="signum", gtopk=True),
             dict(mode="allreduce", gtopk=True),
             dict(compressor="qint8", clip_norm=1.0),
             dict(compressor="signum", momentum_correction=0.9),
             dict(momentum_correction=0.9),
             # the first guard that applies wins, in JAX's order
             dict(mode="fsdp", compressor="signum", gtopk=True,
                  clip_norm=1.0)]
    for kw in cases:
        with pytest.raises(ValueError) as port_err:
            tdear.build_train_step(lambda m, b: m(b).sum(), model,
                                   group=group, device="cpu", **kw)
        with pytest.raises(ValueError) as jax_err:
            jdear.build_train_step(lambda p, b: 0.0, params, mesh=mesh, **kw)
        assert str(port_err.value) == str(jax_err.value), kw
    with pytest.raises(KeyError) as port_err:
        tdear.build_train_step(lambda m, b: m(b).sum(), model, group=group,
                               device="cpu", compressor="zstd")
    with pytest.raises(KeyError) as jax_err:
        jdear.build_train_step(lambda p, b: 0.0, params, mesh=mesh,
                               compressor="zstd")
    assert str(port_err.value) == str(jax_err.value)
    # every registry compressor builds on allreduce and dear
    for mode in ("allreduce", "dear"):
        for name in NAMES:
            ts = tdear.build_train_step(
                lambda m, b: m(b).sum(), model, group=group, device="cpu",
                mode=mode, compressor=name, density=0.1,
                gtopk=name in T.SPARSE,
                momentum_correction=0.9 if name in T.SPARSE else 0.0)
            assert ts.compressor.name == name
            ts.close()


@pytest.mark.parametrize("mode", ["allreduce", "dear", "dear-fused", "rsag",
                                  "fsdp"])
@pytest.mark.parametrize("flags", [
    ["--compressor", "eftopk", "--density", "0.01", "--gtopk",
     "--momentum-correction", "0.9", "--momentum", "0.9"],
    ["--density", "0.5"], ["--remat-policy", "full"]])
def test_cli_compression_rule_matches_jax(mode, flags):
    """``config_from_args`` follows the JAX runner's rule
    (runner.py:556-571): the compression flags reach the config on
    ``allreduce``, ``dear`` and ``dear-fused``; elsewhere they are dropped
    with its warning; ``--density`` without a compressor warns;
    ``--remat-policy`` reaches ``remat``."""
    import warnings

    from dear_pytorch_tpu.benchmarks import gpt as jcli
    from dear_pytorch_tpu.benchmarks import runner as jrunner
    from dear_pytorch_tpu_torch.benchmarks import gpt as cli
    from dear_pytorch_tpu_torch.benchmarks import runner

    argv = ["--mode", mode] + flags
    got_w, want_w = [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = runner.config_from_args(cli.build_parser().parse_args(argv),
                                      world=2)
        got_w = [str(w.message) for w in caught]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = jrunner.config_from_args(jcli.build_parser().parse_args(argv),
                                        world=2)
        want_w = [str(w.message) for w in caught
                  if "compressor" in str(w.message)
                  or "density" in str(w.message)]
    assert got_w == want_w
    for field in ("compressor", "density", "gtopk", "momentum_correction",
                  "remat"):
        assert getattr(got, field) == getattr(want, field), field
    if got.momentum_correction:   # JAX config.py:190-193
        assert got.optimizer().momentum == 0.0 and got.momentum == 0.9
