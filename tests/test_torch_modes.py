"""The port's baseline schedules (dear_pytorch_tpu_torch.parallel.dear,
``mode="allreduce"``, ``"rsag"``, ``"rb"``, ``"bytescheduler"`` and
``"fsdp"``) and the ``exclude_parts`` ablations of ``"dear"`` on the CPU.

Each mode is held against the JAX package's ``build_train_step`` in the
same mode, as tests/test_torch_dear.py holds ``"dear"``: the small GPT with
the same seeded flax weights on both sides, the same numpy token batch, 3
steps, the per-step losses (and clip norms) and the gathered master
parameters compared by name. World 1 runs in this process over a
single-rank gloo group; world 2 runs every case in ONE spawn of two fresh
jax-free ranks (`spawn_ranks`), with a tiny ResNet in ``allreduce`` beside
them (tests/test_torch_dear_resnet.py's, for the BatchNorm state sync in a
replicated mode). Every run also counts its collectives per step against
the schedule's table (the module docstring of the port's dear.py).

The ablations cannot be held against JAX: which parameters a shard holds
depends on the plan's leaf order, which differs between the packages by
design; they are held to their counts and to running at all.

Tolerances: 1e-5 in fp32 (summation order only); 2e-4 where a leg travels
in bf16 (tests/test_torch_dear.py's reasoning).
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

from dear_pytorch_tpu.ops import fusion as jF
from dear_pytorch_tpu.ops import fused_sgd as jopt
from dear_pytorch_tpu.parallel import dear as jdear
from dear_pytorch_tpu_torch.models import gpt as tgpt
from dear_pytorch_tpu_torch.models.convert import gpt_params_from_jax
from dear_pytorch_tpu_torch.parallel import dear as tdear
from tests import test_torch_dear as TD
from tests import test_torch_dear_resnet as TR

STEPS = TD.STEPS
TOL, TOL_BF16 = TD.TOL, TD.TOL_BF16
#: ~5 KB chunks of the ~20 KB fp32 buckets: several chunks per bucket
PARTITION_MB = 0.005

#: name -> options; each runs 3 steps in both packages at worlds 1 and 2
CASES = {
    "allreduce": {"mode": "allreduce"},
    "rsag": {"mode": "rsag"},
    "rb": {"mode": "rb"},
    "bytescheduler": {"mode": "bytescheduler",
                      "partition_mb": PARTITION_MB},
    "fsdp": {"mode": "fsdp"},
    "fsdp_bf16": {"mode": "fsdp", "gather": "bf16"},
    "fsdp_accum2": {"mode": "fsdp", "accum_steps": 2},
    "allreduce_clip": {"mode": "allreduce", "clip_norm": 0.05},
    "fsdp_clip": {"mode": "fsdp", "clip_norm": 0.05},
}
#: the port alone: the ablations, and ``dear`` for fsdp's equality
PORT_CASES = {
    "no_reducescatter": {"exclude": ["reducescatter"]},
    "no_allgather": {"exclude": ["allgather"]},
    "dear": {},
    "dear_bf16": {"comm": "bf16", "gather": "bf16"},
}
COUNTERS = ("rs", "ag", "ar", "reduce", "bcast", "update")


def _tol(opts):
    return TOL_BF16 if (opts.get("comm") or opts.get("gather")) else TOL


def _run_jax(opts, world, params, ids):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("dp",))
    model = TD.jgpt.GptLmHeadModel(TD._jax_config())

    def loss_fn(p, batch):
        logits = model.apply({"params": p}, batch["input_ids"], train=False)
        return TD.jgpt.gpt_lm_loss(logits, batch["input_ids"],
                                   vocab_size=TD.VOCAB)

    ts = jdear.build_train_step(
        loss_fn, params, optimizer=jopt.fused_sgd(lr=0.05, momentum=0.9),
        mesh=mesh, mode=opts["mode"], threshold_mb=TD.THRESHOLD_MB,
        gather_dtype=jnp.bfloat16 if opts.get("gather") else None,
        accum_steps=opts.get("accum_steps", 1),
        clip_norm=opts.get("clip_norm"),
        partition_mb=opts.get("partition_mb", 4.0))
    state = ts.init(jax.tree.map(jnp.copy, params))
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = ts.step(state, {"input_ids": jnp.asarray(ids)})
        losses.append(float(m["loss"]))
        if "grad_norm" in m:
            norms.append(float(m["grad_norm"]))
    final = gpt_params_from_jax(
        jax.tree.map(np.asarray, ts.gather_params(state)),
        TD._torch_config())
    return losses, norms, {k: v.numpy() for k, v in final.items()}


# the port's side: build, init, 3 steps, gather. The world-2 worker below
# runs its source in a jax-free process, so it imports what it needs itself
def run_mode(opts, group, rank, world, state_dict, ids, cfg):
    import torch
    from dear_pytorch_tpu_torch.models import gpt as tgpt
    from dear_pytorch_tpu_torch.ops import fused_sgd as topt
    from dear_pytorch_tpu_torch.parallel import dear as tdear

    model = tgpt.GptLmHeadModel(cfg, device="cpu")
    model.load_state_dict(state_dict)
    seen = {"ts": None, "bytes": []}

    class Probe(torch.autograd.Function):
        """The identity on the loss; its backward runs first and records
        the bytes each full bucket's storage holds there."""

        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            seen["bytes"].append([f.untyped_storage().nbytes()
                                  for f in seen["ts"]._full])
            return g

    def loss_fn(m, batch):
        logits = m(batch["input_ids"], train=True)
        return Probe.apply(tgpt.gpt_lm_loss(logits, batch["input_ids"],
                                            vocab_size=cfg.vocab_size))

    bf16 = torch.bfloat16
    ts = tdear.build_train_step(
        loss_fn, model, optimizer=topt.fused_sgd(lr=0.05, momentum=0.9),
        group=group, device="cpu", mode=opts.get("mode", "dear"),
        threshold_mb=0.02,
        comm_dtype=bf16 if opts.get("comm") else None,
        gather_dtype=bf16 if opts.get("gather") else None,
        accum_steps=opts.get("accum_steps", 1),
        clip_norm=opts.get("clip_norm"),
        partition_mb=opts.get("partition_mb", 4.0),
        exclude_parts=tuple(opts.get("exclude", ())))
    seen["ts"] = ts
    casts = {"kept": 0, "recast": 0}
    pack = ts._pack

    def counting_pack(t):
        """fsdp's pack, counting the casts of parameters it saves as
        themselves (kept alive to the backward) and as references."""
        saved = pack(t)
        if saved is not t:
            casts["recast"] += saved.cast is not None
            return saved
        fn = (t if t._base is None else t._base).grad_fn
        casts["kept"] += (type(fn).__name__ == "ToCopyBackward0" and hasattr(
            fn.next_functions[0][0], "variable"))
        return saved

    ts._pack = counting_pack
    per = ids.shape[0] // world
    batch = {"input_ids": torch.from_numpy(ids[rank * per:(rank + 1) * per])}
    state = ts.init()
    losses, norms = [], []
    for _ in range(3):
        state, m = ts.step(state, batch)
        losses.append(float(m["loss"]))
        if "grad_norm" in m:
            norms.append(float(m["grad_norm"]))
    final = {k: v.numpy() for k, v in ts.gather_params(state).items()}
    counts = [getattr(ts, k + "_launches")
              for k in ("rs", "ag", "ar", "reduce", "bcast", "update")]
    padded = [b.padded_size for b in ts.plan.buckets]
    itemsize = ts._gbuf[0].element_size()
    ts.close()
    return {"losses": losses, "norms": norms, "final": final,
            "counts": counts, "padded": padded, "itemsize": itemsize,
            "bytes": seen["bytes"], "kept_casts": casts["kept"],
            "recasts": casts["recast"]}


def _expected_counts(opts, padded, itemsize):
    """The schedule's table (the port's dear.py docstring) over 3 steps:
    collectives launched, init's gathers included."""
    nb = len(padded)
    mode = opts.get("mode", "dear")
    k = opts.get("accum_steps", 1)
    want = dict.fromkeys(COUNTERS, 0)
    want["update"] = STEPS * nb
    if mode == "allreduce":
        want["ar"] = STEPS * nb
    elif mode == "rsag":
        want["rs"] = want["ag"] = STEPS * nb
    elif mode == "rb":
        want["reduce"] = want["bcast"] = STEPS * nb
    elif mode == "bytescheduler":   # JAX's own chunking of each bucket
        chunks = sum(len(jF.chunk_bounds(n, itemsize, opts["partition_mb"]))
                     for n in padded)
        assert chunks >= 2 * nb
        want["rs"] = want["ag"] = STEPS * chunks
    elif mode == "fsdp":
        # every microbatch's forward gathers each bucket, and its backward
        # gathers again each bucket a saved tensor views or casts (the
        # fp32 model casts bf16 buckets: the cast is done again there)
        want["rs"] = STEPS * nb
        want["ag"] = nb + STEPS * 2 * k * nb
    else:
        excl = set(opts.get("exclude", ()))
        want["rs"] = 0 if "reducescatter" in excl else STEPS * nb
        want["ag"] = 0 if "allgather" in excl else (STEPS + 1) * nb
    return want


def _check_run(opts, got):
    counts = dict(zip(COUNTERS, (int(c) for c in got["counts"])))
    assert counts == _expected_counts(opts, list(got["padded"]),
                                      int(got["itemsize"])), counts
    if opts.get("mode") == "fsdp":  # no full bucket from forward to backward
        seen = np.asarray(got["bytes"])
        assert seen.shape == (STEPS * opts.get("accum_steps", 1),
                              len(got["padded"]))
        assert not seen.any(), seen
        # nor a cast of one: the bf16 buckets' casts are done again
        assert int(got["kept_casts"]) == 0
        assert (int(got["recasts"]) > 0) == bool(opts.get("gather"))
    elif opts.get("mode") is None:
        assert np.asarray(got["bytes"]).all()


def _compare(opts, got, want):
    tol = _tol(opts)
    jlosses, jnorms, jfinal = want
    np.testing.assert_allclose(got["losses"], jlosses, rtol=tol, atol=tol)
    assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(got["norms"], jnorms, rtol=tol, atol=tol)
    assert len(got["norms"]) == (STEPS if opts.get("clip_norm") else 0)
    assert sorted(got["final"]) == sorted(jfinal)
    for name, p in got["final"].items():
        np.testing.assert_allclose(p, jfinal[name], rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def jax_params():
    return TD._init_params()


@pytest.fixture(scope="module")
def state_dict(jax_params):
    return gpt_params_from_jax(jax.tree.map(np.asarray, jax_params),
                               TD._torch_config())


@pytest.fixture(scope="module")
def group():
    from dear_pytorch_tpu_torch.comm import backend

    return backend.init("cpu")


@pytest.fixture(scope="module")
def world1(state_dict, group):
    """Every port case at world 1, run once."""
    return {name: run_mode(opts, group, 0, 1, state_dict, TD._ids(),
                           TD._torch_config())
            for name, opts in {**CASES, **PORT_CASES}.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_world1_matches_jax(case, world1, jax_params):
    opts = CASES[case]
    got = world1[case]
    _check_run(opts, got)
    _compare(opts, got, _run_jax(opts, 1, jax_params, TD._ids()))


_WORKER = '''
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.models import gpt as tgpt
{run_mode}
{run_resnet}
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store")
group = backend.init("cpu")
assert backend.size() == world and backend.rank() == rank
inputs = np.load(out + "/inputs.npz")
state_dict = {{k[3:]: torch.from_numpy(inputs[k]) for k in inputs.files
               if k.startswith("sd.")}}
cfg = tgpt.GptConfig(**json.loads(open(out + "/cfg.json").read()))
cases = json.loads(open(out + "/cases.json").read())
for name, opts in sorted(cases.items()):
    got = run_mode(opts, group, rank, world, state_dict, inputs["ids"], cfg)
    final = got.pop("final")
    np.savez(f"{{out}}/{{name}}.rank{{rank}}.npz",
             **{{k: np.array(v) for k, v in got.items()}},
             **{{"p." + k: v for k, v in final.items()}})
rn = np.load(out + "/resnet.npz")
rn_sd = {{k[3:]: torch.from_numpy(rn[k]) for k in rn.files
          if k.startswith("sd.")}}
losses, final, counts = run_resnet({{"mode": "allreduce"}}, group, rank,
                                   world, rn_sd, rn["x"], rn["y"],
                                   json.loads(open(out + "/rcfg.json").read()))
np.savez(f"{{out}}/resnet.rank{{rank}}.npz", losses=np.array(losses),
         counts=np.array(counts), **{{"p." + k: v for k, v in final.items()}})
backend.shutdown()
'''


@pytest.fixture(scope="module")
def world2(tmp_path_factory, state_dict):
    """Every case at world 2 and the ResNet case, in one spawn of two
    ranks; per case, both ranks' results."""
    out = str(tmp_path_factory.mktemp("modes_world2"))
    np.savez(os.path.join(out, "inputs.npz"), ids=TD._ids(),
             **{"sd." + k: v.numpy() for k, v in state_dict.items()})
    cfg = dataclasses.asdict(TD._torch_config())
    cfg = {k: v for k, v in cfg.items() if k not in ("dtype",
                                                     "kv_cache_dtype")}
    with open(os.path.join(out, "cfg.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(out, "cases.json"), "w") as f:
        json.dump({**CASES, **PORT_CASES}, f)
    x, y = TR._batch()
    rn_sd = TR.resnet_params_from_jax(*TR._variables(),
                                      stage_sizes=TR.CFG["stages"])
    np.savez(os.path.join(out, "resnet.npz"), x=x, y=y,
             **{"sd." + k: v.numpy() for k, v in rn_sd.items()})
    with open(os.path.join(out, "rcfg.json"), "w") as f:
        json.dump(TR.CFG, f)
    code = _WORKER.format(
        root=TD.ROOT, run_mode=inspect.getsource(run_mode),
        run_resnet=inspect.getsource(TR.run_port).replace(
            "def run_port(", "def run_resnet("))
    TD.spawn_ranks(code, 2, out)

    def load(case):
        ranks = [np.load(os.path.join(out, f"{case}.rank{r}.npz"))
                 for r in range(2)]
        return [{k: r[k] for k in r.files} for r in ranks]

    return {case: load(case)
            for case in [*CASES, *PORT_CASES, "resnet"]}


def _rank0(ranks):
    """Rank 0's result, after checking both ranks report the same."""
    r0, r1 = ranks
    for key in r0:
        np.testing.assert_array_equal(r1[key], r0[key], err_msg=key)
    got = {k: v for k, v in r0.items() if not k.startswith("p.")}
    got["final"] = {k[2:]: v for k, v in r0.items() if k.startswith("p.")}
    got["losses"], got["norms"] = list(got["losses"]), list(got["norms"])
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_world2_matches_jax(case, world2, jax_params):
    opts = CASES[case]
    got = _rank0(world2[case])
    _check_run(opts, got)
    _compare(opts, got, _run_jax(opts, 2, jax_params, TD._ids()))


def test_world2_resnet_allreduce_syncs_the_model_state(world2):
    """A replicated mode with BatchNorm state: the running statistics are
    the ranks' mean once per step (one all-gather), as JAX's pmean, and
    the parameters and statistics equal JAX's ``allreduce`` step's."""
    r0, r1 = world2["resnet"]
    for key in r0:
        np.testing.assert_array_equal(r1[key], r0[key], err_msg=key)
    final = {k[2:]: v for k, v in r0.items() if k.startswith("p.")}
    x, y = TR._batch()
    opts = {"mode": "allreduce"}
    variables = TR._variables()
    want = TR._run_jax(opts, 2, *variables, x, y)
    init = TR.resnet_params_from_jax(*variables, stage_sizes=TR.CFG["stages"])
    TR._compare(opts, list(r0["losses"]), final, want, init, STEPS)
    n_buckets, rs, ag, upd, syncs = r0["counts"]
    assert n_buckets >= 3 and rs == ag == 0 and upd == STEPS * n_buckets
    assert syncs == STEPS


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("case", sorted(PORT_CASES))
def test_port_cases_follow_the_table(case, world, world1, world2):
    """The ablations and ``dear`` run, every full bucket is live at the
    backward's start in ``dear``, and each counts its collectives as the
    table says (an excluded leg launches nothing)."""
    got = world1[case] if world == 1 else _rank0(world2[case])
    _check_run(PORT_CASES[case], got)
    assert all(np.isfinite(got["losses"]))


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("fsdp,dear", [("fsdp", "dear"),
                                       ("fsdp_bf16", "dear_bf16")])
def test_fsdp_equals_dear(fsdp, dear, world, world1, world2):
    """``fsdp`` is ``dear`` with the full buckets freed from the forward to
    the backward and gathered again there: the same gradients, the same
    reduce-scatters (both legs in ``gather_dtype``), so the same losses
    and parameters, bit for bit."""
    runs = ((world1[fsdp], world1[dear]) if world == 1
            else (_rank0(world2[fsdp]), _rank0(world2[dear])))
    (f, d) = runs
    np.testing.assert_array_equal(f["losses"], d["losses"])
    for name, p in f["final"].items():
        np.testing.assert_array_equal(p, d["final"][name], err_msg=name)


def test_guards_match_jax(group):
    """The JAX package's guards, with its messages: ``exclude_parts``
    entries and mode, ``gather_dtype`` outside the sharded modes,
    ``comm_dtype`` and ``remat`` with ``fsdp``; ``remat`` builds elsewhere
    (since slice 14)."""
    model = tgpt.GptLmHeadModel(TD._torch_config(), device="cpu")

    def loss_fn(m, b):
        return m(b).sum()

    def build(**kw):
        return tdear.build_train_step(loss_fn, model, group=group,
                                      device="cpu", **kw)

    params = TD._init_params()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))

    def jbuild(**kw):
        return jdear.build_train_step(lambda p, b: 0.0, params, mesh=mesh,
                                      **kw)

    for kw, match in (
            (dict(exclude_parts=("gather",)), "exclude_parts entries"),
            (dict(mode="rsag", exclude_parts=("allgather",)),
             "'dear'-mode ablation"),
            (dict(mode="allreduce", gather_dtype="bf16"),
             "gather_dtype applies"),
            (dict(mode="fsdp", comm_dtype="bf16"), "comm_dtype must be None"),
            (dict(mode="fsdp", remat="full"), "owns its rematerialization"),
            (dict(remat="half"), "remat must be None")):
        with pytest.raises(ValueError, match=match) as port_err:
            build(**{k: torch.bfloat16 if v == "bf16" else v
                     for k, v in kw.items()})
        with pytest.raises(ValueError, match=match) as jax_err:
            jbuild(**{k: jnp.bfloat16 if v == "bf16" else v
                      for k, v in kw.items()})
        assert str(port_err.value) == str(jax_err.value)
    assert build(mode="allreduce", remat="full").remat == "full"
    for mode in ("allreduce", "rsag", "rb", "bytescheduler", "fsdp"):
        assert build(mode=mode).mode == mode


@pytest.mark.parametrize("mode", ["allreduce", "rsag", "rb", "bytescheduler",
                                  "fsdp", "dear"])
@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("fp16", [False, True])
def test_cli_config_matches_jax(mode, world, fp16):
    """``config_from_args`` follows the JAX runner's rule: ``fsdp``'s
    gradients travel in the gather dtype (no ``comm_dtype``), the gathers
    in bf16 for ``dear`` and ``fsdp`` at world > 1 only; ``--partition``
    and ``--exclude-parts`` reach the config."""
    from dear_pytorch_tpu.benchmarks import gpt as jcli
    from dear_pytorch_tpu.benchmarks import runner as jrunner
    from dear_pytorch_tpu_torch.benchmarks import gpt as cli
    from dear_pytorch_tpu_torch.benchmarks import runner

    argv = ["--mode", mode, "--partition", "2.5"] + (["--fp16"] if fp16
                                                     else [])
    if mode == "dear":
        argv += ["--exclude-parts", "reducescatter, allgather"]
    got = runner.config_from_args(cli.build_parser().parse_args(argv),
                                  world=world)
    want = jrunner.config_from_args(jcli.build_parser().parse_args(argv),
                                    world=world)
    for field in ("comm_dtype", "gather_dtype"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None) and str(g).endswith(
            str(None if w is None else jnp.dtype(w))), field
    assert got.partition_mb == want.partition_mb == 2.5
    assert got.exclude_parts == want.exclude_parts
    assert got.build_kwargs()["exclude_parts"] == want.exclude_parts


def test_cli_exclude_parts_errors_match_jax():
    """An unknown part is the JAX runner's SystemExit, with its message;
    an ablation outside ``dear`` is the build's ValueError."""
    from dear_pytorch_tpu.benchmarks import runner as jrunner
    from dear_pytorch_tpu_torch.benchmarks import gpt as cli

    with pytest.raises(SystemExit) as jax_err:
        jrunner.parse_exclude_parts("allgather,bogus")
    with pytest.raises(SystemExit) as port_err:
        cli.main(["--device", "cpu", "--exclude-parts", "allgather,bogus"])
    assert str(port_err.value) == str(jax_err.value) \
        == "--exclude-parts: unknown part 'bogus'"
    with pytest.raises(ValueError, match="'dear'-mode ablation"):
        cli.main(["--device", "cpu", "--mode", "rsag", "--exclude-parts",
                  "allgather", "--num-hidden-layers", "1",
                  "--sequence-len", "16", "--batch-size", "2"])


@pytest.mark.parametrize("flags", [
    ["--mode", "allreduce"], ["--mode", "rsag"], ["--mode", "rb"],
    ["--mode", "bytescheduler", "--partition", "1"], ["--mode", "fsdp"],
    ["--mode", "fsdp", "--fp16"],
    ["--exclude-parts", "reducescatter"], ["--exclude-parts", "allgather"]])
def test_cli_trains_every_mode_on_the_cpu(flags):
    """Each mode and ablation through ``benchmarks/gpt.py --device cpu``
    (GPT-2's widths at one layer, S=16; ``fsdp --fp16`` at world 1 keeps
    fp32 buckets under bf16 compute, so its backward casts every bucket it
    gathers again): three steps with finite losses, falling but for the
    ablations, and the collectives of the table per step."""
    from dear_pytorch_tpu_torch.benchmarks import gpt as cli

    res = cli.main(["--device", "cpu", "--num-hidden-layers", "1",
                    "--batch-size", "2", "--sequence-len", "16",
                    "--flash-attention", "--base-lr", "0.01",
                    "--momentum", "0.9", "--num-warmup-batches", "1",
                    "--num-batches-per-iter", "1", "--num-iters", "2"]
                   + flags)
    ts = res.train_step
    assert len(res.losses) == STEPS and all(np.isfinite(res.losses))
    opts = {"mode": ts.mode, "exclude": list(ts._exclude)}
    if ts.mode == "bytescheduler":
        opts["partition_mb"] = 1.0
    if ts.mode != "dear":
        assert res.losses[-1] < res.losses[0]
    counts = {k: getattr(ts, k + "_launches") for k in COUNTERS}
    assert counts == _expected_counts(
        opts, [b.padded_size for b in ts.plan.buckets],
        ts._gbuf[0].element_size())


@pytest.mark.parametrize("mode", ["allreduce", "fsdp", "dear"])
def test_close_releases_the_step(mode, group, state_dict):
    """`TrainStep.close` removes the step's hooks from the model: a
    parameter's gradient hook is held from C++, so without that the model
    and the step (its masters, gradient buffers and optimizer state) are
    never collected, and runs in one process pile up."""
    import gc
    import weakref

    model = tgpt.GptLmHeadModel(TD._torch_config(), device="cpu")
    model.load_state_dict(state_dict)

    def loss_fn(m, b):
        return tgpt.gpt_lm_loss(m(b, train=True), b, vocab_size=TD.VOCAB)

    ts = tdear.build_train_step(loss_fn, model, group=group, device="cpu",
                                mode=mode, threshold_mb=TD.THRESHOLD_MB)
    state, _ = ts.step(ts.init(), torch.from_numpy(TD._ids()))
    # the step's masters: its gathers, which may still be in flight when
    # step() returns, write them into the model; close() waits for them
    masters = ts.gather_params(state)
    ts.close()
    for k, v in model.named_parameters():   # the model keeps its values
        assert torch.equal(v, masters[k]), k
    refs = [weakref.ref(ts), weakref.ref(model), weakref.ref(ts._gbuf[0])]
    del ts, model, state, v
    gc.collect()
    assert [r() for r in refs] == [None, None, None]
