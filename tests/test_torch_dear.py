"""The port's eager DeAR train step (dear_pytorch_tpu_torch.parallel.dear,
``mode="dear"``) against the JAX package's, on the CPU: the small GPT of
tests/test_serving.py with the same seeded flax weights on both sides, the
same numpy token batch, 3 steps, then the per-step losses and the gathered
master parameters compared per parameter name (the port buckets in module
order, JAX in sorted-key order, so the plans differ but the function does
not).

World 1 runs in this process over a single-rank gloo group. World 2 runs
as two fresh Python processes (no jax in them) meeting at a FileStore
through the launcher variables of `comm.backend`; they write their results
as .npz and this process compares them with JAX on a 2-device sub-mesh.

Tolerances: 1e-5 in fp32 (summation order only). Where gradients travel in
bf16 (``comm_dtype``) or the parameters are gathered in bf16
(``gather_dtype``), 2e-4: the two packages round the same fp32 gradient to
bf16, but fp32 gradients that differ in their last bits can round to
neighbouring bf16 values (one bf16 ulp is 2^-8 relative), and lr x that
difference x 3 steps of momentum stays under 2e-4 here. The
``fused_ring_proj`` cases (``mode="dear-fused"`` with the ring-matmul
projections of `ops.collective_matmul.make_ring_projection_impl` on both
sides; the ring at world 2, the dense product at world 1) are fp32 too:
1e-5.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.models import gpt as jgpt
from dear_pytorch_tpu.ops import collective_matmul as JCM
from dear_pytorch_tpu.ops import fused_sgd as jopt
from dear_pytorch_tpu.ops import schedules as jsched
from dear_pytorch_tpu.parallel import dear as jdear
from dear_pytorch_tpu_torch.models import gpt as tgpt
from dear_pytorch_tpu_torch.models.convert import gpt_params_from_jax
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.parallel import dear as tdear

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B, S, VOCAB = 3, 4, 16, 61
THRESHOLD_MB = 0.02      # ~20 KB buckets: >= 3 of them in either order
TOL, TOL_BF16 = 1e-5, 2e-4

#: name -> options; each runs 3 steps in both packages
CASES = {
    "dense": {},
    "flash": {"flash": True},
    "comm_bf16": {"comm": "bf16"},
    "accum2": {"accum_steps": 2},
    "clip": {"clip_norm": 0.05},
    "adamw_cosine": {"opt": "adamw"},
    "fused_sgd_bf16": {"mode": "dear-fused", "comm": "bf16"},
    "fused_adamw": {"mode": "dear-fused", "opt": "adamw"},
    "fused_ring_proj": {"mode": "dear-fused", "ring_proj": True},
}
WORLD2_CASES = {
    "dense": {},
    "flash": {"flash": True},
    "gather_bf16": {"comm": "bf16", "gather": "bf16"},
    "fused_sgd": {"mode": "dear-fused"},
    "fused_adamw": {"mode": "dear-fused", "opt": "adamw"},
    "fused_ring_proj": {"mode": "dear-fused", "ring_proj": True},
}


def _jax_config():
    return jgpt.GptConfig(
        vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=32, embd_dropout_prob=0.0,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _torch_config():
    ported = {f.name for f in dataclasses.fields(tgpt.GptConfig)}
    cfg = _jax_config()
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name in ported}
    kw["dtype"] = torch.float32
    return tgpt.GptConfig(**kw)


def _init_params():
    model = jgpt.GptLmHeadModel(_jax_config())
    return model.init({"params": jax.random.PRNGKey(0)},
                      jnp.zeros((2, 4), jnp.int32), train=False)["params"]


def _ids():
    return np.random.RandomState(5).randint(0, VOCAB, (B, S))


def _tol(opts):
    return TOL_BF16 if (opts.get("comm") or opts.get("gather")) else TOL


def _run_jax(opts, world, params, ids):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("dp",))
    model = jgpt.GptLmHeadModel(
        _jax_config(), attention_impl=jgpt.flash_causal_attention_impl()
        if opts.get("flash") else None,
        projection_impl=JCM.make_ring_projection_impl("dp")
        if opts.get("ring_proj") else None)

    def loss_fn(p, batch):
        logits = model.apply({"params": p}, batch["input_ids"], train=False)
        return jgpt.gpt_lm_loss(logits, batch["input_ids"], vocab_size=VOCAB)

    if opts.get("opt") == "adamw":
        opt = jopt.fused_adamw(lr=jsched.warmup_cosine(1e-2, 1, STEPS),
                               weight_decay=0.01)
    else:
        opt = jopt.fused_sgd(lr=0.05, momentum=0.9)
    bf16 = jnp.bfloat16
    ts = jdear.build_train_step(
        loss_fn, params, optimizer=opt, mesh=mesh,
        mode=opts.get("mode", "dear"),
        threshold_mb=THRESHOLD_MB,
        comm_dtype=bf16 if opts.get("comm") else None,
        gather_dtype=bf16 if opts.get("gather") else None,
        accum_steps=opts.get("accum_steps", 1),
        clip_norm=opts.get("clip_norm"))
    state = ts.init(jax.tree.map(jnp.copy, params))
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = ts.step(state, {"input_ids": jnp.asarray(ids)})
        losses.append(float(m["loss"]))
        if "grad_norm" in m:
            norms.append(float(m["grad_norm"]))
    final = gpt_params_from_jax(
        jax.tree.map(np.asarray, ts.gather_params(state)), _torch_config())
    return losses, norms, {k: v.numpy() for k, v in final.items()}


# the port's side: build, init, 3 steps, gather. The world-2 worker below
# runs its source in a jax-free process, so it imports what it needs itself
def run_port(opts, group, rank, world, state_dict, ids, cfg):
    import torch
    from dear_pytorch_tpu_torch.models import gpt as tgpt
    from dear_pytorch_tpu_torch.ops import collective_matmul as tcm
    from dear_pytorch_tpu_torch.ops import fused_sgd as topt
    from dear_pytorch_tpu_torch.ops import schedules as tsched
    from dear_pytorch_tpu_torch.parallel import dear as tdear

    model = tgpt.GptLmHeadModel(
        cfg, attention_impl=tgpt.flash_causal_attention_impl()
        if opts.get("flash") else None,
        projection_impl=tcm.make_ring_projection_impl()
        if opts.get("ring_proj") else None, device="cpu")
    model.load_state_dict(state_dict)

    def loss_fn(m, batch):
        logits = m(batch["input_ids"], train=True)
        return tgpt.gpt_lm_loss(logits, batch["input_ids"],
                                vocab_size=cfg.vocab_size)

    if opts.get("opt") == "adamw":
        opt = topt.fused_adamw(lr=tsched.warmup_cosine(1e-2, 1, 3),
                               weight_decay=0.01)
    else:
        opt = topt.fused_sgd(lr=0.05, momentum=0.9)
    bf16 = torch.bfloat16
    ts = tdear.build_train_step(
        loss_fn, model, optimizer=opt, group=group, device="cpu",
        mode=opts.get("mode", "dear"), threshold_mb=0.02,
        comm_dtype=bf16 if opts.get("comm") else None,
        gather_dtype=bf16 if opts.get("gather") else None,
        accum_steps=opts.get("accum_steps", 1),
        clip_norm=opts.get("clip_norm"))
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
    counts = (ts.plan.num_buckets, ts.rs_launches, ts.ag_launches,
              ts.update_launches, ts.cm_calls)
    ts.close()
    return losses, norms, final, counts


@pytest.fixture(scope="module")
def jax_params():
    return _init_params()


@pytest.fixture(scope="module")
def state_dict(jax_params):
    return gpt_params_from_jax(jax.tree.map(np.asarray, jax_params),
                               _torch_config())


@pytest.fixture(scope="module")
def group():
    from dear_pytorch_tpu_torch.comm import backend

    return backend.init("cpu")


def _compare(opts, got, want, init):
    tol = _tol(opts)
    losses, norms, final = got[:3]
    jlosses, jnorms, jfinal = want
    np.testing.assert_allclose(losses, jlosses, rtol=tol, atol=tol)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(norms, jnorms, rtol=tol, atol=tol)
    assert sorted(final) == sorted(jfinal)
    moved = 0.0
    for name, p in final.items():
        if opts.get("opt") == "adamw" and name.endswith(".key.bias"):
            # the key bias gets no gradient in exact arithmetic (softmax is
            # invariant to one shift of a whole score row): both packages'
            # gradients there are rounding noise, which Adam's
            # normalisation scales up towards lr; held small, not equal
            assert np.abs(p).max() < 1e-4 and np.abs(jfinal[name]).max() < 1e-4
            continue
        np.testing.assert_allclose(p, jfinal[name], rtol=tol, atol=tol,
                                   err_msg=name)
        moved = max(moved, float(np.abs(p - init[name].numpy()).max()))
    assert moved > 100 * tol      # the comparison is not of the init


@pytest.mark.parametrize("case", sorted(CASES))
def test_world1_matches_jax(case, jax_params, state_dict, group):
    opts = CASES[case]
    ids = _ids()
    got = run_port(opts, group, 0, 1, state_dict, ids, _torch_config())
    want = _run_jax(opts, 1, jax_params, ids)
    _compare(opts, got, want, state_dict)
    if opts.get("clip_norm"):
        assert len(got[1]) == STEPS
    n_buckets, rs, ag, upd, cm = got[3]
    assert n_buckets >= 3
    assert rs == upd == STEPS * n_buckets      # one of each per bucket
    assert ag == (STEPS + 1) * n_buckets       # + init's gathers
    assert cm == 0                             # world 1: the dense product


_WORKER = '''
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.models import gpt as tgpt
{port_run}
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store")
group = backend.init("cpu")
assert backend.size() == world and backend.rank() == rank
inputs = np.load(out + "/inputs.npz")
ids = inputs["ids"]
state_dict = {{k[3:]: torch.from_numpy(inputs[k]) for k in inputs.files
               if k.startswith("sd.")}}
cfg = tgpt.GptConfig(**json.loads(open(out + "/cfg.json").read()))
cases = json.loads(open(out + "/cases.json").read())
for name, opts in sorted(cases.items()):
    losses, norms, final, counts = run_port(opts, group, rank, world,
                                            state_dict, ids, cfg)
    np.savez(f"{{out}}/{{name}}.rank{{rank}}.npz", losses=np.array(losses),
             norms=np.array(norms), counts=np.array(counts),
             **{{"p." + k: v for k, v in final.items()}})
backend.shutdown()
'''


#: how a rank runs its worker script: in a namespace of its own that it
#: empties (and collects) before the interpreter exits, so the process
#: group and everything holding it (work handles, rings) are destroyed
#: while the interpreter is whole. A gloo group still alive when the
#: interpreter finalizes is destroyed with its C++ statics, and that
#: teardown can abort the rank after its work is done ("terminate called
#: without an active exception", SIGABRT), now and then under load; it
#: failed test_collectives_match_jax[4] in a loaded run, and
#: tests/torch_spawn_stress.py --raw shows it.
_RANK_MAIN = """import gc, sys
path = sys.argv.pop(1)
ns = {"__name__": "__main__", "__file__": path}
exec(compile(open(path).read(), path, "exec"), ns)
ns.clear()
gc.collect()
"""


def spawn_ranks(code, world, out, timeout=400):
    """Run ``code`` as ``world`` fresh Python processes (argv: rank, world,
    out), one intra-op thread each; raise with every rank's output if any
    fails or the deadline passes. Each rank writes to its own log file, not
    a pipe, so no rank can block on a full pipe while a peer waits for it
    in a collective; the first rank to fail ends the others. Each rank
    runs ``code`` through `_RANK_MAIN`, which releases all it holds before
    the interpreter exits."""
    path = os.path.join(out, "worker.py")
    with open(path, "w") as f:
        f.write(code)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DEAR_", "JAX_", "XLA_"))}
    env["OMP_NUM_THREADS"] = "1"
    logs = [os.path.join(out, f"rank{r}.log") for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK_MAIN, path, str(r), str(world),
                 out], stdout=f, stderr=subprocess.STDOUT, env=env, cwd=out))
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        outs = "".join(f"--- rank {r} (exit {p.returncode}):\n"
                       + open(log).read()
                       for r, (p, log) in enumerate(zip(procs, logs)))
        raise AssertionError(f"ranks {failed} failed or passed the "
                             f"{timeout} s deadline:\n{outs}")


@pytest.fixture(scope="module")
def world2_results(tmp_path_factory, state_dict):
    out = str(tmp_path_factory.mktemp("dear_world2"))
    np.savez(os.path.join(out, "inputs.npz"), ids=_ids(),
             **{"sd." + k: v.numpy() for k, v in state_dict.items()})
    cfg = dataclasses.asdict(_torch_config())
    cfg = {k: v for k, v in cfg.items() if k not in ("dtype",
                                                     "kv_cache_dtype")}
    with open(os.path.join(out, "cfg.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(out, "cases.json"), "w") as f:
        json.dump(WORLD2_CASES, f)
    code = _WORKER.format(root=ROOT, port_run=inspect.getsource(run_port))
    spawn_ranks(code, 2, out)
    return out


@pytest.mark.parametrize("case", sorted(WORLD2_CASES))
def test_world2_matches_jax(case, world2_results, jax_params, state_dict):
    opts = WORLD2_CASES[case]
    ranks = [np.load(os.path.join(world2_results, f"{case}.rank{r}.npz"))
             for r in range(2)]
    for r in ranks:   # every rank reports the same mean loss and params
        for key in r.files:
            np.testing.assert_array_equal(r[key], ranks[0][key])
    r0 = ranks[0]
    final = {k[2:]: r0[k] for k in r0.files if k.startswith("p.")}
    got = (list(r0["losses"]), list(r0["norms"]), final)
    want = _run_jax(opts, 2, jax_params, _ids())
    _compare(opts, got, want, state_dict)
    n_buckets, rs, ag, upd, cm = r0["counts"]
    assert n_buckets >= 3 and rs == upd == STEPS * n_buckets
    # K6, K7, K8 for 4 projections x 2 layers per step
    assert cm == (STEPS * 2 * 4 * 3 if opts.get("ring_proj") else 0)


def test_world2_fused_matches_port_dear(world2_results):
    """At world 2 the ring's sum of two fp32 gradients is the gloo
    reduce-scatter's (a + b is commutative), so dear-fused and dear agree
    to the fp32 tolerance of the update's own arithmetic."""
    def load(case):
        r0 = np.load(os.path.join(world2_results, f"{case}.rank0.npz"))
        return r0["losses"], {k: r0[k] for k in r0.files
                              if k.startswith("p.")}

    (lf, pf), (ld, pd) = load("fused_sgd"), load("dense")
    np.testing.assert_allclose(lf, ld, rtol=TOL, atol=TOL)
    for k in pf:
        np.testing.assert_allclose(pf[k], pd[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_rejected_options_raise(group):
    """The multi-slice ``dcn`` schedule is ported (item 9c): an exchanger
    that is not one with one local slice, or a mode other than ``dear``,
    is refused with a ValueError (tests/test_torch_multislice.py holds the
    guards against JAX's); ``multi_step`` runs
    since slice 15. What is ported builds: ``model_state_template``, the
    baseline modes and ``fsdp``, the ``exclude_parts`` ablations, and since
    slice 14 compression, ``remat="full"`` (outside ``fsdp``) and LAMB;
    ``mode="dear-fused"`` builds, and refuses what the JAX package's
    dear-fused refuses with its ValueError."""
    model = tgpt.GptLmHeadModel(_torch_config(), device="cpu")

    def loss_fn(m, b):
        return m(b).sum()

    lamb = topt.fused_lamb(lr=0.1)
    for kw, match in ((dict(dcn=object()), "exactly one local slice"),
                      (dict(mode="allreduce", dcn=object()),
                       "hierarchical")):
        with pytest.raises(ValueError, match=match):
            tdear.build_train_step(loss_fn, model, group=group,
                                   device="cpu", **kw)
    # model state is ported: a template naming no buffer is accepted
    assert tdear.build_train_step(loss_fn, model, group=group, device="cpu",
                                  model_state_template={})._mstate == []
    # the modes, the ablations, compression, remat and LAMB are ported:
    # they build
    for kw in (dict(mode="allreduce"), dict(mode="rsag"), dict(mode="rb"),
               dict(mode="bytescheduler"), dict(mode="fsdp"),
               dict(exclude_parts=("allgather",)),
               dict(exclude_parts=("reducescatter", "allgather")),
               dict(compressor="eftopk"), dict(gtopk=True, compressor="topk"),
               dict(momentum_correction=0.9, compressor="eftopk"),
               dict(mode="allreduce", compressor="qint8"),
               dict(remat="full"), dict(mode="allreduce", remat="full"),
               dict(optimizer=lamb), dict(mode="fsdp", optimizer=lamb)):
        ts = tdear.build_train_step(loss_fn, model, group=group,
                                    device="cpu", **kw)
        assert ts.mode == kw.get("mode", "dear")
        assert ts.remat == kw.get("remat")
        assert (ts.compressor is not None) == ("compressor" in kw)
        assert ts.layerwise == ("optimizer" in kw)
        ts.close()
    fused = tdear.build_train_step(loss_fn, model, group=group,
                                   device="cpu", mode="dear-fused")
    assert fused.fused and fused.ring.world == 1
    for kw, match in ((dict(clip_norm=1.0), "global-norm clip"),
                      (dict(optimizer=lamb), "LAMB"),
                      (dict(compressor="eftopk"), "compression cannot ride"),
                      (dict(dcn=object()), "multislice")):
        with pytest.raises(ValueError, match=match):
            tdear.build_train_step(loss_fn, model, group=group,
                                   device="cpu", mode="dear-fused", **kw)
    ts = tdear.build_train_step(loss_fn, model, group=group, device="cpu")
    # multi_step is ported (slice 15): one callable per n, n >= 1
    assert ts.multi_step(2) is ts.multi_step(2)
    with pytest.raises(ValueError, match="n >= 1"):
        ts.multi_step(0)
    with pytest.raises(ValueError, match="mode must be one of"):
        tdear.build_train_step(loss_fn, model, group=group, device="cpu",
                               mode="zero3")
    assert isinstance(lamb, topt.LayerwiseShardOptimizer)
    with pytest.raises(NotImplementedError, match="from_torch_optim"):
        topt.from_optax(None)
    with pytest.raises(RuntimeError, match="init"):
        ts.step(None, torch.zeros((1, 4), dtype=torch.long))


def test_init_copies_and_dropout_generator_is_per_step(group, state_dict):
    """`init` never aliases the caller's tensors; with ``rng_seed`` the
    loss sees a generator seeded per (seed, step, rank, microbatch): one
    seed replays the same losses, another does not."""
    cfg = dataclasses.replace(_torch_config(), hidden_dropout_prob=0.1,
                              embd_dropout_prob=0.1,
                              attention_probs_dropout_prob=0.1)
    ids = torch.from_numpy(_ids())

    def run(seed):
        model = tgpt.GptLmHeadModel(cfg, device="cpu")
        model.load_state_dict(state_dict)
        caller = {n: p.detach().clone() for n, p in model.named_parameters()}
        seen = []

        def loss_fn(m, b, gen):
            seen.append(gen)
            return tgpt.gpt_lm_loss(m(b, train=True, generator=gen), b,
                                    vocab_size=VOCAB)

        ts = tdear.build_train_step(loss_fn, model, group=group,
                                    device="cpu", rng_seed=seed,
                                    threshold_mb=THRESHOLD_MB)
        state = ts.init(caller)
        snapshot = {n: t.clone() for n, t in caller.items()}
        losses = []
        for _ in range(2):
            state, m = ts.step(state, ids)
            losses.append(float(m["loss"]))
        for n, t in caller.items():   # the shards are copies
            assert torch.equal(t, snapshot[n]), n
        assert len(seen) == 2 and seen[0].initial_seed() != \
            seen[1].initial_seed()
        return losses

    a, b, c = run(7), run(7), run(8)
    assert a == b and a != c and all(np.isfinite(a))


def test_has_aux_metric_is_the_microbatch_and_rank_mean(group, state_dict):
    """``has_aux``: ``loss_fn`` returns ``(loss, aux)`` and
    ``metrics["aux"]`` is its mean over microbatches (and ranks), as the
    JAX package's ``lax.pmean`` of the scanned microbatch mean."""
    model = tgpt.GptLmHeadModel(_torch_config(), device="cpu")
    model.load_state_dict(state_dict)

    def loss_fn(m, b):
        loss = tgpt.gpt_lm_loss(m(b, train=True), b, vocab_size=VOCAB)
        return loss, torch.stack([loss.detach() * 2, b[:, 0].float().mean()])

    ts = tdear.build_train_step(loss_fn, model, group=group, device="cpu",
                                has_aux=True, accum_steps=2)
    ids = torch.from_numpy(_ids())
    _, m = ts.step(ts.init(), ids)
    np.testing.assert_allclose(float(m["aux"][0]), 2 * float(m["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["aux"][1]), float(ids[:, 0].float()
                                                         .mean()), rtol=1e-6)
