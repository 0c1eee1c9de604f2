"""Sequence-parallel training in the port (dear_pytorch_tpu_torch.parallel.
sp, the dp x sp DeAR step) against the JAX package, on the CPU.

JAX's tiny configs of tests/test_sp_training.py (2 layers, hidden 32, 4
heads, S = 32, B = 4, SGD lr 0.05 momentum 0.9, 3 steps, dropout off):
the port trains GPT (ring, ring_flash, ulysses, zigzag) and BERT (ring,
ring_flash, ulysses) at dp x sp = 2 x 2 and 1 x 4 in ONE spawned world of
4 jax-free ranks (`comm.backend.form_sp_groups`, ``mean_axes=("dp",)``),
from JAX's initial parameters (`models.convert`), on the same numpy batch.

The reference is JAX's one-device dense training of the same batch: JAX's
SP training costs 3-10 s a configuration on this CPU (49 s for GPT's
eight), and tests/test_sp_training.py holds it to this same dense run at
the same tolerance. JAX's SP training itself runs for one configuration
(GPT Ulysses at 1 x 4: the cheapest to compile), held to the dense run
and to the port. Losses at rtol 2e-4 / atol 2e-5 (JAX's SP tolerance,
tests/test_sp_training.py:207); parameters by name at 1e-5.

Also: `sp_cls_pool` against the global first token, its gradient psum's
transpose (held against ``jax.vjp`` in
tests/test_torch_ring_attention.py); the build guards (dear-fused over two
axes, compression with ``mean_axes``, ``mean_axes`` not a subset, dcn=
and elastic regroup with a layout) against JAX's messages or naming their
ROADMAP item; the CLIs' refusals against the JAX CLIs'.
"""

import dataclasses
import inspect
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.benchmarks import bert as jbert_cli
from dear_pytorch_tpu.benchmarks import gpt as jgpt_cli
from dear_pytorch_tpu.benchmarks import runner as jrunner
from dear_pytorch_tpu.models import data as jdata
from dear_pytorch_tpu.models.bert import (
    BertConfig, BertForPreTraining, bert_pretraining_loss,
)
from dear_pytorch_tpu.models.gpt import GptConfig, GptLmHeadModel, gpt_lm_loss
from dear_pytorch_tpu.ops.fused_sgd import fused_sgd
from dear_pytorch_tpu.parallel import build_train_step
from dear_pytorch_tpu.parallel import sp as JSP
from dear_pytorch_tpu.parallel.ring_attention import zigzag_permutation
from dear_pytorch_tpu_torch.benchmarks import bert as tbert_cli
from dear_pytorch_tpu_torch.benchmarks import gpt as tgpt_cli
from dear_pytorch_tpu_torch.benchmarks import runner as trunner
from dear_pytorch_tpu_torch.models import bert as tbert
from dear_pytorch_tpu_torch.models import gpt as tgpt
from dear_pytorch_tpu_torch.models.convert import (
    bert_params_from_jax, gpt_params_from_jax,
)
from tests.test_torch_dear import spawn_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, STEPS = 4, 32, 3
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
LAYOUTS = ((2, 2), (1, 4))
GPT_SCHEMES = ("ring", "ring_flash", "ulysses", "zigzag")
BERT_SCHEMES = ("ring", "ring_flash", "ulysses")
RUNS = [(kind, dp, sp, scheme)
        for dp, sp in LAYOUTS
        for kind, schemes in (("gpt", GPT_SCHEMES), ("bert", BERT_SCHEMES))
        for scheme in schemes]
#: JAX's SP training run here too: (kind, dp, sp, scheme)
JAX_SP_RUNS = (("gpt", 1, 4, "ulysses"),)


def _run_id(run):
    kind, dp, sp, scheme = run
    return f"{kind}-{dp}x{sp}-{scheme}"


def _gpt_cfg():
    return GptConfig(
        vocab_size=61, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=32, embd_dropout_prob=0.0,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _bert_cfg():
    return BertConfig(
        num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
        intermediate_size=64, vocab_size=64, max_position_embeddings=32,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _port_cfg(jcfg, cls):
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name in fields and f.name != "dtype"}
    return kw


def _batches():
    rs = np.random.RandomState(9)
    gpt = {"input_ids": rs.randint(0, 61, (B, S)).astype(np.int32)}
    # every token labelled (JAX's test): the ranks' valid counts are equal,
    # so the dp mean of means is the global mean; the last 6 keys padded
    mask = np.ones((B, S), np.int32)
    mask[:, S - 6:] = 0
    bert = {"input_ids": rs.randint(0, 64, (B, S)).astype(np.int32),
            "token_type_ids": rs.randint(0, 2, (B, S)).astype(np.int32),
            "attention_mask": mask,
            "masked_lm_labels": rs.randint(0, 64, (B, S)).astype(np.int32),
            "next_sentence_labels": rs.randint(0, 2, (B,)).astype(np.int32)}
    return gpt, bert


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _dense(kind, params, batch):
    """JAX's one-device dense training (tests/test_sp_training.py:45):
    losses and final parameters."""
    if kind == "gpt":
        model = GptLmHeadModel(_gpt_cfg())

        def loss_fn(p):
            logits = model.apply({"params": p}, batch["input_ids"],
                                 train=False)
            return gpt_lm_loss(logits, batch["input_ids"], vocab_size=61)
    else:
        model = BertForPreTraining(_bert_cfg())

        def loss_fn(p):
            logits, nsp = model.apply(
                {"params": p}, batch["input_ids"], batch["token_type_ids"],
                batch["attention_mask"], train=False)
            return bert_pretraining_loss(logits, nsp,
                                         batch["masked_lm_labels"],
                                         batch["next_sentence_labels"])

    opt = fused_sgd(lr=0.05, momentum=0.9)

    @jax.jit
    def step(p, states):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        flat, treedef = jax.tree_util.tree_flatten(p)
        new, out = [], []
        for x, g, st in zip(flat, jax.tree_util.tree_leaves(grads), states):
            q, st = opt.update(g.reshape(-1), st, x.reshape(-1))
            new.append(q.reshape(x.shape))
            out.append(st)
        return loss, jax.tree_util.tree_unflatten(treedef, new), out

    states = [opt.init(x.reshape(-1)) for x in jax.tree_util.tree_leaves(
        params)]
    losses = []
    for _ in range(STEPS):
        loss, params, states = step(params, states)
        losses.append(float(loss))
    return losses, params


def _jax_sp(run, params, batch):
    """JAX's SP training of ``run`` (tests/test_sp_training.py:73): the
    losses and the final parameters."""
    kind, dp, sp, scheme = run
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:dp * sp]).reshape(
        dp, sp), ("dp", "sp"))
    if kind == "gpt":
        loss_fn = JSP.make_sp_gpt_loss_fn(
            JSP.sp_gpt_model(_gpt_cfg(), attention=scheme), vocab_size=61,
            train=False)
    else:
        loss_fn = JSP.make_sp_bert_loss_fn(
            JSP.sp_bert_model(_bert_cfg(), attention=scheme), train=False)
    ts = build_train_step(loss_fn, params, mesh=mesh, axis_name=("dp", "sp"),
                          mean_axes=("dp",),
                          batch_spec_fn=JSP.bert_sp_batch_specs,
                          threshold_mb=0.01,
                          optimizer=fused_sgd(lr=0.05, momentum=0.9),
                          donate=False)
    state = ts.init(params)
    losses = []
    for _ in range(STEPS):
        state, m = ts.step(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return losses, ts.gather_params(state)


def _jax_messages():
    """JAX's build-time refusals of a dp x sp step."""
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("dp", "sp"))
    params = {"w": jnp.zeros((8,))}
    out = {}
    for name, kw in (
            ("fused", dict(mode="dear-fused")),
            ("compressed", dict(mean_axes=("dp",), compressor="topk",
                                density=0.5)),
            ("subset", dict(mean_axes=("tp",)))):
        with pytest.raises(ValueError) as err:
            build_train_step(lambda p, b: jnp.sum(p["w"]), params, mesh=mesh,
                             axis_name=("dp", "sp"), **kw)
        out[name] = str(err.value)
    return out


# ---------------------------------------------------------------------------
# the port's side: one world of 4 jax-free ranks
# ---------------------------------------------------------------------------


def run_port(run, rank, state_dict, batch, cfg_kw):
    """Train ``run`` on this rank's part of the global batch: losses,
    gathered parameters, the step's averaging degree and counts."""
    import torch
    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.models import bert as tbert
    from dear_pytorch_tpu_torch.models import gpt as tgpt
    from dear_pytorch_tpu_torch.ops import fused_sgd as topt
    from dear_pytorch_tpu_torch.parallel import dear as tdear
    from dear_pytorch_tpu_torch.parallel import sp as TSP
    from dear_pytorch_tpu_torch.parallel.ring_attention import (
        zigzag_permutation,
    )

    kind, dp, sp, scheme = run
    if backend.sp_layout() is None or backend.sp_size() != sp:
        backend.form_sp_groups(sp)
    batch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    if kind == "gpt":
        model = TSP.sp_gpt_model(tgpt.GptConfig(**cfg_kw), attention=scheme,
                                 device="cpu")
        zigzag = scheme == "zigzag"
        if zigzag:
            batch = {"input_ids": batch["input_ids"][
                :, torch.from_numpy(zigzag_permutation(S, sp))]}
        loss_fn = TSP.make_sp_gpt_loss_fn(model, vocab_size=61, train=False,
                                          zigzag=zigzag)
    else:
        model = TSP.sp_bert_model(tbert.BertConfig(**cfg_kw),
                                  attention=scheme, device="cpu")
        loss_fn = TSP.make_sp_bert_loss_fn(model, train=False)
    model.load_state_dict(state_dict)
    ts = tdear.build_train_step(loss_fn, model, device="cpu",
                                optimizer=topt.fused_sgd(lr=0.05,
                                                         momentum=0.9),
                                threshold_mb=0.01, mean_axes=("dp",))
    state = ts.init()
    mine = TSP.shard_sp_batch(batch)
    losses = []
    for _ in range(STEPS):
        state, m = ts.step(state, mine)
        losses.append(float(m["loss"]))
    final = {k: v.numpy() for k, v in ts.gather_params(state).items()}
    counts = (ts.mean_world, ts.plan.num_buckets, ts.rs_launches,
              ts.update_launches, backend.dp_rank(), backend.sp_rank())
    ts.close()
    return losses, final, counts


def run_checks(rank, x):
    """`sp_cls_pool` at 1 x 4 (its output and input gradient), and the
    messages of the build guards and of elastic regroup under a layout."""
    import torch
    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.ops import fused_sgd as topt
    from dear_pytorch_tpu_torch.parallel import dear as tdear
    from dear_pytorch_tpu_torch.parallel import sp as TSP

    backend.form_sp_groups(4)
    n = x.shape[1] // 4
    xb = torch.from_numpy(x[:, rank * n:(rank + 1) * n].copy())
    xb.requires_grad_()
    pooled = TSP.sp_cls_pool()(xb)
    pooled.sum().backward()
    res = {"pool": pooled.detach().numpy(), "pool_grad": xb.grad.numpy()}
    class Lin(torch.nn.Linear):
        device = property(lambda self: self.weight.device)

    model = Lin(8, 1)

    def build(**kw):
        try:
            tdear.build_train_step(lambda m, b: m(b).sum(), model,
                                   device="cpu", **kw)
        except (ValueError, NotImplementedError) as e:
            return f"{type(e).__name__}: {e}"
        return "built"

    res["fused"] = build(mode="dear-fused")
    res["compressed"] = build(mean_axes=("dp",), compressor="topk",
                              density=0.5)
    res["subset"] = build(mean_axes=("tp",))
    res["dcn"] = build(dcn=object())
    res["sum_sp"] = build(mean_axes=("dp",))
    try:
        backend.regroup(type("V", (), {"epoch": 1, "members": (0,),
                                       "rank": 0})())
    except NotImplementedError as e:
        res["regroup"] = f"NotImplementedError: {e}"
    # a layout over ranks 2 and 3 only: the others get no group, no layout
    g = backend.form_sp_groups(2, ranks=[2, 3])
    res["ranks_subset"] = np.array([g is not None, backend.sp_size(),
                              backend.sp_rank(), backend.dp_size()])
    return {k: (np.array(v) if isinstance(v, str) else v)
            for k, v in res.items()}


_WORKER = '''
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.comm import backend
S, STEPS = {S}, {STEPS}
{fns}
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store")
backend.init("cpu")
inp = np.load(out + "/inputs.npz")
cfgs = json.loads(open(out + "/cfgs.json").read())
res = {{}}
for i, run in enumerate({runs!r}):
    kind = run[0]
    sd = {{k[len(kind) + 4:]: torch.from_numpy(inp[k]) for k in inp.files
           if k.startswith(kind + ".sd.")}}
    batch = {{k[len(kind) + 7:]: inp[k] for k in inp.files
              if k.startswith(kind + ".batch.")}}
    losses, final, counts = run_port(tuple(run), rank, sd, batch,
                                     cfgs[kind])
    res[f"r{{i}}.losses"] = np.array(losses)
    res[f"r{{i}}.counts"] = np.array(counts)
    if rank == 0:
        res.update({{f"r{{i}}.p.{{k}}": v for k, v in final.items()}})
res.update({{"check." + k: v for k, v in run_checks(rank,
                                                    inp["pool_x"]).items()}})
np.savez(f"{{out}}/rank{{rank}}.npz", **res)
backend.shutdown()
'''


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX's results, the ranks' results): the ranks run in a thread
    while this process computes JAX's."""
    out = str(tmp_path_factory.mktemp("sp_training"))
    gpt_batch, bert_batch = _batches()
    key = jax.random.PRNGKey(0)
    ids = jnp.zeros((1, S), jnp.int32)
    gpt_params = jax.jit(lambda k: GptLmHeadModel(_gpt_cfg()).init(
        {"params": k}, ids, train=False))(key)["params"]
    bert_params = jax.jit(lambda k: BertForPreTraining(_bert_cfg()).init(
        {"params": k}, ids, train=False))(key)["params"]
    tcfg = {"gpt": _port_cfg(_gpt_cfg(), tgpt.GptConfig),
            "bert": _port_cfg(_bert_cfg(), tbert.BertConfig)}

    def to_port(kind, params):
        p = jax.tree.map(np.asarray, params)
        if kind == "gpt":
            return gpt_params_from_jax(p, tgpt.GptConfig(**tcfg["gpt"]))
        return bert_params_from_jax(p, _bert_cfg())

    arrays = {"pool_x": np.random.RandomState(3).standard_normal(
        (2, 16, 8)).astype(np.float32)}
    for kind, params, batch in (("gpt", gpt_params, gpt_batch),
                                ("bert", bert_params, bert_batch)):
        for k, v in to_port(kind, params).items():
            arrays[f"{kind}.sd.{k}"] = v.numpy()
        for k, v in batch.items():
            arrays[f"{kind}.batch.{k}"] = v
    np.savez(os.path.join(out, "inputs.npz"), **arrays)
    with open(os.path.join(out, "cfgs.json"), "w") as f:
        json.dump(tcfg, f)
    fns = "\n\n".join(inspect.getsource(f) for f in (run_port, run_checks))
    code = _WORKER.format(root=ROOT, S=S, STEPS=STEPS, fns=fns,
                          runs=[list(r) for r in RUNS])
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
        for kind, params, batch in (("gpt", gpt_params, gpt_batch),
                                    ("bert", bert_params, bert_batch)):
            losses, final = _dense(kind, params, batch)
            want[kind] = (losses, {k: v.numpy() for k, v in
                                   to_port(kind, final).items()})
        for run in JAX_SP_RUNS:
            batch = gpt_batch if run[0] == "gpt" else bert_batch
            params = gpt_params if run[0] == "gpt" else bert_params
            losses, final = _jax_sp(run, params, batch)
            want[run] = (losses, {k: v.numpy() for k, v in
                                  to_port(run[0], final).items()})
        want["messages"] = _jax_messages()
    finally:
        t.join()
    if failure:
        raise failure[0]
    got = [np.load(os.path.join(out, f"rank{r}.npz")) for r in range(4)]
    return want, got


@pytest.mark.parametrize("index", range(len(RUNS)),
                         ids=[_run_id(r) for r in RUNS])
def test_sp_training_matches_jax(index, results):
    """3 SP steps: every rank's losses against JAX's dense training of the
    global batch (rtol 2e-4 / atol 2e-5), the gathered parameters by name
    (1e-5); the step averages over dp and sums over sp (``mean_world`` =
    dp), one update per bucket per step, the ranks at JAX's mesh places."""
    want, got = results
    kind, dp, sp, _ = RUNS[index]
    jlosses, jfinal = want[kind]
    for r in range(4):
        np.testing.assert_allclose(got[r][f"r{index}.losses"], jlosses,
                                   **LOSS_TOL)
        mean_world, buckets, rs, upd, dp_rank, sp_rank = \
            got[r][f"r{index}.counts"]
        assert mean_world == dp and (dp_rank, sp_rank) == divmod(r, sp)
        assert buckets >= 2 and rs == upd == STEPS * buckets
    prefix = f"r{index}.p."
    final = {k[len(prefix):]: got[0][k] for k in got[0].files
             if k.startswith(prefix)}
    assert sorted(final) == sorted(jfinal)
    for name, p in final.items():
        np.testing.assert_allclose(p, jfinal[name], **PARAM_TOL,
                                   err_msg=name)
    assert jlosses[-1] < jlosses[0]


@pytest.mark.parametrize("run", JAX_SP_RUNS, ids=_run_id)
def test_jax_sp_training_agrees(run, results):
    """JAX's own SP training of the run equals its dense training and the
    port's SP training, losses and parameters."""
    want, got = results
    jlosses, jfinal = want[run]
    dlosses, dfinal = want[run[0]]
    np.testing.assert_allclose(jlosses, dlosses, **LOSS_TOL)
    index = RUNS.index(run)
    np.testing.assert_allclose(got[0][f"r{index}.losses"], jlosses,
                               **LOSS_TOL)
    for name, p in jfinal.items():
        np.testing.assert_allclose(got[0][f"r{index}.p.{name}"], p,
                                   **PARAM_TOL, err_msg=name)
        np.testing.assert_allclose(dfinal[name], p, **PARAM_TOL,
                                   err_msg=name)


def test_sp_cls_pool_picks_global_first_token(results):
    """Every rank of the 1 x 4 layout pools the global first token; the
    gradient of the pooled sum (ones on every rank) reaches rank 0's first
    token only, summed over the group: psum's transpose, 4."""
    _, got = results
    x = np.random.RandomState(3).standard_normal((2, 16, 8)).astype(
        np.float32)
    for r in range(4):
        np.testing.assert_array_equal(got[r]["check.pool"], x[:, 0])
        want = np.zeros((2, 4, 8), np.float32)
        if r == 0:
            want[:, 0] = 4.0
        np.testing.assert_array_equal(got[r]["check.pool_grad"], want)


@pytest.mark.parametrize("name", ["fused", "compressed", "subset"])
def test_build_guards_match_jax(name, results):
    """The dp x sp step's build refusals carry JAX's messages."""
    want, got = results
    for r in range(4):
        assert str(got[r]["check." + name]) == \
            "ValueError: " + want["messages"][name]


def test_unported_combinations_name_their_item(results):
    """SP with dcn= or elastic regroup raises NotImplementedError naming
    ROADMAP Queue 1 item 10d; ``mean_axes=("dp",)`` builds."""
    _, got = results
    for r in range(4):
        assert str(got[r]["check.dcn"]).startswith("NotImplementedError")
        assert "item 10d" in str(got[r]["check.dcn"])
        assert "item 10d" in str(got[r]["check.regroup"])
        assert str(got[r]["check.sum_sp"]) == "built"


def test_sp_layout_over_a_subset_of_ranks(results):
    """`form_sp_groups(2, ranks=[2, 3])`, called by every rank: ranks 2
    and 3 form dp 1 x sp 2 (sp indices 0 and 1), ranks 0 and 1 get no
    group and no layout (sp 1, dp = the world)."""
    _, got = results
    for r in range(4):
        want = [1, 2, r - 2, 1] if r >= 2 else [0, 1, 0, 4]
        assert list(got[r]["check.ranks_subset"]) == want


_CLI_REFUSALS = [
    ("gpt", ["--sp-attention", "ring"]),
    ("gpt", ["--flash-attention", "--sp-degree", "2", "--sp-attention",
             "ulysses"]),
    ("gpt", ["--sp-degree", "2", "--sp-attention", "zigzag",
             "--sequence-len", "30"]),
    ("bert", ["--sp-attention", "ring"]),
    ("bert", ["--flash-attention", "--sp-degree", "2", "--sp-attention",
              "ulysses"]),
]


@pytest.mark.parametrize("cli,argv", _CLI_REFUSALS,
                         ids=[f"{c}{i}" for i, (c, _) in
                              enumerate(_CLI_REFUSALS)])
def test_cli_refusals_match_jax(cli, argv):
    """The CLIs refuse what the JAX CLIs refuse, before building anything,
    with their messages."""
    jmain = (jgpt_cli if cli == "gpt" else jbert_cli).main
    tmain = (tgpt_cli if cli == "gpt" else tbert_cli).main
    with pytest.raises(SystemExit) as jerr:
        jmain(argv)
    with pytest.raises(SystemExit) as terr:
        tmain(argv + ["--device", "cpu"])
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("sp,seq,pipeline", [(3, 32, "none"),
                                             (2, 33, "none"),
                                             (2, 32, "numpy")])
def test_sp_layout_refusals_match_jax(sp, seq, pipeline, monkeypatch):
    """`runner.build_sp_groups` refuses with `build_sp_mesh`'s messages
    (JAX runner.py:393-417) on an 8-rank world."""
    from dear_pytorch_tpu_torch.comm import backend

    with pytest.raises(SystemExit) as jerr:
        jrunner.build_sp_mesh(sp, seq, pipeline, seq_flag="--sequence-len")
    monkeypatch.setattr(backend, "size", lambda: 8)
    with pytest.raises(SystemExit) as terr:
        trunner.build_sp_groups(sp, seq, pipeline, seq_flag="--sequence-len")
    assert str(terr.value) == str(jerr.value)


def test_gpt_per_token_position_offset():
    """A per-token ``[1, S]`` position offset (the zigzag layout's) gives
    the positions ``offset + arange(S)``: a zigzag-permuted forward equals
    the dense forward's logits permuted, and decode mode refuses it."""
    cfg = tgpt.GptConfig(**_port_cfg(_gpt_cfg(), tgpt.GptConfig))
    model = tgpt.GptLmHeadModel(cfg, device="cpu", seed=2)
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, 61, (2, 8)))
    perm = torch.from_numpy(zigzag_permutation(8, 2))
    with torch.no_grad():
        dense = model(ids)
        # zigzag positions of the whole permuted sequence, one "rank"
        got = model(ids[:, perm], position_offset=(perm - torch.arange(8))[
            None])
    # causal attention differs in the permuted order; the positions do not:
    # the first chunk's logits (a causal prefix in both orders) agree
    torch.testing.assert_close(got[:, :2], dense[:, :2])
    with pytest.raises(ValueError, match="per-token"):
        model(ids[:, :1], position_offset=torch.zeros((1, 1)),
              cache=model.init_cache(2))
