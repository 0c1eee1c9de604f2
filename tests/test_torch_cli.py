"""The port's training CLI (dear_pytorch_tpu_torch.benchmarks.gpt) and its
configuration (dear_pytorch_tpu_torch.config) on the CPU: the same
`DearConfig` fields, defaults and ``DEAR_*`` names as the JAX package's;
the CLI's flag rules (kernel attention zeroes the attention-probs dropout;
with ``--fp16`` gradients travel in bf16 and gathers only when world > 1);
unported flags and fields raise; ``--ring-projections`` needs
``--mode dear-fused`` (JAX's SystemExit); and short CPU runs of GPT-2's
full width at one layer, which must lower their loss and run the schedule
once per bucket per step; the ImageNet CLI (ResNet-18 and ViT-S/16 at
224²) likewise, and the rest of the zoo through it (DenseNet-121,
Inception-v4 at 299², VGG-11 with dropout, MnistNet on 28² MNIST
batches); the BERT CLI (BERT-Base's widths at one layer, dense and flash)
and its refusals, and ``--mode dear-fused --ring-projections`` at world 2
(two spawned jax-free ranks) against the same run without ring
projections; the port's MNIST example (synthetic and real digits)."""

import dataclasses

import numpy as np
import pytest
import torch

from dear_pytorch_tpu.config import DearConfig as JaxDearConfig
from dear_pytorch_tpu_torch.benchmarks import gpt as cli
from dear_pytorch_tpu_torch.benchmarks import imagenet
from dear_pytorch_tpu_torch.benchmarks import runner
from dear_pytorch_tpu_torch.config import DearConfig


def test_config_fields_and_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JaxDearConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(DearConfig)}
    assert jf == tf


def test_config_from_env_and_unported_fields(monkeypatch):
    monkeypatch.setenv("DEAR_THRESHOLD_MB", "none")
    monkeypatch.setenv("DEAR_COMM_DTYPE", "bf16")
    monkeypatch.setenv("DEAR_ACCUM_STEPS", "2")
    monkeypatch.setenv("DEAR_CLIP_NORM", "1.5")
    cfg = DearConfig.from_env(lr=0.2)
    assert cfg.threshold_mb is None and cfg.comm_dtype == torch.bfloat16
    assert cfg.accum_steps == 2 and cfg.clip_norm == 1.5 and cfg.lr == 0.2
    kw = cfg.build_kwargs()
    assert kw["comm_dtype"] == torch.bfloat16 and kw["accum_steps"] == 2
    assert kw["optimizer"].kind == "sgd" and kw["optimizer"].lr == 0.2
    monkeypatch.setenv("DEAR_ACCUM_STEPS", "0")
    with pytest.raises(ValueError, match="DEAR_ACCUM_STEPS"):
        DearConfig.from_env()
    # autotune is ported since slice 15: the tuning fields are the
    # runner's (build_stepper), not the train step's
    kw = DearConfig(autotune="bo", bo_trials=3).build_kwargs()
    assert "autotune" not in kw and "bo_trials" not in kw
    # ported: the ablations and bytescheduler's partition pass through, and
    # since slice 14 compression and remat
    kw = DearConfig(exclude_parts=("allgather",),
                    partition_mb=2.0).build_kwargs()
    assert kw["exclude_parts"] == ("allgather",) and kw["partition_mb"] == 2.0
    kw = DearConfig(compressor="eftopk", density=0.01, gtopk=True,
                    momentum_correction=0.9, remat="full").build_kwargs()
    assert (kw["compressor"], kw["density"], kw["gtopk"],
            kw["momentum_correction"], kw["remat"]) == (
                "eftopk", 0.01, True, 0.9, "full")
    assert DearConfig(remat="none").build_kwargs()["remat"] is None
    # momentum correction carries the momentum: SGD's is 0 (JAX's rule)
    assert kw["optimizer"].momentum == 0.0
    assert DearConfig().optimizer().momentum == 0.9
    assert DearConfig(optimizer_name="adamw").optimizer().kind == "adamw"


@pytest.mark.parametrize("env", [{}, {"DEAR_ADAM_BETAS": "0.8,0.99",
                                      "DEAR_ADAM_EPS": "1e-7",
                                      "DEAR_WEIGHT_DECAY": "0.05"}])
def test_config_lamb_is_jaxs(env, monkeypatch):
    """``optimizer_name="lamb"`` builds JAX's LAMB: ``adam_betas``,
    ``adam_eps`` and ``weight_decay`` (defaults (0.9, 0.999), 1e-8 and 0),
    not `fused_lamb`'s own defaults (1e-6, 0.01): one update equals JAX's
    config's on the same shard."""
    import jax.numpy as jnp

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = DearConfig.from_env(optimizer_name="lamb", lr=0.1)
    jcfg = JaxDearConfig.from_env(optimizer_name="lamb", lr=0.1)
    assert (cfg.adam_betas, cfg.adam_eps, cfg.weight_decay) == (
        jcfg.adam_betas, jcfg.adam_eps, jcfg.weight_decay)
    opt, jopt_ = cfg.build_kwargs()["optimizer"], jcfg.optimizer()
    rng = np.random.default_rng(0)
    p = rng.normal(size=16).astype(np.float32)
    g = (1e-4 * rng.normal(size=16)).astype(np.float32)
    seg = np.array([0] * 9 + [1] * 7, np.int32)
    tp = torch.from_numpy(p.copy())
    state = opt.init(tp)
    opt.update(torch.from_numpy(g), state, tp, torch.from_numpy(seg), 3,
               lambda x: x)
    jp, _ = jopt_.update(jnp.asarray(g), jopt_.init(jnp.asarray(p)),
                         jnp.asarray(p), jnp.asarray(seg), 3, lambda x: x)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)


def _args(*extra):
    return cli.build_parser().parse_args(list(extra))


def test_cli_dtype_rules():
    a = _args("--fp16")
    assert runner.config_from_args(a, world=1).comm_dtype == torch.bfloat16
    assert runner.config_from_args(a, world=1).gather_dtype is None
    assert runner.config_from_args(a, world=2).gather_dtype == torch.bfloat16
    b = _args()
    assert runner.config_from_args(b, world=2).comm_dtype is None
    assert runner.config_from_args(_args("--threshold", "0")).threshold_mb \
        is None


@pytest.mark.parametrize("flags", [
    ["--sp-degree", "2"], ["--remat", "--num-experts", "4"],
    ["--num-experts", "4"]])
def test_cli_unported_flags_raise(flags):
    """What is left unported raises, naming only itself (``--remat`` is
    ported since slice 14)."""
    with pytest.raises(NotImplementedError, match="not ported") as err:
        cli.main(flags + ["--device", "cpu"])
    assert "--remat" not in str(err.value)


@pytest.mark.parametrize("flags", [
    [], ["--mode", "dear"], ["--mode", "dear-fused", "--sp-degree", "2"]])
def test_cli_ring_projections_requires_dear_fused(flags):
    """JAX's rule and message (dear_pytorch_tpu/benchmarks/gpt.py:127-129),
    checked before anything else runs."""
    with pytest.raises(SystemExit, match="requires --mode dear-fused"):
        cli.main(["--ring-projections", "--device", "cpu"] + flags)


def test_cli_ring_projections_trains_on_the_cpu():
    """``--mode dear-fused --ring-projections`` at world 1: the query, key,
    value and MLP-up projections are `ProjDense` modules over the ring
    impl (dense at world 1, as JAX's), the plan has the dense model's
    parameters, and two steps lower the loss."""
    from dear_pytorch_tpu_torch.models.bert import ProjDense

    res = cli.main(["--device", "cpu", "--mode", "dear-fused",
                    "--ring-projections", "--num-hidden-layers", "1",
                    "--batch-size", "2", "--sequence-len", "16", "--fp16",
                    "--flash-attention", "--base-lr", "0.01",
                    "--num-warmup-batches", "0", "--num-batches-per-iter",
                    "2", "--num-iters", "1"])
    ts = res.train_step
    block = ts.model.h_0
    assert all(isinstance(getattr(block, n), ProjDense)
               for n in ("query", "key", "value", "mlp_in"))
    assert not isinstance(block.output, ProjDense)
    assert not isinstance(block.mlp_out, ProjDense)
    assert len(res.losses) == 2 and res.losses[-1] < res.losses[0]
    assert ts.cm_calls == 0 and ts.ring.world == 1
    ts.close()


def test_cli_unknown_flag_is_an_error():
    """A JAX CLI flag the port does not carry (``--sp-attention``: ROADMAP
    Queue 1 item 10; ``--compressor`` is carried since slice 14,
    ``--autotune`` since slice 15, ``--pipeline`` since slice 16) is an
    argparse error."""
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--sp-attention", "ring"])
    assert cli.build_parser().parse_args(
        ["--compressor", "eftopk"]).compressor == "eftopk"
    assert cli.build_parser().parse_args(
        ["--autotune", "bo"]).autotune == "bo"
    assert cli.build_parser().parse_args(
        ["--pipeline", "numpy"]).pipeline == "numpy"


def test_cli_trains_on_the_cpu(capsys):
    """GPT-2 small's widths at one layer, S=16: the kernel-attention rule
    logs, the loss falls, and each step runs one reduce-scatter, update and
    all-gather per bucket."""
    res = cli.main(["--device", "cpu", "--num-hidden-layers", "1",
                    "--batch-size", "2", "--sequence-len", "16",
                    "--flash-attention", "--fp16", "--threshold", "25",
                    "--base-lr", "0.01", "--momentum", "0.9",
                    "--num-warmup-batches", "1", "--num-batches-per-iter",
                    "1", "--num-iters", "2"])
    out = capsys.readouterr().out
    assert "attention_probs_dropout_prob 0.1 -> 0.0" in out
    assert "Tokens/sec on 1 CPU(s)" in out
    ts = res.train_step
    steps = len(res.losses)
    assert steps == 3 and res.losses[-1] < res.losses[0]
    n = ts.plan.num_buckets
    assert ts.rs_launches == ts.update_launches == steps * n
    assert ts.ag_launches == (steps + 1) * n
    assert res.world == 1 and res.device == "CPU"


def test_cli_dear_fused_trains_on_the_cpu():
    """``--mode dear-fused`` at world 1: the ring collectives short-cut
    (the update per bucket, the gather the shard), two steps, the loss
    falls, the gathers in fp32 as the JAX CLI's (only 'dear' and 'fsdp'
    gather in bf16)."""
    res = cli.main(["--device", "cpu", "--mode", "dear-fused",
                    "--num-hidden-layers", "1", "--batch-size", "2",
                    "--sequence-len", "16", "--fp16", "--base-lr", "0.01",
                    "--num-warmup-batches", "0", "--num-batches-per-iter",
                    "2", "--num-iters", "1"])
    ts = res.train_step
    assert ts.fused and ts.ring.world == 1
    assert len(res.losses) == 2 and res.losses[-1] < res.losses[0]
    n = ts.plan.num_buckets
    assert ts.rs_launches == ts.update_launches == 2 * n
    assert ts.ag_launches == 3 * n
    assert runner.config_from_args(
        _args("--fp16", "--mode", "dear-fused"), world=2).gather_dtype is None
    ts.close()


def test_imagenet_cli_trains_resnet_on_the_cpu(capsys):
    """The ImageNet CLI at 224² (ResNet-18, batch 2, bf16, the s2d stem):
    the loss falls, each step runs one reduce-scatter, update and
    all-gather per bucket, the BN statistics are the step's model state
    (at world 1 nothing to sync) and moved."""
    res = imagenet.main(["--device", "cpu", "--model", "resnet18",
                         "--stem", "s2d", "--batch-size", "2", "--fp16",
                         "--num-warmup-batches", "0",
                         "--num-batches-per-iter", "3", "--num-iters", "1"])
    out = capsys.readouterr().out
    assert "Img/sec per CPU" in out and "fusion: " in out
    ts = res.train_step
    assert len(res.losses) == 3 and res.losses[-1] < res.losses[0]
    n = ts.plan.num_buckets
    assert ts.rs_launches == ts.update_launches == 3 * n
    assert ts.ag_launches == 4 * n and ts.state_syncs == 0
    assert len(ts._mstate) == 3 * 20          # 20 BNs in ResNet-18
    assert int(ts.model.bn1.num_batches_tracked) == 3
    assert float(ts.model.bn1.running_var.sub(1).abs().max()) > 0
    assert res.batch["image"].shape == (2, 3, 224, 224)
    assert res.batch["image"].dtype == torch.bfloat16
    assert ts.model.conv1.weight.shape == (64, 12, 4, 4)


@pytest.mark.parametrize("argv,match", [
    (["--model", "densenet121", "--stem", "s2d"], "ResNet models only"),
    (["--model", "gpt2"], "CNNs are"),
])
def test_imagenet_cli_refuses_what_it_does_not_run(argv, match):
    with pytest.raises(SystemExit, match=match):
        imagenet.main(argv + ["--device", "cpu"])


#: per flag of slice 16: (argv argparse refuses, argv it takes, what it
#: sets)
_SLICE16_FLAGS = {
    "--pipeline": (["--pipeline", "bogus"], ["--pipeline", "native"],
                   {"pipeline": "native"}),
    "--profile-dir": (["--profile-dir"],
                      ["--profile-dir", "prof", "--metrics-file", "m.jsonl"],
                      {"profile_dir": "prof", "metrics_file": "m.jsonl"}),
}


@pytest.mark.parametrize("flag", ["--pipeline", "--profile-dir"])
def test_imagenet_cli_unported_flags_are_errors(flag):
    """The JAX CLI's ``--pipeline``, ``--profile-dir`` and
    ``--metrics-file``, ported in slice 16: a value outside ``--pipeline``'s
    choices, or a path flag without its path, is an argparse error; the
    flags' values parse."""
    bad, good, want = _SLICE16_FLAGS[flag]
    with pytest.raises(SystemExit):
        imagenet.build_parser().parse_args(bad)
    args = imagenet.build_parser().parse_args(good)
    assert {k: getattr(args, k) for k in want} == want


def _bert(*extra):
    from dear_pytorch_tpu_torch.benchmarks import bert

    return bert.main(["--device", "cpu", "--model", "bert_base",
                      "--num-hidden-layers", "1", "--sentence-len", "16",
                      "--batch-size", "2", "--num-warmup-batches", "0",
                      "--num-batches-per-iter", "3", "--num-iters", "1"]
                     + list(extra))


def test_bert_cli_trains_on_the_cpu(capsys):
    """The BERT CLI (BERT-Base's widths at one layer, S=16): JAX's header
    lines, each step one reduce-scatter, update and all-gather per bucket,
    the loss falls (``--dropout0``, lr 0.01), and ``--mfu`` logs the
    counted FLOPs (no peak on the CPU)."""
    res = _bert("--dropout0", "--base-lr", "0.01", "--mfu")
    out = capsys.readouterr().out
    assert "BERT Base Pretraining, Sentence len: 16" in out
    assert "Number of CPUs: 1" in out and "fusion: " in out
    assert "FLOP/step: " in out and "peak unknown for CPU" in out
    assert res.flops_per_step > 0
    ts = res.train_step
    # --mfu counts an extra untimed step when there is no warmup
    assert len(res.losses) == 4 and res.losses[-1] < res.losses[0]
    n = ts.plan.num_buckets
    assert ts.rs_launches == ts.update_launches == 4 * n
    assert res.batch["input_ids"].shape == (2, 16)
    assert res.batch["input_ids"].dtype == torch.int32


def test_bert_cli_flash_attention_matches_dense_on_the_cpu(capsys):
    """``--flash-attention`` zeroes the attention-probs dropout with JAX's
    log line and runs the flash impl; with ``--dropout0`` its first loss
    equals the dense core's on the same weights and batch (fp32)."""
    from dear_pytorch_tpu_torch.models.bert import dot_product_attention

    flash = _bert("--flash-attention", "--base-lr", "0.01")
    out = capsys.readouterr().out
    assert "attention_probs_dropout_prob 0.1 -> 0.0" in out
    cfg = flash.train_step.model.config
    assert cfg.attention_probs_dropout_prob == 0.0
    assert cfg.hidden_dropout_prob == 0.1
    assert flash.train_step.model.attention_impl is not dot_product_attention
    assert all(np.isfinite(flash.losses))
    a = _bert("--flash-attention", "--dropout0")
    b = _bert("--dropout0")
    assert b.train_step.model.attention_impl is dot_product_attention
    np.testing.assert_allclose(a.losses[0], b.losses[0], rtol=1e-5)


@pytest.mark.parametrize("flags,match", [
    (["--sp-degree", "2"], "item 10"),
    (["--sp-attention", "ring"], "item 10"),
])
def test_bert_cli_unported_flags_raise(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        _bert(*flags)


def test_bert_cli_refuses_other_models():
    with pytest.raises(SystemExit, match="bert_base"):
        _bert("--model", "gpt2")


def test_imagenet_cli_trains_vit_on_the_cpu(capsys):
    """The ImageNet CLI with ``vit_s16`` at 224² (batch 1, bf16, as the
    JAX CLI runs it): no model state, one reduce-scatter, update and
    all-gather per bucket."""
    res = imagenet.main(["--device", "cpu", "--model", "vit_s16",
                         "--batch-size", "1", "--fp16",
                         "--num-warmup-batches", "0",
                         "--num-batches-per-iter", "2", "--num-iters", "1"])
    out = capsys.readouterr().out
    assert "Model: vit_s16" in out and "stem" not in out
    ts = res.train_step
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert ts._mstate == [] and ts.state_syncs == 0
    n = ts.plan.num_buckets
    assert ts.rs_launches == ts.update_launches == 2 * n
    assert ts.model.pos_embed.shape == (1, 197, 384)


@pytest.mark.parametrize("model,size,buffers", [
    ("densenet121", 224, 3 * 121), ("inceptionv4", 299, 3 * 149),
    ("vgg11", 224, 0), ("mnistnet", 28, 0)])
def test_imagenet_cli_trains_the_zoo_on_the_cpu(model, size, buffers):
    """The rest of the zoo through the ImageNet CLI at full size, batch 1,
    bf16, one step: the JAX CLI's image size (299² Inception, 28²
    grayscale MNIST), a finite loss, one reduce-scatter and update per
    bucket, the BN statistics as the step's model state (none for VGG and
    MnistNet, whose dropout draws from the step's generator)."""
    res = imagenet.main(["--device", "cpu", "--model", model,
                         "--batch-size", "1", "--fp16",
                         "--num-warmup-batches", "0",
                         "--num-batches-per-iter", "1", "--num-iters", "1"])
    ts = res.train_step
    assert len(res.losses) == 1 and all(np.isfinite(res.losses))
    n = ts.plan.num_buckets
    assert ts.rs_launches == ts.update_launches == n
    assert len(ts._mstate) == buffers and ts.state_syncs == 0
    assert res.batch["image"].shape == (1, 1 if model == "mnistnet" else 3,
                                        size, size)
    assert ts.rng_seed is not None


def test_plain_sgd_reference_is_the_cli_dear_run():
    """scripts/plain_sgd_reference.py (plain ``torch.optim.SGD``, the CLI's
    model, batch and dropout masks) gives the ImageNet CLI's ``--mode
    dear`` losses at one rank: MnistNet in fp32, 5 steps, with dropout."""
    from dear_pytorch_tpu_torch.scripts import plain_sgd_reference as ref

    res = imagenet.main(["--device", "cpu", "--model", "mnistnet",
                         "--batch-size", "16", "--num-warmup-batches", "1",
                         "--num-batches-per-iter", "2", "--num-iters", "2"])
    losses, clean = ref.main(["--device", "cpu", "--model", "mnistnet",
                              "--batch-size", "16", "--steps", "5"])
    np.testing.assert_allclose(losses, res.losses, rtol=1e-5, atol=1e-5)
    assert len(clean) == 2 and clean[1] < clean[0]


def test_imagenet_cli_gives_vgg16_fc1_a_bucket_of_its_own():
    """VGG-16's fc1 weight (102,760,448 parameters, 411 MB in fp32) is one
    leaf over sixteen times the 25 MB threshold: the plan gives its layer
    (weight and bias) a bucket of its own, whose shard at world 2 is half
    of it; 6 buckets in all."""
    from dear_pytorch_tpu_torch import models
    from dear_pytorch_tpu_torch.ops import fusion
    from tests.test_torch_zoo import shapes_only

    with shapes_only():
        model = models.get_model("vgg16", device="meta")
    for world, shard in ((1, 102_764_544), (2, 51_382_272)):
        plan = fusion.make_plan(model, world, threshold_mb=25.0)
        fc1 = next(b for b in plan.buckets if any(
            plan.leaves[i].name == "fc1.weight" for i in b.leaf_ids))
        assert [plan.leaves[i].name for i in fc1.leaf_ids] == [
            "fc1.weight", "fc1.bias"]
        assert fc1.size == 25088 * 4096 + 4096 == 102_764_544
        assert fc1.shard_size == shard and plan.num_buckets == 6


def test_bert_cli_ring_projections_requires_dear_fused():
    with pytest.raises(SystemExit, match="requires --mode dear-fused"):
        _bert("--ring-projections")


_BERT_RP_WORKER = """
import json, os, sys
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.benchmarks import bert
from dear_pytorch_tpu_torch.comm import backend
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store")
argv = ["--device", "cpu", "--model", "bert_base", "--num-hidden-layers",
        "1", "--sentence-len", "16", "--batch-size", "2", "--dropout0",
        "--base-lr", "0.01", "--mode", "dear-fused",
        "--num-warmup-batches", "0", "--num-batches-per-iter", "3",
        "--num-iters", "1"]
results = {{}}
for name, extra in (("plain", []), ("ring", ["--ring-projections"])):
    res = bert.main(argv + extra)      # both runs in one group
    ts = res.train_step
    results[name] = {{"losses": res.losses, "cm_calls": ts.cm_calls,
                      "proj": sum(type(m).__name__ == "ProjDense"
                                  for m in ts.model.modules())}}
    ts.close()
backend.shutdown()
json.dump(results, open(f"{{out}}/rank{{rank}}.json", "w"))
"""


def test_bert_cli_ring_projections_train_at_world2(tmp_path):
    """``--mode dear-fused --ring-projections`` at world 2 (two jax-free
    ranks over gloo, the ring matmul's plain versions over the group):
    the query, key, value and intermediate products of the layer go
    through the ring (3 ring-matmul calls each per step: forward, dx,
    dw), and every step's loss equals the run without ring projections
    within 1e-5 (fp32) on both ranks."""
    import json
    import os

    from tests.test_torch_dear import ROOT, spawn_ranks

    spawn_ranks(_BERT_RP_WORKER.format(root=ROOT), 2, str(tmp_path))
    ranks = [json.load(open(os.path.join(tmp_path, f"rank{r}.json")))
             for r in range(2)]
    for r in ranks:
        assert r["plain"]["proj"] == 0 and r["ring"]["proj"] == 4
        assert r["plain"]["cm_calls"] == 0
        assert r["ring"]["cm_calls"] == 3 * 4 * 3
        np.testing.assert_allclose(r["ring"]["losses"],
                                   r["plain"]["losses"], rtol=1e-5,
                                   atol=1e-5)
        assert r["ring"]["losses"][-1] < r["ring"]["losses"][0]
    assert ranks[0]["ring"]["losses"] == ranks[1]["ring"]["losses"]


def test_mnist_example_on_synthetic_data():
    """The port's examples/mnist.py on the class-template stand-in, the
    JAX test's arguments and bar (> 0.9 held-out accuracy)."""
    from dear_pytorch_tpu_torch.examples import mnist

    acc = mnist.main(["--device", "cpu", "--data", "synthetic",
                      "--epochs", "3", "--batch-size", "64",
                      "--train-size", "2048", "--test-size", "512",
                      "--lr", "0.05"])
    assert acc > 0.9, acc


def test_mnist_example_learns_real_digits():
    """Real handwritten digits (scikit-learn's bundled corpus) through the
    whole DeAR schedule and the sharded sampler: the JAX test's arguments
    and its bar, >= 0.9 held-out accuracy."""
    pytest.importorskip("sklearn")
    from dear_pytorch_tpu_torch.examples import mnist

    acc = mnist.main(["--device", "cpu", "--data", "real", "--epochs",
                      "10", "--batch-size", "64", "--lr", "0.05",
                      "--momentum", "0.9"])
    assert acc >= 0.9, acc


def test_mnist_example_refusals(monkeypatch):
    """Without scikit-learn the real digits raise ImportError, never a
    silent switch to synthetic data. (``--checkpoint-dir`` and
    ``--resume`` work now: tests/test_torch_guard.py.)"""
    import sys

    from dear_pytorch_tpu_torch.examples import mnist

    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        mnist.main(["--device", "cpu", "--epochs", "1"])
