"""The port's training CLI (dear_pytorch_tpu_torch.benchmarks.gpt) and its
configuration (dear_pytorch_tpu_torch.config) on the CPU: the same
`DearConfig` fields, defaults and ``DEAR_*`` names as the JAX package's;
the CLI's flag rules (kernel attention zeroes the attention-probs dropout;
with ``--fp16`` gradients travel in bf16 and gathers only when world > 1);
unported flags and fields raise; ``--ring-projections`` needs
``--mode dear-fused`` (JAX's SystemExit); and short CPU runs of GPT-2's
full width at one layer, which must lower their loss and run the schedule
once per bucket per step."""

import dataclasses

import pytest
import torch

from dear_pytorch_tpu.config import DearConfig as JaxDearConfig
from dear_pytorch_tpu_torch.benchmarks import gpt as cli
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
    for field, value in (("compressor", "eftopk"), ("autotune", "bo"),
                         ("remat", "full"), ("gtopk", True),
                         ("exclude_parts", ("allgather",)),
                         ("momentum_correction", 0.9)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DearConfig(**{field: value}).build_kwargs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DearConfig(optimizer_name="lamb").build_kwargs()
    assert DearConfig(optimizer_name="adamw").optimizer().kind == "adamw"


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
    ["--sp-degree", "2"], ["--remat"], ["--num-experts", "4"]])
def test_cli_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        cli.main(flags + ["--device", "cpu"])


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
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--compressor", "eftopk"])


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
