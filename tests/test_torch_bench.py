"""The port's bench entry (dear_pytorch_tpu_torch.bench) on the CPU with
``DEAR_BENCH_SMOKE=1 --device cpu``: one JSON line on stdout; the five
metrics with the names and units of the root bench.py (read from its
source) in its order; no ``vs_baseline``; the env switches and the error
entry of a secondary metric; `_gather_dtype`; and each entry's counted
FLOPs (`benchmarks.runner.step_flops`) equal to the analytic count at the
smoke sizes (exact on the CPU: the same ops, counted twice)."""

import ast
import contextlib
import io
import json
import pathlib

import pytest
import torch

from dear_pytorch_tpu_torch import bench

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(monkeypatch, **env):
    monkeypatch.setenv("DEAR_BENCH_SMOKE", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--device", "cpu"])
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def smoke():
    with pytest.MonkeyPatch.context() as mp:
        rc, out = _run(mp)
    return rc, out


def test_one_json_line(smoke):
    rc, out = smoke
    lines = out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == bench.PRIMARY_METRIC
    assert "vs_baseline" not in line
    # the telemetry block: on by default, counters only (no span records)
    tel = line["telemetry"]
    assert tel["enabled"] is True and "spans" not in tel
    assert tel["counters"]["dear.steps"] > 0


def test_telemetry_block_honours_an_explicit_disable(monkeypatch):
    """``DEAR_TELEMETRY=0`` is honoured: the block says disabled and holds
    no counter; the tracer the caller had is put back afterwards."""
    from dear_pytorch_tpu_torch.observability import tracer

    def stub(metric):
        return lambda *a, **k: {"metric": metric, "value": 1.0}

    monkeypatch.setattr(bench, "bench_resnet", stub(bench.PRIMARY_METRIC))
    for name in ("bench_bert", "bench_vit", "bench_gpt"):
        monkeypatch.setattr(bench, name, stub(name))
    before = tracer._tracer
    rc, out = _run(monkeypatch, DEAR_TELEMETRY="0")
    assert rc == 0 and tracer._tracer is before
    assert json.loads(out)["telemetry"] == {"enabled": False, "counters": {}}


def test_names_units_and_order_are_the_root_benchs(smoke):
    src = (ROOT / "bench.py").read_text()
    tree = ast.parse(src)
    funcs = {f.name: ast.get_source_segment(src, f) for f in tree.body
             if isinstance(f, ast.FunctionDef)}
    owner = {"resnet50": "bench_resnet", "bert": "bench_bert",
             "vit": "bench_vit", "gpt2": "bench_gpt"}
    for metric, unit in bench.METRICS:
        assert f'"{metric}"' in src, metric
        fn = owner[metric.split("_")[0]]
        assert f'"unit": "{unit}"' in funcs[fn], (metric, unit)
    # bench.py's primary metric, then its main's extras in this order
    assert f'PRIMARY_METRIC = "{bench.PRIMARY_METRIC}"' in src
    main_src = funcs["main"]
    at = [main_src.index(f'"{m}"') for m, _ in bench.METRICS[1:]]
    assert at == sorted(at)
    line = json.loads(smoke[1])
    got = [(line["metric"], line["unit"])] + [
        (m["metric"], m["unit"]) for m in line["extra_metrics"]]
    assert got == list(bench.METRICS)
    for m in [line] + line["extra_metrics"]:
        assert "error" not in m and "vs_baseline" not in m
        assert isinstance(m["value"], float) and m["value"] > 0
        assert m["mfu"] is None and m["peak_hbm_gb"] is None   # the CPU
        assert m["step_ms"] > 0


def test_counted_flops_equal_the_analytic_count(smoke):
    line = json.loads(smoke[1])
    want = bench.analytic_step_flops(smoke=True)
    for m in [line] + line["extra_metrics"]:
        assert m["flops_per_step"] == pytest.approx(want[m["metric"]],
                                                    rel=1e-9), m["metric"]


def test_env_switches_and_error_entry(monkeypatch):
    """BERT-Large and GPT switched off; ViT on but failing: its entry is
    bench.py's error entry and the line still comes."""
    def broken(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(bench, "bench_vit", broken)
    rc, out = _run(monkeypatch, DEAR_BENCH_BERT_LARGE="0",
                   DEAR_BENCH_GPT="false")
    line = json.loads(out)
    assert rc == 0
    assert [m["metric"] for m in line["extra_metrics"]] == [
        "bert_base_sen_sec_per_chip", "vit_b16_bs64_train_img_sec_per_chip"]
    assert line["extra_metrics"][1] == {
        "metric": "vit_b16_bs64_train_img_sec_per_chip",
        "error": "RuntimeError: boom"}


def test_gather_dtype(monkeypatch):
    monkeypatch.delenv("DEAR_BENCH_GATHER_DTYPE", raising=False)
    assert bench._gather_dtype(1) is None
    assert bench._gather_dtype(2) == torch.bfloat16
    monkeypatch.setenv("DEAR_BENCH_GATHER_DTYPE", "bf16")
    assert bench._gather_dtype(1) == torch.bfloat16
    monkeypatch.setenv("DEAR_BENCH_GATHER_DTYPE", "f32")
    assert bench._gather_dtype(8) is None
    monkeypatch.setenv("DEAR_BENCH_GATHER_DTYPE", "fp8")
    with pytest.raises(SystemExit, match="DEAR_BENCH_GATHER_DTYPE"):
        bench._gather_dtype(2)


def test_protocol_follows_bench_py(monkeypatch):
    monkeypatch.delenv("DEAR_BENCH_SMOKE", raising=False)
    full = bench.Protocol.from_env()
    assert (full.warmup_steps, full.num_iters, full.batches_per_iter) == (
        10, 10, 10)
    monkeypatch.setenv("DEAR_BENCH_SMOKE", "1")
    smoke = bench.Protocol.from_env()
    assert smoke.smoke and smoke.warmup_steps == 2
    assert (smoke.num_iters, smoke.batches_per_iter) == (2, 2)


def test_protocol_iters_shortens_the_timed_window(monkeypatch):
    """``DEAR_BENCH_ITERS`` changes the timed iterations only."""
    monkeypatch.delenv("DEAR_BENCH_SMOKE", raising=False)
    monkeypatch.setenv("DEAR_BENCH_ITERS", "2")
    short = bench.Protocol.from_env()
    assert (short.warmup_steps, short.num_iters, short.batches_per_iter) == (
        10, 2, 10)


def test_analytic_counts_at_full_size():
    """The full-size counts the card's counted steps are held against
    (PERF.md names them), reckoned by hand from the configs: ResNet-50 3 x
    8.1784 GFLOP per image less the stem's input gradient (0.2360), BERT
    6 x 108.96 M (Base) and 334.30 M (Large) matmul parameters per token
    plus the pooler and the dense attention, ViT-B/16 and GPT-2 with the
    dense core (6.425 and 12.14 TFLOP of matmuls, 0.2747 and 1.855 of
    attention)."""
    want = bench.analytic_step_flops()
    assert want[bench.PRIMARY_METRIC] == pytest.approx(1.5551e12, rel=1e-3)
    assert want["bert_base_sen_sec_per_chip"] == pytest.approx(
        1.3536e12, rel=1e-3)
    assert want["bert_large_sen_sec_per_chip"] == pytest.approx(
        2.0734e12, rel=1e-3)
    assert want["vit_b16_bs64_train_img_sec_per_chip"] == pytest.approx(
        6.7297e12, rel=1e-3)
    assert want["gpt2_s1024_tok_sec_per_chip"] == pytest.approx(
        1.4000e13, rel=1e-3)
