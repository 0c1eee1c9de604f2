"""The rest of the port's bench harness on the CPU: the CLIs' streamed
batches (``--pipeline``), ``--metrics-file`` and the ``TELEMETRY`` line,
the sweep driver (`benchmarks.driver`), the scaling sweep
(`benchmarks.scaling`) and the collective sweep (`benchmarks.collectives`).

- A CLI run with ``--pipeline numpy`` has per-step losses equal, at 1e-5
  fp32, to a port `TrainStep` fed the JAX package's `NumpyPipeline`
  batches of the same seed (the global batch's rows of this rank).
- The driver mirrors tests/test_config_and_driver.py (`extract_log`,
  `cell_cmd`'s routing, a resume-only sweep and its reports.json), and
  runs one real cell of two spawned gloo ranks with its telemetry.
- ``scaling`` runs worlds 1 and 2 inside one launched world of two gloo
  ranks.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dear_pytorch_tpu.benchmarks import driver as jdriver
from dear_pytorch_tpu.runtime import pipeline as JP
from dear_pytorch_tpu_torch import models
from dear_pytorch_tpu_torch.benchmarks import driver
from dear_pytorch_tpu_torch.benchmarks import gpt as gpt_cli
from dear_pytorch_tpu_torch.benchmarks import imagenet as imagenet_cli
from dear_pytorch_tpu_torch.benchmarks import runner
from dear_pytorch_tpu_torch.models.gpt import gpt_lm_loss
from dear_pytorch_tpu_torch.utils.metrics import read_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
_GPT = ["--device", "cpu", "--num-hidden-layers", "1", "--batch-size", "2",
        "--sequence-len", "16", "--dropout0", "--threshold", "25",
        "--base-lr", "0.01", "--momentum", "0.9"]


def _env():
    """A rank's environment: this checkout on the path, no launcher
    variables, one intra-op thread (tests/test_torch_dear.py's rule)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DEAR_", "JAX_", "XLA_"))}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


# ---------------------------------------------------------------------------
# streamed batches
# ---------------------------------------------------------------------------


def test_streamed_losses_equal_a_train_step_on_jaxs_batches(tmp_path):
    """GPT-2 (one layer, full width, fp32) with ``--pipeline numpy``
    against a `TrainStep` built from the same flags over the same seeded
    model, fed JAX's `NumpyPipeline(gpt_spec)` batches (int32 ids, cast to
    the CLI's int64): the same 4 losses at 1e-5. The metrics file holds
    one record per timed run and a summary."""
    metrics = str(tmp_path / "m.jsonl")
    res = gpt_cli.main(_GPT + ["--pipeline", "numpy", "--metrics-file",
                               metrics, "--num-warmup-batches", "1",
                               "--num-batches-per-iter", "3",
                               "--num-iters", "1"])
    res.train_step.close()
    assert type(res.pipeline).__name__ == "NumpyPipeline"
    args = gpt_cli.build_parser().parse_args(_GPT)
    cfg = dataclasses.replace(models.dropout_free(models.gpt_config("gpt2")),
                              num_hidden_layers=1)
    model = models.GptLmHeadModel(cfg, device="cpu", seed=0)

    def loss_fn(m, b, generator):
        return gpt_lm_loss(m(b["input_ids"], train=True, generator=generator),
                           b["input_ids"], vocab_size=cfg.vocab_size)

    from dear_pytorch_tpu_torch.comm import backend

    group = backend.init("cpu")
    ts, stepper = runner.build_stepper(
        runner.config_from_args(args, world=1), loss_fn, model, group=group,
        device=torch.device("cpu"))
    jp = JP.NumpyPipeline(JP.gpt_spec(2, 16, vocab=cfg.vocab_size), seed=0)
    state, losses = stepper.init(), []
    for _ in range(4):
        ids = torch.from_numpy(jp.next()["input_ids"]).long()
        state, m = stepper.step(state, {"input_ids": ids})
        losses.append(float(m["loss"]))
    ts.close()
    # res.losses: the last step of each call, one step per call
    np.testing.assert_allclose(res.losses, losses, rtol=TOL, atol=0)
    recs = read_metrics(metrics)
    assert [r.get("iter") for r in recs[:-1]] == [0]
    assert recs[0]["sen_per_sec_per_device"] > 0
    assert recs[-1]["summary"] is True and recs[-1]["world"] == 1


def test_imagenet_streams_nhwc_batches_as_nchw_and_logs_telemetry(
        capsys, tmp_path, monkeypatch):
    """``--pipeline native`` on the ImageNet CLI: the driven object is the
    native `Pipeline`, the staged image is the models' NCHW (a
    channels-last view of the pipeline's NHWC rows), and with the tracer
    on the run ends with one ``TELEMETRY {...}`` line the driver scrapes,
    logged to the metrics file too; ``--profile-dir`` writes a trace."""
    from dear_pytorch_tpu_torch.observability import tracer as T
    from dear_pytorch_tpu_torch.runtime import pipeline as TP

    seen = []
    orig = runner.stage_global

    def recording(*a, **k):
        out = orig(*a, **k)
        seen.append(out["image"])
        return out

    monkeypatch.setattr(runner, "stage_global", recording)
    before = T._tracer
    T.set_tracer(T.Tracer([T.MemoryExporter()]))
    try:
        res = imagenet_cli.main([
            "--device", "cpu", "--model", "mnistnet", "--batch-size", "4",
            "--pipeline", "native", "--num-warmup-batches", "1",
            "--num-batches-per-iter", "2", "--num-iters", "1",
            "--metrics-file", str(tmp_path / "m.jsonl"),
            "--profile-dir", str(tmp_path / "prof")])
    finally:
        T.set_tracer(before)
    res.train_step.close()
    assert type(res.pipeline) is TP.Pipeline
    assert seen[0].shape == (4, 28, 28, 1)
    out = capsys.readouterr().out
    tel = [line for line in out.splitlines()
           if line.startswith("TELEMETRY ")]
    assert len(tel) == 1
    snap = json.loads(tel[0][len("TELEMETRY "):])
    assert snap["counters"]["dear.steps"] == 3
    assert snap["counters"]["pipeline.batches"] == 3
    assert snap["counters"]["kernel.fused_update_launches"] == 0  # the CPU
    recs = read_metrics(str(tmp_path / "m.jsonl"))
    assert recs[-1]["kind"] == "telemetry"
    assert json.loads(recs[-1]["telemetry"]) == snap
    assert os.path.exists(tmp_path / "prof" / "trace_rank0.json")
    log = tmp_path / "cell.log"          # the driver's scrapers read it
    log.write_text(out)
    assert driver.extract_telemetry(str(log)) == snap
    assert driver.extract_log(str(log))[0] > 0


def test_scan_steps_still_refuses_a_pipeline():
    args = gpt_cli.build_parser().parse_args(
        ["--scan-steps", "2", "--pipeline", "numpy"])
    with pytest.raises(SystemExit, match="incompatible with --pipeline"):
        runner.validate_scan_steps(args)


# ---------------------------------------------------------------------------
# the driver (tests/test_config_and_driver.py's cases)
# ---------------------------------------------------------------------------


def test_extract_log(tmp_path):
    log = tmp_path / "x.log"
    log.write_text(
        "Running benchmark...\n"
        "Total img/sec on 8 CPU(s): 123.4 +-5.6\n"
        "Total img/sec on 8 GPU(s): 150.0 +-2.0\n"
    )
    assert driver.extract_log(str(log)) == (150.0, 2.0)
    assert driver.extract_log(str(log)) == jdriver.extract_log(str(log))
    assert driver.extract_log(str(tmp_path / "missing.log")) is None


def test_cell_cmd_routing():
    cmd = driver.cell_cmd("bert_base", 8, "dear", [])
    assert "dear_pytorch_tpu_torch.benchmarks.bert" in cmd
    cmd = driver.cell_cmd("gpt2", 8, "dear-fused", [])
    assert "dear_pytorch_tpu_torch.benchmarks.gpt" in cmd
    cmd = driver.cell_cmd("resnet50", 64, "mgwfbp", [])
    assert "dear_pytorch_tpu_torch.benchmarks.imagenet" in cmd
    assert "--mgwfbp" in cmd
    assert driver.METHOD_ARGS == jdriver.METHOD_ARGS
    assert driver.DEFAULT_TASKS == jdriver.DEFAULT_TASKS
    # every method's flags parse on the CLI that runs them
    for method, flags in driver.METHOD_ARGS.items():
        imagenet_cli.build_parser().parse_args(flags)


def test_driver_sweep_resume_and_report(tmp_path):
    """Full driver pass with pre-seeded logs: every cell resume-skips, so
    the sweep exercises scrape + aggregation without a card or a rank."""
    logdir = tmp_path / "logs"
    logdir.mkdir()
    (logdir / "mnistnet-bs4-dear.log").write_text(
        "Total img/sec on 8 GPU(s): 111.0 +-1.0\n"
        'TELEMETRY {"enabled": true, "counters": {"dear.steps": 7}}\n')
    (logdir / "mnistnet-bs4-allreduce.log").write_text(
        "Total img/sec on 8 GPU(s): 99.0 +-1.0\n")
    report = driver.main([
        "--logdir", str(logdir), "--tasks", "mnistnet:4",
        "--methods", "dear,allreduce",
    ])
    assert report["mnistnet"]["dear"]["all"] == [111.0, 1.0]
    data = json.load(open(logdir / "reports.json"))
    assert data["mnistnet"]["allreduce"]["all"] == [99.0, 1.0]
    assert data["telemetry"]["cells_skipped"] == 2
    assert data["telemetry"]["per_cell"] == {
        "mnistnet-bs4-dear": {"enabled": True,
                              "counters": {"dear.steps": 7}}}
    with pytest.raises(SystemExit, match="unknown method"):
        driver.main(["--logdir", str(logdir), "--methods", "bogus"])


def test_driver_runs_a_two_rank_gloo_cell(tmp_path):
    """One real cell of two spawned ranks (``--emulate --nworkers 2``:
    gloo, ``--device cpu``) with ``DEAR_TELEMETRY`` on: its result and
    telemetry land in reports.json; a second pass resume-skips it."""
    args = ["--logdir", str(tmp_path), "--tasks", "mnistnet:4",
            "--methods", "dear", "--emulate", "--nworkers", "2",
            "--warmup", "1", "--batches", "2", "--iters", "1",
            "--timeout", "240"]
    env = dict(_env(), DEAR_TELEMETRY="1")
    proc = subprocess.run(
        [sys.executable, "-m", "dear_pytorch_tpu_torch.benchmarks.driver"]
        + args, cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    logs = "".join(open(tmp_path / f).read() for f in os.listdir(tmp_path)
                   if f.endswith(".log"))
    assert proc.returncode == 0, proc.stdout + proc.stderr + logs
    rep = json.load(open(tmp_path / "reports.json"))
    cell = rep["mnistnet"]["dear"]["2"]
    assert cell is not None and cell[0] > 0, logs
    snap = rep["telemetry"]["per_cell"]["mnistnet-bs4-dear-n2"]
    assert snap["counters"]["dear.steps"] == 3
    assert "Total img/sec on 2 CPU(s)" in open(
        tmp_path / "mnistnet-bs4-dear-n2.log").read()
    assert os.path.exists(tmp_path / "mnistnet-bs4-dear-n2.rank1.log")
    again = driver.main(args)
    assert again["mnistnet"]["dear"]["2"] == cell
    assert again["telemetry"]["cells_skipped"] == 1


# ---------------------------------------------------------------------------
# scaling and collectives
# ---------------------------------------------------------------------------


def test_scaling_worlds_one_and_two_in_two_gloo_ranks(tmp_path):
    """One launched world of two gloo ranks; world 1 trains on
    ``new_group([0])`` while rank 1 waits, world 2 on both: two ``Total``
    lines and the summary; the JSON's efficiencies relative to world 1."""
    out = str(tmp_path / "scaling.json")
    cmd = [sys.executable, "-m", "dear_pytorch_tpu_torch.benchmarks.scaling",
           "--device", "cpu", "--model", "mnistnet", "--batch-size", "4",
           "--worlds", "1,2", "--num-warmup-batches", "1",
           "--num-batches-per-iter", "2", "--num-iters", "1",
           "--json", out]
    logs = [str(tmp_path / "rank0.log"), str(tmp_path / "rank1.log")]
    codes = driver.run_cell(cmd, 2, logs[0], timeout=240)
    text = open(logs[0]).read()
    assert codes == [0, 0], text + open(str(tmp_path / "rank0.rank1.log")
                                        ).read()
    assert "Total img/sec on 1 CPU(s)" in text
    assert "Total img/sec on 2 CPU(s)" in text
    assert "Scaling efficiency (1->2 devices)" in text
    doc = json.load(open(out))
    assert set(doc["per_device_img_sec"]) == {"1", "2"}
    assert doc["efficiency"]["1"] == 1.0


def test_scaling_refuses_worlds_out_of_range():
    from dear_pytorch_tpu_torch.benchmarks import scaling

    assert scaling._parse_worlds(None, 4) == [1, 2, 4]
    assert scaling._parse_worlds("2,1,2", 2) == [1, 2]
    with pytest.raises(SystemExit, match="out of range"):
        scaling._parse_worlds("1,3", 2)
    with pytest.raises(SystemExit, match="out of range"):
        scaling._parse_worlds("0", 2)


def test_collectives_sweep_on_a_one_rank_gloo_group(tmp_path):
    from dear_pytorch_tpu_torch.benchmarks import collectives as BC

    out = BC.main(["--device", "cpu", "--sizes-log2", "10:15:2",
                   "--repeats", "2", "--warmup", "1",
                   "--json", str(tmp_path / "c.json")])
    assert out["world"] == 1 and out["backend"] == "gloo"
    assert set(out["collectives"]) == set(BC.COLLECTIVES)
    for c in out["collectives"].values():
        assert [r["bytes"] for r in c["rows"]] == [4096, 16384, 65536]
        assert all(r["time_s"] > 0 and r["busbw_gbs"] == r["bw_gbs"]
                   for r in c["rows"])
    assert json.load(open(tmp_path / "c.json")) == json.loads(
        json.dumps(out))
    assert BC._bus_factor("all_reduce", 4) == 1.5
    assert BC._bus_factor("all_gather", 4) == 0.75
    with pytest.raises(SystemExit, match="want lo:hi:step"):
        BC.main(["--sizes-log2", "10:x"])
    with pytest.raises(SystemExit, match="unknown collective"):
        BC.main(["--collectives", "bogus", "--device", "cpu"])
