"""The port's input pipeline (`dear_pytorch_tpu_torch.runtime`), its
retry (`resilience.retry`), its metrics logger (`utils.metrics`) and the
runner's pinned staging, against the JAX package's modules on the CPU.

- `NumpyPipeline` batches are byte-identical to JAX's for the same seed,
  epoch, shard and ``num_shards``, for all four specs, also after
  ``reshard`` and a ``state_dict`` round trip.
- The native `Pipeline` at ``nthreads=1`` (one producer, one RNG, slots
  in FIFO order: csrc/dear_runtime.cpp:60-80) is byte-identical to JAX's
  native `Pipeline` at ``nthreads=1``; JAX's own stream repeats there
  (checked first). Both libraries are built from the same source, the
  port's from its byte-identical copy into ``build/runtime/``.
- Held copies survive slot recycling, in the pipeline and in the
  runner's `PinnedStager`.
- ``retry_call``'s delays and its `RetryError` equal JAX's for the same
  label and policy; ``MetricsLogger`` writes JAX's lines; ``read_metrics``
  skips a torn tail.
"""

import hashlib
import json
import pathlib
import random

import numpy as np
import pytest
import torch

from dear_pytorch_tpu.resilience import retry as jretry
from dear_pytorch_tpu.runtime import pipeline as JP
from dear_pytorch_tpu.utils import metrics as jmetrics
from dear_pytorch_tpu_torch.benchmarks import runner
from dear_pytorch_tpu_torch.resilience import retry as tretry
from dear_pytorch_tpu_torch.runtime import build as TB
from dear_pytorch_tpu_torch.runtime import pipeline as TP
from dear_pytorch_tpu_torch.utils import metrics as tmetrics

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: the four specs at small sizes, built by each package's own function
SPECS = {
    "image": lambda P: P.image_spec(3, image_size=8, classes=17),
    "mnist": lambda P: P.mnist_spec(4),
    "bert": lambda P: P.bert_spec(2, 16, vocab=101, masked_fraction=0.2),
    "gpt": lambda P: P.gpt_spec(2, 12, vocab=97),
}


def _same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_the_producer_source_is_a_byte_identical_copy():
    root = (ROOT / "csrc" / "dear_runtime.cpp").read_bytes()
    assert TB.SOURCE == ROOT / "dear_pytorch_tpu_torch" / "csrc" / \
        "dear_runtime.cpp"
    assert TB.SOURCE.read_bytes() == root


def test_native_library_builds_from_the_ports_source():
    """g++ is here: ``load`` compiles the port's copy into build/runtime
    under its sha256 tag (JAX build.py:63-64's command)."""
    assert TP.native_available(), TB.load_error()
    tag = hashlib.sha256(TB.SOURCE.read_bytes()).hexdigest()[:12]
    so = TB.library_path()
    assert so == ROOT / "build" / "runtime" / f"dear_runtime_{tag}.so"
    assert so.exists()
    assert TB.CXX_CMD == ("g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                          "-pthread")
    assert TP.now_ns() > 0


@pytest.mark.parametrize("name", sorted(SPECS))
def test_numpy_pipeline_is_jaxs_byte_for_byte(name):
    """Same seed and shard: the same batches; then after a reshard to
    (shard 1 of 3, epoch 2), and from a state dict taken mid-stream."""
    tp = TP.NumpyPipeline(SPECS[name](TP), seed=5, shard=1, num_shards=2)
    jp = JP.NumpyPipeline(SPECS[name](JP), seed=5, shard=1, num_shards=2)
    for _ in range(3):
        _same(tp.next(), jp.next())
    tp.reshard(1, 3, epoch=2)
    jp.reshard(1, 3, epoch=2)
    _same(tp.next(), jp.next())
    state = tp.state_dict()
    assert json.loads(json.dumps(state)) == state      # sidecar-safe
    assert state == jp.state_dict()
    ahead = [tp.next() for _ in range(2)]
    resumed = TP.NumpyPipeline(SPECS[name](TP), seed=0)
    resumed.load_state_dict(state)
    jp2 = JP.NumpyPipeline(SPECS[name](JP), seed=0)
    jp2.load_state_dict(state)
    for want in ahead:
        got = resumed.next()
        _same(got, want)
        _same(got, jp2.next())
    assert resumed.produced == jp2.produced == state["produced"] + 2


def test_numpy_pipeline_default_stream_and_spec_guard():
    _same(TP.NumpyPipeline(SPECS["image"](TP), seed=9).next(),
          JP.NumpyPipeline(SPECS["image"](JP), seed=9).next())
    p = TP.NumpyPipeline(SPECS["gpt"](TP), seed=1)
    with pytest.raises(ValueError, match="different batch spec"):
        p.load_state_dict(TP.NumpyPipeline(SPECS["mnist"](TP)).state_dict())
    for args in ((0, 0, 0, 1), (3, 0, 0, 1), (3, 2, 1, 4, 7),
                 (11, 1, 2, 0, 5)):
        assert TP._fold_seed(*args) == JP._fold_seed(*args)


def test_native_pipeline_at_one_thread_is_jaxs():
    """JAX's native stream repeats at one producer thread, and the port's
    is the same stream, byte for byte (both specs' kinds: normal floats,
    uniform ints, constants, masked ints)."""
    assert JP.native_available() and TP.native_available()
    for name in ("image", "bert"):
        kw = dict(nslots=2, nthreads=1, seed=4, shard=1, num_shards=2)
        j1 = JP.Pipeline(SPECS[name](JP), **kw)
        j2 = JP.Pipeline(SPECS[name](JP), **kw)
        t = TP.Pipeline(SPECS[name](TP), **kw)
        assert type(t) is TP.Pipeline and type(j1) is JP.Pipeline
        for _ in range(5):
            want = j1.next()
            _same(j2.next(), want)
            _same(t.next(), want)
        t.reshard(0, 2, epoch=1)
        j1.reshard(0, 2, epoch=1)
        _same(t.next(), j1.next())
        assert t.state_dict() == j1.state_dict()
        for p in (j1, j2, t):
            p.close()


def test_native_statistics_and_counters():
    """Two producer threads: the JAX tests' statistics, and the
    ``pipeline.*`` counters and span on the port's tracer."""
    from dear_pytorch_tpu_torch.observability import tracer as T

    live = T.Tracer([T.MemoryExporter()])
    before = T._tracer
    T.set_tracer(live)
    try:
        with TP.Pipeline(TP.image_spec(8, image_size=64, classes=100),
                         seed=3) as p:
            batch = p.next()
            p.next()
            assert p.produced == 2
    finally:
        T.set_tracer(before)
    x = batch["image"]
    assert abs(float(x.mean())) < 5.0 / np.sqrt(x.size)
    assert abs(float(x.std()) - 1.0) < 0.02
    assert 0 <= batch["label"].min() and batch["label"].max() < 100
    assert live.counters()["pipeline.batches"] == 2
    assert [s.name for s in live._exporters[0].spans] == ["pipeline.next"] * 2


def test_pipeline_falls_back_to_numpy_without_the_library(monkeypatch):
    """JAX's documented fallback (pipeline.py:245-251): a Pipeline asked
    for with no library is a NumpyPipeline; ``--pipeline native`` refuses
    instead (runner.make_batch_source, JAX runner.py:469-474)."""
    monkeypatch.setattr(TB, "load", lambda: None)
    assert type(TP.Pipeline(SPECS["gpt"](TP), seed=2)) is TP.NumpyPipeline

    class Args:
        pipeline = "native"

    with pytest.raises(SystemExit, match="--pipeline native"):
        runner.make_batch_source(Args(), SPECS["gpt"](TP),
                                 {"input_ids": torch.zeros(2, 12)},
                                 device="cpu")


def test_slot_recycling_does_not_corrupt_copies():
    """JAX's test: a held batch survives the producers reusing its slot."""
    with TP.Pipeline(TP.mnist_spec(2), nslots=2, nthreads=2, seed=4) as p:
        first = p.next()
        snapshot = first["image"].copy()
        for _ in range(8):  # force slot reuse
            p.next()
        np.testing.assert_array_equal(first["image"], snapshot)


def test_stager_slots_do_not_corrupt_held_batches():
    """The runner's staging: each field cast to the target dtype on the
    host (fp32 -> bf16, int32 -> int64), this rank's rows only, and a held
    staged batch unchanged after the stager has refilled every slot."""
    stager = runner.PinnedStager("cpu", slots=2)
    dtypes = {"image": torch.bfloat16, "label": torch.int64}
    pl = TP.NumpyPipeline(TP.image_spec(4, image_size=8), seed=1)
    hosts = [pl.next() for _ in range(5)]
    held = runner.stage_global(hosts[0], stager, dtypes, rank=1, world=2)
    keep = {k: v.clone() for k, v in held.items()}
    for h in hosts[1:]:
        runner.stage_global(h, stager, dtypes, rank=1, world=2)
    for k, v in held.items():
        assert torch.equal(v, keep[k]) and v.dtype == dtypes[k]
    assert held["image"].shape == (2, 8, 8, 3)
    assert torch.equal(held["image"], torch.from_numpy(
        hosts[0]["image"][2:]).to(torch.bfloat16))
    assert torch.equal(held["label"],
                       torch.from_numpy(hosts[0]["label"][2:]).long())


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------


def _failing(n_failures, exc=OSError):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= n_failures:
            raise exc(f"transient {calls['n']}")
        return "ok"

    return fn, calls


@pytest.mark.parametrize("policy", [
    dict(attempts=5),
    dict(attempts=6, base_delay_s=0.01, max_delay_s=0.07),
    dict(attempts=4, jitter=False),
    dict(attempts=4, backoff=3.0, base_delay_s=0.02),
])
def test_retry_delays_and_giveup_equal_jaxs(policy):
    """The same label and policy: the same sleeps, the same result, and
    on exhaustion the same `RetryError` message and cause."""
    runs = {}
    for name, mod in (("jax", jretry), ("port", tretry)):
        sleeps = []
        fn, calls = _failing(2)
        out = mod.retry_call(fn, name="io.sidecar", sleep=sleeps.append,
                             **policy)
        fn2, _ = _failing(99)
        sleeps2 = []
        with pytest.raises(mod.RetryError) as err:
            mod.retry_call(fn2, name="io.sidecar", sleep=sleeps2.append,
                           **policy)
        runs[name] = (out, calls["n"], sleeps, sleeps2, str(err.value),
                      type(err.value.__cause__), str(err.value.__cause__))
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == "ok" and len(runs["port"][2]) == 2


def test_retry_jitter_stream_and_passthrough():
    for label in ("a", "pipeline.next", "ckpt:7"):
        assert (tretry._jitter_rng(label).random()
                == jretry._jitter_rng(label).random())
    assert isinstance(tretry._jitter_rng("x"), random.Random)
    fn, calls = _failing(1, exc=ValueError)       # not retried
    with pytest.raises(ValueError):
        tretry.retry_call(fn, sleep=lambda s: None)
    assert calls["n"] == 1

    @tretry.retryable(attempts=3, base_delay_s=0.0)
    def flaky(box=[0]):
        box[0] += 1
        if box[0] < 3:
            raise TimeoutError("slow")
        return box[0]

    assert flaky() == 3


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_metrics_logger_lines_equal_jaxs(tmp_path, monkeypatch):
    """Line for line, with the clock pinned: scalars, numpy and torch
    values, lists, non-finite values (strict JSON: their repr), a step."""
    monkeypatch.setattr(jmetrics.time, "time", lambda: 100.0)
    monkeypatch.setattr(tmetrics.time, "time", lambda: 100.0)
    recs = [dict(step=3, loss=0.25, ok=True, name="x"),
            dict(val=np.float32(1.5), arr=np.arange(3), nan=float("nan"),
                 inf=float("-inf"), none=None),
            dict(summary=True, world=2, per_device_mean=1234.5)]
    paths = {}
    for name, mod in (("jax", jmetrics), ("port", tmetrics)):
        path = str(tmp_path / f"{name}.jsonl")
        with mod.MetricsLogger(path) as ml:
            for r in recs:
                ml.log(**r)
        paths[name] = path
    assert open(paths["port"]).read() == open(paths["jax"]).read()
    with tmetrics.MetricsLogger(str(tmp_path / "t.jsonl")) as ml:
        ml.log(loss=torch.tensor(0.5), vec=torch.tensor([1.0, 2.0]))
    assert tmetrics.read_metrics(str(tmp_path / "t.jsonl"))[0] == {
        "time": 0.0, "loss": 0.5, "vec": [1.0, 2.0]}
    assert tmetrics.read_metrics(paths["port"]) == \
        jmetrics.read_metrics(paths["jax"])


def test_read_metrics_skips_a_torn_tail(tmp_path):
    path = tmp_path / "m.jsonl"
    path.write_text('{"a": 1}\n{"b": 2}\n{"c": ')
    assert tmetrics.read_metrics(str(path)) == [{"a": 1}, {"b": 2}]
    path.write_text('{"a": 1}\n{"b": \n{"c": 3}\n')
    with pytest.warns(UserWarning, match=":2: skipping"):
        assert tmetrics.read_metrics(str(path)) == [{"a": 1}, {"c": 3}]
