"""The port's observability (dear_pytorch_tpu_torch.observability) and
profiling utilities (dear_pytorch_tpu_torch.utils), on the CPU.

  - `plan_comm_accounting`, `predict_leg_times` and `CostModel` equal the
    JAX package's on the same plan (the MLP of tests/test_dear_numerics.py,
    whose module order is JAX's sorted order), for every mode, wire dtype
    and compressor;
  - the tracer: the JAX package's names and event model, `snapshot`, the
    Chrome-trace and JSONL exporters round-tripping, the disabled default
    and the ``DEAR_TELEMETRY`` grammar; the train step's counters
    (``dear.steps``, ``dear.<leg>_bytes``, ``kernel.*`` in dear-fused)
    equal its own;
  - `LinkFit` / `Calibration` JSON round trips, and the profilers' output
    shapes (`StepTimer`, `CommunicationProfiler`, `fit_interconnect`,
    `measure_layerwise_backward`, `measure_step_time`).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.observability import costmodel as jcm
from dear_pytorch_tpu.observability import counters as jctr
from dear_pytorch_tpu.observability import overlap as jov
from dear_pytorch_tpu.ops import fusion as JF
from dear_pytorch_tpu.tuning import planspace as jps
from dear_pytorch_tpu_torch.observability import costmodel as tcm
from dear_pytorch_tpu_torch.observability import counters as tctr
from dear_pytorch_tpu_torch.observability import overlap as tov
from dear_pytorch_tpu_torch.observability import tracer as T
from dear_pytorch_tpu_torch.ops import fusion as F
from dear_pytorch_tpu_torch.parallel import dear as tdear
from dear_pytorch_tpu_torch.tuning import planspace as tps
from dear_pytorch_tpu_torch.utils import profiling as P

from tests.test_torch_multi_step import (
    TorchMLP,
    mlp_loss,
    mlp_problem,
    torch_batch,
)


@pytest.fixture(scope="module")
def group():
    from dear_pytorch_tpu_torch.comm import backend

    return backend.init("cpu")


@pytest.fixture
def live_tracer():
    old = T.get_tracer()
    live = T.Tracer([T.MemoryExporter()])
    T.set_tracer(live)
    yield live
    T.set_tracer(old)


def _plans(world, threshold_mb):
    params, _ = mlp_problem()
    return (F.make_plan(TorchMLP(params), world, threshold_mb=threshold_mb),
            JF.make_plan(params, world, threshold_mb=threshold_mb))


def _rows(acct):
    return [(r.bucket, r.leg, r.tensors, r.elements, r.padded_elements,
             r.payload_bytes, r.wire_bytes, r.messages) for r in acct.rows]


@pytest.mark.parametrize("world", [1, 3, 8])
def test_accounting_and_leg_times_match_jax(world):
    ours_plan, jax_plan = _plans(world, 0.0008)
    assert [b.padded_size for b in ours_plan.buckets] == \
        [b.padded_size for b in jax_plan.buckets]
    for mode in tctr.MODE_LEGS:
        for kw in (dict(), dict(comm_itemsize=2),
                   dict(comm_itemsize=2, gather_itemsize=2),
                   dict(compressor="eftopk", density=0.05),
                   dict(compressor="efsignum"), dict(compressor="qint8")):
            ours = tctr.plan_comm_accounting(ours_plan, mode=mode, **kw)
            theirs = jctr.plan_comm_accounting(jax_plan, mode=mode, **kw)
            assert _rows(ours) == _rows(theirs), (mode, kw)
            assert ours.payload_bytes_per_step == \
                theirs.payload_bytes_per_step
            for leg in {r.leg for r in ours.rows}:
                assert ours.leg_bytes_per_step(leg) == \
                    theirs.leg_bytes_per_step(leg)
            assert tov.predict_leg_times(ours, 2e-5, 3e-10) == \
                jov.predict_leg_times(theirs, 2e-5, 3e-10)
            assert ours.totals(steps=7, runtime_counters={}) == \
                theirs.totals(steps=7, runtime_counters={})


def test_cost_model_matches_jax():
    params, _ = mlp_problem()
    model = TorchMLP(params)
    ours = tcm.CostModel(lambda thr: F.make_plan(model, 8, threshold_mb=thr),
                         alpha=1e-6, beta=1e-8)
    theirs = jcm.CostModel(
        lambda thr: JF.make_plan(params, 8, threshold_mb=thr),
        alpha=1e-6, beta=1e-8)
    cfgs = [dict(threshold_mb=0.001), dict(threshold_mb=0.001,
                                           comm_dtype="bf16",
                                           gather_dtype="bf16"),
            dict(threshold_mb=0.02, compressor="eftopk", density=0.01),
            dict(threshold_mb=0.001, mode="dear-fused", remat="full")]
    assert ours.floor(tps.PlanConfig()) is None
    for cfg in cfgs:
        assert ours.comm(tps.PlanConfig(**cfg)) == \
            theirs.comm(jps.PlanConfig(**cfg))
    for cfg, t in zip(cfgs[:2], (0.010, 0.004)):
        ours.observe(tps.PlanConfig(**cfg), t)
        theirs.observe(jps.PlanConfig(**cfg), t)
    assert ours.compute_est == theirs.compute_est
    for cfg in cfgs:
        assert ours.floor(tps.PlanConfig(**cfg)) == \
            theirs.floor(jps.PlanConfig(**cfg))
    assert ours.floor(tps.PlanConfig(**cfgs[3])) >= \
        ours.floor(tps.PlanConfig(**dict(cfgs[3], remat=None)))


def test_calibration_round_trips(tmp_path):
    fit = tcm.LinkFit(alpha=1e-5, beta=2e-10, source="measured", nsamples=4)
    cal = tcm.Calibration(ici=fit)
    path = str(tmp_path / "cal.json")
    cal.dump(path)
    assert tcm.load_calibration(path) == cal
    assert tcm.load_calibration({"alpha": 1e-5, "beta": 2e-10}).ici.alpha \
        == 1e-5
    assert tcm.load_calibration(json.dumps({"calibration": cal.to_dict()})) \
        == cal
    assert cal.to_dict() == jcm.Calibration(
        ici=jcm.LinkFit(1e-5, 2e-10, "measured", 4)).to_dict()
    sizes, times = [4096.0, 65536.0, 1048576.0], [1e-5, 3e-5, 4e-4]
    for w in (1, 4):
        assert tcm.fit_allgather_sweep(w, sizes, times) == \
            jcm.fit_allgather_sweep(w, sizes, times)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


def test_tracer_default_is_null_and_env_grammar(tmp_path):
    assert T.NullTracer.enabled is False
    null = T.NullTracer()
    with null.span("x"):
        null.count("y")
    assert null.counters() == {} and T._NULL_SPAN is null.span("z")
    for spec in ("", "0", "false", "no"):
        T._tracer = None
        try:
            assert T.configure_from_env(spec) is T._NULL_TRACER
        finally:
            T._tracer = None
    chrome = str(tmp_path / "t.json")
    try:
        tr = T.configure_from_env(f"chrome:{chrome},jsonl:"
                                  f"{tmp_path / 't.jsonl'}")
        assert tr.enabled and len(tr.exporters()) == 3
        tr.close()
        T._tracer = None
        with pytest.raises(ValueError, match="bad sink spec"):
            T.configure_from_env("csv:/x")
        T._tracer = None
        with pytest.raises(NotImplementedError, match="item 12"):
            T.configure_from_env("prom:/x.prom")
        with pytest.raises(NotImplementedError, match="item 12"):
            T.configure(stream=str(tmp_path / "h.jsonl"))
    finally:
        T._tracer = None
    assert T.process_index() == 0


def test_tracer_spans_events_counters_and_exporters(tmp_path):
    chrome, jsonl = str(tmp_path / "t.json"), str(tmp_path / "t.jsonl")
    old = T.get_tracer()
    tr = T.configure(chrome=chrome, jsonl=jsonl)
    try:
        with tr.span("outer", k=1):
            with tr.span("inner"):
                tr.event("tick", n=2, bad=float("nan"))
            tr.count("steps")
            tr.count("bytes", 1.5e6)
            assert [s["name"] for s in tr.live_spans()] == ["outer"]
        snap = T.snapshot()
        assert snap["enabled"] and snap["counters"] == {"steps": 1,
                                                        "bytes": 1.5e6}
        assert snap["spans"]["outer"]["count"] == 1 and snap["events"] == 1
        mem = tr.exporters()[0]
        inner, outer = mem.spans
        assert (inner.name, inner.depth, outer.depth) == ("inner", 1, 0)
        assert outer.attrs == {"k": 1} and outer.dur_us >= inner.dur_us
    finally:
        T.disable()
        T.set_tracer(old)
    trace = json.load(open(chrome))["traceEvents"]
    assert [(e["name"], e["ph"]) for e in trace] == [
        ("tick", "i"), ("inner", "X"), ("outer", "X")]
    recs = [json.loads(line) for line in open(jsonl)]
    assert [(r["kind"], r["name"]) for r in recs] == [
        ("event", "tick"), ("span", "inner"), ("span", "outer")]
    assert recs[0]["bad"] == "nan" and recs[2]["k"] == 1


@pytest.mark.parametrize("mode", ["dear", "dear-fused",
                                  "dear-fused-launching"])
def test_train_step_counters_match_its_own(mode, group, live_tracer,
                                           monkeypatch):
    """``kernel.*`` are the ring wrappers' own launch counts over the step:
    none at world 1 (the short-cut runs no ring) nor on the CPU; with
    wrappers that count a launch per call, as the card's do, one of each
    per bucket per step (init's gathers are not a step's)."""
    launching = mode == "dear-fused-launching"
    mode = mode.replace("-launching", "")
    if launching:
        CM = tdear.CM

        def counting(fn, name):
            def wrapper(*args, **kw):
                setattr(CM, name, getattr(CM, name) + 1)
                return fn(*args, **kw)
            return wrapper

        monkeypatch.setattr(CM, "fused_reduce_scatter_update",
                            counting(CM.fused_reduce_scatter_update,
                                     "ring_rs_launches"))
        monkeypatch.setattr(CM, "ring_all_gather",
                            counting(CM.ring_all_gather, "ring_ag_launches"))
    params, batches = mlp_problem()
    ts = tdear.build_train_step(mlp_loss, TorchMLP(params), group=group,
                                device="cpu", mode=mode, threshold_mb=0.0008)
    state = ts.init()
    for _ in range(3):
        state, _ = ts.step(state, torch_batch(batches[0]))
    c = live_tracer.counters()
    nb = ts.plan.num_buckets
    assert c["dear.steps"] == 3 and c["dear.plan_builds"] == 1
    acct = tctr.plan_comm_accounting(ts.plan, mode=mode)
    assert c["dear.reduce_scatter_bytes"] == \
        3 * acct.leg_bytes_per_step("reduce_scatter")
    assert c["dear.all_gather_bytes"] == \
        3 * acct.leg_bytes_per_step("all_gather")
    if mode == "dear-fused":
        rings = 3 * nb if launching else 0
        assert ts.rs_launches == ts.ag_launches - nb == 3 * nb   # - init
        assert c["kernel.fused_rs_launches"] == rings
        assert c["kernel.ring_ag_launches"] == rings
    else:
        assert "kernel.fused_rs_launches" not in c
    events = [e.name for e in live_tracer._exporters[0].events]
    assert events == ["dear.plan_built"]
    ts.close()


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_profilers_on_the_cpu(group):
    timer = P.StepTimer()
    for _ in range(3):
        timer.tick()
    with timer:
        pass
    assert len(timer.times) == 3 and timer.mean >= 0 and "steps" in \
        timer.summary()
    for coll in ("all_reduce", "reduce_scatter", "all_gather",
                 "all_reduce_rsag"):
        prof = P.CommunicationProfiler(group, collective=coll, device="cpu")
        sizes, times = prof.benchmark(sizes=[1024, 4096], repeats=2,
                                      warmup=1)
        assert sizes == [4096, 16384] and all(t > 0 for t in times)
    alpha, beta = prof.fit(sizes=[1024, 4096, 16384], repeats=2, warmup=1)
    assert alpha >= 0 and beta >= 0
    assert all(x >= 0 for x in tov.fit_interconnect(group, device="cpu",
                                                    repeats=2, warmup=1))
    with pytest.raises(KeyError):
        P.CommunicationProfiler(group, collective="scatter", device="cpu")
    params, batches = mlp_problem()
    model = TorchMLP(params)
    times = P.measure_layerwise_backward(mlp_loss, model,
                                         torch_batch(batches[0]),
                                         repeats=2, warmup=1)
    assert len(times) == len(F.layer_sizes(model)) == 3
    assert all(t > 0 for t in times)
    assert all(p.grad is None for p in model.parameters())
    ts = tdear.build_train_step(mlp_loss, model, group=group, device="cpu")
    secs, state = tov.measure_step_time(ts, ts.init(),
                                        torch_batch(batches[0]), steps=2,
                                        warmup=1)
    assert secs > 0 and state.step == 3
    ts.close()
