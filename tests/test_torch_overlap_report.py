"""The port's overlap audit (`observability.overlap.audit_train_step`,
`measure_timeline`) and its renderer and entry point
(`observability.report`) against the JAX package's.

- ``audit_train_step``'s numbers equal JAX's at 1e-12 relative for the
  same accounting rows, α, β, measured time and compute time: both
  packages plan the same buckets here (one layer per bucket, leaf names
  that sort in module order; ROADMAP "Leaf order").
- The render functions give JAX's text for the same report (the timeline
  line in place of JAX's HLO line) and for the telemetry and fleet dicts.
- ``report.main`` at two spawned gloo ranks writes JAX's JSON shape, with
  the measured timeline per mode; its argument refusals are JAX's
  (tests/test_report_cli.py).
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.observability import overlap as JOV
from dear_pytorch_tpu.observability import report as JR
from dear_pytorch_tpu.ops import fusion as JF
from dear_pytorch_tpu_torch.observability import overlap as TOV
from dear_pytorch_tpu_torch.observability import report as TR
from dear_pytorch_tpu_torch.ops import fusion as TF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12
#: (layer, leaf, size): three layers of a bias and a weight
LEAVES = [("l00", "b", 16), ("l00", "w", 256), ("l01", "b", 24),
          ("l01", "w", 384), ("l02", "b", 8), ("l02", "w", 40)]


def _plans(world):
    jparams: dict = {}
    tparams: dict = {}
    for layer, leaf, n in LEAVES:
        jparams.setdefault(layer, {})[leaf] = jnp.zeros((n,))
        tparams[f"{layer}.{leaf}"] = torch.zeros(n)
    return (JF.plan_by_nearby_layers(jparams, world=world, k=1),
            TF.plan_by_nearby_layers(tparams, world=world, k=1))


class _JaxStub:
    """What JAX's audit reads of a train step when nothing lowers."""

    def __init__(self, plan):
        self.plan = plan

    def lower(self, state, batch):
        raise RuntimeError("no backend")


def _close(a, b, path="") -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= RTOL * max(abs(a), abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("mode", ["dear", "allreduce", "rsag", "rb",
                                  "fsdp"])
@pytest.mark.parametrize("world", [2, 4])
def test_audit_equals_jaxs(mode, world):
    """Every field of the report but JAX's ``hlo`` and the port's
    ``timeline``, over measured times below the ideal, between ideal and
    serial, above serial, and with nothing measured."""
    jplan, tplan = _plans(world)
    assert [b.size for b in jplan.buckets] == [b.size for b in tplan.buckets]
    rng = np.random.default_rng(world)
    for alpha, beta in ((1e-5, 1e-9), (3e-4, 2.5e-10), (0.0, 0.0)):
        for measured, compute in ((None, 1e-3), (5e-4, 1e-3),
                                  (1.3e-3, 1e-3), (9e-3, 1e-3),
                                  (float(rng.uniform(1e-4, 1e-2)),
                                   float(rng.uniform(1e-4, 1e-2))),
                                  (2e-3, None)):
            kw = dict(alpha=alpha, beta=beta, mode=mode,
                      measured_step_s=measured, compute_time_s=compute,
                      gather_itemsize=2 if mode == "dear" else None)
            j = JOV.audit_train_step(_JaxStub(jplan), None, None,
                                     include_hlo=False, **kw).to_dict()
            t = TOV.audit_train_step(SimpleNamespace(plan=tplan),
                                     **kw).to_dict()
            assert j.pop("hlo") is None and t.pop("timeline") is None
            _close(t, j)


def test_audit_takes_counted_flops_over_a_peak():
    _, tplan = _plans(2)
    rep = TOV.audit_train_step(SimpleNamespace(plan=tplan), alpha=1e-5,
                               beta=1e-9, measured_step_s=2e-3,
                               flops_per_step=4e9, peak_flops=989e12)
    assert rep.compute_time_s == 4e9 / 989e12
    assert rep.flops_per_step == 4e9
    none = TOV.audit_train_step(SimpleNamespace(plan=tplan), alpha=1e-5,
                                beta=1e-9, measured_step_s=2e-3,
                                flops_per_step=4e9)
    assert none.compute_time_s is None and none.overlap_efficiency is None


def test_renderers_equal_jaxs():
    jplan, tplan = _plans(4)
    kw = dict(alpha=2e-5, beta=1e-9, mode="dear", measured_step_s=1.2e-3,
              compute_time_s=1e-3)
    j = JOV.audit_train_step(_JaxStub(jplan), None, None, include_hlo=False,
                             **kw)
    t = TOV.audit_train_step(SimpleNamespace(plan=tplan), **kw)
    assert TR.render_text(t) == JR.render_text(j)
    assert TR.render_comparison({"dear": t}) == JR.render_comparison(
        {"dear": j})
    snap = {"enabled": True, "counters": {"dear.steps": 3, "x": 0.5},
            "spans": {"dear.step": {"count": 3, "total_us": 1234.5}}}
    assert TR.render_telemetry(snap) == JR.render_telemetry(snap)
    attr = {"steps": {"summary": {"n_steps": 2, "step_p50_s": 0.1,
                                  "step_p99_s": 0.2, "exposed_frac": 0.25,
                                  "stragglers": {"1": 2}},
                      "steps": [{"mem_epoch": 0, "step": 3, "step_s": 0.1,
                                 "straggler": 1, "exposed_comm_s": 0.01,
                                 "hidden_comm_s": 0.02,
                                 "ranks": {"1": {"longest_leg": {
                                     "name": "rs", "dur_s": 0.03}}}}]},
            "requests": {"summary": {"n_requests": 1,
                                     "service_p50_s": 0.5},
                         "requests": [{"request_id": "r1", "service_s": 0.5,
                                       "hops": [1, 2], "redispatches": 1}]}}
    assert TR.render_fleet_trace(attr) == JR.render_fleet_trace(attr)
    assert TR.render_fleet_trace({}) == JR.render_fleet_trace({})
    # the timeline's lines follow JAX's text
    tl = {"steps": 2, "source": "kernels on the card",
          "compute_s_per_step": 1e-3, "collective_s_per_step": 5e-4,
          "overlap_share": 0.5,
          "legs": {"reduce_scatter": {"count_per_step": 3,
                                      "span_s_per_step": 5e-4,
                                      "overlap_share": 0.5}},
          "buckets": [{"bucket": 0, "leg": "reduce_scatter",
                       "span_s": 2e-4, "overlap_share": None}]}
    text = TR.render_text(TOV.audit_train_step(
        SimpleNamespace(plan=tplan), timeline=tl, **kw))
    assert [line for line in text.splitlines()
            if not line.startswith("  timeline")
            and " overlapped " not in line] == \
        JR.render_text(j).splitlines()
    assert "timeline (2 traced steps, kernels on the card)" in text
    assert "overlapped 50.0%" in text and "overlapped n/a" in text


def _ev(name, a, b, thread=1, cuda=False):
    return SimpleNamespace(
        name=name, thread=thread,
        device_type=(torch.autograd.DeviceType.CUDA if cuda
                     else torch.autograd.DeviceType.CPU),
        time_range=SimpleNamespace(start=a, end=b))


def test_timeline_from_events_on_the_card():
    """Two steps, two buckets: reduce-scatters issued descending, gathers
    ascending, one extra all-reduce (the loss's mean) per step; compute
    kernels overlap parts of them."""
    ev = []
    for s, t0 in ((0, 0.0), (1, 1000.0)):
        ev += [_ev("void gemm_kernel", t0, t0 + 400, cuda=True),
               _ev("ncclDevKernel_ReduceScatter_Sum_f32", t0 + 300,
                   t0 + 500, cuda=True),                      # bucket 1
               _ev("ncclDevKernel_ReduceScatter_Sum_f32", t0 + 500,
                   t0 + 600, cuda=True),                      # bucket 0
               _ev("ncclDevKernel_AllGather_RING_LL", t0 + 600, t0 + 700,
                   cuda=True),                                # bucket 0
               _ev("void elementwise", t0 + 650, t0 + 700, cuda=True),
               _ev("ncclDevKernel_AllGather_RING_LL", t0 + 700, t0 + 800,
                   cuda=True),                                # bucket 1
               _ev("ncclDevKernel_AllReduce_Sum_f32", t0 + 800, t0 + 810,
                   cuda=True),
               _ev("Memcpy HtoD", t0 + 300, t0 + 900, cuda=True),
               _ev("aten::mm", t0, t0 + 10)]
    tl = TOV.timeline_from_events(ev, num_buckets=2, steps=2,
                                  on_device=True)
    assert tl["legs"]["reduce_scatter"]["count_per_step"] == 2
    assert tl["legs"]["all_reduce"]["count_per_step"] == 1
    by = {(b["bucket"], b["leg"]): b for b in tl["buckets"]}
    assert by[1, "reduce_scatter"]["overlap_share"] == pytest.approx(0.5)
    assert by[0, "reduce_scatter"]["overlap_share"] == 0.0
    assert by[0, "all_gather"]["overlap_share"] == pytest.approx(0.5)
    assert by[1, "all_gather"]["overlap_share"] == 0.0
    assert by[1, "reduce_scatter"]["span_s"] == pytest.approx(200e-6)
    assert tl["compute_s_per_step"] == pytest.approx(450e-6)
    assert not any(b["leg"] == "all_reduce" and b["bucket"] == 1
                   for b in tl["buckets"])


def test_timeline_labels_gloo_spans_by_the_issued_calls():
    """gloo runs a reduce-scatter as an all-reduce on its thread: the
    spans take the legs of the c10d calls the main thread issued."""
    ev = [_ev("aten::mm", 0, 100), _ev("aten::add", 100, 120),
          _ev("c10d::_reduce_scatter_base_", 50, 52),
          _ev("c10d::_allgather_base_", 130, 131),
          _ev("gloo:all_reduce", 55, 150, thread=7),
          _ev("gloo:all_gather", 150, 170, thread=7)]
    tl = TOV.timeline_from_events(ev, num_buckets=1, steps=1,
                                  on_device=False)
    assert set(tl["legs"]) == {"reduce_scatter", "all_gather"}
    assert tl["legs"]["reduce_scatter"]["overlap_share"] == \
        pytest.approx(65 / 95)
    assert tl["source"] == "host spans (gloo)"
    # ranks sharing a card: blocking host-staged calls, and a barrier
    # gloo runs as no span; each span takes the last call before it
    ev = [_ev("aten::mm", 0, 10), _ev("c10d::barrier", 0, 1),
          _ev("c10d::_reduce_scatter_base_", 20, 40),
          _ev("gloo:all_reduce", 21, 39, thread=7),
          _ev("c10d::_allgather_base_", 50, 60),
          _ev("gloo:all_gather", 51, 59, thread=7),
          _ev("void gemm", 30, 35, cuda=True)]
    tl = TOV.timeline_from_events(ev, num_buckets=1, steps=1,
                                  on_device=True)
    assert set(tl["legs"]) == {"reduce_scatter", "all_gather"}
    assert tl["legs"]["reduce_scatter"]["overlap_share"] == \
        pytest.approx(5 / 18)


def test_report_cli_rejects_bad_args(capsys):
    """tests/test_report_cli.py's refusals: argparse's exit code 2."""
    with pytest.raises(SystemExit) as e:
        TR.main(["--bogus-flag"])
    assert e.value.code == 2
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        TR.main(["--world", "not-a-number"])
    assert e.value.code == 2
    capsys.readouterr()
    with pytest.raises(SystemExit, match="not in"):
        TR.main(["--modes", "bogus", "--device", "cpu", "--world", "1"])


def test_report_renders_without_measurement():
    """render_text must not crash on a report with no measured step (the
    honest-absence path: exposure split absent, never guessed)."""
    plan = TF.plan_by_nearby_layers({"w": torch.zeros(64)}, world=4, k=1)
    rep = TOV.audit_train_step(SimpleNamespace(plan=plan), alpha=1e-3,
                               beta=1e-6, mode="dear")
    text = TR.render_text(rep)
    assert "n/a" in text and "overlap efficiency n/a" in text


def test_report_cli_json_shape_and_world_override(tmp_path):
    """tests/test_report_cli.py's run, at two spawned gloo ranks: the
    JSON's shape, the world, two legs a bucket, the telemetry's steps, and
    the measured timeline of each mode."""
    out_json = str(tmp_path / "overlap.json")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DEAR_", "JAX_", "XLA_"))}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "dear_pytorch_tpu_torch.observability.report",
         "--world", "2", "--layers", "1", "--width", "32", "--batch", "8",
         "--steps", "2", "--modes", "dear,allreduce", "--device", "cpu",
         "--json", out_json],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=220)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "overlap audit: mode=dear" in proc.stdout
    assert "== mode comparison ==" in proc.stdout
    assert "== telemetry (enabled=True) ==" in proc.stdout
    doc = json.load(open(out_json))
    assert set(doc) >= {"world", "alpha", "beta", "compute_time_s",
                        "modes", "telemetry"}
    assert doc["world"] == 2
    assert doc["alpha"] >= 0 and doc["beta"] >= 0
    rep = doc["modes"]["dear"]
    assert rep["mode"] == "dear" and rep["world"] == 2
    assert {"comm_time_s", "measured_step_s", "overlap_efficiency",
            "legs", "num_buckets", "timeline"} <= set(rep)
    assert len(rep["legs"]) == 2 * rep["num_buckets"]  # RS + AG per bucket
    for leg in rep["legs"]:
        assert leg["leg"] in ("reduce_scatter", "all_gather")
        assert leg["payload_bytes"] > 0
    tl = rep["timeline"]
    assert tl["source"] == "host spans (gloo)"
    assert {(b["bucket"], b["leg"]) for b in tl["buckets"]} == {
        (g, leg) for g in range(rep["num_buckets"])
        for leg in ("reduce_scatter", "all_gather")}
    assert {b["leg"] for b in doc["modes"]["allreduce"]["timeline"][
        "buckets"]} == {"all_reduce"}
    assert doc["telemetry"]["enabled"] is True
    assert doc["telemetry"]["counters"]["dear.steps"] > 0
    assert json.loads(json.dumps(doc)) == doc  # JSON-safe end to end
