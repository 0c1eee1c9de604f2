"""The port's resilience layer (dear_pytorch_tpu_torch.resilience) against
the JAX package's, on the CPU.

  - the pure functions equal JAX's on the same views: `parse_faults`,
    `evaluate_health_views`, `newest_common_step`, `vote`,
    `fingerprint_array`, `encode_fingerprints` and the loss fingerprint;
  - `poison_pytree` poisons the leaf JAX's does; `flip_state_bucket` sets
    the bit JAX's does, in place, and only on the rank that holds it;
  - ``metrics["sdc_fp"]`` (``DEAR_SDC=1`` at build time) equals JAX's host
    `fingerprint_array` over the same post-update masters, exactly; with
    ``DEAR_SDC`` off the step has no such metric;
  - the consensus exchange over the c10d store transport (two ranks on
    threads over one store) and a peer that never comes (`PeerTimeout`);
    the refusal of an unknown transport lists the port's names;
  - the watchdog's default abort fires while the main thread is blocked,
    through the runner's ``DEAR_STEP_WATCHDOG_SECS`` (a subprocess); the
    bench's phase watchdog prints the partial line and exits 0 once the
    primary metric exists;
  - one spawn of three gloo ranks: the host collectives, the allgather
    transport, and ``flip@4:0:r0`` under ``DEAR_SDC=1`` in a replicated
    mode — the vote names rank 0 and bucket 0 on every rank, and the
    replay convicts it.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dear_pytorch_tpu.resilience import cluster as JCL
from dear_pytorch_tpu.resilience import inject as JINJ
from dear_pytorch_tpu.resilience import sdc as JSDC
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.parallel import dear as tdear
from dear_pytorch_tpu_torch.resilience import cluster as CL
from dear_pytorch_tpu_torch.resilience import inject as INJ
from dear_pytorch_tpu_torch.resilience import sdc as SDC

from tests.test_torch_checkpoint import bn_batches, bn_step
from tests.test_torch_dear import ROOT, spawn_ranks


@pytest.fixture(scope="module")
def group():
    from dear_pytorch_tpu_torch.comm import backend

    return backend.init("cpu")


# ---------------------------------------------------------------------------
# the pure functions, against JAX's
# ---------------------------------------------------------------------------


def test_parse_faults_matches_jax():
    spec = ("nan@3,exc@5:r1,hang@7:0.5,ckpt_corrupt@9,preempt@11:r0,"
            "flip@4:2:r1,slow@2:0.05:s1,dcn_drop@6,flip_logits@3")
    assert [dataclasses.astuple(f) for f in INJ.parse_faults(spec)] == [
        dataclasses.astuple(f) for f in JINJ.parse_faults(spec)]
    for bad in ("nan", "boom@3", "nan@x", "nan@3:r1:s0"):
        with pytest.raises(ValueError):
            JINJ.parse_faults(bad)
        with pytest.raises(ValueError):
            INJ.parse_faults(bad)


def _views(rng, n, *, sfp_len=3):
    views = []
    for r in range(n):
        v = {"ok": bool(rng.random() > 0.2), "fp": rng.choice(["", "a", "b"]),
             "pre": bool(rng.random() > 0.8),
             "sfp": ".".join(f"{int(w):08x}" for w in rng.choice(
                 [1, 2], sfp_len)) if rng.random() > 0.3 else "",
             "host": f"h{r}"}
        views.append(v)
    return views


def test_health_views_and_common_step_match_jax():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 4, 5, 7):
        for _ in range(20):
            views = _views(rng, n)
            got = CL.evaluate_health_views(range(n), views, step=3)
            want = JCL.evaluate_health_views(range(n), views, step=3)
            assert got == want
    for views in ([[6, 4, 2], [4, 2], None], [[6], [4]], [None, None],
                  [[5, 3], [5, 3, 1], [3]]):
        assert CL.newest_common_step(views) == JCL.newest_common_step(views)


def test_vote_and_fingerprints_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(50):
        n = int(rng.integers(1, 6))
        fps = {r: ".".join(f"{int(w):08x}" for w in rng.integers(0, 3, 4))
               if rng.random() > 0.2 else "" for r in range(n)}
        assert SDC.vote(fps) == JSDC.vote(fps)
    for arr in (rng.standard_normal(1000).astype(np.float32),
                np.array([-0.0, np.inf, -np.inf, 1e-38], np.float32),
                np.zeros(0, np.float32)):
        assert SDC.fingerprint_array(arr) == JSDC.fingerprint_array(arr)
    words = rng.integers(0, 2**32, 5, dtype=np.uint64)
    assert SDC.encode_fingerprints(words) == JSDC.encode_fingerprints(words)
    loss = np.float32(1.2345)
    assert (CL.ClusterCoordinator.fingerprint(torch.tensor(loss).numpy())
            == JCL.ClusterCoordinator.fingerprint(jnp.asarray(loss)))


def test_poison_pytree_poisons_the_leaf_jax_does():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    batch = {"y": np.arange(3, dtype=np.int32), "x": x, "z": x + 1}
    want = JINJ.poison_pytree(batch)
    got = INJ.poison_pytree({k: torch.from_numpy(v) for k, v in
                             batch.items()})
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert np.isnan(got["x"].numpy()).all() and not np.isnan(
        got["z"].numpy()).any()
    with pytest.raises(ValueError, match="no floating-point leaf"):
        INJ.poison_pytree({"ids": torch.zeros(3, dtype=torch.long)})
    inj = INJ.FaultInjector(INJ.parse_faults("nan@2"), own_rank=0)
    with pytest.raises(INJ.InjectedFault, match="degraded to a step error"):
        inj.poison_batch(2, {"ids": torch.zeros(3, dtype=torch.long)})


def test_flip_state_bucket_sets_the_bit_jax_does(group):
    class _S:
        def __init__(self, buffers):
            self.buffers = buffers

        def _replace(self, buffers):
            return _S(buffers)

    ts = bn_step(group)
    state = ts.init()
    for g, b in enumerate(ts.plan.buckets):
        full = state.shards[g].clone()
        want, wb, widx = JINJ.flip_state_bucket(
            _S((full.numpy(),)), 0, None)
        before = state.shards[g].clone()
        got, gb, gidx = INJ.flip_state_bucket(state, g, ts.plan, rank=0)
        assert got is state and gb == g and gidx == b.size - 1
        if b.size == b.padded_size:            # JAX's without a plan
            assert gidx == widx
            np.testing.assert_array_equal(state.shards[g].numpy(),
                                          np.asarray(want.buffers[0]))
        w = state.shards[g].view(torch.int32)
        assert int(w[gidx]) == int(before.view(torch.int32)[gidx]) | 1
        INJ.flip_state_bucket(state, g, ts.plan, rank=0)   # idempotent
        assert torch.equal(state.shards[g].view(torch.int32), w)
    ts.close()


def test_flip_only_on_the_rank_that_holds_the_element():
    from dear_pytorch_tpu_torch.ops import fusion as F

    plan = F.make_plan([("a", (5,), torch.float32)], 2, threshold_mb=None)
    shard = torch.zeros(3)          # world 2: rank r holds [3r, 3r + 3)

    class S:
        shards = (shard,)

    for rank, hit in ((0, False), (1, True)):
        shard.zero_()
        _, b, idx = INJ.flip_state_bucket(S, 0, plan, rank=rank)
        assert (b, idx) == (0, 4)
        assert bool(shard.view(torch.int32)[1]) == hit
        assert int(shard.view(torch.int32).sum()) == int(hit)


def test_sdc_fingerprint_metric_equals_jax_host_checksum(group, monkeypatch):
    monkeypatch.setenv("DEAR_SDC", "1")
    ts = bn_step(group)
    state = ts.init()
    for b in bn_batches(2):
        state, m = ts.step(state, b)
    fp = m["sdc_fp"]
    assert fp.dtype == torch.int64 and fp.shape == (ts.plan.num_buckets,)
    want = [JSDC.fingerprint_array(s.numpy()) for s in state.shards]
    assert fp.tolist() == want
    ts.close()
    monkeypatch.setenv("DEAR_SDC", "")
    ts = bn_step(group)
    _, m = ts.step(ts.init(), bn_batches(1)[0])
    assert "sdc_fp" not in m
    ts.close()


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


def _store_pair(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 2)
    return [CL.ClusterCoordinator(
        process_index=r, process_count=2, timeout_s=20, instance=1,
        transport=CL.StoreTransport(store, index=r, num_processes=2))
        for r in range(2)]


def test_store_transport_consensus(tmp_path):
    coords = _store_pair(tmp_path)
    out = [None, None]

    def rank(r):
        c = coords[r]
        v = c.health_check(r == 0, fingerprint="f", step=4)
        s = c.consensus_restore_step([6, 4, 2] if r else [4, 2])
        c.barrier("x")
        out[r] = (v, s, c.exchange("t", f"p{r}"))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for v, s, ex in out:
        assert not v.ok and v.unhealthy_ranks == (1,) and s == 4
        assert ex == ["p0", "p1"]


def test_store_transport_peer_timeout_and_transport_names(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 2)
    c = CL.ClusterCoordinator(
        process_index=0, process_count=2, timeout_s=0.3, instance=2,
        transport=CL.StoreTransport(store, index=0, num_processes=2))
    with pytest.raises(CL.PeerTimeout):
        c.exchange("lonely", "x")
    with pytest.raises(ValueError,
                       match="'store', 'allgather', and 'file:<dir>'"):
        CL.ClusterCoordinator(process_index=0, process_count=2,
                              transport="carrier-pigeon")


# ---------------------------------------------------------------------------
# watchdogs (subprocesses: the default abort is os._exit)
# ---------------------------------------------------------------------------

_HUNG_RUNNER = '''
import os, sys, threading
sys.path.insert(0, {root!r})
os.environ["DEAR_STEP_WATCHDOG_SECS"] = "0.5"
from dear_pytorch_tpu_torch.benchmarks import runner
calls = [0]


def step():
    calls[0] += 1
    if calls[0] > 2:                       # the first timed call hangs
        threading.Event().wait()           # blocked in a C-level wait


runner.run_timed(step, batch_size=1, num_warmup_batches=2,
                 num_batches_per_iter=1, num_iters=3, device="cpu")
print("not reached")
'''

_HUNG_BENCH = '''
import os, sys, time
sys.path.insert(0, {root!r})
os.environ["DEAR_BENCH_WATCHDOG_SECS"] = "0.4"
from dear_pytorch_tpu_torch import bench
dog = bench._Watchdog()
dog.arm("resnet", bench.PRIMARY_METRIC)
dog.primary = {{"metric": bench.PRIMARY_METRIC, "value": 1.0}}
dog.extras.append({{"metric": "bert_base_sen_sec_per_chip", "value": 2.0}})
dog.arm("bert", "bert_large_sen_sec_per_chip")
time.sleep(30)
'''


def _run(code, timeout=60):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DEAR_", "JAX_", "XLA_"))}
    return subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def test_runner_step_watchdog_fires_while_the_step_blocks():
    p = _run(_HUNG_RUNNER)
    assert p.returncode == 13, p.stderr[-2000:]
    assert "bench-step-watchdog" in p.stderr
    assert "'phase': 'timed', 'iter': 0" in p.stderr
    assert "not reached" not in p.stdout


def test_bench_phase_watchdog_prints_the_partial_line():
    p = _run(_HUNG_BENCH)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["value"] == 1.0
    assert [m["metric"] for m in line["extra_metrics"]] == [
        "bert_base_sen_sec_per_chip", "bert_large_sen_sec_per_chip"]
    assert "wedged" in line["extra_metrics"][1]["error"]


# ---------------------------------------------------------------------------
# world 3: host collectives, the allgather transport, the SDC vote
# ---------------------------------------------------------------------------

_WORKER = '''
import json, os, sys
import numpy as np
import torch
from torch import nn
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import collectives as C
from dear_pytorch_tpu_torch.observability import tracer as T
from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd
from dear_pytorch_tpu_torch.parallel import dear as D
from dear_pytorch_tpu_torch.resilience import cluster as CL
from dear_pytorch_tpu_torch.resilience import inject as INJ
from dear_pytorch_tpu_torch.utils.guard import DivergenceError, GuardedTrainer

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store",
                  DEAR_CLUSTER_TIMEOUT_SECS="60", DEAR_SDC="1",
                  DEAR_SDC_HOST="host%d" % rank)
g = backend.init("cpu")
res = {{}}
res["ag"] = C.host_allgather(np.array([rank, 10 * rank], np.int32)).tolist()
res["ar"] = float(C.allreduce(float(rank + 1)))
res["ar_sum"] = C.allreduce(np.array([rank, 1]), average=False).tolist()
ag = CL.ClusterCoordinator(namespace="ag", transport="allgather")
res["ag_exchange"] = ag.exchange("t", "r%d" % rank)


class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.dense1, self.out = nn.Linear(12, 16), nn.Linear(16, 4)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)

    @property
    def device(self):
        return self.out.weight.device

    def forward(self, x):
        return self.out(torch.tanh(self.dense1(x)))


def batch(i):
    rng = np.random.RandomState(100 + i)
    sl = slice(8 * rank, 8 * (rank + 1))
    return {{"x": torch.from_numpy(rng.randn(8 * world, 12).astype(
                 np.float32)[sl]),
            "y": torch.from_numpy(rng.randint(0, 4, 8 * world)[sl])}}


T.set_tracer(T.Tracer())
ts = D.build_train_step(
    lambda m, b: nn.functional.cross_entropy(m(b["x"]), b["y"]), MLP(),
    group=g, device="cpu", mode="allreduce", threshold_mb=0.0005,
    optimizer=fused_sgd(lr=0.1, momentum=0.9))
state = ts.init()
restored, suspects, error = [], [], ""
guard = GuardedTrainer(ts, os.path.join(out, "ckpt"), check_every=1,
                       checkpoint_every=2, max_keep=10,
                       injector=INJ.FaultInjector(
                           INJ.parse_faults("flip@4:0:r0")),
                       on_rollback=lambda c, s: restored.append(s))
fps = []
try:
    for i in range(8):
        state, m = guard.step(state, batch(i))
        if guard._sdc.last_suspects:
            suspects.append(list(guard._sdc.last_suspects))
        if "sdc_fp" in m:
            fps.append(m["sdc_fp"].tolist())
except DivergenceError as exc:
    error = str(exc)
res.update(restored=restored, suspects=suspects, error=error, fps=fps,
           convicted=sorted(guard._sdc.convicted),
           drain=guard._sdc.drain_requested,
           counters={{k: v for k, v in T.get_tracer().counters().items()
                     if k.startswith(("guard.", "cluster.", "sdc.",
                                      "faults."))}})
with open(os.path.join(out, "rank%d.json" % rank), "w") as f:
    json.dump(res, f)
ts.close()
'''


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("resilience_world3"))
    spawn_ranks(_WORKER.format(root=ROOT), 3, out)
    return [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(3)]


def test_world3_host_collectives(world3):
    for r, res in enumerate(world3):
        assert res["ag"] == [[0, 0], [1, 10], [2, 20]]
        assert res["ar"] == 2.0 and res["ar_sum"] == [3, 3]
        assert res["ag_exchange"] == ["r0", "r1", "r2"]


def test_world3_vote_names_the_flipped_rank_and_bucket(world3):
    first = world3[0]["suspects"][0]
    assert first == [[0, 0, "host0"]]
    for res in world3:
        assert res["suspects"][0] == first      # every rank, the same vote
        assert res["restored"] and res["counters"]["sdc.votes"] >= 1
        assert res["counters"]["cluster.sdc_suspects_detected"] >= 1
        assert "host0" in res["convicted"]      # the replay reproduced it
        assert res["fps"][0] == world3[0]["fps"][0]  # replicas agree first
    assert world3[0]["drain"] and not world3[1]["drain"]
    assert world3[0]["counters"]["faults.sdc_flips"] >= 1
    assert "faults.sdc_flips" not in world3[1]["counters"]
