"""Chaos drills of the port's elastic membership — the port of the JAX
package's ``scripts/chaos_check.py --elastic`` (JAX :421-666),
``--autoscale`` with its cold start (JAX :1241-1676) and the multi-slice
drills (JAX :1677-2400), with JAX's scenarios and verdicts, over the
port's supervisor (`launch.supervisor`):

  - ``--elastic``: 3 ranks train under the supervisor; rank 2 SIGKILLs
    itself before attempt 5; the survivors' health sync commits epoch 1
    (world 2), `AutoTuner.rescale` forms the epoch's process group
    (`comm.backend.regroup`) and step, and every survivor rolls back to
    the newest common checkpoint; the relaunch rejoins at epoch 2
    (world 3) and the fleet runs 4 lockstep steps more.
  - ``--autoscale``: 2 ranks stream checkpoints to per-rank object
    stores; a capacity hint scales the fleet to 3 (a brand-new rank 2,
    epoch 1), rank 1 is SIGKILLed (e2) and relaunched (e3), rank 0 is
    drained with a SIGTERM (a planned shrink, e4) and backfilled (e5);
    then a cold start restores from the remote tier alone.
  - ``--multislice``, ``--multislice-flap``, ``--multislice-degraded``: 2
    slices x 2 ranks (``DEAR_ELASTIC_RANKS_PER_SLICE=2``) train the
    hierarchical schedule (`parallel.dear`, ``dcn=``) over a shared
    `FileTransport` DCN exchanger (`comm.dcn`). JAX's drill runs 2 x 4
    ranks, each a process holding a whole 2-device slice as its own mesh;
    a port process drives one card, so here a slice is two processes, its
    intra-slice peers over the slice's process group
    (`comm.backend.slice_group`). The stories: the whole of slice 1 dies
    before attempt 5 and the survivors commit ONE slice-shaped shrink,
    renormalize the DCN leg, train degraded under a ``dcn_slow``
    straggler and readmit the relaunched slice as ONE epoch; a sub-budget
    ``dcn_flap`` under bounded staleness costs no rollback; a past-budget
    ``dcn_partition`` makes the victim slice evict itself (exit 70) and
    rejoin.

Every rank is a process: checkpoints are per-host (``DEAR_CKPT_SHARED=0``:
each blob holds the whole state), the membership runs over the
supervisor's `FileTransport` and each epoch's group over a ``FileStore``
in the same directory, both of which outlive every rank. The JAX gate's
steps-per-hour SLO (``--autoscale``, ``--multislice-flap``) goes through
its ``scripts/bench_gate.py --slo``, which is the JAX package's: that one
check is left out; every other verdict stays. The other drills of the
JAX script raise, naming their ROADMAP item.

The workload is ``--model mlp`` (JAX's tiny MLP, a torch copy with its
shapes), ``mnistnet`` (the MNIST example's net) or ``gpt2`` (GPT-2 small
cut to 2 layers at full width, bf16, flash attention, dropout off,
B = 4 per rank, S = 1024); ``--device cuda`` (the default)
or ``cpu``. The multi-slice drills' strict DCN deadline
(``DEAR_DCN_TIMEOUT_SECS``) is 0.45 of the peer timeout (JAX's 20 s of
45), so a dead slice fails the step well before the health sync gives
up. Beyond JAX's verdicts each worker records per attempt its
loss, the K5 epilogue's launches and the plan's buckets, and per
transition its times (`chip_smoke.py`'s elastic phase prints them), and
``--elastic`` replays the first post-shrink steps in a fresh 2-rank run
restored from the same checkpoint.

    python -m dear_pytorch_tpu_torch.scripts.chaos_check --elastic \\
        [--device cpu] [--model mlp] [--workdir DIR]
    python -m dear_pytorch_tpu_torch.scripts.chaos_check --multislice \\
        [--device cpu] [--model mlp|mnistnet|gpt2]

Prints one JSON summary line and ``CHAOS CHECK PASSED|FAILED``; exit 0
iff every verdict held.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Optional

from dear_pytorch_tpu_torch.scripts import chaos_common as CC

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_MODULE = "dear_pytorch_tpu_torch.scripts.chaos_check"
_check = CC.check
#: the global batch rows of the small workloads: they shard over 2 and 3
_ROWS = 12
#: GPT-2's rows per rank and sequence length
_GPT_ROWS, _GPT_SEQ = 4, 1024
#: how many post-shrink attempts the fresh replay runs (at most)
_REPLAY_STEPS = 4


# -- the workloads ------------------------------------------------------------


def _workload(name: str, device):
    """``(model, loss_fn, batch_at, build_kwargs, threshold_mb)``:
    ``batch_at(i, index, world)`` is rank ``index``'s rows of attempt
    ``i``'s global batch, made on the host from a seed (the same on every
    rank and every life)."""
    import dataclasses

    import numpy as np
    import torch

    from dear_pytorch_tpu_torch import models

    dev = torch.device(device)
    if name == "mlp":
        g = torch.Generator().manual_seed(0)
        model = torch.nn.Sequential()
        model.add_module("dense", torch.nn.Linear(12, 32))
        model.add_module("act", torch.nn.Tanh())
        model.add_module("out", torch.nn.Linear(32, 4))
        with torch.no_grad():
            for lin in (model.dense, model.out):
                lin.weight.copy_(torch.randn(lin.weight.shape, generator=g)
                                 * 0.1)
                lin.bias.zero_()
        model = model.to(dev)
        model.device = dev
        teacher = np.random.default_rng(42).standard_normal((12, 4))

        def batch_at(i, index, world):
            x = np.random.default_rng(100 + i).standard_normal(
                (_ROWS, 12)).astype(np.float32)
            y = np.argmax(x @ teacher, axis=-1)
            n = _ROWS // world
            sl = slice(index * n, (index + 1) * n)
            return (torch.from_numpy(x[sl]).to(dev),
                    torch.from_numpy(y[sl]).to(dev))

        def loss_fn(m, b):
            x, y = b
            return torch.nn.functional.cross_entropy(m(x), y)

        return model, loss_fn, batch_at, {}, 0.0008
    if name == "mnistnet":
        model = models.MnistNet(device=dev, seed=0)

        def batch_at(i, index, world):
            rng = np.random.default_rng(100 + i)
            x = rng.standard_normal((_ROWS, 1, 28, 28)).astype(np.float32)
            y = rng.integers(0, 10, (_ROWS,))
            n = _ROWS // world
            sl = slice(index * n, (index + 1) * n)
            return (torch.from_numpy(x[sl]).to(dev),
                    torch.from_numpy(y[sl]).to(dev))

        def loss_fn(m, b):
            x, y = b
            return torch.nn.functional.nll_loss(m(x), y)

        return model, loss_fn, batch_at, {}, 0.01
    if name == "gpt2":
        from dear_pytorch_tpu_torch.models.gpt import (
            flash_causal_attention_impl, gpt_lm_loss)

        cfg = models.dropout_free(dataclasses.replace(
            models.gpt_config("gpt2", dtype=torch.bfloat16),
            num_hidden_layers=2))
        model = models.GptLmHeadModel(
            cfg, attention_impl=flash_causal_attention_impl(), device=dev,
            seed=0)

        def batch_at(i, index, world):
            ids = np.random.default_rng(100 + i).integers(
                0, cfg.vocab_size, (world * _GPT_ROWS, _GPT_SEQ))
            sl = slice(index * _GPT_ROWS, (index + 1) * _GPT_ROWS)
            return torch.from_numpy(ids[sl]).to(dev)

        def loss_fn(m, b):
            return gpt_lm_loss(m(b), b, vocab_size=cfg.vocab_size)

        return (model, loss_fn, batch_at, {"comm_dtype": torch.bfloat16},
                25.0)
    raise ValueError(f"unknown --model {name!r} (mlp, mnistnet, gpt2)")


def _tuner(args, group_device, **extra):
    """The worker's `AutoTuner` (JAX's: strategy bo, a tuning interval
    that never fires, SGD lr 0.05 momentum 0.9) over the workload, and
    the workload's ``batch_at``; ``extra`` goes to the build (``dcn``)."""
    from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd
    from dear_pytorch_tpu_torch.tuning.autotune import AutoTuner

    model, loss_fn, batch_at, kw, thr = _workload(args.model, group_device)
    tuner = AutoTuner(loss_fn, model, strategy="bo", threshold_mb=thr,
                      interval=10**9, device=group_device,
                      optimizer=fused_sgd(lr=0.05, momentum=0.9),
                      **kw, **extra)
    return tuner, batch_at


def _pipeline(cluster):
    from dear_pytorch_tpu_torch.runtime import build as RB
    from dear_pytorch_tpu_torch.runtime import pipeline as P

    spec = P.SyntheticSpec((
        P.Field("x", (_ROWS, 12), RB.KIND_NORMAL_F32, 0.0, 1.0),))
    return P.NumpyPipeline(spec, seed=123, shard=cluster.index,
                           num_shards=cluster.world)


def _redirect_output(workdir: str, rank: int) -> None:
    """A worker's stdout and stderr into ``workdir/rank<r>.<pid>.log``
    (the guard logs a flight-ring dump per rollback)."""
    path = os.path.join(workdir, f"rank{rank}.{os.getpid()}.log")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)


def _write_json(path: str, doc) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(doc, f)
    os.replace(path + ".tmp", path)


class _Timeline:
    """A worker's record of its run: per attempt the loss, the state's
    step, the epoch, the plan's world and buckets and the K5 epilogue's
    launches; per membership transition the commit time, the regroup's
    duration, the hook's start and the restore's end (wall-clock times,
    comparable across the ranks of one host)."""

    def __init__(self, cluster, guard):
        from dear_pytorch_tpu_torch.comm import backend

        self.cluster, self.guard = cluster, guard
        self.rows: list = []
        self.transitions: list = []
        self.rejoin_s: Optional[float] = None
        self.resume_s: Optional[float] = None
        self._open: Optional[dict] = None
        self.last_step_end: Optional[float] = None
        #: the step of the newest state the guard returned to this rank (a
        #: rejoiner: None until its re-entry has restored one)
        self.last_step: Optional[int] = 0

        def timed(fn, what):
            def wrapper(*a, **k):
                t0 = time.time()
                out = fn(*a, **k)
                self._note(what, t0, time.time())
                return out
            return wrapper

        for name in ("reconfigure", "admit"):
            setattr(cluster, name, timed(getattr(cluster, name), name))
        backend.regroup = timed(backend.regroup, "regroup")

    def _note(self, what, t0, t1) -> None:
        if what in ("reconfigure", "admit"):
            self._open = {"epoch": self.cluster.epoch,
                          "kind": "shrink" if what == "reconfigure"
                          else "admit",
                          "world": self.cluster.world,
                          "t_commit": t1, "commit_s": t1 - t0,
                          "attempt": self.guard.steps_seen}
            self.transitions.append(self._open)
        elif what == "regroup" and self._open is not None:
            self._open["regroup_s"] = t1 - t0

    def hook(self, on_change):
        def wrapped(view):
            if self._open is not None:
                self._open["t_hook"] = time.time()
                # the newest step this rank held before the move (None: the
                # move came during its re-entry, with nothing to lose)
                self._open["step_before"] = self.last_step
            on_change(view)
            if self._open is not None:
                self._open["plan"] = [self.guard.ts.plan.world,
                                      self.guard.ts.plan.epoch]
                self._open["groups"] = [list(b.leaf_ids) for b
                                        in self.guard.ts.plan.buckets]
        return wrapped

    def on_rollback(self, count, at_step) -> None:
        if self._open is not None and "t_restored" not in self._open:
            self._open["t_restored"] = time.time()
            self._open["restored_step"] = int(at_step)
            before = self._open.get("step_before")
            self._open["steps_lost"] = (None if before is None
                                        else before - int(at_step))

    def step(self, state, batch):
        from dear_pytorch_tpu_torch.ops import fused_sgd as FS

        ts = self.guard.ts
        buckets, world = ts.plan.num_buckets, ts.world
        n0, u0 = FS.fused_update_launches, ts.update_launches
        state, m = self.guard.step(state, batch)
        loss = m.get("loss", float("nan"))
        loss = float(loss)
        self.rows.append({
            "attempt": self.guard.steps_seen, "step": int(state.step),
            "epoch": self.cluster.epoch, "world": world,
            "buckets": buckets, "launches": FS.fused_update_launches - n0,
            # the step's shard updates: K5 epilogue launches on the card,
            # its plain version on the CPU
            "updates": (ts.update_launches - u0
                        if self.guard.ts is ts else None),
            "rolled_back": bool(m.get("rolled_back")),
            "loss": loss if math.isfinite(loss) else None})
        self.last_step_end = time.time()
        self.last_step = int(state.step)
        return state, m


class _Guarded:
    """What the harness loops drive: the guard's ``steps_seen`` and a
    recorded ``step``; the victim leaves the end time of its last step on
    disk before the harness SIGKILLs it."""

    def __init__(self, guard, timeline: _Timeline, death_file=None):
        self._guard, self._tl, self._death = guard, timeline, death_file

    @property
    def steps_seen(self) -> int:
        return self._guard.steps_seen

    def step(self, state, batch):
        out = self._tl.step(state, batch)
        if self._death is not None:
            _write_json(self._death, {"t": self._tl.last_step_end})
        return out


def _solo_group(rank: int, device):
    """A one-rank group of this process's own (an in-memory store)."""
    import torch.distributed as dist

    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.resilience.membership import MembershipView

    solo = MembershipView(epoch=-1, members=(rank,), rank=rank, index=0,
                          world=1)
    return backend.regroup(solo, device=device, store=dist.HashStore())


def _start_group(cluster, rejoining: bool, device):
    """The worker's first group: a first-launch member forms epoch 0's;
    a relaunched or scale-up rank builds its step on a one-rank group of
    its own until its admission (the rescale then forms the admitted
    epoch's group)."""
    from dear_pytorch_tpu_torch.comm import backend

    if not rejoining:
        return backend.regroup(cluster.view(), device=device)
    return _solo_group(cluster.rank, device)


def _release(tuner) -> None:
    """Close the live step (its hooks tie the model and the step into a
    cycle) and release the groups before the interpreter exits: a gloo
    group torn down during finalization can abort the process after its
    work is done."""
    from dear_pytorch_tpu_torch.comm import backend

    tuner.close()
    backend.shutdown()


def _final_counters(tracer) -> dict:
    return {k: v for k, v in tracer.counters().items()
            if k.startswith(("cluster.", "guard.", "pipeline.",
                             "autotune.", "ckpt.", "kernel."))}


def run_worker_elastic(args) -> dict:
    """One rank of the elastic drill (JAX :421-545), spawned by
    `run_elastic` under the supervisor's rejoin env contract."""
    os.environ["DEAR_CKPT_SHARED"] = "0"
    import importlib

    from dear_pytorch_tpu_torch.observability import flight as FL
    from dear_pytorch_tpu_torch.observability import tracer as T
    from dear_pytorch_tpu_torch.resilience import membership as M
    from dear_pytorch_tpu_torch.utils import checkpoint as ckpt
    from dear_pytorch_tpu_torch.utils.guard import GuardedTrainer

    EH = importlib.import_module(
        "dear_pytorch_tpu_torch.scripts.elastic_harness")
    workdir = args.workdir
    cluster = M.ElasticCluster.from_env(max_candidates=256)
    rejoining = M.ElasticCluster.rejoining_by_env()
    rank, world0 = cluster.rank, cluster.world
    _redirect_output(workdir, rank)
    kr, ka = os.environ["DEAR_CHAOS_ELASTIC_KILL"].split(":")
    kill_rank, kill_at = int(kr), int(ka)
    post_steps = int(os.environ.get("DEAR_CHAOS_ELASTIC_POST", "4"))
    ckpt_dir = os.path.join(workdir, f"rank{rank}", "ckpts")
    tracer = T.get_tracer()

    _start_group(cluster, rejoining, args.device)
    tuner, batch_at = _tuner(args, args.device)
    pipe = _pipeline(cluster)
    guard = GuardedTrainer(
        tuner.ts, ckpt_dir, check_every=1,
        checkpoint_every=args.checkpoint_every, max_keep=1000,
        max_recoveries=8, coordinator=cluster, pipeline=pipe)
    tl = _Timeline(cluster, guard)
    guard.on_membership_change = tl.hook(EH.attach_elastic(guard, tuner))
    rollback_steps = []

    def on_rollback(c, at):
        rollback_steps.append(at)
        tl.on_rollback(c, at)

    guard.on_rollback = on_rollback
    resumed_at = None
    t_target = None
    if rejoining:
        t0 = time.time()
        rejoin = cluster.rejoin

        def timed_rejoin(*a, **k):
            out = rejoin(*a, **k)
            tl.rejoin_s = time.time() - t0
            return out

        cluster.rejoin = timed_rejoin
        tl.last_step = None
        state, resumed_at, _ = EH.reenter(cluster, tuner, guard, ckpt_dir)
        tl.resume_s = time.time() - t0 - (tl.rejoin_s or 0.0)
        tl.last_step = resumed_at
        t_target = guard.steps_seen + post_steps
    else:
        state = tuner.init()
    death = (os.path.join(workdir, f"death_rank{rank}.json")
             if kill_rank == rank and not rejoining else None)
    state, m = EH.run_loop(
        cluster, _Guarded(guard, tl, death), pipe, state,
        lambda i: batch_at(i, cluster.index, cluster.world), tracer,
        rejoining=rejoining, kill=(kill_rank, kill_at),
        post=post_steps, t_target=t_target, deadline_s=args.deadline)
    guard.finalize()
    ring = FL.get_recorder().dump()["records"]
    verdict = {
        "rank": rank,
        "rejoined": bool(rejoining),
        "epoch": cluster.epoch,
        "members": list(cluster.members),
        "resumed_at": resumed_at,
        "rollback_steps": rollback_steps,
        "final_step": int(state.step),
        "final_loss": float(m.get("loss", float("nan"))),
        "steps_seen": guard.steps_seen,
        "plan_world": guard.ts.plan.world,
        "plan_epoch": guard.ts.plan.epoch,
        "pipe_shard": [pipe.shard, pipe.num_shards],
        "flight_epoch": (ring[-1].get("mem_epoch") if ring else None),
        "sidecar_epoch": ckpt.read_mem_epoch(ckpt_dir,
                                             guard._last_good_step or -1),
        "counters": _final_counters(tracer),
        "rows": tl.rows,
        "transitions": tl.transitions,
        "rejoin_s": tl.rejoin_s,
        "resume_s": tl.resume_s,
    }
    # the lockstep verdict is itself a member-scoped collective
    views = cluster.exchange("chaos.verdict", json.dumps(
        [verdict["final_step"], verdict["final_loss"], verdict["epoch"]]))
    verdict["lockstep"] = all(
        json.loads(v) == json.loads(views[0]) for v in views)
    _write_json(os.path.join(workdir, f"verdict_rank{rank}.json"), verdict)
    print(f"CHAOS_EL rank={rank}/{world0} " + json.dumps(
        {k: v for k, v in verdict.items() if k != "rows"}), flush=True)
    _release(tuner)
    return verdict


def _supervisor_env(args, extra: dict) -> dict:
    env = dict(os.environ)
    env.pop("DEAR_TRACE_RANK", None)
    for k in ("DEAR_NUM_PROCESSES", "DEAR_PROCESS_ID",
              "DEAR_COORDINATOR_ADDRESS"):
        env.pop(k, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["DEAR_TELEMETRY"] = "1"
    env["DEAR_FLIGHT"] = "8"
    # every rank of this host shares its cards (one card: a gloo group)
    env.setdefault("DEAR_LOCAL_SIZE", "3")
    env.setdefault("OMP_NUM_THREADS", "1")
    # a peer's post-transition rebuild must not read as a death
    env.setdefault("DEAR_CLUSTER_TIMEOUT_SECS", "30")
    if args.peer_timeout is not None:
        env["DEAR_CLUSTER_TIMEOUT_SECS"] = str(args.peer_timeout)
    env.update(extra)
    return env


def _worker_argv(args, drill: str) -> list:
    return [sys.executable, "-m", _MODULE, "--worker", drill,
            "--checkpoint-every", str(args.checkpoint_every),
            "--workdir", args.workdir, "--device", args.device,
            "--model", args.model, "--deadline", str(args.deadline)]


def _logs_tail(workdir: str, n: int = 3000) -> str:
    out = []
    for name in sorted(os.listdir(workdir)):
        if name.startswith("rank") and name.endswith(".log"):
            with open(os.path.join(workdir, name), errors="replace") as f:
                out.append(f"--- {name}\n" + f.read()[-n:])
    return "\n".join(out)


def _check_steps_lost(v: dict, failures: list) -> None:
    """A member's rollback lands at or before the step it held: a
    negative 'steps lost' is a fault of the drill's bookkeeping or of the
    restore."""
    bad = [(t["epoch"], t["steps_lost"]) for t in v["transitions"]
           if (t.get("steps_lost") or 0) < 0]
    _check(not bad, f"rank {v['rank']}: no transition restored it past the "
           f"step it held ((epoch, steps lost) {bad})", failures)


def run_elastic(args, *, nprocs: int = 3) -> dict:
    """Parent of the elastic drill (JAX :547-666): the supervisor runs
    ``nprocs`` ranks of `run_worker_elastic`; rank ``nprocs - 1``
    SIGKILLs itself before attempt 5. Gates on JAX's verdicts (epochs
    0 -> 1 -> 2, lockstep, the rescaled epoch-stamped plan, the resharded
    pipeline, epoch-stamped flight rows and sidecars, the counters, every
    rollback on the newest common checkpoint, the relaunch resumed
    there) and on one shard update per bucket per completed step. With
    ``args.replay_shrink`` the relaunch waits out the peer timeout and
    ``args.relaunch_delay`` more, so the survivors train at world 2
    first, and those attempts are replayed in a fresh 2-rank run restored
    from the same checkpoint."""
    import tempfile

    workdir = args.workdir = args.workdir or tempfile.mkdtemp(
        prefix="dear_chaos_el_")
    os.makedirs(workdir, exist_ok=True)
    kill_rank, kill_at = nprocs - 1, 5
    post_steps = 4
    sup_mod = CC.load_supervisor()
    env = _supervisor_env(args, {
        "DEAR_CHAOS_ELASTIC_KILL": f"{kill_rank}:{kill_at}",
        "DEAR_CHAOS_ELASTIC_POST": str(post_steps)})
    delay = args.relaunch_delay
    if args.replay_shrink:
        delay += float(env["DEAR_CLUSTER_TIMEOUT_SECS"])
    t0 = time.monotonic()
    sup = sup_mod.ElasticSupervisor(
        nprocs, _worker_argv(args, "--elastic"),
        elastic_dir=os.path.join(workdir, "elastic"), env=env,
        max_relaunches=1, relaunch_delay_s=delay).start()
    rc = sup.wait(deadline_s=args.deadline + 60)
    elapsed = time.monotonic() - t0

    failures: list = []
    _check(rc == 0, f"supervisor exits 0 (got {rc})", failures)
    _check(sup.relaunches.get(kill_rank) == 1
           and all(n == 0 for r, n in sup.relaunches.items()
                   if r != kill_rank),
           f"exactly the killed rank was relaunched ({sup.relaunches})",
           failures)
    verdicts = {}
    for r in range(nprocs):
        path = os.path.join(workdir, f"verdict_rank{r}.json")
        if not os.path.exists(path):
            failures.append(f"rank {r} wrote no verdict")
            continue
        with open(path) as f:
            verdicts[r] = json.load(f)
    summary = {"passed": False, "procs": nprocs, "workdir": workdir,
               "elapsed_s": elapsed, "verdicts": verdicts,
               "failures": failures}
    if len(verdicts) != nprocs:
        summary["logs"] = _logs_tail(workdir)
        return summary

    expect_restore = (kill_at - 1) - (kill_at - 1) % args.checkpoint_every
    for r, v in verdicts.items():
        _check(v["epoch"] == 2 and v["members"] == list(range(nprocs)),
               f"rank {r} ends at epoch 2, full membership "
               f"(epoch {v['epoch']}, members {v['members']})", failures)
        _check(v["lockstep"], f"rank {r} finished in lockstep", failures)
        _check(v["plan_world"] == nprocs and v["plan_epoch"] == 2,
               f"rank {r} trains the rescaled epoch-stamped plan "
               f"(world {v['plan_world']}, epoch {v['plan_epoch']})",
               failures)
        _check(v["pipe_shard"][1] == nprocs,
               f"rank {r} pipeline resharded over the full membership",
               failures)
        _check(v["flight_epoch"] == 2,
               f"rank {r} flight rows are epoch-stamped "
               f"({v['flight_epoch']})", failures)
        _check(v["sidecar_epoch"] == 2,
               f"rank {r} newest checkpoint sidecar carries the epoch "
               f"({v['sidecar_epoch']})", failures)
        _check(v["final_step"] >= expect_restore + post_steps
               and v["final_step"] == verdicts[0]["final_step"],
               f"rank {r} continued past the transitions to step "
               f"{v['final_step']}", failures)
        done = [w for w in v["rows"] if not w["rolled_back"]]
        key = "launches" if args.device == "cuda" else "updates"
        _check(all(w[key] == w["buckets"] for w in done),
               f"rank {r}: every completed step ran the shard update once "
               f"per bucket ({key}: {sum(w[key] for w in done)} over "
               f"{len(done)} steps, {sum(w['buckets'] for w in done)} "
               "buckets)", failures)
        _check_steps_lost(v, failures)
    survivors = [v for r, v in verdicts.items() if r != kill_rank]
    for v in survivors:
        c = v["counters"]
        _check(c.get("cluster.reconfigs", 0) >= 1,
               f"rank {v['rank']} committed a reconfiguration", failures)
        _check(c.get("cluster.rejoins", 0) >= 1,
               f"rank {v['rank']} admitted the relaunched rank", failures)
        _check(c.get("guard.membership_changes", 0) >= 2,
               f"rank {v['rank']} guard saw both transitions", failures)
        _check(c.get("autotune.rescales", 0) >= 2,
               f"rank {v['rank']} rescaled the plan per transition",
               failures)
        _check(c.get("pipeline.reshards", 0) >= 2
               and c.get("pipeline.resumes", 0) >= 1,
               f"rank {v['rank']} pipeline resharded + resumed", failures)
        # zero loss of progress: every rollback landed exactly on the
        # newest commonly-valid checkpoint, never older
        _check(bool(v["rollback_steps"])
               and all(s == expect_restore for s in v["rollback_steps"]),
               f"rank {v['rank']} rollbacks landed on the newest common "
               f"checkpoint {expect_restore} ({v['rollback_steps']})",
               failures)
        plans = [t.get("plan") for t in v["transitions"]]
        _check(plans[:2] == [[nprocs - 1, 1], [nprocs, 2]],
               f"rank {v['rank']} plan world {nprocs} -> {nprocs - 1} -> "
               f"{nprocs} with the epoch stamped ({plans})", failures)
    rv = verdicts[kill_rank]
    _check(rv["rejoined"] and rv["resumed_at"] == expect_restore,
           f"relaunched rank rejoined and resumed at the fleet-agreed "
           f"step ({rv['resumed_at']})", failures)
    if args.replay_shrink:
        summary["replay"] = _replay_check(args, verdicts[0], failures)
    summary["passed"] = not failures
    if failures:
        summary["logs"] = _logs_tail(workdir)
    return summary


# -- the fresh replay of the first post-shrink steps --------------------------


def _post_shrink(v: dict) -> tuple:
    """``(restored step, first attempt index, [losses])`` of a survivor's
    world-2 stretch: the first `_REPLAY_STEPS` attempts after the
    shrink's rollback, up to the next transition."""
    rows = v["rows"]
    k = next(i for i, w in enumerate(rows)
             if w["rolled_back"] and w["epoch"] == 1)
    shrink = next(t for t in v["transitions"] if t["kind"] == "shrink")
    losses = []
    for w in rows[k + 1:k + 1 + _REPLAY_STEPS]:
        if w["rolled_back"] or w["epoch"] != 1:
            break
        losses.append(w["loss"])
    return shrink["restored_step"], rows[k]["attempt"], losses


def _replay_check(args, v0: dict, failures: list) -> dict:
    """Replay rank 0's post-shrink attempts in a fresh 2-rank run restored
    from the shrink's checkpoint (rank 0's per-host copy, which holds the
    whole state) and hold the losses equal, bitwise."""
    import shutil
    import subprocess

    step, first, losses = _post_shrink(v0)
    if not losses:
        _check(False, "the survivors trained at least one step at world 2 "
               "before the rejoin", failures)
        return {}
    rdir = os.path.join(args.workdir, "replay")
    shutil.rmtree(rdir, ignore_errors=True)
    os.makedirs(rdir)
    src = os.path.join(args.workdir, "rank0", "ckpts")
    spec = {"step": step, "first": first, "n": len(losses), "src": src,
            "groups": next(t["groups"] for t in v0["transitions"]
                           if t["kind"] == "shrink")}
    env = _supervisor_env(args, {"DEAR_CHAOS_REPLAY": json.dumps(spec)})
    env.pop("DEAR_TELEMETRY", None)
    procs = []
    for r in range(2):
        e = dict(env, DEAR_ELASTIC_RANK=str(r), DEAR_ELASTIC_WORLD="2")
        procs.append(subprocess.Popen(
            _worker_argv(args, "--replay") + ["--workdir", rdir], env=e))
    rcs = [p.wait(timeout=args.deadline) for p in procs]
    out = {"step": step, "first_attempt": first, "survivor": losses}
    try:
        with open(os.path.join(rdir, "replay_rank0.json")) as f:
            out.update(json.load(f))
    except (OSError, ValueError):
        pass
    _check(rcs == [0, 0] and out.get("losses") is not None,
           f"the fresh 2-rank replay ran (rcs {rcs})", failures)
    if out.get("losses") is not None:
        _check(out.get("same_groups", False),
               "the replay's plan buckets the survivors' rescaled plan",
               failures)
        _check(out["losses"] == losses,
               f"the first {len(losses)} post-shrink losses equal, bitwise, "
               f"a fresh 2-rank run restored from step {step} "
               f"({losses} vs {out['losses']})", failures)
    return out


def run_worker_replay(args) -> dict:
    """One rank of the fresh 2-rank replay: epoch 1's group at world 2,
    the workload rescaled to it, `elastic_restore` of the survivors'
    checkpoint from a per-rank copy, then the same attempts' batches."""
    import shutil

    import torch.distributed as dist

    from dear_pytorch_tpu_torch.resilience.membership import MembershipView
    from dear_pytorch_tpu_torch.utils import checkpoint as ckpt

    spec = json.loads(os.environ["DEAR_CHAOS_REPLAY"])
    rank = int(os.environ["DEAR_ELASTIC_RANK"])
    _redirect_output(args.workdir, rank)
    _solo_group(rank, args.device)
    tuner, batch_at = _tuner(args, args.device)
    view = MembershipView(epoch=1, members=(0, 1), rank=rank, index=rank,
                          world=2)
    store = dist.FileStore(os.path.join(args.workdir, "store"), -1)
    tuner.rescale(view, store=store)
    ts = tuner.ts
    mine = os.path.join(args.workdir, f"rank{rank}")
    os.makedirs(mine, exist_ok=True)
    step = int(spec["step"])
    shutil.copytree(os.path.join(spec["src"], f"step_{step:010d}"),
                    os.path.join(mine, f"step_{step:010d}"))
    shutil.copy(os.path.join(spec["src"], f"meta_{step:010d}.json"), mine)
    state = ckpt.elastic_restore(mine, ts, step=step)
    losses = []
    for i in range(int(spec["first"]), int(spec["first"]) + int(spec["n"])):
        state, m = ts.step(state, batch_at(i, rank, 2))
        losses.append(float(m["loss"]))
    out = {"losses": losses,
           "same_groups": [list(b.leaf_ids) for b in ts.plan.buckets]
           == spec["groups"]}
    _write_json(os.path.join(args.workdir, f"replay_rank{rank}.json"), out)
    _release(tuner)
    return out


# -- the autoscale drill ------------------------------------------------------


def _newest_remote_store(remote_root: str, *, skip_rank=None):
    """The replica store holding the newest committed upload (states are
    replica-identical across ranks, so any store hydrates any rank)."""
    from dear_pytorch_tpu_torch.utils import checkpoint as ckpt
    from dear_pytorch_tpu_torch.utils.objectstore import LocalObjectStore

    best, best_step = None, -1
    try:
        names = sorted(os.listdir(remote_root))
    except OSError:
        return None, None
    for name in names:
        if skip_rank is not None and name == f"rank{skip_rank}":
            continue
        store = LocalObjectStore(os.path.join(remote_root, name))
        steps = ckpt.remote_steps(store)
        if steps and steps[0] > best_step:
            best, best_step = store, steps[0]
    return best, (best_step if best is not None else None)


def run_worker_autoscale(args) -> dict:
    """One rank of the autoscale drill (JAX :1241-1368): the elastic
    worker plus a `PreemptionHandler` with the spot grace window (a
    drain's SIGTERM becomes an emergency save and a planned shrink), a
    `CheckpointStreamer` uploading every committed checkpoint to this
    rank's object store, and hydration from a fleet replica's remote tier
    for a rank with no newer local checkpoint."""
    os.environ["DEAR_CKPT_SHARED"] = "0"
    import importlib

    from dear_pytorch_tpu_torch.observability import tracer as T
    from dear_pytorch_tpu_torch.resilience import PreemptionHandler
    from dear_pytorch_tpu_torch.resilience import membership as M
    from dear_pytorch_tpu_torch.utils import checkpoint as ckpt
    from dear_pytorch_tpu_torch.utils.guard import GuardedTrainer
    from dear_pytorch_tpu_torch.utils.objectstore import LocalObjectStore

    EH = importlib.import_module(
        "dear_pytorch_tpu_torch.scripts.elastic_harness")
    workdir = args.workdir
    cluster = M.ElasticCluster.from_env(max_candidates=256)
    rejoining = M.ElasticCluster.rejoining_by_env()
    rank = cluster.rank
    _redirect_output(workdir, rank)
    kr, ke, kx = os.environ["DEAR_CHAOS_AUTO_KILL"].split(":")
    kill = (int(kr), int(ke), int(kx))
    target_epoch = int(os.environ.get("DEAR_CHAOS_AUTO_EPOCHS", "5"))
    post = int(os.environ.get("DEAR_CHAOS_AUTO_POST", "3"))
    remote_root = os.environ["DEAR_CHAOS_REMOTE"]
    ckpt_dir = os.path.join(workdir, f"rank{rank}", "ckpts")
    tracer = T.get_tracer()

    _start_group(cluster, rejoining, args.device)
    tuner, batch_at = _tuner(args, args.device)
    pipe = _pipeline(cluster)
    store = LocalObjectStore(os.path.join(remote_root, f"rank{rank}"))
    streamer = ckpt.CheckpointStreamer(
        ckpt_dir, store, upload_every=1, pin_last=4)
    pre = PreemptionHandler().install()
    guard = GuardedTrainer(
        tuner.ts, ckpt_dir, check_every=1,
        checkpoint_every=args.checkpoint_every, max_keep=1000,
        max_recoveries=8, coordinator=cluster, pipeline=pipe,
        preemption=pre, streamer=streamer)
    tl = _Timeline(cluster, guard)
    guard.on_membership_change = tl.hook(EH.attach_elastic(guard, tuner))
    rollback_steps = []

    def on_rollback(c, at):
        rollback_steps.append(at)
        tl.on_rollback(c, at)

    guard.on_rollback = on_rollback
    resumed_at = last_epoch = None
    if rejoining:
        hydrate, _ = _newest_remote_store(remote_root, skip_rank=rank)
        tl.last_step = None
        state, resumed_at, last_epoch = EH.reenter(
            cluster, tuner, guard, ckpt_dir, hydrate_store=hydrate)
        tl.last_step = resumed_at
    else:
        state = tuner.init()
    state, m = EH.run_autoscale_loop(
        cluster, _Guarded(guard, tl), pipe, state,
        lambda i: batch_at(i, cluster.index, cluster.world),
        rejoining=rejoining, target_epoch=target_epoch, post=post,
        kill=kill, deadline_s=args.deadline)
    drained = bool(m.get("preempted"))
    streamer.flush(20.0)
    streamer.close()
    verdict = {
        "rank": rank,
        "pid": os.getpid(),
        "rejoined": bool(rejoining),
        "scale_up_join": bool(cluster.joining),
        "drained": drained,
        "grace_remaining": pre.remaining(),
        "epoch": cluster.epoch,
        "members": list(cluster.members),
        "resumed_at": resumed_at,
        "rollback_steps": rollback_steps,
        "final_step": int(state.step),
        "final_loss": float(m.get("loss", float("nan"))),
        "steps_seen": guard.steps_seen,
        "plan_world": guard.ts.plan.world,
        "plan_epoch": guard.ts.plan.epoch,
        "pipe_shard": [pipe.shard, pipe.num_shards],
        "uploaded": sorted(streamer.uploaded),
        "upload_failed": sorted(streamer.failed),
        "counters": _final_counters(tracer),
        "rows": tl.rows,
        "transitions": tl.transitions,
    }
    if not drained:
        # a drained rank exits OUTSIDE the lockstep and skips it
        views = cluster.exchange("chaos.verdict", json.dumps(
            [verdict["final_step"], round(verdict["final_loss"], 9),
             verdict["epoch"]]))
        verdict["lockstep"] = all(
            json.loads(v) == json.loads(views[0]) for v in views)
    else:   # its peers left the group: nothing of it is waited on
        tuner.ts.abandon()
    _release(tuner)
    path = os.path.join(workdir, f"verdict_rank{rank}.{os.getpid()}.json")
    _write_json(path, verdict)
    print(f"CHAOS_AUTO rank={rank} " + json.dumps(
        {k: v for k, v in verdict.items() if k != "rows"}), flush=True)
    return verdict


def run_cold_start(args) -> dict:
    """Scale-from-zero restore gate (JAX :1370-1448): with NO local
    checkpoint, restore from the remote tier alone (sha256-reverified),
    land exactly on the newest uploaded step, and train one live step on
    it (a one-rank group at the uploaded plan's epoch)."""
    import numpy as np

    from dear_pytorch_tpu_torch.observability import tracer as T
    from dear_pytorch_tpu_torch.utils import checkpoint as ckpt

    failures: list = []
    remote_root = os.environ["DEAR_CHAOS_REMOTE"]
    store, newest = _newest_remote_store(remote_root)
    _check(store is not None, "a remote tier with uploads exists", failures)
    local = os.path.join(args.workdir, "cold", "ckpts")
    step = ckpt.restore_from_object_store(store, local)
    _check(step == newest,
           f"cold start restored the NEWEST uploaded step ({newest}); "
           f"got {step}", failures)
    _check(step is not None and ckpt.verify_checkpoint(local, step),
           "downloaded checkpoint passes local checksum verification",
           failures)
    meta = ckpt.read_sidecar(local, step) or {}
    desc = meta.get("plan_desc") or {}
    world = int(desc.get("world", 1))
    epoch = int(desc.get("epoch", 0))
    _check(ckpt.read_pipeline_state(local, step) is not None,
           "the remote sidecar carries the pipeline position", failures)
    _solo_group(0, args.device)
    tuner, batch_at = _tuner(args, args.device)
    tuner.init()
    # one rank restores a per-host blob of any world: the plan is this
    # process's (world 1), the checkpoint's layout comes from its sidecar
    state = ckpt.elastic_restore(local, tuner.ts, step=step)
    _check(int(state.step) == step,
           "restored state sits exactly at the uploaded step "
           "(zero loss of progress past the remote tier)", failures)
    state, m = tuner.ts.step(state, batch_at(999, 0, 1))
    _check(np.isfinite(float(m["loss"])),
           "cold-started state trains a live step", failures)
    counters = T.get_tracer().counters()
    verdict = {
        "passed": not failures,
        "restored_step": step,
        "newest_uploaded": newest,
        "plan_world": world,
        "plan_epoch": epoch,
        "remote_restores": counters.get("ckpt.remote_restores", 0),
        "failures": failures,
    }
    _write_json(os.path.join(args.workdir, "cold_verdict.json"), verdict)
    print("CHAOS_COLD " + json.dumps(verdict), flush=True)
    _release(tuner)
    return verdict


def run_autoscale(args) -> dict:
    """Parent of the autoscale drill (JAX :1450-1676), jax-free: it
    watches the durable decision records to sequence its phases, as an
    external operator would. The JAX gate's steps-per-hour SLO (its
    ``scripts/bench_gate.py --slo``) is left out; steps per hour are
    reported."""
    import subprocess
    import tempfile

    from dear_pytorch_tpu_torch.resilience.scale import ScalePolicy

    workdir = args.workdir = args.workdir or tempfile.mkdtemp(
        prefix="dear_chaos_auto_")
    os.makedirs(workdir, exist_ok=True)
    elastic_dir = os.path.join(workdir, "elastic")
    remote_root = os.path.join(workdir, "remote")
    os.makedirs(remote_root, exist_ok=True)
    capacity = os.path.join(workdir, "capacity.json")
    write_capacity = CC.capacity_writer(capacity)
    write_capacity({"target_world": 2})
    sup_mod = CC.load_supervisor()

    kill_rank, drain_rank, target_epoch, post = 1, 0, 5, 3
    env = _supervisor_env(args, {
        "DEAR_CHAOS_AUTO_KILL": f"{kill_rank}:1:2",  # after the scale-up
        "DEAR_CHAOS_AUTO_EPOCHS": str(target_epoch),
        "DEAR_CHAOS_AUTO_POST": str(post),
        "DEAR_CHAOS_REMOTE": remote_root,
        "DEAR_PREEMPT_GRACE_S": "30"})
    policy = ScalePolicy(capacity_file=capacity, hysteresis_s=0.5,
                         max_world=3)
    sup = sup_mod.ElasticSupervisor(
        2, _worker_argv(args, "--autoscale"),
        elastic_dir=elastic_dir, env=env,
        max_relaunches=2, relaunch_window_s=120.0, policy=policy,
    ).start()

    decided = CC.decided_reader(elastic_dir)
    phase = [0]

    def _phases():
        if (phase[0] == 0
                and _newest_remote_store(remote_root)[0] is not None):
            # the fleet is streaming checkpoints: capacity-UP hint
            write_capacity({"target_world": 3})
            phase[0] = 1
        elif phase[0] == 1 and decided(3) is not None:
            # scale-up (e1), SIGKILL shrink (e2) and rejoin (e3) all
            # committed: now the spot-style drain of rank 0
            write_capacity({"target_world": 3, "drain": [drain_rank]})
            phase[0] = 2

    rc, elapsed_s = CC.run_fleet(sup, deadline_s=args.deadline + 120,
                                 on_poll=_phases)

    failures: list = []
    _check(rc == 0, f"supervisor fleet exits clean (got rc={rc})", failures)
    _check(sup.relaunches.get(kill_rank) == 1,
           f"the SIGKILLed rank was relaunched once within its window "
           f"budget ({sup.relaunches})", failures)
    kinds = [d.kind for d in policy.decisions]
    _check(kinds.count("scale_up") >= 2 and "drain" in kinds,
           f"policy decided capacity-up, drain, and backfill ({kinds})",
           failures)
    _check(("drained", drain_rank) in sup.events,
           f"rank {drain_rank} drained CLEANLY on SIGTERM "
           f"(events {sup.events})", failures)
    expect_delta = {
        1: {"added": [2], "removed": []},
        2: {"added": [], "removed": [kill_rank]},
        3: {"added": [kill_rank], "removed": []},
        4: {"added": [], "removed": [drain_rank]},
        5: {"added": [drain_rank], "removed": []},
    }
    for e, want in expect_delta.items():
        rec = decided(e)
        _check(isinstance(rec, dict) and rec.get("delta") == want,
               f"decision record e{e} carries the signed delta {want} "
               f"(got {rec})", failures)
    rec5 = decided(5)
    _check(isinstance(rec5, dict) and rec5.get("members") == [0, 1, 2],
           f"epoch-5 record commits the full world ({rec5})", failures)

    lives, finals = CC.collect_verdicts(workdir)
    summary = {"passed": False, "workdir": workdir, "rc": rc,
               "elapsed_s": elapsed_s, "policy_decisions": kinds,
               "finals": finals, "lives": lives, "failures": failures}
    if sorted(finals) != [0, 1, 2]:
        failures.append(f"expected final verdicts from ranks 0-2, got "
                        f"{sorted(finals)}")
        summary["logs"] = _logs_tail(workdir)
        return summary
    for r, v in sorted(finals.items()):
        _check(v["epoch"] == target_epoch and v["members"] == [0, 1, 2],
               f"rank {r} ends at epoch {target_epoch}, full membership "
               f"(epoch {v['epoch']}, members {v['members']})", failures)
        _check(v.get("lockstep"), f"rank {r} finished in lockstep",
               failures)
        _check(v["plan_world"] == 3 and v["plan_epoch"] == target_epoch,
               f"rank {r} trains the rescaled epoch-stamped plan "
               f"(world {v['plan_world']}, epoch {v['plan_epoch']})",
               failures)
        _check(v["pipe_shard"][1] == 3,
               f"rank {r} pipeline resharded over the full membership",
               failures)
        _check(bool(v["uploaded"]) and not v["upload_failed"],
               f"rank {r} streamed checkpoints to its remote tier "
               f"({v['uploaded']}, failed {v['upload_failed']})", failures)
    merged: dict = {}
    for vs in lives.values():
        for v in vs:
            _check_steps_lost(v, failures)
            for k, n in v.get("counters", {}).items():
                merged[k] = merged.get(k, 0) + n
    _check(merged.get("cluster.scale_ups", 0) >= 1,
           f"a scale-UP admission was counted (cluster.scale_ups="
           f"{merged.get('cluster.scale_ups', 0)})", failures)
    _check(merged.get("cluster.reconfigs", 0) >= 2,
           "both shrinks (SIGKILL + planned drain) committed", failures)
    _check(merged.get("cluster.rejoins", 0) >= 3,
           "scale-up, relaunch, and backfill admissions all counted",
           failures)
    _check(merged.get("ckpt.uploads", 0) >= 3,
           f"checkpoint streaming uploaded throughout "
           f"(ckpt.uploads={merged.get('ckpt.uploads', 0)})", failures)
    fresh_life = [v for vs in lives.values() for v in vs
                  if v.get("scale_up_join")]
    _check(bool(fresh_life),
           "the brand-new rank hydrated from the remote tier and joined "
           "with no sidecar epoch", failures)
    drained_life = [v for vs in lives.values() for v in vs
                    if v.get("drained")]
    _check(len(drained_life) == 1
           and drained_life[0]["rank"] == drain_rank
           and (drained_life[0]["grace_remaining"] or 0) > 0,
           "exactly the drained rank exited via the planned-shrink path "
           "inside its grace window", failures)
    _, newest_uploaded = _newest_remote_store(remote_root)
    final_step = finals[0]["final_step"]
    _check(newest_uploaded is not None and final_step >= newest_uploaded,
           f"final step {final_step} >= newest uploaded checkpoint "
           f"{newest_uploaded} (zero loss past the remote tier)", failures)
    steps_per_hour = final_step * 3600.0 / max(elapsed_s, 1e-9)

    cold = subprocess.run(
        _worker_argv(args, "--cold-start"), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=max(args.deadline, 120))
    _check(cold.returncode == 0,
           f"cold-start worker exits 0: {cold.stdout[-1500:]}", failures)
    cold_verdict = {}
    try:
        with open(os.path.join(workdir, "cold_verdict.json")) as f:
            cold_verdict = json.load(f)
    except (OSError, ValueError):
        failures.append("cold-start worker wrote no verdict")
    _check(bool(cold_verdict.get("passed")),
           f"cold-start restore from the remote tier alone "
           f"({cold_verdict.get('failures')})", failures)
    summary.update({
        "passed": not failures,
        "steps_per_hour": steps_per_hour,
        "newest_uploaded": newest_uploaded,
        "cold": cold_verdict,
        "merged_counters": {k: v for k, v in sorted(merged.items())
                            if k.startswith(("cluster.", "ckpt."))},
        "failures": failures,
    })
    if failures:
        summary["logs"] = _logs_tail(workdir)
    return summary


# -- the multi-slice drills ------------------------------------------------------

#: the multi-slice fleet: 2 slices x 2 ranks (module docstring)
_NSLICES, _RPS = 2, 2


def _slice_group(cluster, rank: int, device, rejoining: bool):
    """The worker's first groups, with its slice's group: a first-launch
    member forms epoch 0's; a relaunched rank forms a one-rank group (and
    a one-rank slice group of its own slice) until its admission."""
    import torch.distributed as dist

    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.resilience.membership import MembershipView

    if not rejoining:
        return backend.regroup(cluster.view(), device=device)
    sid = cluster.slice_of(rank)
    solo = MembershipView(epoch=-1, members=(rank,), rank=rank, index=0,
                          world=1, slices=(sid,), slice_id=sid)
    return backend.regroup(solo, device=device, store=dist.HashStore())


def _fit_dcn(dcn):
    from dear_pytorch_tpu_torch.observability import costmodel as CMOD

    try:
        return list(CMOD.fit_dcn(dcn.samples()))
    except ValueError:
        return None


def run_worker_multislice(args) -> dict:
    """One rank of the multi-slice drills (JAX :1677-1899): a 2-slice x
    2-rank fleet where every rank trains the hierarchical schedule — the
    per-bucket reduce-scatter and gathers over its slice's process group
    (`comm.backend.slice_group`), the cross-slice mean over a shared
    `FileTransport` DCN exchanger between the backward and the update
    (`comm.dcn`). Membership is slice-granular
    (``DEAR_ELASTIC_RANKS_PER_SLICE``); the live slices shard the data,
    and the ranks of a slice split their slice's rows.
    ``DEAR_CHAOS_MULTI_MODE``: ``kill`` (the victim slice SIGKILLs its
    ranks at one attempt; the survivors shrink, train degraded and
    readmit it), ``flap`` (a fixed-step bounded-staleness run under a
    sub-budget ``dcn_flap``: no rollback at all) or ``partition`` (a
    past-budget ``dcn_partition`` makes the victim slice evict itself,
    exit 70 and rejoin; its relaunch strips the outage fault)."""
    os.environ["DEAR_CKPT_SHARED"] = "0"
    import importlib

    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.comm.dcn import DcnExchanger, DcnSelfEvict
    from dear_pytorch_tpu_torch.observability import tracer as T
    from dear_pytorch_tpu_torch.resilience import membership as M
    from dear_pytorch_tpu_torch.resilience.cluster import FileTransport
    from dear_pytorch_tpu_torch.resilience.inject import (
        FaultInjector, parse_faults)
    from dear_pytorch_tpu_torch.runtime import build as RB
    from dear_pytorch_tpu_torch.runtime import pipeline as P
    from dear_pytorch_tpu_torch.utils import checkpoint as ckpt
    from dear_pytorch_tpu_torch.utils.guard import GuardedTrainer
    from dear_pytorch_tpu_torch.utils.objectstore import LocalObjectStore

    EH = importlib.import_module(
        "dear_pytorch_tpu_torch.scripts.elastic_harness")
    workdir = args.workdir
    cluster = M.ElasticCluster.from_env(max_candidates=256)
    rejoining = M.ElasticCluster.rejoining_by_env()
    rank, my_slice = cluster.rank, cluster.slice_of(cluster.rank)
    _redirect_output(workdir, rank)
    mode = os.environ.get("DEAR_CHAOS_MULTI_MODE", "kill")
    if mode == "kill":
        ks, ka = os.environ["DEAR_CHAOS_MULTI_KILL"].split(":")
        kill_slice, kill_at = int(ks), int(ka)
    else:
        kill_slice, kill_at = -1, 1
    target_epoch = int(os.environ.get("DEAR_CHAOS_MULTI_EPOCHS", "2"))
    post = int(os.environ.get("DEAR_CHAOS_MULTI_POST", "3"))
    remote_root = os.environ["DEAR_CHAOS_REMOTE"]
    ckpt_dir = os.path.join(workdir, f"rank{rank}", "ckpts")
    tracer = T.get_tracer()

    faults_spec = os.environ.get("DEAR_FAULTS", "").strip()
    if rejoining and faults_spec:
        # a relaunched life must not re-arm the one-shot outage that
        # evicted it
        faults_spec = ",".join(
            f for f in faults_spec.split(",")
            if f.split("@", 1)[0] not in ("dcn_flap", "dcn_partition"))
    injector = (FaultInjector(parse_faults(faults_spec), own_rank=rank,
                              own_slice=my_slice) if faults_spec else None)
    # a rejoiner's exchanger starts at the INITIAL view; admission hands
    # it the committed slice set through AutoTuner.rescale (reenter)
    dcn = DcnExchanger(FileTransport(os.path.join(workdir, "dcn")),
                       local_slices=(my_slice,), slices=cluster.slices,
                       partition_mb=0.0005, injector=injector)
    _slice_group(cluster, rank, args.device, rejoining)
    tuner, batch_rows = _tuner(args, args.device, dcn=dcn)
    view0 = cluster.view()
    spec = P.SyntheticSpec((
        P.Field("x", (_ROWS, 12), RB.KIND_NORMAL_F32, 0.0, 1.0),))
    pipe = P.NumpyPipeline(spec, seed=123, shard=view0.data_shard,
                           num_shards=view0.data_world)
    store = LocalObjectStore(os.path.join(remote_root, f"rank{rank}"))
    streamer = ckpt.CheckpointStreamer(ckpt_dir, store, upload_every=1,
                                       pin_last=4)
    guard = GuardedTrainer(
        tuner.ts, ckpt_dir, check_every=1,
        checkpoint_every=args.checkpoint_every, max_keep=1000,
        max_recoveries=12, coordinator=cluster, pipeline=pipe,
        streamer=streamer)
    tl = _Timeline(cluster, guard)
    base_hook = EH.attach_elastic(guard, tuner)
    transitions = []

    def on_change(view):
        base_hook(view)
        transitions.append({"epoch": view.epoch, "slices": list(view.slices),
                            "steps_seen": guard.steps_seen})

    guard.on_membership_change = tl.hook(on_change)
    rollback_steps = []

    def on_rollback(c, at):
        rollback_steps.append(at)
        tl.on_rollback(c, at)

    guard.on_rollback = on_rollback

    def batch_at(i):
        # the GLOBAL batch, sliced to the CURRENT live slices: this
        # slice's rows, split over its ranks; one live slice trains the
        # whole batch
        view, ts = cluster.view(), guard.ts
        return batch_rows(i, view.data_shard * ts.world + ts.rank,
                          max(view.data_world, 1) * ts.world)

    resumed_at = last_epoch = None
    if rejoining:
        hydrate, _ = _newest_remote_store(remote_root, skip_rank=rank)
        tl.last_step = None
        state, resumed_at, last_epoch = EH.reenter(
            cluster, tuner, guard, ckpt_dir, hydrate_store=hydrate)
        tl.last_step = resumed_at
    else:
        state = tuner.init()
    death = (os.path.join(workdir, f"death_rank{rank}.json")
             if my_slice == kill_slice and not rejoining else None)
    stepper = _Guarded(guard, tl, death)
    m = {}
    try:
        if mode == "flap":
            # fixed-step degraded-mode run: the sub-budget transient must
            # be absorbed by the ladder's skip rung, with no rollback
            steps = int(os.environ.get("DEAR_CHAOS_MULTI_STEPS", "12"))
            while guard.steps_seen < steps:
                i = guard.steps_seen
                pipe.next()
                state, m = stepper.step(state, batch_at(i))
        else:
            kill = ((rank, 0, kill_at - 1) if my_slice == kill_slice
                    else (-1, 0, 0))
            state, m = EH.run_autoscale_loop(
                cluster, stepper, pipe, state, batch_at,
                rejoining=rejoining, target_epoch=target_epoch, post=post,
                kill=kill, deadline_s=args.deadline)
    except DcnSelfEvict as exc:
        # rung 3, local side: this slice is the partitioned one. Flush what
        # is committed, leave a durable marker for the parent, release the
        # groups and exit nonzero so the supervisor relaunches this rank
        # through the slice-gated rejoin
        streamer.flush(20.0)
        streamer.close()
        doc = {"rank": rank, "slice": my_slice, "pid": os.getpid(),
               "steps_seen": guard.steps_seen, "reason": str(exc)}
        _write_json(os.path.join(
            workdir, f"selfevict_rank{rank}.{os.getpid()}.json"), doc)
        print(f"CHAOS_MULTI rank={rank} SELF-EVICT " + json.dumps(doc),
              flush=True)
        tuner.ts.abandon()
        _release(tuner)
        raise SystemExit(70)
    streamer.flush(20.0)
    streamer.close()
    counters = tracer.counters()
    verdict = {
        "rank": rank,
        "slice": my_slice,
        "pid": os.getpid(),
        "rejoined": bool(rejoining),
        "epoch": cluster.epoch,
        "members": list(cluster.members),
        "slices": list(cluster.slices),
        "transitions": transitions,
        "resumed_at": resumed_at,
        "last_epoch": last_epoch,
        "rollback_steps": rollback_steps,
        "final_step": int(state.step),
        "final_loss": float(m.get("loss", float("nan"))),
        "steps_seen": guard.steps_seen,
        "plan_world": guard.ts.plan.world,
        "plan_epoch": guard.ts.plan.epoch,
        "slice_group": [backend.slice_id(), backend.ici_index()],
        "pipe_shard": [pipe.shard, pipe.num_shards],
        "dcn_slices": list(dcn.slices),
        "dcn_samples": len(dcn.samples()),
        "dcn_fit": _fit_dcn(dcn),
        "dcn_times": guard.ts.dcn_times,
        "dcn_bytes": guard.ts.dcn_bytes,
        "uploaded": sorted(streamer.uploaded),
        "upload_failed": sorted(streamer.failed),
        "counters": {k: v for k, v in counters.items()
                     if k.startswith(("cluster.", "guard.", "pipeline.",
                                      "autotune.", "ckpt.", "dcn.",
                                      "faults.", "kernel."))},
        "rows": tl.rows,
        "timeline": tl.transitions,
    }
    # the lockstep verdict is itself a member-scoped collective
    views = cluster.exchange("chaos.verdict", json.dumps(
        [verdict["final_step"], round(verdict["final_loss"], 9),
         verdict["epoch"], verdict["slices"]]))
    verdict["lockstep"] = all(
        json.loads(v) == json.loads(views[0]) for v in views)
    _write_json(os.path.join(
        workdir, f"verdict_rank{rank}.{os.getpid()}.json"), verdict)
    print(f"CHAOS_MULTI rank={rank} " + json.dumps(
        {k: v for k, v in verdict.items() if k != "rows"}), flush=True)
    _release(tuner)
    return verdict


def _multislice_fleet(args, drill_env: dict, *, relaunches: int,
                      deadline_s: float):
    """Start the 2 x 2 supervised fleet of ``--multislice`` workers with
    ``drill_env``; returns ``(sup, decided, rc, elapsed_s, remote_root)``."""
    import tempfile

    workdir = args.workdir = args.workdir or tempfile.mkdtemp(
        prefix="dear_chaos_multi_")
    os.makedirs(workdir, exist_ok=True)
    elastic_dir = os.path.join(workdir, "elastic")
    remote_root = os.path.join(workdir, "remote")
    os.makedirs(remote_root, exist_ok=True)
    sup_mod = CC.load_supervisor()
    env = _supervisor_env(args, dict(drill_env, **{
        "DEAR_CHAOS_REMOTE": remote_root,
        "DEAR_LOCAL_SIZE": str(_NSLICES * _RPS)}))
    sup = sup_mod.ElasticSupervisor(
        _NSLICES * _RPS, _worker_argv(args, "--multislice"),
        elastic_dir=elastic_dir, env=env, max_relaunches=relaunches,
        relaunch_window_s=300.0, ranks_per_slice=_RPS).start()
    decided = CC.decided_reader(elastic_dir)
    rc, elapsed_s = CC.run_fleet(sup, deadline_s=deadline_s)
    return sup, decided, rc, elapsed_s, remote_root


def _dcn_timeout(args, frac: float) -> str:
    """The drill's ``DEAR_DCN_TIMEOUT_SECS``: a fraction of the peer
    timeout, so a dead slice fails the step (and hands recovery to the
    membership) well before the health sync gives up (JAX: 20 s of 45)."""
    peer = float(args.peer_timeout
                 or os.environ.get("DEAR_CLUSTER_TIMEOUT_SECS", "") or 30)
    return f"{frac * peer:g}"


def _multislice_summary(args, rc, elapsed_s, failures):
    lives, finals = CC.collect_verdicts(args.workdir)
    summary = {"passed": False, "workdir": args.workdir, "rc": rc,
               "elapsed_s": elapsed_s, "finals": finals,
               "failures": failures}
    n = _NSLICES * _RPS
    if sorted(finals) != list(range(n)):
        failures.append(f"expected final verdicts from ranks 0-{n - 1}, "
                        f"got {sorted(finals)}")
        summary["logs"] = _logs_tail(args.workdir)
    return summary, finals


def _check_updates(args, v: dict, failures: list) -> None:
    """Every completed step of a final life ran the shard update once per
    bucket: K5 epilogue launches on the card, its plain version on the
    CPU."""
    done = [w for w in v["rows"] if not w["rolled_back"]]
    key = "launches" if args.device == "cuda" else "updates"
    _check(all(w[key] == w["buckets"] for w in done),
           f"rank {v['rank']}: every completed step ran the shard update "
           f"once per bucket ({key}: {sum(w[key] for w in done)} over "
           f"{len(done)} steps, {sum(w['buckets'] for w in done)} buckets)",
           failures)


def _transition_story(args, finals: dict, victims: list) -> dict:
    """What the card's phase prints: per survivor the time from the
    victims' death (or their exit) to the shrink's commit, the degraded
    steps between the shrink and the readmission, the time between the
    two commits, the steps lost at each transition, the renorms, and the
    `fit_dcn` α-β from each rank's exchanger samples."""
    deaths = []
    for r in victims:
        path = os.path.join(args.workdir, f"death_rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                deaths.append(json.load(f)["t"])
    story = {}
    for r, v in sorted(finals.items()):
        tl = v.get("timeline") or []
        shrink = next((t for t in tl if t["kind"] == "shrink"), None)
        admit = next((t for t in tl if t["kind"] == "admit"), None)
        tr = v["transitions"]
        sh = next((t for t in tr if len(t["slices"]) == _NSLICES - 1), None)
        rj = next((t for t in tr if len(t["slices"]) == _NSLICES), None)
        story[r] = {
            "death_to_commit_s": (shrink["t_commit"] - max(deaths)
                                  if shrink and deaths else None),
            "degraded_steps": (rj["steps_seen"] - sh["steps_seen"]
                               if sh and rj else None),
            "readmit_s": (admit["t_commit"] - shrink["t_commit"]
                          if shrink and admit else None),
            "steps_lost": [t.get("steps_lost") for t in tl],
            "renorms": v["counters"].get("dcn.renorms", 0),
            "degraded_rounds": v["counters"].get("dcn.degraded_rounds", 0),
            "dcn_fit": v.get("dcn_fit"),
            "dcn_times": v.get("dcn_times"),
            "dcn_bytes": v.get("dcn_bytes"),
        }
    return story


def run_multislice(args) -> dict:
    """Parent of the multi-slice storm (JAX :1901-2089): a 2-slice x
    2-rank supervised fleet trains the hierarchical schedule while
    streaming checkpoints to per-rank object stores; the whole of slice 1
    SIGKILLs itself before attempt 5 and must commit as exactly ONE
    membership epoch (e1, ``slices.removed == [1]``); the surviving slice
    renormalizes the DCN leg and trains degraded under a slice-targeted
    ``dcn_slow`` straggler fault; the relaunches readmit as ONE epoch
    (e2, ``slices.added == [1]``) hydrated from the remote tier; the fleet
    finishes in lockstep with nothing lost past the newest upload. In the
    JAX drill each of its 2 x 4 ranks holds a whole 2-device slice; here a
    process drives one card, so the two ranks of a slice are its
    intra-slice peers (module docstring)."""
    kill_slice, kill_at, target_epoch, post = 1, 5, 2, 3
    victims = list(range(kill_slice * _RPS, (kill_slice + 1) * _RPS))
    sup, decided, rc, elapsed_s, remote_root = _multislice_fleet(args, {
        "DEAR_CHAOS_MULTI_KILL": f"{kill_slice}:{kill_at}",
        "DEAR_CHAOS_MULTI_EPOCHS": str(target_epoch),
        "DEAR_CHAOS_MULTI_POST": str(post),
        # the survivor slice gets an armed 30 ms DCN latency from its 6th
        # exchange on: degraded and post-rejoin training absorb it
        "DEAR_FAULTS": "dcn_slow@6:0.03:s0",
        "DEAR_DCN_TIMEOUT_SECS": _dcn_timeout(args, 0.45)},
        relaunches=1, deadline_s=args.deadline + 120)
    failures: list = []
    _check(rc == 0, f"supervisor fleet exits clean (got rc={rc})", failures)
    _check(all(sup.relaunches.get(r, 0) == 1 for r in victims)
           and all(sup.relaunches.get(r, 0) == 0 for r in range(_RPS)),
           f"exactly the killed slice's ranks were relaunched "
           f"({sup.relaunches})", failures)
    rec1, rec2, rec3 = decided(1), decided(2), decided(3)
    _check(isinstance(rec1, dict)
           and rec1.get("delta", {}).get("removed") == victims
           and rec1.get("delta", {}).get("slices")
           == {"added": [], "removed": [kill_slice]},
           f"e1 commits the WHOLE slice loss as one membership event "
           f"(got {rec1})", failures)
    _check(isinstance(rec2, dict)
           and rec2.get("delta", {}).get("added") == victims
           and rec2.get("delta", {}).get("slices")
           == {"added": [kill_slice], "removed": []}
           and rec2.get("members") == list(range(_NSLICES * _RPS)),
           f"e2 readmits the relaunched slice as one epoch at full "
           f"membership (got {rec2})", failures)
    _check(rec3 is None, f"no spurious membership epochs past "
           f"e{target_epoch} (e3 = {rec3})", failures)
    summary, finals = _multislice_summary(args, rc, elapsed_s, failures)
    if summary.get("logs"):
        return summary
    expect_restore = (kill_at - 1) - (kill_at - 1) % args.checkpoint_every
    for r, v in sorted(finals.items()):
        _check(v["epoch"] == target_epoch
               and v["members"] == list(range(_NSLICES * _RPS))
               and v["slices"] == [0, 1],
               f"rank {r} ends at epoch {target_epoch}, both slices live "
               f"(epoch {v['epoch']}, slices {v['slices']})", failures)
        _check(v.get("lockstep"), f"rank {r} finished in lockstep",
               failures)
        _check(v["plan_world"] == _RPS and v["plan_epoch"] == target_epoch,
               f"rank {r}'s plan keeps the FIXED intra-slice world and the "
               f"committed epoch (world {v['plan_world']}, epoch "
               f"{v['plan_epoch']})", failures)
        _check(v["pipe_shard"][1] == _NSLICES
               and v["pipe_shard"][0] == v["slice"],
               f"rank {r} pipeline sharded at SLICE granularity "
               f"({v['pipe_shard']})", failures)
        _check(v["slice_group"] == [v["slice"], r % _RPS],
               f"rank {r} ends in its slice's group at its position "
               f"({v['slice_group']})", failures)
        _check(v["dcn_slices"] == [0, 1],
               f"rank {r}'s DCN leg ends renormalized to both slices "
               f"({v['dcn_slices']})", failures)
        _check(v["counters"].get("dcn.exchanges", 0) > 0,
               f"rank {r} exchanged gradients over the DCN leg", failures)
        _check(bool(v["uploaded"]) and not v["upload_failed"],
               f"rank {r} streamed checkpoints to its remote tier "
               f"({v['uploaded']}, failed {v['upload_failed']})", failures)
        _check(all((t.get("steps_lost") or 0) >= 0
                   for t in v.get("timeline") or []),
               f"rank {r}: no transition restored it past the step it held",
               failures)
        _check_updates(args, v, failures)
    survivors = [v for r, v in finals.items() if r not in victims]
    for v in survivors:
        c = v["counters"]
        _check(c.get("cluster.slice_losses", 0) == 1
               and c.get("cluster.slice_rejoins", 0) == 1
               and c.get("cluster.reconfigs", 0) == 1,
               f"rank {v['rank']} saw exactly one slice loss and one slice "
               f"rejoin ({c})", failures)
        _check(c.get("dcn.renorms", 0) >= 2,
               f"rank {v['rank']} renormalized the DCN leg at both "
               f"transitions (dcn.renorms={c.get('dcn.renorms', 0)})",
               failures)
        _check(bool(v["rollback_steps"])
               and min(v["rollback_steps"]) >= expect_restore,
               f"rank {v['rank']} rollbacks never went past the newest "
               f"common checkpoint {expect_restore} ({v['rollback_steps']})",
               failures)
        shrink = [t for t in v["transitions"]
                  if t["slices"] == [1 - kill_slice]]
        rejoin = [t for t in v["transitions"] if t["slices"] == [0, 1]]
        _check(bool(shrink) and bool(rejoin)
               and rejoin[0]["steps_seen"] > shrink[0]["steps_seen"],
               f"rank {v['rank']} trained DEGRADED on the surviving slice "
               f"between shrink and rejoin ({v['transitions']})", failures)
    rejoined = [v for r, v in finals.items() if r in victims]
    _check(all(v["rejoined"] for v in rejoined),
           "every relaunched rank of the lost slice came back through "
           "rejoin", failures)
    slow_fired = sum(v["counters"].get("faults.injected", 0)
                     for v in survivors)
    _check(slow_fired == _RPS,
           f"dcn_slow fired on every surviving-slice rank "
           f"(faults.injected={slow_fired}, want {_RPS})", failures)
    _, newest_uploaded = _newest_remote_store(remote_root)
    final_step = finals[0]["final_step"]
    _check(newest_uploaded is not None and final_step >= newest_uploaded,
           f"final step {final_step} >= newest uploaded checkpoint "
           f"{newest_uploaded} (zero loss past the remote tier)", failures)
    summary.update({"passed": not failures, "newest_uploaded":
                    newest_uploaded, "story": _transition_story(
                        args, finals, victims), "failures": failures})
    if failures:
        summary["logs"] = _logs_tail(args.workdir)
    return summary


def run_multislice_flap(args) -> dict:
    """Parent of the DCN flap storm (JAX :2091-2235): the 2 x 2 fleet
    trains 12 steps in bounded-staleness mode (``DEAR_DCN_STALENESS=2``)
    while a sub-budget ``dcn_flap`` suppresses slice 1's publishes on
    alternating exchanges and a ``dcn_slow`` straggler drags slice 0. The
    gate: zero guard rollbacks on every rank, zero membership epochs and
    relaunches, the ladder engaged (skips and degraded rounds everywhere,
    the flapped slice's residual carried, no escalation), lockstep at the
    exact step target. JAX's steps-per-hour SLO (its
    ``scripts/bench_gate.py --slo``) is left out; steps per hour are
    reported."""
    steps, flap_slice = 12, 1
    sup, decided, rc, elapsed_s, _ = _multislice_fleet(args, {
        "DEAR_CHAOS_MULTI_MODE": "flap",
        "DEAR_CHAOS_MULTI_STEPS": str(steps),
        "DEAR_FAULTS": (f"dcn_flap@4:2:s{flap_slice},"
                        f"dcn_slow@8:0.03:s{1 - flap_slice}"),
        "DEAR_DCN_STALENESS": "2",
        "DEAR_DCN_RETRIES": "1",
        "DEAR_DCN_TIMEOUT_SECS": "3"},
        relaunches=0, deadline_s=args.deadline + 60)
    failures: list = []
    _check(rc == 0, f"supervisor fleet exits clean (got rc={rc})", failures)
    _check(all(n == 0 for n in sup.relaunches.values()),
           f"no rank was relaunched under the sub-budget flap "
           f"({sup.relaunches})", failures)
    _check(decided(1) is None,
           f"zero membership epochs: a sub-budget transient never reaches "
           f"the eviction rung (e1 = {decided(1)})", failures)
    summary, finals = _multislice_summary(args, rc, elapsed_s, failures)
    if summary.get("logs"):
        return summary
    for r, v in sorted(finals.items()):
        c = v["counters"]
        _check(c.get("guard.rollbacks", 0) == 0 and not v["rollback_steps"],
               f"rank {r}: ZERO guard rollbacks under the sub-budget flap "
               f"(rollbacks={c.get('guard.rollbacks', 0)}, "
               f"steps={v['rollback_steps']})", failures)
        _check(v["steps_seen"] == steps and v["final_step"] == steps,
               f"rank {r} finished the exact step target "
               f"({v['steps_seen']}/{steps})", failures)
        _check(v.get("lockstep"), f"rank {r} finished in lockstep",
               failures)
        _check(not v["transitions"],
               f"rank {r} saw no membership transitions "
               f"({v['transitions']})", failures)
        _check(c.get("dcn.degraded_rounds", 0) > 0
               and c.get("dcn.skips", 0) >= 1,
               f"rank {r} trained through degraded rounds by SKIPPING the "
               f"absent slice (degraded_rounds="
               f"{c.get('dcn.degraded_rounds', 0)}, "
               f"skips={c.get('dcn.skips', 0)})", failures)
        _check(c.get("dcn.escalations", 0) == 0
               and c.get("dcn.self_evicts", 0) == 0,
               f"rank {r}: the ladder never escalated a SUB-budget "
               f"transient ({c})", failures)
        _check_updates(args, v, failures)
    flapped = [v for v in finals.values() if v["slice"] == flap_slice]
    _check(all(v["counters"].get("dcn.residual_carries", 0) >= 1
               for v in flapped),
           "the flapped slice carried its unmerged partial as an "
           "error-feedback residual on every rank", failures)
    flap_fired = sum(v["counters"].get("faults.injected", 0)
                     for v in flapped)
    _check(flap_fired >= _RPS,
           f"dcn_flap armed on every flapped-slice rank "
           f"(faults.injected={flap_fired}, want >= {_RPS})", failures)
    final_step = finals[0]["final_step"]
    summary.update({
        "passed": not failures,
        "steps_per_hour": final_step * 3600.0 / max(elapsed_s, 1e-9),
        "story": _transition_story(args, finals, []),
        "failures": failures})
    if failures:
        summary["logs"] = _logs_tail(args.workdir)
    return summary


def run_multislice_degraded(args) -> dict:
    """Parent of the sustained-partition storm (JAX :2237-2399): the 2 x 2
    fleet trains in bounded-staleness mode while a ``dcn_partition`` far
    past the staleness budget starves slice 1. No SIGKILL: the victim's
    own staleness clock trips ``DcnSelfEvict``, its ranks exit 70, the
    survivors escalate the silent peer, commit the shrink as ONE
    slice-shaped epoch, and the relaunches (which strip the partition
    fault) readmit as one epoch. The gate: the whole ladder walked (skip,
    escalate, self-evict, evict, rejoin), survivor rollbacks only at the
    two transitions."""
    part_slice, target_epoch, post = 1, 2, 3
    victims = list(range(part_slice * _RPS, (part_slice + 1) * _RPS))
    sup, decided, rc, elapsed_s, _ = _multislice_fleet(args, {
        "DEAR_CHAOS_MULTI_MODE": "partition",
        "DEAR_CHAOS_MULTI_EPOCHS": str(target_epoch),
        "DEAR_CHAOS_MULTI_POST": str(post),
        "DEAR_FAULTS": f"dcn_partition@3:600:s{part_slice}",
        "DEAR_DCN_STALENESS": "1",
        "DEAR_DCN_RETRIES": "1",
        "DEAR_DCN_TIMEOUT_SECS": "2"},
        relaunches=1, deadline_s=args.deadline + 120)
    failures: list = []
    _check(rc == 0, f"supervisor fleet exits clean (got rc={rc})", failures)
    _check(all(sup.relaunches.get(r, 0) == 1 for r in victims)
           and all(sup.relaunches.get(r, 0) == 0 for r in range(_RPS)),
           f"exactly the partitioned slice's ranks were relaunched "
           f"({sup.relaunches})", failures)
    evicts = []
    for name in sorted(os.listdir(args.workdir)):
        if name.startswith("selfevict_rank") and name.endswith(".json"):
            with open(os.path.join(args.workdir, name)) as f:
                evicts.append(json.load(f))
    _check(sorted(e["rank"] for e in evicts) == victims
           and all(e["slice"] == part_slice for e in evicts),
           f"every rank of the partitioned slice exited through "
           f"DcnSelfEvict, nobody else did ({evicts})", failures)
    rec1, rec2, rec3 = decided(1), decided(2), decided(3)
    _check(isinstance(rec1, dict)
           and rec1.get("delta", {}).get("removed") == victims
           and rec1.get("delta", {}).get("slices")
           == {"added": [], "removed": [part_slice]},
           f"e1 commits the self-evicted slice as one membership event "
           f"(got {rec1})", failures)
    _check(isinstance(rec2, dict)
           and rec2.get("delta", {}).get("added") == victims
           and rec2.get("delta", {}).get("slices")
           == {"added": [part_slice], "removed": []}
           and rec2.get("members") == list(range(_NSLICES * _RPS)),
           f"e2 readmits the relaunched slice as one epoch at full "
           f"membership (got {rec2})", failures)
    _check(rec3 is None, f"no spurious membership epochs past "
           f"e{target_epoch} (e3 = {rec3})", failures)
    summary, finals = _multislice_summary(args, rc, elapsed_s, failures)
    if summary.get("logs"):
        return summary
    for r, v in sorted(finals.items()):
        _check(v["epoch"] == target_epoch
               and v["members"] == list(range(_NSLICES * _RPS))
               and v["slices"] == [0, 1],
               f"rank {r} ends at epoch {target_epoch}, both slices live "
               f"(epoch {v['epoch']}, slices {v['slices']})", failures)
        _check(v.get("lockstep"), f"rank {r} finished in lockstep",
               failures)
        _check(v["dcn_slices"] == [0, 1],
               f"rank {r}'s DCN leg ends renormalized to both slices "
               f"({v['dcn_slices']})", failures)
    survivors = [v for r, v in finals.items() if r not in victims]
    for v in survivors:
        c = v["counters"]
        _check(c.get("dcn.skips", 0) >= 1
               and c.get("dcn.degraded_rounds", 0) >= 1,
               f"rank {v['rank']} first SKIPPED the starved slice "
               f"(skips={c.get('dcn.skips', 0)})", failures)
        _check(c.get("dcn.escalations", 0) >= 1,
               f"rank {v['rank']} escalated the past-budget peer "
               f"(dcn.escalations={c.get('dcn.escalations', 0)})", failures)
        _check(c.get("cluster.slice_losses", 0) == 1
               and c.get("cluster.slice_rejoins", 0) == 1,
               f"rank {v['rank']} saw exactly one slice loss and one slice "
               f"rejoin ({c})", failures)
        _check(len(v["rollback_steps"]) <= 2,
               f"rank {v['rank']}: rollbacks ONLY at the membership "
               f"transitions, never for the transient itself "
               f"({v['rollback_steps']})", failures)
        shrink = [t for t in v["transitions"]
                  if t["slices"] == [1 - part_slice]]
        rejoin = [t for t in v["transitions"] if t["slices"] == [0, 1]]
        _check(bool(shrink) and bool(rejoin)
               and rejoin[0]["steps_seen"] > shrink[0]["steps_seen"],
               f"rank {v['rank']} trained DEGRADED between shrink and "
               f"rejoin ({v['transitions']})", failures)
    rejoined = [v for r, v in finals.items() if r in victims]
    _check(all(v["rejoined"] for v in rejoined),
           "every relaunched rank of the partitioned slice came back "
           "through rejoin", failures)
    _check(all(v["counters"].get("faults.injected", 0) == 0
               for v in rejoined),
           "the relaunched lives stripped the armed partition fault",
           failures)
    summary.update({"passed": not failures, "failures": failures})
    if failures:
        summary["logs"] = _logs_tail(args.workdir)
    return summary


# -- the command line ---------------------------------------------------------

#: the JAX script's other drills, and the ROADMAP item each waits for
_UNPORTED = {
    "serve": "11 (the rest of serving)",
    "online": "11 (online learning)",
    "sdc": "9a's SDC storm: tests/test_torch_resilience.py holds the vote",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="the port's elastic chaos drills (module docstring)")
    ap.add_argument("--elastic", action="store_true",
                    help="SIGKILL one rank of a 3-rank fleet mid-run; the "
                         "survivors commit a smaller epoch and keep "
                         "training, the relaunch rejoins")
    ap.add_argument("--autoscale", action="store_true",
                    help="capacity-up to 3 ranks, SIGKILL shrink + "
                         "relaunch, spot-drain shrink + backfill, then a "
                         "cold start from the remote checkpoint tier")
    ap.add_argument("--multislice", action="store_true",
                    help="2 slices x 2 ranks train the hierarchical "
                         "schedule; slice 1 dies, the survivors shrink, "
                         "train degraded and readmit it")
    ap.add_argument("--multislice-flap", action="store_true",
                    help="a sub-budget DCN flap under bounded staleness: "
                         "no rollback, no membership change")
    ap.add_argument("--multislice-degraded", action="store_true",
                    help="a past-budget DCN partition: the victim slice "
                         "evicts itself and rejoins")
    for name in _UNPORTED:
        ap.add_argument("--" + name.replace("_", "-"), action="store_true",
                        help=argparse.SUPPRESS)
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--workdir", type=str, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model", default="mlp",
                    choices=("mlp", "mnistnet", "gpt2"))
    ap.add_argument("--deadline", type=float, default=300.0,
                    help="each worker's training-loop deadline in seconds")
    ap.add_argument("--peer-timeout", type=float, default=None,
                    help="the ranks' DEAR_CLUSTER_TIMEOUT_SECS (default: "
                         "this process's, else 30)")
    ap.add_argument("--relaunch-delay", type=float, default=0.5,
                    help="--elastic: the supervisor's relaunch delay")
    ap.add_argument("--replay-shrink", action="store_true",
                    help="--elastic: delay the relaunch past the peer "
                         "timeout, then replay the survivors' world-2 "
                         "steps in a fresh 2-rank run restored from the "
                         "same checkpoint (losses held bitwise)")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)   # internal: one drill rank
    ap.add_argument("--replay", action="store_true",
                    help=argparse.SUPPRESS)   # internal: the fresh replay
    ap.add_argument("--cold-start", action="store_true",
                    help=argparse.SUPPRESS)   # internal: scale-from-zero
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for name, item in _UNPORTED.items():
        if getattr(args, name):
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported yet: ROADMAP "
                f"Queue 1 item {item}")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run "
                               "the drill on the CPU")
    multi = (args.multislice or args.multislice_flap
             or args.multislice_degraded)
    if args.worker:
        if multi:
            run_worker_multislice(args)
        elif args.replay:
            run_worker_replay(args)
        elif args.cold_start:
            return 0 if run_cold_start(args)["passed"] else 1
        elif args.autoscale:
            run_worker_autoscale(args)
        elif args.elastic:
            run_worker_elastic(args)
        return 0
    if args.autoscale:
        summary = run_autoscale(args)
        drop = ("finals", "lives", "logs")
    elif args.elastic:
        summary = run_elastic(args)
        drop = ("verdicts", "logs")
    elif multi:
        summary = (run_multislice_flap(args) if args.multislice_flap
                   else run_multislice_degraded(args)
                   if args.multislice_degraded else run_multislice(args))
        drop = ("finals", "logs")
    else:
        raise SystemExit("pass --elastic, --autoscale or --multislice*")
    print(json.dumps({k: v for k, v in summary.items() if k not in drop}))
    if summary.get("logs"):
        print(summary["logs"], file=sys.stderr)
    print("CHAOS CHECK " + ("PASSED" if summary["passed"] else "FAILED"))
    return 0 if summary["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
