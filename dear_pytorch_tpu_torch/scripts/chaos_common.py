"""Shared plumbing of the port's chaos drills (`scripts.chaos_check`) —
the jax-free helpers of the JAX package's ``scripts/chaos_common.py``
that the ``--elastic`` and ``--autoscale`` drills use, copied. The drill
parents supervise workers and read their files; they never touch a
device.

  - `check`            the printing assertion every gate phase uses
  - `load_supervisor`  the port's `launch.supervisor`
  - `decided_reader`   the durable decision records (the signed
                       world-delta commits) an external operator watches
  - `run_fleet`        supervise a fleet to completion with a deadline
  - `collect_verdicts` every rank's verdict files, per life
  - `capacity_writer`  atomic writes to a `resilience.scale.ScalePolicy`
                       capacity file
  - `FleetPump`        poll-the-supervisor-until-condition with one
                       shared deadline

The JAX package's ``slo_gate`` (its ``scripts/bench_gate.py --slo``) and
``shard_union_balanced`` (the online drill's) are not copied.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, List


def check(cond, what: str, failures: List[str]) -> bool:
    """Print one gate line; record the failure. Returns ``cond``."""
    status = "ok" if cond else "FAIL"
    print(f"chaos_check: [{status}] {what}")
    if not cond:
        failures.append(what)
    return bool(cond)


def load_supervisor():
    """The port's supervisor module (`launch.supervisor`)."""
    from dear_pytorch_tpu_torch.launch import supervisor

    return supervisor


def decided_reader(elastic_dir: str, ns: str = "elastic"):
    """``fn(n) -> parsed durable decision record e{n}`` (None when
    absent/torn) — the jax-free phase-sequencing surface every storm
    parent watches, exactly as an external operator would (the signed
    world-delta commits under ``{dir}/dearel/{ns}/decided/e*``)."""
    base = os.path.join(elastic_dir, "dearel", ns, "decided")

    def decided(n: int):
        try:
            with open(os.path.join(base, f"e{int(n)}")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None
    return decided


def run_fleet(sup, *, deadline_s: float, poll_s: float = 0.1,
              on_poll: Callable[[], None] = None):
    """Supervise a storm fleet to completion: reap/relaunch via
    ``sup.poll()`` until every rank exits, killing everything at the
    deadline. Returns ``(rc, elapsed_s)`` — rc 124 on deadline, else 1
    iff any rank's FINAL run exited nonzero. ``on_poll`` runs each
    iteration (the storm parents' phase machines)."""
    import time as _time

    t0 = _time.monotonic()
    deadline = t0 + float(deadline_s)
    rc = None
    while True:
        alive = sup.poll()
        if not alive:
            break
        if _time.monotonic() >= deadline:
            sup.kill_all()
            rc = 124
            break
        if on_poll is not None:
            on_poll()
        _time.sleep(poll_s)
    if rc is None:
        bad = {r: c for r, c in sup._final_rc.items() if c != 0}
        rc = 1 if bad else 0
    return rc, _time.monotonic() - t0


def collect_verdicts(workdir: str):
    """``(lives, finals)``: every ``verdict_rank*.json`` under
    ``workdir`` grouped per rank in (mtime, filename) order — churned
    ranks write one verdict per LIFE; ``finals`` maps each rank to its
    newest. The filename tie-break keeps two same-mtime files orderable
    (dicts do not compare)."""
    lives: dict = {}
    for name in sorted(os.listdir(workdir)):
        if not (name.startswith("verdict_rank")
                and name.endswith(".json")):
            continue
        path = os.path.join(workdir, name)
        with open(path) as f:
            v = json.load(f)
        lives.setdefault(int(v["rank"]), []).append(
            (os.path.getmtime(path), name, v))
    for vs in lives.values():
        vs.sort(key=lambda t: t[:2])
    lives = {r: [v for _t, _n, v in vs] for r, vs in lives.items()}
    return lives, {r: vs[-1] for r, vs in lives.items()}


def capacity_writer(path: str) -> Callable[[dict], None]:
    """Atomic JSON writes to the `ScalePolicy` capacity file (the env
    contract standing in for a spot-pool API)."""
    def write(doc: dict) -> None:
        with open(path + ".tmp", "w") as f:
            json.dump(doc, f)
        os.replace(path + ".tmp", path)
    return write


class FleetPump:
    """The storm parents' heartbeat-poll loop: keep the supervisor(s)
    reaped while waiting for a condition, against one storm-wide
    deadline. ``pump(cond, what, timeout_s)`` returns True when ``cond``
    held in time; a timeout records a failure and returns False, so gate
    phases degrade into assertions instead of hangs.

    ``samplers`` run on EVERY poll — the continuous-observation hooks
    (e.g. min-healthy-during-swap) that made single post-hoc samples
    vacuous in earlier storms.
    """

    def __init__(self, supervisors, failures: List[str], *,
                 deadline_s: float, poll_s: float = 0.1):
        self.supervisors = list(supervisors)
        self.failures = failures
        self.deadline = time.monotonic() + float(deadline_s)
        self.poll_s = float(poll_s)
        self.samplers: List[Callable[[], None]] = []

    def add_supervisor(self, sup) -> None:
        self.supervisors.append(sup)

    def add_sampler(self, fn: Callable[[], None]) -> None:
        self.samplers.append(fn)

    def poll(self) -> None:
        for sup in self.supervisors:
            sup.poll()
        for fn in self.samplers:
            fn()

    def remaining(self) -> float:
        return max(self.deadline - time.monotonic(), 0.0)

    def pump(self, cond: Callable[[], bool], what: str,
             timeout_s: float = 120.0) -> bool:
        t_end = min(time.monotonic() + float(timeout_s), self.deadline)
        while time.monotonic() < t_end:
            self.poll()
            if cond():
                return True
            time.sleep(self.poll_s)
        self.failures.append(f"timeout waiting for: {what}")
        return False
