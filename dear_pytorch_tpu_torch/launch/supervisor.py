"""Elastic rank supervisor: launch N worker ranks, relaunch the dead ones,
and — with a `ScalePolicy` — ride external capacity up and down.

The port's copy of the JAX package's ``launch/supervisor.py``, with the
same flags and the same env contract. It imports the port's
`resilience.scale` and `resilience.sdc` (the JAX package's would import
jax through its package ``__init__``), and runs as
``python -m dear_pytorch_tpu_torch.launch.supervisor``.

The resilience stack's division of labor (docs/RESILIENCE.md "Elastic
membership" / "Autoscaling"): `resilience.membership.ElasticCluster`
decides WHO is in the fleet — survivors shrink the membership when a rank
dies, a relaunched rank rejoins at a later epoch, and a brand-new rank is
admitted through the same barrier (scale-UP) — but something outside the
job has to bring ranks up and down. On a real pod that is the cluster
manager (k8s restartPolicy, GCE instance groups, a spot-pool API); this
supervisor is the same contract for process clusters on one host, and the
reference implementation of the **rejoin env contract** every relauncher
must speak:

    DEAR_ELASTIC_DIR    FileTransport root — the coordination store that
                        outlives any single rank (never the c10d TCP
                        store, which dies with rank 0)
    DEAR_ELASTIC_RANK   the stable rank id (identity, not position)
    DEAR_ELASTIC_WORLD  the initial world size (a scale-up rank's id is
                        >= this — `ElasticCluster.from_env` joins)
    DEAR_ELASTIC_REJOIN "1" on a RELAUNCHED or SCALE-UP rank — the worker
                        must come back through `ElasticCluster.rejoin`
                        instead of assuming first-launch membership

Policy: a rank exiting 0 is finished and never relaunched (unless it was
being **drained** — then the scale policy may backfill it while capacity
still wants the larger world); any other exit (including signals — a
SIGKILLed host shows up here as -9) is relaunched with the rejoin flag
after ``relaunch_delay_s``, within the per-rank **sliding-window budget**:
at most ``max_relaunches`` relaunches per rank inside the trailing
``relaunch_window_s`` seconds. With no window the budget degrades to the
legacy per-rank lifetime cap — but a long-running continuous-training
service exhausts any lifetime cap by design, so production runs should
always set the window. Per-rank pid files under
``<dir>/supervisor/pids/<rank>`` let chaos harnesses
(scripts/chaos_check.py --elastic/--autoscale) target a specific rank.

With ``--capacity-file`` the supervisor drives a
`dear_pytorch_tpu_torch.resilience.scale.ScalePolicy` each poll: a
``target_world`` above the live world spawns new ranks (fresh ids beyond
the initial world, admitted as scale-UP epochs), below it — or an explicit
``drain`` list — SIGTERMs victims so `resilience.preempt`'s grace window
(``DEAR_PREEMPT_GRACE_S``) turns the exit into an emergency save plus a
*planned* membership shrink.

Usage::

    python -m dear_pytorch_tpu_torch.launch.supervisor --nprocs 3 \
        --dir /tmp/elastic \
        [--max-relaunches 2] [--relaunch-window 600] \
        [--capacity-file /tmp/capacity.json] [--deadline 300] \
        -- python worker.py
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

ELASTIC_DIR_ENV = "DEAR_ELASTIC_DIR"
ELASTIC_RANK_ENV = "DEAR_ELASTIC_RANK"
ELASTIC_WORLD_ENV = "DEAR_ELASTIC_WORLD"
ELASTIC_REJOIN_ENV = "DEAR_ELASTIC_REJOIN"
#: slice-granular fleets: rank ids are SLICE-ALIGNED by contract
#: (``slice = rank // ranks_per_slice``) — the supervisor exports the
#: value so `resilience.membership.ElasticCluster.from_env` widens
#: failures to whole slices, and mints scale-up ids on slice boundaries
ELASTIC_RPS_ENV = "DEAR_ELASTIC_RANKS_PER_SLICE"


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _import_scale():
    """The policy lives in the package (`resilience.scale`) so its
    counters are audited with everything else; the supervisor is runnable
    from anywhere, so bootstrap the repo root onto sys.path first."""
    repo = _repo_root()
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from dear_pytorch_tpu_torch.resilience import scale

    return scale


def _import_sdc():
    """`resilience.sdc` imports torch only inside its self-test, which runs
    in a subprocess anyway."""
    repo = _repo_root()
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from dear_pytorch_tpu_torch.resilience import sdc

    return sdc


class ElasticSupervisor:
    """Supervise one elastic process cluster on this host."""

    def __init__(
        self,
        nprocs: int,
        command: List[str],
        *,
        elastic_dir: str,
        env: Optional[dict] = None,
        max_relaunches: int = 2,
        relaunch_window_s: Optional[float] = None,
        relaunch_delay_s: float = 0.5,
        policy=None,
        ranks_per_slice: Optional[int] = None,
        log=lambda s: print(s, file=sys.stderr, flush=True),
    ):
        if nprocs < 1:
            raise ValueError(f"nprocs must be >= 1, got {nprocs}")
        if not command:
            raise ValueError("empty worker command")
        if ranks_per_slice is not None:
            ranks_per_slice = int(ranks_per_slice)
            if ranks_per_slice < 1 or nprocs % ranks_per_slice:
                raise ValueError(
                    f"nprocs={nprocs} must be a whole number of slices "
                    f"of {ranks_per_slice} ranks")
        self.ranks_per_slice = ranks_per_slice
        self.nprocs = int(nprocs)
        self.command = list(command)
        self.elastic_dir = os.path.abspath(elastic_dir)
        self.base_env = dict(os.environ if env is None else env)
        self.max_relaunches = int(max_relaunches)
        self.relaunch_window_s = (
            None if relaunch_window_s is None else float(relaunch_window_s))
        self.relaunch_delay_s = float(relaunch_delay_s)
        self.policy = policy
        self._log = log
        self._procs: Dict[int, subprocess.Popen] = {}
        self._final_rc: Dict[int, int] = {}   # rank -> exit of its LAST run
        self.relaunches: Dict[int, int] = {r: 0 for r in range(self.nprocs)}
        self._relaunch_times: Dict[int, List[float]] = {}
        self._draining: set = set()      # ranks SIGTERMed by the policy
        self._backfill: List[int] = []   # drained ranks eligible to respawn
        self._finished: set = set()      # ranks that completed cleanly
        self._ever_ranks: set = set(range(self.nprocs))
        self.events: List[tuple] = []    # (what, rank) policy/churn audit
        self._pid_dir = os.path.join(self.elastic_dir, "supervisor", "pids")
        os.makedirs(self._pid_dir, exist_ok=True)
        # -- SDC quarantine (docs/RESILIENCE.md "SDC sentinel"): the
        # supervisor owns HOST IDENTITY. Rank ids are seats; strikes and
        # convictions in the SDC ledger are charged to the host a seat is
        # on, so a relaunched rank on the same host INHERITS its ledger
        # state. The pool is persisted under <dir>/supervisor/hosts/<rank>
        # so identity survives a supervisor restart, and each spawn
        # exports it as DEAR_SDC_HOST.
        self.sdc_active = self.base_env.get("DEAR_SDC", "") == "1"
        self._host_dir = os.path.join(self.elastic_dir, "supervisor",
                                      "hosts")
        os.makedirs(self._host_dir, exist_ok=True)
        self._hosts: Dict[int, str] = {}
        for name in os.listdir(self._host_dir):
            try:
                with open(os.path.join(self._host_dir, name)) as f:
                    self._hosts[int(name)] = f.read().strip()
            except (ValueError, OSError):
                continue
        self._host_seq = 0
        self._ledger = None              # lazy resilience.sdc.SdcLedger
        self._probation: Dict[str, subprocess.Popen] = {}
        self._probation_done: set = set()  # hosts ever sent to probation

    # -- host identity & the SDC quarantine ledger ---------------------------

    def _mint_host(self) -> str:
        """A fresh host id no seat has ever used (stand-in for asking the
        cluster manager for a different machine)."""
        used = set(self._hosts.values())
        while True:
            self._host_seq += 1
            host = f"host-{self._host_seq}"
            if host not in used:
                return host

    def _set_host(self, rank: int, host: str) -> None:
        self._hosts[rank] = host
        with open(os.path.join(self._host_dir, str(rank)), "w") as f:
            f.write(host)

    def ledger(self):
        """The durable quarantine ledger (first-writer-wins records under
        <dir>/sdc) — the same store every worker rank appends to."""
        if self._ledger is None:
            sdc = _import_sdc()
            root = self.base_env.get(sdc.LEDGER_ENV) or os.path.join(
                self.elastic_dir, "sdc")
            self._ledger = sdc.ledger_from_dir(root)
        return self._ledger

    def _seat_host(self, rank: int) -> str:
        """The host a seat will run on next. A quarantined host is NEVER
        re-seated: the ledger is consulted before every (re)launch and a
        convicted host is swapped for a fresh one — it can only come back
        through the probation self-test, and even then only via a worker's
        own rejoin gate."""
        host = self._hosts.get(rank)
        if host is None:
            host = self._mint_host()
            self._set_host(rank, host)
        if self.sdc_active and self.ledger().quarantined(host):
            fresh = self._mint_host()
            self._log(
                f"supervisor: host {host} (rank {rank}) is quarantined in "
                f"the SDC ledger — re-seating on fresh host {fresh}")
            self.events.append(("sdc_reseat", rank))
            self._start_probation(host)
            self._set_host(rank, fresh)
            host = fresh
        return host

    def _start_probation(self, host: str) -> None:
        """Kick off the known-answer self-test for a quarantined host,
        once per host, without blocking supervision: a subprocess runs
        `resilience.sdc --selftest` and writes the readmission record
        itself iff the burn-in passes."""
        if not self.sdc_active or host in self._probation_done:
            return
        self._probation_done.add(host)
        sdc = _import_sdc()
        root = self.base_env.get(sdc.LEDGER_ENV) or os.path.join(
            self.elastic_dir, "sdc")
        env = dict(self.base_env)
        env["PYTHONPATH"] = _repo_root() + os.pathsep + env.get(
            "PYTHONPATH", "")
        env[sdc.HOST_ENV] = host
        proc = subprocess.Popen(
            [sys.executable, "-m", "dear_pytorch_tpu_torch.resilience.sdc",
             "--selftest", "--ledger", root, "--host", host],
            env=env)
        self._probation[host] = proc
        self.events.append(("sdc_probation", host))
        self._log(f"supervisor: probation self-test started for "
                  f"quarantined host {host} pid={proc.pid}")

    def _reap_probation(self) -> None:
        for host, proc in list(self._probation.items()):
            rc = proc.poll()
            if rc is None:
                continue
            del self._probation[host]
            if rc == 0:
                self.events.append(("sdc_readmit", host))
                self._log(f"supervisor: host {host} passed the probation "
                          "self-test — readmitted in the SDC ledger")
            else:
                self.events.append(("sdc_probation_failed", host))
                self._log(f"supervisor: host {host} FAILED the probation "
                          f"self-test rc={rc} — stays quarantined")

    # -- lifecycle -----------------------------------------------------------

    def _spawn(self, rank: int, *, rejoin: bool) -> None:
        env = dict(self.base_env)
        env[ELASTIC_DIR_ENV] = self.elastic_dir
        env[ELASTIC_RANK_ENV] = str(rank)
        env[ELASTIC_WORLD_ENV] = str(self.nprocs)
        env["DEAR_SDC_HOST"] = self._seat_host(rank)
        if self.ranks_per_slice is not None:
            env[ELASTIC_RPS_ENV] = str(self.ranks_per_slice)
        if rejoin:
            env[ELASTIC_REJOIN_ENV] = "1"
        else:
            env.pop(ELASTIC_REJOIN_ENV, None)
        proc = subprocess.Popen(self.command, env=env)
        self._procs[rank] = proc
        self._ever_ranks.add(rank)
        self.relaunches.setdefault(rank, 0)
        with open(os.path.join(self._pid_dir, str(rank)), "w") as f:
            f.write(str(proc.pid))
        self._log(
            f"supervisor: rank {rank} "
            f"{'RELAUNCHED (rejoin)' if rejoin else 'launched'} "
            f"pid={proc.pid}")

    def start(self) -> "ElasticSupervisor":
        for rank in range(self.nprocs):
            self._spawn(rank, rejoin=False)
        return self

    def pid(self, rank: int) -> Optional[int]:
        proc = self._procs.get(rank)
        return proc.pid if proc is not None else None

    # -- relaunch budget -----------------------------------------------------

    def _budget_ok(self, rank: int) -> bool:
        """Per-rank sliding-window relaunch budget: at most
        ``max_relaunches`` within the trailing ``relaunch_window_s``. With
        no window, the legacy lifetime cap (which a long-running service
        exhausts by design — prefer the window)."""
        if self.relaunch_window_s is None:
            return self.relaunches.get(rank, 0) < self.max_relaunches
        now = time.monotonic()
        times = [t for t in self._relaunch_times.get(rank, [])
                 if now - t < self.relaunch_window_s]
        self._relaunch_times[rank] = times
        return len(times) < self.max_relaunches

    def _relaunch(self, rank: int) -> None:
        self.relaunches[rank] = self.relaunches.get(rank, 0) + 1
        self._relaunch_times.setdefault(rank, []).append(time.monotonic())
        self.events.append(("relaunch", rank))
        time.sleep(self.relaunch_delay_s)
        self._spawn(rank, rejoin=True)

    # -- policy actions ------------------------------------------------------

    def drain(self, rank: int) -> bool:
        """Planned removal: SIGTERM so the worker's `PreemptionHandler`
        turns the exit into an emergency save + a planned membership
        shrink inside the grace window. A clean exit of a draining rank
        is recorded for backfill, not treated as 'finished'."""
        proc = self._procs.get(rank)
        if proc is None:
            return False
        self._draining.add(rank)
        self.events.append(("drain", rank))
        self._log(f"supervisor: draining rank {rank} (SIGTERM, planned "
                  "shrink inside the preemption grace window)")
        try:
            proc.send_signal(signal.SIGTERM)
        except OSError:
            return False
        return True

    def scale_up(self, count: int) -> List[int]:
        """Spawn ``count`` additional ranks: drained ranks are backfilled
        first (stable ids, bounded rank space), then fresh ids beyond
        every rank ever used — admitted by the fleet as scale-UP epochs."""
        spawned = []
        for _ in range(max(int(count), 0)):
            if self._backfill:
                rank = self._backfill.pop(0)
            else:
                # dense minting keeps the slice-aligned rank-id contract
                # (slice = rank // ranks_per_slice) by construction: ids
                # are consecutive from a whole-number-of-slices initial
                # world (validated above), so a fresh slice always starts
                # exactly on a slice boundary
                rank = max(self._ever_ranks) + 1
            self.events.append(("scale_up", rank))
            self._spawn(rank, rejoin=True)
            spawned.append(rank)
        return spawned

    def _policy_tick(self) -> None:
        if self.policy is None or not self._procs or self._finished:
            # the policy scales a LIVE service: a fully-exited fleet is
            # finished, not under-capacity — and the moment ANY rank
            # completes cleanly (not drained) the job is wrapping up, so
            # the policy stands down rather than "backfilling" completed
            # work (observed: the fleet's staggered lockstep exits left a
            # live<target window that spawned ghost ranks which then
            # waited out their whole rejoin timeout against a dead fleet)
            return
        live = tuple(sorted(self._procs))
        quarantined = (len(self.ledger().quarantined_hosts())
                       if self.sdc_active else 0)
        decision = self.policy.decide(
            live_world=len(live), live_ranks=live,
            draining=tuple(sorted(self._draining & set(live))),
            quarantined=quarantined)
        if decision is None:
            return
        if decision.kind == "scale_up":
            self.scale_up(decision.count)
        else:  # "drain" / "scale_down"
            for rank in decision.ranks:
                self.drain(rank)

    # -- the supervision loop ------------------------------------------------

    def poll(self) -> bool:
        """One supervision pass: reap exits, relaunch failures, run the
        scale policy. Returns True while any rank is still running (or
        pending relaunch)."""
        for rank, proc in list(self._procs.items()):
            rc = proc.poll()
            if rc is None:
                continue
            del self._procs[rank]
            self._final_rc[rank] = rc
            if rank in self._draining:
                self._draining.discard(rank)
                if rc == 0:
                    self._log(f"supervisor: rank {rank} drained cleanly; "
                              "eligible for backfill")
                    self.events.append(("drained", rank))
                else:
                    # a dirty drain (crash inside the grace window) is
                    # still a DRAIN: the policy asked for this rank's
                    # removal, so relaunching it would override the
                    # capacity decision and burn its relaunch budget —
                    # it stays out until the policy backfills it
                    self._log(f"supervisor: draining rank {rank} exited "
                              f"rc={rc} (dirty drain; not relaunched — "
                              "eligible for backfill)")
                    self.events.append(("drained_dirty", rank))
                    self._final_rc[rank] = 0  # a requested removal is
                    #                           not a job failure
                host = self._hosts.get(rank)
                if self.sdc_active and host \
                        and self.ledger().quarantined(host):
                    # the seat is now empty and its host sits in the
                    # quarantine ledger: the scale policy holds the
                    # backfill (capacity cap) until a readmission, so
                    # the probation self-test must start NOW — waiting
                    # for a re-seat attempt would deadlock against the
                    # cap that quarantine itself imposes
                    self._start_probation(host)
                self._backfill.append(rank)
                continue
            if rc == 75:  # resilience.sdc.QUARANTINE_RC: the worker
                # convicted its OWN host in the ledger, committed a
                # planned membership shrink, and exited for backfill — a
                # requested removal, so no relaunch budget is burned. The
                # seat respawns immediately; `_seat_host` sees the
                # quarantined host and swaps in a fresh one (and starts
                # the old host's probation self-test).
                self._log(
                    f"supervisor: rank {rank} exited rc=75 (SDC "
                    "quarantine drain); respawning the seat on a fresh "
                    "host")
                self.events.append(("sdc_quarantine", rank))
                self._final_rc[rank] = 0
                time.sleep(self.relaunch_delay_s)
                self._spawn(rank, rejoin=True)
                continue
            if rc == 0:
                self._log(f"supervisor: rank {rank} finished cleanly")
                self._finished.add(rank)
                continue
            if not self._budget_ok(rank):
                window = ("lifetime" if self.relaunch_window_s is None
                          else f"{self.relaunch_window_s:.0f}s window")
                self._log(
                    f"supervisor: rank {rank} exited rc={rc}; relaunch "
                    f"budget ({self.max_relaunches} per {window}) "
                    "exhausted — giving up")
                continue
            self._log(
                f"supervisor: rank {rank} exited rc={rc}; relaunching with "
                f"{ELASTIC_REJOIN_ENV}=1 "
                f"({self.relaunches.get(rank, 0) + 1}/{self.max_relaunches})"
                f" in {self.relaunch_delay_s:.1f}s")
            self._relaunch(rank)
        self._reap_probation()
        self._policy_tick()
        return bool(self._procs)

    def wait(self, deadline_s: Optional[float] = None, poll_s: float = 0.2,
             ) -> int:
        """Supervise until every rank has finished (rc 0 or budget
        exhausted) or the deadline expires (everything still alive is
        killed). Returns 0 iff every rank's FINAL run exited 0."""
        t_end = (None if deadline_s is None
                 else time.monotonic() + float(deadline_s))
        while self.poll():
            if t_end is not None and time.monotonic() >= t_end:
                self._log(
                    f"supervisor: deadline {deadline_s:.0f}s expired with "
                    f"rank(s) {sorted(self._procs)} still alive — killing")
                self.kill_all()
                for rank, proc in list(self._procs.items()):
                    self._final_rc[rank] = proc.wait()
                self._procs.clear()
                return 124
            time.sleep(poll_s)
        # the fleet is done; give any in-flight probation self-test a
        # bounded window to write its readmission record (it is a short
        # known-answer burn-in, not a training job)
        for host, proc in list(self._probation.items()):
            try:
                proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
        self._reap_probation()
        bad = {r: rc for r, rc in self._final_rc.items() if rc != 0}
        if bad:
            self._log(f"supervisor: failed rank exits: {bad}")
            return 1
        return 0

    def kill_all(self, sig: int = signal.SIGKILL) -> None:
        for proc in self._procs.values():
            try:
                proc.send_signal(sig)
            except OSError:
                pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="elastic rank supervisor (see module docstring)")
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--dir", required=True,
                    help="elastic coordination dir (FileTransport root)")
    ap.add_argument("--relaunch-budget", "--max-relaunches",
                    dest="relaunch_budget", type=int, default=2,
                    help="relaunch budget PER RANK (default 2) — within "
                         "--relaunch-window when set, else lifetime "
                         "(--max-relaunches is the legacy alias)")
    ap.add_argument("--relaunch-window", type=float, default=None,
                    metavar="SECS",
                    help="sliding window for the per-rank budget; unset = "
                         "legacy lifetime cap (a long-running service "
                         "should always set this)")
    ap.add_argument("--relaunch-delay", type=float, default=0.5)
    ap.add_argument("--ranks-per-slice", type=int, default=None,
                    help="slice-granular fleet: rank ids are "
                         "slice-aligned (slice = rank // N), failures "
                         "widen to whole slices, scale-ups mint "
                         "slice-boundary ids (exported as "
                         "DEAR_ELASTIC_RANKS_PER_SLICE)")
    ap.add_argument("--capacity-file", default=None,
                    help="watched capacity-hint JSON (spot-pool stand-in); "
                         "enables the ScalePolicy loop "
                         "(DEAR_CAPACITY_FILE also works)")
    ap.add_argument("--max-world", type=int, default=None,
                    help="ScalePolicy ceiling on the fleet size")
    ap.add_argument("--deadline", type=float, default=None,
                    help="overall wall-clock budget in seconds")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="-- worker command...")
    args = ap.parse_args(argv)
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        ap.error("missing worker command (pass it after --)")
    policy = None
    capacity = args.capacity_file or os.environ.get("DEAR_CAPACITY_FILE")
    if capacity:
        policy = _import_scale().ScalePolicy(
            capacity_file=capacity, max_world=args.max_world)
    sup = ElasticSupervisor(
        args.nprocs, command, elastic_dir=args.dir,
        max_relaunches=args.relaunch_budget,
        relaunch_window_s=args.relaunch_window,
        relaunch_delay_s=args.relaunch_delay,
        policy=policy,
        ranks_per_slice=args.ranks_per_slice,
    ).start()
    try:
        return sup.wait(args.deadline)
    except KeyboardInterrupt:
        sup.kill_all(signal.SIGTERM)
        return 130


if __name__ == "__main__":
    sys.exit(main())
