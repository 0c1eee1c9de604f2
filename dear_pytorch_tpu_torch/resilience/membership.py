"""Elastic membership: survivor continuation, rejoin, epoch consensus —
the port of ``dear_pytorch_tpu/resilience/membership.py``. The protocol is
the JAX package's, key for key, over the port's transports
(`resilience.cluster.LocalTransport`, `FileTransport`, `StoreTransport`).
What a committed view does to the data plane — a new process group per
epoch — is `comm.backend.regroup`'s.

PR 3's `resilience.cluster` deliberately stops at "`PeerTimeout` →
forensics → crash-for-relaunch": a permanently lost host still costs the
whole job. This module delivers the layer `utils.guard`'s docstring
promised would compose on top — **whole-process elasticity**:

  - **membership epochs** — the fleet's composition is versioned by a
    monotonic epoch, consensus-agreed over a host-level transport
    (`LocalTransport` thread-ranks for unit tests,
    `StoreTransport` over the c10d store of a live process group, or —
    the transport relaunch actually needs — `cluster.FileTransport`,
    whose store outlives any single rank). Every exchange key is scoped
    ``{ns}/e{epoch}/{tag}/{seq}/{rank}``, and per-tag sequence counters
    reset at every transition, so a rank that joins at epoch E starts in
    lockstep at seq 0 with everyone else.
  - **reconfiguration** — a confirmed `PeerTimeout` in the member
    exchange becomes a survivor-set proposal: round-based **two-phase
    commit** in which every survivor publishes its observed-dead set,
    commits only on *strict unanimity* (every gathered proposal
    byte-identical to its own), and otherwise widens its set to the union
    and advances a round. A peer that dies mid-reconfig (before its
    proposal, or between proposal and commit ack) is absorbed by the next
    round; each committed reconfiguration bumps the epoch by exactly one
    regardless of rounds. ``cluster.reconfigs`` counts commits;
    ``cluster.epoch``'s counter value tracks the current epoch.
  - **rejoin** — a relaunched rank publishes a rejoin request carrying
    its last known epoch (from its newest checkpoint sidecar,
    `utils.checkpoint.read_mem_epoch`); the member leader polls for
    requests each `health_check`, the gathered union makes the admit
    decision identical on every member, and the admitted rank enters at
    an **epoch barrier** (the first exchange of the new epoch) with the
    fleet's cadence context (``steps_seen``) handed over in the admission
    ack. ``cluster.rejoins`` counts admissions.
  - **scale-UP** — the same admission path grows the fleet past the
    initial world: a brand-new rank (no prior death, no sidecar epoch —
    ``last_epoch=None``) publishes the identical join request, the leader
    discovers it via the transport's ``list_prefix`` enumeration (no
    static rank list can know a rank that never existed), and the commit
    is an ordinary epoch bump whose decision record carries a **signed
    world delta** (``added``/``removed``) instead of implying "shrink".
    ``cluster.scale_ups`` counts admissions of never-before-seen ranks.
    Transports without ``list_prefix`` (the c10d store)
    degrade to relaunch-only admission over the initial rank set.
  - **planned shrink (drain)** — a rank holding a spot/preemption SIGTERM
    (`resilience.preempt`, ``DEAR_PREEMPT_GRACE_S``) announces
    ``draining=True`` in its next `health_check`; the survivors commit
    the shrink *at that sync* — no peer-timeout window burned against the
    kill deadline — while the drainer itself skips the reconfiguration
    (it is the dead set) and exits after its emergency save.

Failure-detector honesty: like every timeout-based detector, this one
cannot distinguish "dead" from "slower than the deadline". A false
positive does not corrupt the protocol: a rank that finds *itself* in
the fleet's dead-set union raises `EvictedError` and exits for relaunch
(its supervisor brings it back through the rejoin path), and every epoch
commit is anchored on a durable first-writer-wins **decision record**
(`_decide_epoch`) — so even a rank that widened everyone else into its
dead set (and would otherwise "win" a sole-survivor commit) discovers
the fleet's committed member set and evicts itself instead of forking
the membership. A false positive still costs a spurious epoch; size
``DEAR_CLUSTER_TIMEOUT_SECS`` well above the slowest legitimate
inter-sync gap.

Known limitation, by construction: the c10d TCP store runs *inside*
rank 0, so with the ``store`` transport a rank-0 loss takes the store down
with it — survivors degrade to the fixed-world crash-for-relaunch.
`FileTransport` (or any external store) has no distinguished host.

What elasticity does *downstream* of a committed transition — fusion-plan
epoch restamp, pipeline reshard, consensus restore to the newest step
valid on every survivor — lives in `utils.guard.GuardedTrainer` (see
the JAX package's docs/RESILIENCE.md "Elastic membership").
"""

from __future__ import annotations

import json
import logging
import os
import time
import uuid
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from dear_pytorch_tpu_torch.observability import tracer as _telemetry
from dear_pytorch_tpu_torch.resilience.cluster import (
    TIMEOUT_ENV, RESTORE_TIMEOUT_ENV, DEFAULT_TIMEOUT_S,
    ClusterError, FileTransport, PeerTimeout,
    evaluate_health_views, newest_common_step,
)

logger = logging.getLogger("dear_pytorch_tpu_torch")

__all__ = [
    "ElasticCluster", "ElasticVerdict", "MembershipView", "EvictedError",
    "current_epoch", "ELASTIC_DIR_ENV", "ELASTIC_RANK_ENV",
    "ELASTIC_WORLD_ENV", "ELASTIC_REJOIN_ENV", "ELASTIC_RPS_ENV",
]

#: The supervisor's rejoin env contract (`launch.supervisor` exports
#: these; `ElasticCluster.from_env` consumes them).
ELASTIC_DIR_ENV = "DEAR_ELASTIC_DIR"      # FileTransport root
ELASTIC_RANK_ENV = "DEAR_ELASTIC_RANK"    # stable rank id (falls back to
#                                           DEAR_PROCESS_ID, JAX_PROCESS_ID)
ELASTIC_WORLD_ENV = "DEAR_ELASTIC_WORLD"  # initial world size (falls back
#                                           to DEAR_NUM_PROCESSES, then
#                                           JAX_NUM_PROCESSES)
ELASTIC_REJOIN_ENV = "DEAR_ELASTIC_REJOIN"  # "1" on a relaunched rank
#: Slice granularity: when set (to the rank count per slice), the fleet's
#: FAILURE UNIT is the slice — rank ids are slice-aligned
#: (``slice_of(r) = r // ranks_per_slice``, the supervisor contract), a
#: rank loss widens to its whole slice (one membership event, not N), and
#: admission waits for complete slices.
ELASTIC_RPS_ENV = "DEAR_ELASTIC_RANKS_PER_SLICE"

#: How long a relaunched rank waits for its admission ack. Admission only
#: happens at a member health sync, and the fleet may be mid-reconfig or
#: mid-restore when the request lands — so this is sized in multiples of
#: the base exchange deadline, not heartbeats.
REJOIN_TIMEOUT_ENV = "DEAR_CLUSTER_REJOIN_TIMEOUT_SECS"

#: Leader-side poll budget for one pending-rejoin probe (tiny: the key is
#: either already in the store or it isn't).
_POLL_S = 0.05


def _first_env(*names: str) -> str:
    """The first set variable among ``names`` (KeyError naming the first
    when none is)."""
    for k in names:
        v = os.environ.get(k, "").strip()
        if v:
            return v
    raise KeyError(names[0])


class EvictedError(ClusterError):
    """This rank appears in the fleet's agreed dead set — a peer's
    failure detector declared it dead and the membership moved on. The
    only safe action is to exit and come back through `rejoin` (the
    supervisor relaunch path); continuing would fork the membership."""


class MembershipView(NamedTuple):
    """One rank's view of a committed membership epoch."""

    epoch: int
    members: Tuple[int, ...]   # stable rank ids, sorted
    rank: int                  # my stable rank id
    index: int                 # my position in ``members`` — the data
    #                            shard slot `runtime.pipeline.reshard` uses
    #                            on rank-granular fleets
    world: int                 # len(members)
    #: live slice ids (slice-granular fleets only; () otherwise)
    slices: Tuple[int, ...] = ()
    #: this rank's slice id (None on rank-granular fleets)
    slice_id: Optional[int] = None

    @property
    def data_shard(self) -> int:
        """The data-parallel shard slot. On a slice-granular fleet the
        ranks of one slice are lockstep replicas of the SAME shard (the
        slice is the data-parallel unit — its intra-slice mesh computes
        one model replica), so the slot is the slice's position among
        the live slices; rank-granular fleets keep the member position.
        `utils.guard.GuardedTrainer._reshard_pipeline` reads this."""
        if self.slice_id is not None and self.slices:
            return self.slices.index(self.slice_id)
        return self.index

    @property
    def data_world(self) -> int:
        """Companion to `data_shard`: live slices on a slice-granular
        fleet, the member count otherwise."""
        return len(self.slices) if self.slices else self.world


class ElasticVerdict(NamedTuple):
    """Outcome of one `ElasticCluster.health_check` sync. The first five
    fields mirror `cluster.HealthVerdict` (the guard's consumers see the
    same shape); the rest report membership activity during the sync."""

    ok: bool
    unhealthy_ranks: tuple
    desync: bool
    any_preempted: bool
    fingerprints: tuple
    epoch: int = 0
    members: tuple = ()
    reconfigured: bool = False   # a shrink (or a re-formation) committed
    admitted: tuple = ()         # ranks admitted during this sync
    lost: tuple = ()             # ranks dropped during this sync
    drained: tuple = ()         # ranks that announced a planned departure
    sdc_suspects: tuple = ()    # (rank, bucket) fingerprint-vote losers
    hosts: tuple = ()           # (rank, host-identity) ledger-key pairs
    sdc_voted: bool = False     # enough voters reached this sync to blame

    @property
    def membership_changed(self) -> bool:
        return self.reconfigured or bool(self.admitted)

    @property
    def self_draining(self) -> bool:
        """True on the rank that announced the drain: save and exit; the
        SURVIVORS' verdict carries the committed shrink (their membership
        moved) instead."""
        return bool(self.drained) and not self.membership_changed


# Process-global "current membership epoch" for forensic stamping: the
# flight recorder and watchdog reports resolve it through `current_epoch`
# (a weakref — a test's discarded cluster must not pin an epoch forever).
_live_cluster: Optional["weakref.ReferenceType[ElasticCluster]"] = None


def current_epoch() -> Optional[int]:
    """The most recently constructed `ElasticCluster`'s epoch (None when
    no elastic cluster exists in this process) — stamped into flight rows
    (``mem_epoch``) and `WatchdogReport.mem_epoch`."""
    cluster = _live_cluster() if _live_cluster is not None else None
    return cluster.epoch if cluster is not None else None


class ElasticCluster:
    """Membership-epoch consensus over a host-level KV transport.

    Drop-in for the guard's coordinator surface (``exchange`` /
    ``health_check`` / ``consensus_restore_step`` / ``index`` /
    ``process_count`` / ``max_candidates``) with one semantic upgrade:
    a dead peer shrinks the membership instead of crashing the job, and a
    relaunched peer grows it back. Every public call is a collective over
    the *current members* — all members must call in the same order (the
    guard's check-interval discipline guarantees this).

    ``rank`` is a stable identity (the launch rank), not a position:
    positions (``index``) are recomputed per epoch and drive data-shard
    assignment.
    """

    #: The guard feature-detects this before passing ``draining=`` to
    #: `health_check` (scripted test coordinators may not accept it).
    supports_draining = True
    #: membership can change (shrink/rejoin/scale-up): the guard must keep
    #: its coordinated health sync running even at world 1 — the sync is
    #: where the sole survivor polls rejoin requests (utils/guard.py
    #: `_coordinated`)
    supports_membership = True

    def __init__(
        self,
        *,
        rank: int,
        world: Optional[int] = None,
        members: Optional[Sequence[int]] = None,
        transport=None,
        timeout_s: Optional[float] = None,
        namespace: str = "elastic",
        max_candidates: int = 16,
        joining: bool = False,
        ranks_per_slice: Optional[int] = None,
    ):
        global _live_cluster
        if ranks_per_slice is not None and int(ranks_per_slice) < 1:
            raise ValueError(
                f"ranks_per_slice must be >= 1, got {ranks_per_slice}")
        #: slice granularity (`ELASTIC_RPS_ENV`): the failure unit. Rank
        #: ids are slice-aligned by contract —
        #: ``slice_of(r) = r // ranks_per_slice`` — so a relaunched or
        #: scaled-up rank keeps its slice without any extra state.
        self.ranks_per_slice = (None if ranks_per_slice is None
                                else int(ranks_per_slice))
        if members is None:
            if world is None:
                raise ValueError("pass world=N or an explicit members list")
            members = range(int(world))
        self.rank = int(rank)
        self.members: Tuple[int, ...] = tuple(sorted(int(m) for m in members))
        if self.rank not in self.members:
            if not joining:
                raise ValueError(
                    f"rank {rank} not in members {self.members} "
                    "(a brand-new scale-up rank must pass joining=True "
                    "and enter through rejoin())")
            # scale-UP joiner: not a member yet — the committed member set
            # arrives in the admission ack; until then this instance only
            # publishes its join request (never exchanges)
            self.members = tuple(sorted(set(self.members) | {self.rank}))
        self.joining = bool(joining)
        self.initial_ranks: Tuple[int, ...] = self.members
        self.epoch = 0
        if timeout_s is None:
            timeout_s = float(os.environ.get(TIMEOUT_ENV, "")
                              or DEFAULT_TIMEOUT_S)
        self.timeout_s = float(timeout_s)
        self.max_candidates = max(int(max_candidates), 1)
        # the namespace must be STABLE across relaunches (no per-process
        # instance counter: a relaunched rank has a fresh process but must
        # land in the same key space its predecessor's peers use)
        self._ns = f"dearel/{namespace}"
        if isinstance(transport, str) and transport.startswith("file:"):
            transport = FileTransport(transport[len("file:"):])
        if transport is None:
            raise ValueError(
                "ElasticCluster needs an explicit transport (FileTransport/"
                "LocalTransport/StoreTransport); the "
                "allgather transport cannot gather over a shrinking subset")
        self._transport = transport
        self._seqs: Dict[str, int] = {}
        self._epoch_counted = 0
        self._stale_epochs: List[int] = []  # superseded, GC deferred
        _live_cluster = weakref.ref(self)
        # flight rows carry the membership epoch from now on (lazy import:
        # observability must not import resilience)
        from dear_pytorch_tpu_torch.observability import flight as _flight

        _flight.set_epoch_provider(current_epoch)

    # -- env contract --------------------------------------------------------

    @classmethod
    def from_env(cls, **overrides) -> "ElasticCluster":
        """Construct from the `launch.supervisor` env contract:
        ``DEAR_ELASTIC_DIR`` (FileTransport root), ``DEAR_ELASTIC_RANK`` /
        ``DEAR_ELASTIC_WORLD`` (fall back to the launcher contract,
        ``DEAR_PROCESS_ID`` / ``DEAR_NUM_PROCESSES`` or their ``JAX_*``
        names).
        The caller checks ``DEAR_ELASTIC_REJOIN`` to decide between
        first-launch membership and `rejoin`."""
        root = os.environ.get(ELASTIC_DIR_ENV, "").strip()
        if not root:
            raise ClusterError(
                f"{ELASTIC_DIR_ENV} is not set — not launched under the "
                "elastic supervisor contract")
        rank = int(_first_env(ELASTIC_RANK_ENV, "DEAR_PROCESS_ID",
                              "JAX_PROCESS_ID"))
        world = int(_first_env(ELASTIC_WORLD_ENV, "DEAR_NUM_PROCESSES",
                               "JAX_NUM_PROCESSES"))
        kw = dict(rank=rank, world=world,
                  transport=FileTransport(root))
        rps = os.environ.get(ELASTIC_RPS_ENV, "").strip()
        if rps:
            kw["ranks_per_slice"] = int(rps)
        if rank >= world:
            # a scale-up spawn: the supervisor handed out a rank id beyond
            # the initial world — this process can only be a joiner
            kw["joining"] = True
        kw.update(overrides)
        return cls(**kw)

    @staticmethod
    def rejoining_by_env() -> bool:
        return os.environ.get(ELASTIC_REJOIN_ENV, "").strip().lower() in (
            "1", "true", "yes", "on")

    # -- views ---------------------------------------------------------------

    @property
    def world(self) -> int:
        return len(self.members)

    @property
    def index(self) -> int:
        """My position within the current members — the shard slot."""
        return self.members.index(self.rank)

    @property
    def process_count(self) -> int:
        """Coordinator-surface alias for the CURRENT world size (the
        guard's ``_coordinated`` gate and the metric aggregator read it)."""
        return self.world

    @property
    def leader(self) -> int:
        return self.members[0]

    # -- slice granularity ---------------------------------------------------

    def slice_of(self, rank: int) -> Optional[int]:
        """The slice a rank belongs to (None on rank-granular fleets).
        Pure id arithmetic — the supervisor's slice-aligned rank-id
        contract — so it holds for ranks that died, relaunched, or have
        never existed yet."""
        if self.ranks_per_slice is None:
            return None
        return int(rank) // self.ranks_per_slice

    @property
    def slices(self) -> Tuple[int, ...]:
        """Live slice ids (sorted; () on rank-granular fleets)."""
        if self.ranks_per_slice is None:
            return ()
        return tuple(sorted({self.slice_of(m) for m in self.members}))

    def slice_ranks(self, sid: int) -> Tuple[int, ...]:
        """Every rank id of slice ``sid`` under the alignment contract
        (members or not — admission gating needs the full roster)."""
        rps = self.ranks_per_slice
        if rps is None:
            raise ValueError("rank-granular cluster has no slices")
        return tuple(range(int(sid) * rps, (int(sid) + 1) * rps))

    def _closure_members(self, ranks) -> set:
        """Widen a rank set to whole slices over the CURRENT members —
        the slice-granular failure unit: one lost rank breaks its
        slice's ICI mesh, so the membership removes (or drains) the
        slice as ONE event instead of N rank-death events. Identity on
        rank-granular clusters."""
        dead = {int(r) for r in ranks} & set(self.members)
        if self.ranks_per_slice is None or not dead:
            return dead
        dead_slices = {self.slice_of(r) for r in dead}
        return {m for m in self.members
                if self.slice_of(m) in dead_slices}

    def view(self) -> MembershipView:
        return MembershipView(epoch=self.epoch, members=self.members,
                              rank=self.rank, index=self.index,
                              world=self.world, slices=self.slices,
                              slice_id=self.slice_of(self.rank))

    # -- the member exchange -------------------------------------------------

    def _seq(self, tag: str) -> int:
        s = self._seqs.get(tag, 0)
        self._seqs[tag] = s + 1
        return s

    def _gather(self, base: str, ranks: Sequence[int], deadline_s: float,
                *, grace_s: float = 0.2):
        """Fetch ``{base}/{r}`` for every rank; returns (values, missing).
        One shared wall-clock deadline: after it expires, each remaining
        key gets only ``grace_s`` (a peer that was going to publish has
        had the whole window)."""
        deadline = time.monotonic() + deadline_s
        vals: Dict[int, str] = {}
        missing: List[int] = []
        for r in ranks:
            budget = max(deadline - time.monotonic(), grace_s)
            try:
                vals[r] = self._transport.get(f"{base}/{r}", budget)
            except PeerTimeout:
                missing.append(r)
        return vals, missing

    def exchange(self, tag: str, payload: str,
                 timeout_s: Optional[float] = None) -> List[str]:
        """All-gather one string per *current member* (member-ordered).
        Lockstep within an epoch: keys are ``e{epoch}/{tag}/{seq}``, and
        seq counters reset at every transition — a rank admitted at epoch
        E joins at seq 0 like everyone else. A missing member raises
        `PeerTimeout` with ``missing_ranks`` attached (the reconfiguration
        proposal seed)."""
        if self.world == 1:
            self._gc_superseded()
            return [payload]
        deadline = self.timeout_s if timeout_s is None else float(timeout_s)
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.count("cluster.exchanges")
        seq = self._seq(tag)
        base = f"{self._ns}/e{self.epoch}/{tag}/{seq}"
        self._transport.set(f"{base}/{self.rank}", payload)
        vals, missing = self._gather(base, self.members, deadline)
        if missing:
            if tr.enabled:
                tr.count("cluster.peer_timeouts")
                tr.event("cluster.peer_timeout", tag=tag, epoch=self.epoch,
                         seq=seq, ranks=",".join(map(str, missing)))
            logger.critical(
                "elastic: exchange %s (epoch %d seq %d) missing rank(s) %s "
                "after %.1fs", tag, self.epoch, seq, missing, deadline)
            exc = PeerTimeout(
                f"member(s) {missing} never reached exchange {tag!r} "
                f"(epoch {self.epoch} seq {seq}) within {deadline:.1f}s")
            exc.missing_ranks = tuple(missing)
            raise exc
        # lag-2 GC: my key at seq s-2 has been read by everyone (a member
        # can only publish seq s after completing the gather at s-1, which
        # required every member's s-1 key, which required their s-2 gather)
        if seq >= 2:
            self._transport.delete(
                f"{self._ns}/e{self.epoch}/{tag}/{seq - 2}/{self.rank}")
        # a COMPLETED exchange at this epoch proves every current member
        # has committed it — only now is the superseded epoch's subtree
        # safe to GC (see _commit)
        self._gc_superseded()
        return [vals[r] for r in self.members]

    def barrier(self, tag: str = "barrier") -> None:
        self.exchange(f"{tag}.bar", "b")

    # -- reconfiguration: two-phase commit of the survivor set ---------------

    def reconfigure(self, dead: Sequence[int]) -> MembershipView:
        """Shrink the membership after confirmed peer loss. Collective
        over the survivors (every member that did NOT time out must call
        this — the guard calls it from the failed health sync, so all
        survivors arrive from the same exchange seq).

        Round-based 2PC: propose my observed-dead set; commit only when
        every gathered proposal is byte-identical to mine; otherwise widen
        to the union (peers that missed the round are presumed dead too)
        and advance a round. Terminates: the dead set grows strictly every
        non-committing round and is bounded by the membership. The
        committed epoch is ``epoch + 1`` regardless of rounds.

        Every commit is anchored on the epoch's durable **decision
        record** (`_decide_epoch`, first-writer-wins, never GC'd): a rank
        whose survivor view disagrees with the decided one — a falsely
        evicted slow rank widening everyone else into its dead set, or a
        survivor that missed a commit ack and widened past an already
        committed epoch — finds the record and raises `EvictedError`
        instead of forking the membership."""
        dead_set = self._closure_members(dead)
        if not dead_set:
            raise ValueError(f"no current member in dead={dead!r}")
        if self.rank in dead_set:
            raise EvictedError(
                f"rank {self.rank} is in its own dead set {sorted(dead_set)}"
                + ("" if self.ranks_per_slice is None else
                   " (slice closure: a lost rank takes its whole slice's "
                   "ICI mesh with it — exiting for relaunch+rejoin)"))
        target = self.epoch + 1
        tr = _telemetry.get_tracer()
        survivors: Tuple[int, ...] = ()
        for rnd in range(len(self.members) + 2):
            survivors = tuple(m for m in self.members if m not in dead_set)
            if survivors == (self.rank,):
                break  # sole survivor: unilateral commit
            base = f"{self._ns}/reconfig/e{target}/r{rnd}"
            mine = json.dumps(sorted(dead_set))
            self._transport.set(f"{base}/prop/{self.rank}", mine)
            props, missing = self._gather(base + "/prop", survivors,
                                          self.timeout_s)
            union = set(dead_set) | set(missing)
            for v in props.values():
                union |= set(json.loads(v))
            # slice closure keeps every round's proposal slice-shaped, so
            # survivors whose detectors saw different SUBSETS of a dying
            # slice still converge on the same (whole-slice) dead set
            union = self._closure_members(union)
            if self.rank in union:
                raise EvictedError(
                    f"rank {self.rank} was declared dead during the epoch-"
                    f"{target} reconfiguration — exiting for relaunch+rejoin")
            if union != dead_set:
                # widen and retry: peers knew about more deaths (or died
                # themselves mid-proposal)
                logger.warning(
                    "elastic: reconfig e%d round %d widened dead set "
                    "%s -> %s", target, rnd, sorted(dead_set), sorted(union))
                dead_set = union
                continue
            # strict unanimity: commit phase
            self._transport.set(f"{base}/commit/{self.rank}", "1")
            _, missing2 = self._gather(base + "/commit", survivors,
                                       self.timeout_s)
            if missing2:
                # a peer died between proposing and acking: next round
                dead_set |= set(missing2)
                continue
            break
        else:
            raise ClusterError(
                f"epoch-{target} reconfiguration did not converge "
                f"(dead={sorted(dead_set)})")
        decided = self._decide_epoch(target, survivors,
                                     delta={"removed": dead_set})
        if set(decided) != set(survivors):
            # another partition of the old membership decided this epoch
            # first (it presumed ME dead, or I missed a commit ack and
            # widened past an already committed set). Re-entering an epoch
            # whose exchange cadence started without me cannot be done in
            # lockstep — exit for relaunch and re-enter through rejoin.
            raise EvictedError(
                f"epoch {target} was already decided with members "
                f"{list(decided)} (my survivor view: {list(survivors)}) — "
                "exiting for relaunch+rejoin")
        self._commit(target, survivors)
        if tr.enabled:
            tr.count("cluster.reconfigs")
            tr.event("cluster.reconfig", epoch=target,
                     members=",".join(map(str, survivors)),
                     lost=",".join(map(str, sorted(dead_set))))
            if self.ranks_per_slice is not None:
                lost_slices = sorted({self.slice_of(r) for r in dead_set})
                tr.count("cluster.slice_losses", len(lost_slices))
                tr.event("cluster.slice_loss", epoch=target,
                         slices=",".join(map(str, lost_slices)))
        logger.critical(
            "elastic: membership epoch %d COMMITTED — members %s (lost %s)",
            target, list(survivors), sorted(dead_set))
        return self.view()

    def reform(self) -> MembershipView:
        """Commit ``epoch + 1`` with the SAME members (the port's; the
        JAX package's meshes live in one process and need no such step).
        A collective of the current epoch's process group failed with
        every member alive: a member's step raised after it dispatched,
        or the data plane timed out on a slow peer. The members have then
        issued different collectives on that group, and a gloo or NCCL
        group is not reliably usable after a failed collective, so they
        form the next epoch's group (`comm.backend.regroup`). Every member
        calls this from the same health exchange, so all of them decide
        the same record: a signed delta with nothing added or removed."""
        target = self.epoch + 1
        decided = self._decide_epoch(target, self.members,
                                     delta={"added": (), "removed": ()})
        if set(decided) != set(self.members):
            raise EvictedError(
                f"epoch {target} was already decided with members "
                f"{list(decided)} (re-forming {list(self.members)}) — "
                "exiting for relaunch+rejoin")
        self._commit(target, self.members)
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.count("cluster.reforms")
            tr.event("cluster.reform", epoch=target,
                     members=",".join(map(str, self.members)))
        logger.critical(
            "elastic: membership epoch %d COMMITTED — members %s re-formed "
            "(a collective of epoch %d failed)", target, list(self.members),
            target - 1)
        return self.view()

    def _decide_epoch(self, target: int, members: Sequence[int],
                      *, delta: Optional[dict] = None) -> Tuple[int, ...]:
        """Durable first-writer-wins decision record for epoch ``target``
        (`{ns}/decided/e{target}` — OUTSIDE the per-epoch exchange
        subtrees, so epoch GC never prunes it). Returns the winning member
        set; callers must adopt it or, if excluded from it, exit for
        relaunch+rejoin. One tiny record per epoch for the life of the
        store — what makes a unilateral sole-survivor commit by a
        partitioned rank discover the fleet's commit instead of forking
        the membership.

        Records are **signed world-delta commits**: alongside the member
        set they carry ``delta={"added": [...], "removed": [...]}`` — one
        format for survivor shrinks, drains, AND scale-up admissions, so
        an external supervisor (or a forensic read of the store) can
        replay the fleet's capacity history from the records alone.
        Legacy bare-list records parse compatibly."""
        key = f"{self._ns}/decided/e{int(target)}"
        record = {"members": sorted(int(m) for m in members)}
        if delta:
            record["delta"] = {
                "added": sorted(int(r) for r in delta.get("added", ())),
                "removed": sorted(int(r) for r in delta.get("removed", ())),
            }
            if self.ranks_per_slice is not None:
                # slice-shaped delta: on slice-granular fleets every
                # shrink is slice-closed and every admission slice-gated,
                # so the rank deltas partition into whole slices — the
                # capacity history replays at SLICE granularity from the
                # records alone (an external pool manager thinks in
                # slices, not ranks)
                record["delta"]["slices"] = {
                    "added": sorted({self.slice_of(r)
                                     for r in delta.get("added", ())}),
                    "removed": sorted({self.slice_of(r)
                                       for r in delta.get("removed", ())}),
                }
        mine = json.dumps(record, sort_keys=True)
        decide = getattr(self._transport, "decide_once", None)
        if decide is not None:
            won = decide(key, mine)
        else:
            # stores without an atomic create (coordination-service KV):
            # probe-then-set — racy, but those transports die with their
            # fleet anyway (no relaunch story), so the race window is the
            # in-flight reconfig only
            try:
                won = self._transport.get(key, 0.0)
            except PeerTimeout:
                self._transport.set(key, mine)
                won = mine
        deadline = time.monotonic() + self.timeout_s
        while True:
            try:
                doc = json.loads(won)
                if isinstance(doc, dict):
                    doc = doc["members"]
                return tuple(int(m) for m in doc)
            except (ValueError, KeyError, TypeError):
                # a non-linking store's exclusive-create fallback can
                # expose a mid-write value: the file exists (so get()
                # returns immediately) but the winner's bytes are still
                # landing — poll until the record parses, bounded by the
                # exchange deadline
                if time.monotonic() >= deadline:
                    raise ClusterError(
                        f"epoch-{target} decision record never became "
                        "readable") from None
                time.sleep(_POLL_S)
                won = self._transport.get(key, self.timeout_s)

    def _commit(self, epoch: int, members: Sequence[int]) -> None:
        old_epoch = self.epoch
        self.epoch = int(epoch)
        self.members = tuple(sorted(int(m) for m in members))
        self._seqs = {}
        tr = _telemetry.get_tracer()
        if tr.enabled and self.epoch > self._epoch_counted:
            # the cluster.epoch counter's VALUE tracks the current epoch
            tr.count("cluster.epoch", self.epoch - self._epoch_counted)
            self._epoch_counted = self.epoch
        # the superseded epoch's exchange subtree is GC'd DEFERRED, not
        # here: a peer that has not yet finished its last old-epoch gather
        # commits the new epoch only afterwards — pruning its unread keys
        # now would turn that slow-but-alive peer into a spurious
        # PeerTimeout and a split-brain reconfiguration (observed: a
        # survivor admitted a rejoiner and pruned the old epoch while the
        # OTHER survivor was still reading its health key there). The
        # first successful exchange at the NEW epoch proves every current
        # member has moved past the old one; `exchange` prunes then.
        self._stale_epochs.append(old_epoch)

    def _gc_superseded(self) -> None:
        """Best-effort GC of superseded epochs' exchange subtrees — called
        only from a point that PROVES every current member committed past
        them (a completed exchange at the current epoch)."""
        if not self._stale_epochs:
            return
        prune = getattr(self._transport, "prune_prefix", None)
        if prune is not None:
            for e in self._stale_epochs:
                prune(f"{self._ns}/e{e}")
        self._stale_epochs = []

    # -- rejoin: relaunch -> request -> admission at an epoch barrier --------

    def _poll_rejoin_requests(self) -> Dict[str, dict]:
        """Leader-only probe for pending rejoin/join requests from
        non-member ranks. Only the leader pays the poll; the union across
        the member exchange makes the admit decision identical everywhere.
        With a ``list_prefix``-capable transport (FileTransport,
        LocalTransport) the candidate set is DISCOVERED from the store, so
        a brand-new scale-up rank — one no static rank list has ever
        contained — is admissible; transports without enumeration degrade
        to relaunch-only admission over the initial rank set."""
        if self.rank != self.leader:
            return {}
        lister = getattr(self._transport, "list_prefix", None)
        if lister is not None:
            cands = [int(n) for n in lister(f"{self._ns}/rejoin/req")
                     if str(n).isdigit()]
        else:
            cands = list(self.initial_ranks)
        reqs: Dict[str, dict] = {}
        for r in cands:
            if r in self.members:
                continue
            try:
                raw = self._transport.get(
                    f"{self._ns}/rejoin/req/{r}", _POLL_S)
            except PeerTimeout:
                continue
            try:
                reqs[str(r)] = json.loads(raw)
            except ValueError:
                continue
        return reqs

    def admit(self, reqs: Dict[str, dict],
              *, context: Optional[dict] = None) -> Tuple[int, ...]:
        """Admit rejoining ranks at an epoch barrier. Collective over the
        current members (all call with the identical ``reqs`` union from
        the same sync); the new epoch's first exchange is the barrier the
        rejoiners enter through. ``context`` rides in the admission ack —
        the guard passes its cadence (``steps_seen``) so the rejoiner
        re-enters lockstep at the right attempt count."""
        cands = sorted(int(r) for r in reqs if int(r) not in self.members)
        if self.ranks_per_slice is not None and cands:
            # slice-gated admission: a slice trains only when its ICI
            # mesh is whole, so a PARTIAL slice's requests are DEFERRED
            # (left in the store, re-polled next sync) until every rank
            # of the slice is present — the relaunched slice then
            # readmits as ONE membership event at one epoch barrier
            have = set(cands) | set(self.members)
            ready: List[int] = []
            for sid in sorted({self.slice_of(r) for r in cands}):
                need = set(self.slice_ranks(sid))
                if need <= have:
                    ready.extend(r for r in cands
                                 if self.slice_of(r) == sid)
                else:
                    logger.warning(
                        "elastic: deferring admission of slice %d — "
                        "rank(s) %s requested but %s not yet back",
                        sid, sorted(r for r in cands
                                    if self.slice_of(r) == sid),
                        sorted(need - have))
            cands = sorted(ready)
        if not cands:
            return ()
        new_members = tuple(sorted(set(self.members) | set(cands)))
        new_epoch = self.epoch + 1
        decided = self._decide_epoch(new_epoch, new_members,
                                     delta={"added": cands})
        if set(decided) != set(new_members):
            # a racing reconfiguration won this epoch number (only a stale
            # partitioned rank can race an admission — admission requires
            # a fully healthy sync); the decided record wins
            raise EvictedError(
                f"epoch {new_epoch} was already decided with members "
                f"{list(decided)} (admission wanted {list(new_members)}) — "
                "exiting for relaunch+rejoin")
        if self.rank == self.leader:
            for r in cands:
                req = reqs[str(r)]
                last = req.get("last_epoch")
                logger.warning(
                    "elastic: admitting rank %d (last known epoch %s) at "
                    "epoch %d", r, last, new_epoch)
                self._transport.set(
                    f"{self._ns}/rejoin/ack/{r}/{req['nonce']}",
                    json.dumps({"epoch": new_epoch,
                                "members": list(new_members),
                                "context": context or {}}))
        for r in cands:
            # the request is consumed at the admission DECISION, on every
            # member (deletes are idempotent; leader-only would leave the
            # key behind if the leader dies mid-admit): a rejoiner that
            # dies before the epoch barrier must not leave a stale
            # request that every later sync re-polls, re-admits, and
            # re-evicts — an indefinite admit/evict thrash burning one
            # barrier timeout and two spurious epochs per health check
            self._transport.delete(f"{self._ns}/rejoin/req/{r}")
        # a never-before-seen rank is a SCALE-UP, not a relaunch: record
        # it in initial_ranks so a later relaunch of it stays admissible
        # even on transports without list_prefix discovery
        fresh = tuple(r for r in cands if r not in self.initial_ranks)
        if fresh:
            self.initial_ranks = tuple(
                sorted(set(self.initial_ranks) | set(fresh)))
        self._commit(new_epoch, new_members)
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.count("cluster.rejoins", len(cands))
            if fresh:
                tr.count("cluster.scale_ups", len(fresh))
                tr.event("cluster.scale_up", epoch=new_epoch,
                         ranks=",".join(map(str, fresh)),
                         world=len(new_members))
            if self.ranks_per_slice is not None:
                back = sorted({self.slice_of(r) for r in cands})
                tr.count("cluster.slice_rejoins", len(back))
                tr.event("cluster.slice_rejoin", epoch=new_epoch,
                         slices=",".join(map(str, back)))
            tr.event("cluster.admit", epoch=new_epoch,
                     admitted=",".join(map(str, cands)))
        try:
            # the epoch barrier: every new member (rejoiners included)
            # meets at e{new_epoch}/admit.barrier seq 0
            self.exchange("admit.barrier", json.dumps({"rank": self.rank}))
        except PeerTimeout as exc:
            # an admitted rank died between its request and the barrier
            # (rejoin racing another failure): shrink it right back out
            lost = getattr(exc, "missing_ranks", ())
            logger.error(
                "elastic: admitted rank(s) %s never reached the epoch-%d "
                "barrier; reconfiguring them out", list(lost), new_epoch)
            self.reconfigure(lost)
            return tuple(c for c in cands if c not in set(lost))
        logger.critical(
            "elastic: membership epoch %d COMMITTED — members %s "
            "(admitted %s)", new_epoch, list(new_members), cands)
        return tuple(cands)

    def rejoin(self, last_epoch: Optional[int] = None,
               *, timeout_s: Optional[float] = None,
               ) -> Tuple[MembershipView, dict]:
        """Relaunched-rank entry: present my last known epoch, wait for
        admission, enter at the epoch barrier. Returns ``(view, context)``
        where ``context`` is whatever the fleet handed over in the ack
        (the guard's ``steps_seen`` cadence anchor). The wait is sized for
        a fleet that may be mid-reconfig or mid-restore when the request
        lands (`REJOIN_TIMEOUT_ENV`)."""
        if timeout_s is None:
            timeout_s = float(os.environ.get(REJOIN_TIMEOUT_ENV, "")
                              or max(10 * self.timeout_s, 60.0))
        # SDC probation gate (resilience.sdc): a host the quarantine
        # ledger holds must pass the known-answer self-test BEFORE the
        # rejoin request is even filed — a silently-corrupting host must
        # not get as far as the admission barrier. A relaunched seat on a
        # fresh host passes trivially (no ledger state).
        from dear_pytorch_tpu_torch.resilience import sdc as _sdc
        if _sdc.sdc_enabled():
            _host = _sdc.host_identity(self.rank)
            _ledger = _sdc.SdcSentinel.from_env(rank=self.rank)
            if _ledger is not None and not _sdc.probation_gate(
                    _ledger.ledger, _host):
                raise ClusterError(
                    f"rank {self.rank} on host {_host} is quarantined in "
                    "the SDC ledger and failed (or was refused) the "
                    "probation self-test — rejoin denied")
        nonce = uuid.uuid4().hex[:12]
        req_key = f"{self._ns}/rejoin/req/{self.rank}"
        self._transport.set(req_key, json.dumps(
            {"rank": self.rank, "last_epoch": last_epoch, "nonce": nonce}))
        logger.warning(
            "elastic: rank %d requesting rejoin (last known epoch %s); "
            "waiting up to %.0fs for admission", self.rank, last_epoch,
            timeout_s)
        try:
            ack = json.loads(self._transport.get(
                f"{self._ns}/rejoin/ack/{self.rank}/{nonce}", timeout_s))
        except PeerTimeout:
            self._transport.delete(req_key)
            raise ClusterError(
                f"rank {self.rank} was not admitted within {timeout_s:.0f}s "
                "— fleet dead, or its sync cadence stalled") from None
        self._transport.delete(req_key)
        self._commit(int(ack["epoch"]), ack["members"])
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.count("cluster.rejoins")
            if self.joining:
                # the scale-up is counted on BOTH sides (like rejoins):
                # a brand-new rank's own telemetry must show how it got
                # here even when every original member has since churned
                tr.count("cluster.scale_ups")
            tr.event("cluster.rejoin", epoch=self.epoch, rank=self.rank,
                     last_epoch=-1 if last_epoch is None else int(last_epoch))
        # the epoch barrier (seq 0 of the admitted epoch)
        self.exchange("admit.barrier", json.dumps({"rank": self.rank}))
        logger.critical(
            "elastic: rank %d ADMITTED at epoch %d — members %s",
            self.rank, self.epoch, list(self.members))
        return self.view(), ack.get("context", {})

    # -- recovery decisions (coordinator surface, elastic semantics) ---------

    def health_check(
        self,
        ok: bool,
        *,
        fingerprint: str = "",
        step: Optional[int] = None,
        preempted: bool = False,
        draining: bool = False,
        sdc_fingerprint: str = "",
        host: str = "",
        group_failed: bool = False,
    ) -> ElasticVerdict:
        """The per-check-interval member sync: any-rank-unhealthy, the
        desync sentinel, preemption propagation — and the membership
        triggers. A member that never reaches the exchange is converted
        into a survivor-set reconfiguration (``reconfigured=True``, epoch
        bumped, health data void for this sync); a pending rejoin/join
        request (leader-polled, union-agreed) is admitted at an epoch
        barrier (``admitted`` non-empty, epoch bumped); a member
        announcing ``draining=True`` (spot SIGTERM with a grace deadline,
        `resilience.preempt`) triggers a **planned** shrink: the
        survivors commit it at THIS sync instead of burning a
        peer-timeout window against the kill, and the drainer's own
        verdict (``self_draining``) tells it to save and exit. The caller
        must treat any ``membership_changed`` verdict as a transition
        point: restamp the plan epoch, reshard the pipeline,
        consensus-restore.

        ``group_failed`` (the port's): a collective of this member's step
        failed. If no member left or joined at this sync, the members
        `reform` the epoch with the same members, which is a transition
        too (``reconfigured``, nothing ``lost``)."""
        epoch0, members0 = self.epoch, self.members
        doc = {
            "ok": bool(ok), "fp": fingerprint, "pre": bool(preempted),
            "drain": bool(draining),
            "sfp": sdc_fingerprint, "host": host,
            "rejoin": self._poll_rejoin_requests(),
        }
        if group_failed:
            doc["gf"] = True
        payload = json.dumps(doc)
        try:
            views = [json.loads(v) for v in self.exchange("health", payload)]
        except PeerTimeout as exc:
            lost = getattr(exc, "missing_ranks", ())
            view = self.reconfigure(lost)
            return ElasticVerdict(
                ok=False, unhealthy_ranks=(), desync=False,
                any_preempted=False, fingerprints=(),
                epoch=view.epoch, members=view.members,
                reconfigured=True,
                # report the COMMITTED removal (the slice closure may be
                # wider than the observed-missing seed)
                lost=tuple(m for m in members0
                           if m not in view.members))
        unhealthy, fps, desync, any_pre, suspects, hosts, voted = (
            evaluate_health_views(
                members0, views, step=step,
                scope=f"elastic (epoch {epoch0})"))
        announced = tuple(r for r, v in zip(members0, views)
                          if v.get("drain"))
        drains = announced
        if announced and self.ranks_per_slice is not None:
            # a spot reclaim anywhere in a slice takes the whole slice's
            # ICI mesh: the planned shrink removes the slice as one unit
            drains = tuple(sorted(self._closure_members(announced)))
            if self.rank in drains and self.rank not in announced:
                # a slice-mate of the drainer holds no preemption signal
                # (and no grace window): exit for relaunch and come back
                # through rejoin when the slice is re-provisioned
                raise EvictedError(
                    f"rank {self.rank}'s slice "
                    f"{self.slice_of(self.rank)} is draining (rank(s) "
                    f"{sorted(announced)} hold the preemption signal) — "
                    "exiting for relaunch+rejoin with the slice")
        if drains and self.rank in drains:
            # I announced the drain: the survivors commit the shrink
            # among themselves (I am the dead set); my remaining duties
            # are the emergency save and a clean exit for the supervisor
            logger.warning(
                "elastic: rank %d draining at step %s — survivors commit "
                "the planned shrink; exiting after the emergency save",
                self.rank, step)
            return ElasticVerdict(
                ok=not unhealthy and not desync and not suspects,
                unhealthy_ranks=unhealthy, desync=desync,
                any_preempted=any_pre, fingerprints=fps,
                epoch=self.epoch, members=self.members, drained=drains,
                sdc_suspects=suspects, hosts=hosts, sdc_voted=voted)
        if drains:
            # planned shrink: commit NOW — no timeout window, the 2PC
            # runs over the survivors only (the drainer never proposes)
            logger.warning(
                "elastic: member(s) %s draining at step %s — committing "
                "a planned shrink", list(drains), step)
            self.reconfigure(drains)
        reqs: Dict[str, dict] = {}
        for v in views:
            reqs.update(v.get("rejoin") or {})
        admitted: Tuple[int, ...] = ()
        if reqs:
            admitted = self.admit(
                reqs, context={"steps_seen": int(step or 0)})
        if self.epoch == epoch0 and any(v.get("gf") for v in views):
            # every member holds these views, so all of them re-form
            self.reform()
        # the epoch can also move INSIDE admit() (its barrier-timeout path
        # reconfigures a dead-before-barrier rank right back out, possibly
        # netting admitted=() with the epoch advanced by 2): any movement
        # must surface as a membership change, or the guard would keep its
        # plan/pipeline stamped with a stale epoch while new sidecars
        # carry the advanced one
        moved = self.epoch != epoch0
        lost = tuple(m for m in members0 if m not in self.members)
        return ElasticVerdict(
            ok=(not unhealthy and not desync and not admitted
                and not moved and not suspects),
            unhealthy_ranks=unhealthy, desync=desync,
            any_preempted=any_pre, fingerprints=fps,
            epoch=self.epoch, members=self.members, admitted=admitted,
            reconfigured=moved and not admitted, lost=lost,
            drained=drains, sdc_suspects=suspects, hosts=hosts,
            sdc_voted=voted)

    def consensus_restore_step(
        self, local_steps: Optional[Sequence[int]],
    ) -> Optional[int]:
        """Newest checkpoint step verified on every current member (see
        `cluster.ClusterCoordinator.consensus_restore_step` — identical
        decision rule, member-scoped exchange). A member lost DURING the
        restore exchange is reconfigured out and the exchange retried over
        the survivors, so a second failure mid-recovery cannot deadlock
        the first one's repair."""
        mine = (None if local_steps is None else
                sorted({int(s) for s in local_steps},
                       reverse=True)[: self.max_candidates])
        if self.world == 1:
            return mine[0] if mine else None
        restore_deadline = float(
            os.environ.get(RESTORE_TIMEOUT_ENV, "") or 10 * self.timeout_s)
        for _ in range(len(self.members) + 1):
            try:
                views = [json.loads(v)
                         for v in self.exchange("restore", json.dumps(mine),
                                                timeout_s=restore_deadline)]
                break
            except PeerTimeout as exc:
                self.reconfigure(getattr(exc, "missing_ranks", ()))
                if self.world == 1:
                    views = [mine]
                    break
        else:
            raise ClusterError("consensus restore never converged")
        return newest_common_step(
            views, scope=f"elastic (epoch {self.epoch})",
            epoch=self.epoch)

    @staticmethod
    def fingerprint(value) -> str:
        from dear_pytorch_tpu_torch.resilience.cluster import (
            ClusterCoordinator)

        return ClusterCoordinator.fingerprint(value)
