"""Host-level cluster coordination: consensus recovery for multi-host runs
— the port of ``dear_pytorch_tpu/resilience/cluster.py``. Where the JAX
package exchanges through the jax coordination service's KV store, the
port exchanges through the c10d store the ranks rendezvoused at
(`StoreTransport`, transport ``"store"``, the default), or through
`comm.collectives.host_allgather` on the host gloo group
(``"allgather"``), or a shared directory (``"file:<dir>"``).

DeAR's value proposition is keeping every replica in lockstep through the
decoupled reduce-scatter/all-gather schedule — which makes *recovery* a
distributed protocol too. Before this module, multi-host failure handling
was a per-process branch: `GuardedTrainer` restored the *unverified*
newest checkpoint (one corrupted file killed the pod) and any local step
exception crashed the whole job for external relaunch. `ClusterCoordinator`
turns every recovery decision into a **consensus** decision over the host
collectives (the c10d store, or `comm.collectives.host_allgather`):

  - **consensus restore** — each process contributes its locally verified
    checkpoint steps (`utils.checkpoint.valid_steps`); everyone restores
    the newest step valid on *every* host (`consensus_restore_step`), so a
    corruption visible to one host degrades the whole pod to the previous
    common step instead of desynchronizing or crashing it.
  - **peer-aware failure propagation** — a tiny per-check-interval
    "any-rank-unhealthy" exchange (`health_check`): a local exception or
    NaN on one rank triggers the *same* rollback on all ranks. A SIGTERM
    seen by one rank propagates the same way, so emergency checkpoints
    stay cooperative.
  - **desync sentinel** — the same exchange carries a fingerprint of a
    replicated scalar (the checked loss); replicas that drift apart are
    detected (``cluster.desync_detected``) and coordinately rolled back
    instead of silently training garbage.
  - **bounded-timeout barrier** — every exchange carries a deadline
    (``DEAR_CLUSTER_TIMEOUT_SECS``); a hung or dead peer raises
    `PeerTimeout`, which the guard converts into the old crash-for-relaunch
    behavior (after kicking the `StepWatchdog` dump) rather than a
    deadlock.

All decisions are deterministic: the protocol is lockstep (every rank
performs the same sequence of exchanges, keyed by per-tag epoch counters),
payloads are JSON, and the chosen step is a pure function of the gathered
views. Telemetry (when enabled): ``cluster.*`` counters and one event per
verdict/restore/timeout. Single-process runs take fast paths that never
touch a transport, so the coordinator is safe to construct everywhere.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from dear_pytorch_tpu_torch.observability import tracer as _telemetry

logger = logging.getLogger("dear_pytorch_tpu_torch")

__all__ = [
    "ClusterError", "PeerTimeout", "DesyncError", "HealthVerdict",
    "LocalTransport", "StoreTransport", "AllgatherTransport",
    "FileTransport", "ClusterCoordinator", "enabled_by_env", "CLUSTER_ENV",
    "TIMEOUT_ENV", "TRANSPORT_ENV",
]

#: Deadline for one coordination exchange (set/gather/barrier) before a
#: peer is declared hung/dead. Generous by default: a peer legitimately
#: finishing its fetch of a slow step must not be declared dead.
TIMEOUT_ENV = "DEAR_CLUSTER_TIMEOUT_SECS"
DEFAULT_TIMEOUT_S = 120.0

#: Deadline for the consensus-restore exchange specifically. Restores are
#: rare and gated on checksum-verifying up to ``max_candidates``
#: checkpoints (minutes for multi-GB payloads on shared storage, and only
#: ONE rank does the hashing there) — peers waiting under the ordinary
#: health-sync deadline would declare the verifying rank dead and crash
#: the pod in exactly the scenario consensus restore exists to survive.
#: Default: 10x the base deadline.
RESTORE_TIMEOUT_ENV = "DEAR_CLUSTER_RESTORE_TIMEOUT_SECS"

#: Transport selection: "store" (the c10d store, native timeouts),
#: "allgather" (`comm.collectives.host_allgather` with a thread-join
#: timeout), or "file:<dir>" (shared-directory store — the only transport
#: that survives rank relaunch, see `FileTransport`). "store" is the
#: default wherever a process group is live.
TRANSPORT_ENV = "DEAR_CLUSTER_TRANSPORT"

#: Kill switch: DEAR_CLUSTER=0 restores the legacy multi-host policy
#: (unverified newest-step restore; local exceptions crash for relaunch).
CLUSTER_ENV = "DEAR_CLUSTER"


def enabled_by_env() -> bool:
    """Cluster coordination is opt-out: on unless ``DEAR_CLUSTER`` says
    otherwise."""
    return os.environ.get(CLUSTER_ENV, "").strip().lower() not in (
        "0", "false", "no", "off")

_ALLGATHER_PAYLOAD_BYTES = 2048  # fixed-size slot per rank (allgather needs
#                                  identical shapes on every process)


def evaluate_health_views(ranks, views, *, step, scope="cluster"):
    """The shared any-rank-unhealthy / desync-sentinel / preemption
    evaluation over one gathered health exchange, with its telemetry and
    logging. `ClusterCoordinator` (fixed world) and
    `resilience.membership.ElasticCluster` (member-scoped) must never
    drift on this decision rule, so both call here. Returns
    ``(unhealthy_ranks, fingerprints, desync, any_preempted,
    sdc_suspects, hosts, sdc_voted)`` — ``hosts`` as (rank, host) pairs,
    ``sdc_voted`` True when enough fingerprint-bearing voters reached
    this sync for blame to be decidable.

    When views carry per-bucket SDC fingerprints (``sfp``, emitted by
    the compiled step under `DEAR_SDC`), a strict per-bucket majority
    vote localizes silent divergence to ``(rank, bucket)`` suspects —
    the minority is the corrupt party because post-reduce bucket state
    is replica-identical by construction. With too few voters to blame
    anyone (< 3), a fingerprint disagreement still trips the plain
    desync sentinel: caught, just not localized."""
    unhealthy = tuple(r for r, v in zip(ranks, views) if not v["ok"])
    fps = tuple(v["fp"] for v in views)
    healthy_fps = {v["fp"] for v in views if v["ok"] and v["fp"]}
    desync = len(healthy_fps) > 1
    any_pre = any(v["pre"] for v in views)
    hosts = tuple((r, v.get("host", "")) for r, v in zip(ranks, views))
    sfps = {r: v.get("sfp", "")
            for r, v in zip(ranks, views) if v["ok"]}
    sdc_suspects = ()
    sdc_voted = sum(1 for s in sfps.values() if s) >= 3
    if any(sfps.values()):
        from dear_pytorch_tpu_torch.resilience import sdc as _sdc

        sdc_suspects = tuple(_sdc.vote(sfps))
        if not sdc_suspects and len({s for s in sfps.values() if s}) > 1:
            desync = True
    tr = _telemetry.get_tracer()
    if tr.enabled:
        tr.count("cluster.health_checks")
        if unhealthy:
            tr.count("cluster.unhealthy_detected")
            tr.event("cluster.unhealthy", step=step or -1,
                     ranks=",".join(map(str, unhealthy)))
        if desync:
            tr.count("cluster.desync_detected")
            tr.event("cluster.desync", step=step or -1,
                     fingerprints=";".join(fps)[:200])
        if any_pre:
            tr.count("cluster.preempt_propagated")
        if sdc_suspects:
            tr.count("cluster.sdc_suspects_detected")
            tr.event("cluster.sdc_suspects", step=step or -1,
                     suspects=";".join(
                         f"{r}:{b}" for r, b in sdc_suspects))
    if sdc_suspects:
        logger.critical(
            "%s: SDC at step %s — fingerprint minority vote blames "
            "(rank, bucket) %s", scope, step, list(sdc_suspects))
    if desync:
        logger.critical(
            "%s: DESYNC at step %s — replica fingerprints disagree: %s",
            scope, step, list(fps))
    elif unhealthy:
        logger.warning(
            "%s: rank(s) %s unhealthy at step %s — coordinated rollback",
            scope, list(unhealthy), step)
    return unhealthy, fps, desync, any_pre, sdc_suspects, hosts, sdc_voted


def newest_common_step(views, *, scope="cluster", epoch=None):
    """The shared consensus-restore decision rule over the gathered
    per-rank verified-step views: the newest step present in EVERY
    opining view (None views defer), with its telemetry and logging —
    one implementation for both coordinators."""
    opining = [set(v) for v in views if v is not None]
    common = set.intersection(*opining) if opining else set()
    step = max(common) if common else None
    tr = _telemetry.get_tracer()
    if tr.enabled:
        tr.count("cluster.consensus_restores")
        attrs = dict(
            step=-1 if step is None else step,
            newest_per_rank=",".join(
                "-" if not v else str(max(v)) for v in views))
        if epoch is not None:
            attrs["epoch"] = epoch
        tr.event("cluster.consensus_restore", **attrs)
    logger.warning(
        "%s: consensus restore step = %s (per-rank newest: %s)",
        scope, step, [max(v) if v else None for v in views])
    return step


class ClusterError(RuntimeError):
    """Base class for cluster-coordination failures."""


class PeerTimeout(ClusterError):
    """A peer did not reach the exchange within the deadline — hung or
    dead. The guard degrades to crash-for-relaunch on this."""


class DesyncError(ClusterError):
    """Replicas disagree on a value that must be replicated."""


class HealthVerdict(NamedTuple):
    """Outcome of one `ClusterCoordinator.health_check` exchange."""

    ok: bool                        # all ranks healthy AND no desync
    unhealthy_ranks: tuple         # ranks that reported not-ok
    desync: bool                   # healthy ranks' fingerprints disagree
    any_preempted: bool            # some rank saw a preemption signal
    fingerprints: tuple            # per-rank fingerprint strings
    sdc_suspects: tuple = ()       # (rank, bucket) fingerprint-vote losers
    hosts: tuple = ()              # (rank, host-identity) ledger-key pairs
    sdc_voted: bool = False        # enough voters reached this sync to blame


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------


class LocalTransport:
    """In-memory transport: the single-process fast path, and the unit-test
    harness for the consensus logic (N coordinators on N threads sharing
    one instance behave like N processes)."""

    def __init__(self, num_processes: int = 1):
        self.num_processes = int(num_processes)
        self._store: Dict[str, str] = {}
        self._cv = threading.Condition()
        self._barrier = threading.Barrier(self.num_processes)

    def set(self, key: str, value: str) -> None:
        with self._cv:
            self._store[key] = value
            self._cv.notify_all()

    def get(self, key: str, timeout_s: float) -> str:
        with self._cv:
            if not self._cv.wait_for(lambda: key in self._store,
                                     timeout=timeout_s):
                raise PeerTimeout(
                    f"no peer published {key!r} within {timeout_s:.1f}s")
            return self._store[key]

    def delete(self, key: str) -> None:
        with self._cv:
            self._store.pop(key, None)

    def decide_once(self, key: str, value: str) -> str:
        """First-writer-wins: atomically publish ``value`` under ``key``
        unless a value is already there; returns the winning value either
        way (the consensus-decision primitive `ElasticCluster` anchors
        epoch commits on)."""
        with self._cv:
            won = self._store.setdefault(key, value)
            self._cv.notify_all()
            return won

    def list_prefix(self, prefix: str) -> List[str]:
        """Child key names directly under ``prefix`` (non-blocking). The
        discovery primitive scale-UP admission needs: a brand-new rank's
        join request lands under a key the members cannot enumerate from
        any static rank list."""
        base = prefix.rstrip("/") + "/"
        with self._cv:
            return sorted({k[len(base):].split("/", 1)[0]
                           for k in self._store if k.startswith(base)})

    def barrier(self, tag: str, timeout_s: float) -> None:
        try:
            self._barrier.wait(timeout=timeout_s)
        except threading.BrokenBarrierError:
            raise PeerTimeout(
                f"barrier {tag!r} broken/timed out after {timeout_s:.1f}s"
            ) from None


class FileTransport:
    """Shared-directory KV store: ``set`` is an atomic file write under
    ``root`` (tmp + ``os.replace``), ``get`` polls for the file until the
    deadline. No process group involved at all — which is exactly
    what whole-process elasticity needs: the store outlives any single
    rank, a relaunched rank sees every key its predecessor's peers wrote,
    and rank death can never take the coordination substrate down with it
    (the c10d TCP store lives *inside* process 0, so host-0 loss kills
    that transport's store). Works on any
    filesystem every rank can reach: local disk for same-host process
    clusters (`launch/supervisor.py`), NFS/GCS-fuse on a pod.

    ``barrier`` needs ``index``/``num_processes`` (marker-file gather);
    `resilience.membership.ElasticCluster` never calls it — membership
    can't barrier on a fixed world — so elastic use may omit both.
    """

    def __init__(self, root: str, *, index: Optional[int] = None,
                 num_processes: Optional[int] = None, poll_s: float = 0.02):
        self.root = os.path.abspath(root)
        self.index = index
        self.num_processes = num_processes
        self.poll_s = float(poll_s)
        self._prev_barrier: Optional[str] = None
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        # keys are '/'-structured; mirror them as directories so the store
        # stays human-debuggable (ls the tree to watch a protocol run)
        parts = [p for p in key.split("/") if p not in ("", ".", "..")]
        return os.path.join(self.root, *parts)

    def set(self, key: str, value: str) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(value)
        os.replace(tmp, path)  # readers see the whole value or no file

    def get(self, key: str, timeout_s: float) -> str:
        import time as _time

        path = self._path(key)
        deadline = _time.monotonic() + max(float(timeout_s), 0.0)
        while True:
            try:
                with open(path) as f:
                    return f.read()
            except OSError:
                pass
            if _time.monotonic() >= deadline:
                raise PeerTimeout(
                    f"no peer published {key!r} within {timeout_s:.1f}s")
            _time.sleep(self.poll_s)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except OSError:
            pass

    def decide_once(self, key: str, value: str) -> str:
        """First-writer-wins publish (see `LocalTransport.decide_once`).
        Atomic via hard-link of a fully-written tmp file — ``link`` fails
        with EEXIST when another rank won, and a reader can never observe
        a partially written value (the tmp is complete before linking)."""
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(value)
        try:
            os.link(tmp, path)
            return value
        except FileExistsError:
            return self.get(key, self.poll_s)
        except OSError:
            # filesystem without hard links (some FUSE mounts): exclusive
            # create of the final path — racier (a concurrent reader can
            # catch the value mid-write) but still first-writer-wins
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                with os.fdopen(fd, "w") as f:
                    f.write(value)
                return value
            except FileExistsError:
                return self.get(key, self.poll_s)
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def prune_prefix(self, prefix: str) -> None:
        """Best-effort GC of a whole key subtree (an elastic epoch's
        exchanges after the fleet moved past it)."""
        import shutil

        try:
            shutil.rmtree(self._path(prefix), ignore_errors=True)
        except OSError:
            pass

    def list_prefix(self, prefix: str) -> List[str]:
        """Child key names directly under ``prefix`` (non-blocking; empty
        when the subtree does not exist). In-flight atomic-write temp
        files are excluded — a reader must never enumerate a key whose
        value has not committed."""
        try:
            return sorted(n for n in os.listdir(self._path(prefix))
                          if ".tmp." not in n)
        except OSError:
            return []

    def barrier(self, tag: str, timeout_s: float) -> None:
        if self.index is None or self.num_processes is None:
            raise ClusterError(
                "FileTransport.barrier needs index/num_processes at "
                "construction (elastic membership never barriers on a "
                "fixed world; pass both for ClusterCoordinator use)")
        self.set(f"{tag}/{self.index}", "b")
        for r in range(self.num_processes):
            self.get(f"{tag}/{r}", timeout_s)
        # lag-1 GC: every rank is past the PREVIOUS barrier (it published
        # this one's marker, which happens only after completing that
        # gather), so its subtree is dead weight on the shared store —
        # prune it now instead of accreting one marker per rank per sync
        # for the life of the run. Concurrent prunes are idempotent.
        if self._prev_barrier is not None and self._prev_barrier != tag:
            self.prune_prefix(self._prev_barrier)
        self._prev_barrier = tag


class StoreTransport:
    """The c10d store the ranks rendezvoused at (`comm.backend.store`) as
    the exchange's key-value store — the port's stand-in for the JAX
    package's coordination-service transport: host-level (no device stream
    and no process group is involved, so it stays usable while a
    collective is wedged), with native deadlines (``store.wait``). Keys
    live under their own prefix, apart from c10d's."""

    def __init__(self, store=None, *, index: Optional[int] = None,
                 num_processes: Optional[int] = None):
        import torch.distributed as dist

        if store is None:
            from dear_pytorch_tpu_torch.comm import backend

            if not backend.is_initialized():
                raise ClusterError(
                    "no process group: the store transport needs the "
                    "store the ranks rendezvoused at (comm.backend.init "
                    "on a launched cluster)")
            store = backend.store()
        self._store = dist.PrefixStore("dear_cluster/", store)
        self.index = index
        self.num_processes = num_processes

    def set(self, key: str, value: str) -> None:
        self._store.set(key, value.encode("utf-8"))

    def get(self, key: str, timeout_s: float) -> str:
        import datetime

        try:
            self._store.wait(
                [key], datetime.timedelta(seconds=max(timeout_s, 0.001)))
        except Exception as exc:  # c10d raises a DistStoreError/Runtime
            raise PeerTimeout(
                f"no peer published {key!r} within {timeout_s:.1f}s "
                f"({type(exc).__name__})") from None
        return self._store.get(key).decode("utf-8")

    def delete(self, key: str) -> None:
        try:
            self._store.delete_key(key)
        except Exception:  # best-effort GC; never fail an exchange on it
            pass

    def barrier(self, tag: str, timeout_s: float) -> None:
        if self.index is None or self.num_processes is None:
            raise ClusterError(
                "StoreTransport.barrier needs index/num_processes at "
                "construction")
        self.set(f"{tag}/{self.index}", "b")
        for r in range(self.num_processes):
            self.get(f"{tag}/{r}", timeout_s)


class AllgatherTransport:
    """Exchange built on `comm.collectives.host_allgather` (one
    all-gather on the host gloo group, `comm.backend.host_group`), for
    runs without a reachable store. The allgather IS
    the barrier; the deadline is enforced by running it on a worker thread
    and abandoning it on timeout (the abandoned collective stays wedged,
    which is fine: the caller is about to crash for relaunch)."""

    #: The data gather is itself a barrier and delete() is a local cache
    #: pop — the exchange's pre-delete GC barrier would be a second full
    #: collective per exchange for nothing.
    needs_gc_barrier = False

    def __init__(self, process_index: int, process_count: int):
        self.index = int(process_index)
        self.num_processes = int(process_count)
        self._pending: Dict[str, str] = {}
        self._gathered: Dict[str, List[str]] = {}

    # The generic KV surface degenerates: `set` stages the local payload
    # and the first `get` runs one collective gather for the whole round.
    def set(self, key: str, value: str) -> None:
        raw = value.encode("utf-8")
        if len(raw) + 4 > _ALLGATHER_PAYLOAD_BYTES:
            raise ClusterError(
                f"payload for {key!r} exceeds the {_ALLGATHER_PAYLOAD_BYTES}"
                "-byte allgather slot"
            )
        base = key.rsplit("/", 1)[0]
        self._pending[base] = value

    def _gather(self, base: str, timeout_s: float) -> List[str]:
        from dear_pytorch_tpu_torch.comm import collectives as C

        local = self._pending.pop(base, "")
        raw = local.encode("utf-8")
        buf = np.zeros((_ALLGATHER_PAYLOAD_BYTES,), dtype=np.uint8)
        buf[:4] = np.frombuffer(
            len(raw).to_bytes(4, "big"), dtype=np.uint8)
        buf[4:4 + len(raw)] = np.frombuffer(raw, dtype=np.uint8)

        out: List = [None]
        err: List = [None]

        def work():
            try:
                out[0] = C.host_allgather(buf)
            except BaseException as exc:  # surfaced on the caller thread
                err[0] = exc

        t = threading.Thread(target=work, daemon=True,
                             name="dear-cluster-allgather")
        t.start()
        t.join(timeout=timeout_s)
        if t.is_alive():
            raise PeerTimeout(
                f"host allgather {base!r} did not complete within "
                f"{timeout_s:.1f}s (hung or dead peer)")
        if err[0] is not None:
            raise err[0]
        stacked = np.asarray(out[0])
        vals = []
        for r in range(stacked.shape[0]):
            n = int.from_bytes(stacked[r, :4].tobytes(), "big")
            vals.append(stacked[r, 4:4 + n].tobytes().decode("utf-8"))
        return vals

    def get(self, key: str, timeout_s: float) -> str:
        base, _, rank_s = key.rpartition("/")
        if base not in self._gathered:
            self._gathered[base] = self._gather(base, timeout_s)
        return self._gathered[base][int(rank_s)]

    def delete(self, key: str) -> None:
        self._gathered.pop(key.rsplit("/", 1)[0], None)

    def barrier(self, tag: str, timeout_s: float) -> None:
        # a dedicated tiny round: the gather synchronizes every process
        self.set(f"{tag}/{self.index}", "b")
        self._gather(tag, timeout_s)


# ---------------------------------------------------------------------------
# The coordinator
# ---------------------------------------------------------------------------

_instance_counter = 0
_instance_lock = threading.Lock()


def _next_instance() -> int:
    """Process-wide coordinator counter. Deterministic across ranks: the
    protocol is SPMD, so every rank constructs its Nth coordinator at the
    same program point — the counter keeps KV namespaces (and barrier ids)
    collision-free across trainers in one process lifetime."""
    global _instance_counter
    with _instance_lock:
        _instance_counter += 1
        return _instance_counter


class ClusterCoordinator:
    """Consensus recovery decisions over a host-level transport.

    Every public call is a *collective*: all ranks must call it in the
    same order with the same ``tag`` cadence (the guard's check-interval
    discipline guarantees this). Single-process construction is free and
    every call takes a local fast path.
    """

    def __init__(
        self,
        *,
        namespace: str = "default",
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        timeout_s: Optional[float] = None,
        transport=None,
        max_candidates: int = 16,
        instance: Optional[int] = None,
    ):
        if process_index is None or process_count is None:
            from dear_pytorch_tpu_torch.comm import backend

            process_index = backend.rank()
            process_count = backend.size()
        self.index = int(process_index)
        self.process_count = int(process_count)
        if timeout_s is None:
            timeout_s = float(os.environ.get(TIMEOUT_ENV, "")
                              or DEFAULT_TIMEOUT_S)
        self.timeout_s = float(timeout_s)
        self.max_candidates = max(int(max_candidates), 1)
        # ``instance`` override: N same-process coordinators playing N
        # ranks over one LocalTransport (unit tests) must share a
        # namespace the per-process counter would otherwise split
        inst = _next_instance() if instance is None else int(instance)
        self._ns = f"dearclu/{namespace}/{inst}"
        self._epochs: Dict[str, int] = {}
        if transport is None and self.process_count > 1:
            transport = (os.environ.get(TRANSPORT_ENV, "store").strip()
                         or "store")
        if isinstance(transport, str):
            if transport == "store":
                transport = StoreTransport(index=self.index,
                                           num_processes=self.process_count)
            elif transport == "allgather":
                transport = AllgatherTransport(self.index, self.process_count)
            elif transport.startswith("file:"):
                transport = FileTransport(
                    transport[len("file:"):], index=self.index,
                    num_processes=self.process_count)
            else:
                raise ValueError(
                    f"{TRANSPORT_ENV}={transport!r}: valid transports are "
                    "'store', 'allgather', and 'file:<dir>'"
                )
        self._transport = transport

    # -- plumbing ------------------------------------------------------------

    def _epoch(self, tag: str) -> int:
        e = self._epochs.get(tag, 0)
        self._epochs[tag] = e + 1
        return e

    def exchange(self, tag: str, payload: str,
                 timeout_s: Optional[float] = None) -> List[str]:
        """All-gather one string per rank (index-ordered). Lockstep: every
        rank must call with the same tag sequence. Raises `PeerTimeout`
        when a peer does not show up within the deadline (``timeout_s``
        overrides the coordinator default for exchanges whose legitimate
        work is slower than a heartbeat, e.g. restore verification)."""
        if self.process_count == 1:
            return [payload]
        deadline = self.timeout_s if timeout_s is None else float(timeout_s)
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.count("cluster.exchanges")
        e = self._epoch(tag)
        base = f"{self._ns}/{tag}/{e}"
        try:
            self._transport.set(f"{base}/{self.index}", payload)
            vals = [self._transport.get(f"{base}/{r}", deadline)
                    for r in range(self.process_count)]
            # every rank has read every key: the per-rank keys can be
            # GC'd. The pre-delete barrier exists for SHARED stores (a
            # rank must not delete its key before a slow peer reads it);
            # a transport whose gather already synchronized everyone —
            # and whose delete is local — skips that second collective.
            if getattr(self._transport, "needs_gc_barrier", True):
                self._transport.barrier(f"{base}/done", deadline)
            self._transport.delete(f"{base}/{self.index}")
        except PeerTimeout as exc:
            if tr.enabled:
                tr.count("cluster.peer_timeouts")
                tr.event("cluster.peer_timeout", tag=tag, epoch=e,
                         timeout_s=deadline)
            logger.critical(
                "cluster: exchange %s (epoch %d) timed out after %.1fs — "
                "hung or dead peer; degrading to crash-for-relaunch: %s",
                tag, e, deadline, exc,
            )
            raise
        return vals

    def barrier(self, tag: str = "barrier") -> None:
        """Bounded-timeout barrier over the transport."""
        if self.process_count == 1:
            return
        e = self._epoch(f"{tag}.bar")
        self._transport.barrier(f"{self._ns}/{tag}.bar/{e}", self.timeout_s)

    # -- recovery decisions --------------------------------------------------

    def health_check(
        self,
        ok: bool,
        *,
        fingerprint: str = "",
        step: Optional[int] = None,
        preempted: bool = False,
        sdc_fingerprint: str = "",
        host: str = "",
    ) -> HealthVerdict:
        """The per-check-interval any-rank-unhealthy exchange.

        ``fingerprint`` is the desync sentinel: a digest of a value that
        must be bit-identical on every replica (the guard passes the
        checked loss). Healthy ranks whose fingerprints disagree yield
        ``desync=True`` — silent replica divergence, caught instead of
        trained through. ``preempted`` propagates a preemption signal seen
        by any rank to every rank, so emergency saves stay cooperative.
        ``sdc_fingerprint`` is the per-bucket SDC sentinel (dotted-hex
        uint32 checksums from the compiled step) and ``host`` the ledger
        identity blame should stick to — see `resilience.sdc`.
        """
        payload = json.dumps({
            "ok": bool(ok), "fp": fingerprint, "pre": bool(preempted),
            "sfp": sdc_fingerprint, "host": host,
        })
        views = [json.loads(v)
                 for v in self.exchange("health", payload)]
        unhealthy, fps, desync, any_pre, suspects, hosts, voted = (
            evaluate_health_views(range(len(views)), views, step=step))
        return HealthVerdict(
            ok=not unhealthy and not desync and not suspects,
            unhealthy_ranks=unhealthy, desync=desync,
            any_preempted=any_pre, fingerprints=fps,
            sdc_suspects=suspects, hosts=hosts, sdc_voted=voted,
        )

    def consensus_restore_step(
        self, local_steps: Optional[Sequence[int]],
    ) -> Optional[int]:
        """Newest checkpoint step verified on *every* opining host.

        ``local_steps`` is this rank's locally verified view (newest
        first, e.g. `utils.checkpoint.valid_steps`); only the newest
        ``max_candidates`` entries are exchanged. Pass None for "no local
        opinion" — on SHARED checkpoint storage every rank sees the same
        directory, so one rank verifies for everyone and the rest defer
        instead of re-hashing identical multi-GB files N times (the guard
        does exactly this; per-host storage keeps one view per rank).
        Returns None when no step is valid on every opining host (or
        nobody opined) — nothing commonly restorable."""
        mine = (None if local_steps is None else
                sorted({int(s) for s in local_steps},
                       reverse=True)[: self.max_candidates])
        if self.process_count == 1:
            return mine[0] if mine else None
        restore_deadline = float(
            os.environ.get(RESTORE_TIMEOUT_ENV, "") or 10 * self.timeout_s)
        views = [json.loads(v)
                 for v in self.exchange("restore", json.dumps(mine),
                                        timeout_s=restore_deadline)]
        return newest_common_step(views)

    @staticmethod
    def fingerprint(value) -> str:
        """Bit-exact digest of a host scalar/array for the desync
        sentinel (replicated values must agree byte-for-byte): a hash of
        the FULL buffer — truncating the bytes themselves would silently
        compare only a prefix of larger arrays — tagged with dtype/shape
        so reinterpretations can't collide."""
        import hashlib

        arr = np.asarray(value)
        digest = hashlib.sha256(arr.tobytes()).hexdigest()[:32]
        return f"{digest}:{arr.dtype}:{arr.shape}"
