"""Host-level cross-slice gradient exchange: the DCN leg of the
hierarchical (multi-slice) DeAR schedule — the port of
``dear_pytorch_tpu/comm/dcn.py``.

A multi-slice fleet has two interconnect levels with α-β constants
orders of magnitude apart: a fast link inside a slice, a slow one
between slices. The DeAR-native port (arxiv 2302.12445) is a
**two-level decoupled schedule**: per-bucket reduce-scatter /
all-gather over the slice's own process group stays in the train step
(`parallel.dear.build_train_step(mode='dear', dcn=..., group=<slice
group>)`), while the cross-slice averaging of the reduced partials runs
here — on the host, over a `resilience.cluster`-style KV transport —
between the backward and the optimizer update.

In the JAX package each process holds a whole slice as a local mesh.
Here a process drives one card, so a slice is a GROUP of processes
(`comm.backend.slice_group`): each rank of a slice gathers the slice's
reduced buckets over that group and publishes byte-identical payloads
under the same keys (the JAX contract, "gathered back over ICI by the
caller"), and an exchanger holds exactly one local slice.

The exchange protocol, per training step:

  1. every slice PUBLISHES its bucket partials (the intra-slice
     reduce-scatter means, already divided by the ICI world) under
     epoch-scoped, step-scoped keys, split into ``partition_mb`` chunks
     (`ops.fusion.chunk_bounds` — the per-level bucket partition, so the
     DCN level pipelines at its own message size independent of the ICI
     bucket threshold); every chunk carries an integrity header
     (epoch, step, bucket, chunk, publish seq, sha256) so a torn KV
     write, a duplicated stale value, or a replayed old key is REJECTED
     and counted (``dcn.chunk_rejects``), never silently merged;
  2. it FETCHES the other slices' chunks with a one-ahead prefetch
     thread — the fetch of chunk j+1 is in flight while chunk j is
     decoded and accumulated, and the whole fetch phase overlaps the
     peers' still-running publishes (the decoupled-allreduce overlap,
     at the DCN level);
  3. the mean over the LIVE slice set is returned — membership is a
     parameter, not a constant: `set_slices` renormalizes the exchange
     after an elastic slice loss or rejoin (``dcn.renorms``), so
     degraded-mode training on the survivors needs no recompilation
     (the jitted programs never see the slice count).

Degraded mode — the escalation ladder
-------------------------------------

With ``DEAR_DCN_STALENESS`` >= 1 rounds the exchange stops treating a
cross-slice hiccup as a fleet event. The ladder, rung by rung:

  1. **Retry.** Per-chunk fetches run through `resilience.retry`
     (decorrelated-jitter backoff, ``DEAR_DCN_RETRIES`` attempts after
     the first) inside a per-slice per-step budget of ``timeout_s`` —
     a short flap heals inside the round and never surfaces at all.
  2. **Skip, don't stall.** On budget exhaustion the round averages
     over the slices whose partials arrived. The include/exclude
     decision is **replica-identical**: a tiny per-round participation
     record rides the exchange (the `evaluate_health_views` two-phase
     idiom) — each slice publishes the set of peers it fetched, and the
     include set is the intersection over every gathered record, so a
     slice that ANY participant missed is excluded everywhere,
     including on its own ranks (the desync sentinel backstops the
     residual asymmetric-header window). An excluded slice carries its
     unmerged partial as an **error-feedback residual** (the
     `_repack_comp_state` idiom: additive, in gradient units,
     mass-preserving, persisted in checkpoint sidecars) and republishes
     partial+residual next round — skipped mass is deferred, not lost.
  3. **Escalate.** A slice unmerged for more than the staleness budget
     stops being waited for at all (``dcn.escalations``); its own ranks
     reach the same verdict from the gathered records and raise
     `DcnSelfEvict` to exit for relaunch — the existing slice-granular
     membership machinery (health-sync peer timeout → slice-closed
     shrink epoch → slice-gated rejoin) becomes the LAST rung instead
     of the first response.

A ``staleness=1`` always-on setting doubles as the cross-iteration
prefetch primitive (ROADMAP item 1c): `prefetch` arms a background
fetch of the current step's remote chunks while the backward program
is still running on device, and a peer lagging a single round costs
nothing (its mass arrives one step late through the residual).

With ``DEAR_DCN_STALENESS=0`` (the default) the strict synchronous
contract is unchanged: a missing partial raises `DcnPeerTimeout`
within ``DEAR_DCN_TIMEOUT_SECS`` (deliberately shorter than the
cluster health deadline) and the guard's coordinated recovery handles
it.

Fault hooks (`resilience.inject`): ``dcn_slow@N:SECS`` arms a
persistent per-exchange latency (a straggler slice),
``dcn_drop@N`` suppresses one exchange's outbound publish,
``dcn_flap@N:K`` suppresses K alternating exchanges (drop/recover
cycles — the transient the retry/skip rungs must absorb), and
``dcn_partition@N:SECS`` suppresses outbound for SECS of wall time (a
sustained partition that must escalate past the staleness budget).
All are slice-targetable (``:sK``).

Telemetry: ``dcn.exchanges`` / ``dcn.bytes`` / ``dcn.chunks`` /
``dcn.peer_timeouts`` / ``dcn.renorms`` / ``dcn.chunk_rejects`` /
``dcn.skips`` / ``dcn.degraded_rounds`` / ``dcn.escalations`` /
``dcn.self_evicts`` / ``dcn.residual_carries`` /
``dcn.prefetch_hits`` counters, plus per-fetch ``(bytes, seconds)``
samples (`samples`) feeding the link-aware α-β fit
(`observability.overlap.fit_dcn` → the plan tuner's per-level cost
model).

One repair: `exchange` joins the cross-iteration prefetch thread AFTER
its own publish, where the JAX module joins it before — there two
slices in lockstep each wait for the other's publish until the prefetch
budget (``timeout_s``) runs out, every degraded round.

The JAX module's step-trace spans (``dcn.round``, ``dcn.ladder``) and
the chunk header's ``trace`` field are left out: they come with the
fleet tracer (ROADMAP Queue 1 item 12). Decoders verify only the header
fields they expect, so the JAX package's decoders accept these chunks
and this one accepts theirs, trace field or not.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from dear_pytorch_tpu_torch.observability import tracer as _telemetry
from dear_pytorch_tpu_torch.ops import fusion as F

__all__ = [
    "DcnError", "DcnPeerTimeout", "DcnChunkReject", "DcnSelfEvict",
    "DcnExchanger", "DCN_TIMEOUT_ENV", "DCN_RETRIES_ENV",
    "DCN_STALENESS_ENV",
]

#: Deadline for fetching ONE remote slice's chunk (strict mode) / the
#: per-slice per-step retry budget (degraded mode). Sized below the
#: cluster health deadline on purpose: a dead slice must fail the step
#: (and hand recovery to the guard's membership machinery) before the
#: health sync itself would have timed out.
DCN_TIMEOUT_ENV = "DEAR_DCN_TIMEOUT_SECS"
_DEFAULT_TIMEOUT_S = 20.0

#: Retries per chunk AFTER the first attempt (decorrelated-jitter
#: backoff through `resilience.retry`), inside the per-slice budget.
DCN_RETRIES_ENV = "DEAR_DCN_RETRIES"
_DEFAULT_RETRIES = 2

#: Staleness budget: consecutive rounds a live slice may go unmerged
#: before the ladder escalates to membership eviction. 0 = strict
#: synchronous averaging (any missing partial fails the step).
DCN_STALENESS_ENV = "DEAR_DCN_STALENESS"


class DcnError(RuntimeError):
    """Base class for cross-slice exchange failures."""


class DcnPeerTimeout(DcnError):
    """A remote slice never published its partial within the deadline —
    the slice is dead, partitioned, or dropped its publish (fault). The
    guard treats this as an ordinary step error: coordinated rollback,
    then the membership layer decides whether the slice is gone."""


class DcnChunkReject(DcnError):
    """A fetched chunk failed wire-integrity verification (torn write,
    duplicated stale value, replayed old key) and no clean replacement
    appeared within the deadline. Strict mode only — degraded mode
    absorbs rejects into the skip rung."""


class DcnSelfEvict(DcnError):
    """This process's OWN slice has been unmerged past the staleness
    budget on the fleet's replica-identical view: its contribution is
    not reaching the mean (sustained outbound partition, or the slice
    is the fleet's designated straggler past tolerance). Mirrors
    `membership`'s eviction honesty — the rank exits for relaunch and
    re-enters through the slice-gated rejoin path; the guard re-raises
    this instead of deferring it to a rollback."""


class _ChunkReject(Exception):
    """Internal: one fetched value failed verification (retried)."""


def _digest(raw: bytes) -> str:
    return hashlib.sha256(raw).hexdigest()


def _encode(arr: np.ndarray, *, meta: Optional[dict] = None) -> str:
    """Text-safe framing for KV transports that store strings (the
    FileTransport contract): one JSON header line + base64 payload. The
    header carries the wire-integrity fields (epoch/step/bucket/chunk/
    seq/sha256) when ``meta`` is given. A production DCN transport
    would move raw bytes (gRPC/RDMA); the framing is an
    emulation-substrate cost, stated here once."""
    raw = np.ascontiguousarray(arr).tobytes()
    header = {"dtype": str(arr.dtype), "n": int(arr.size)}
    if meta is not None:
        header.update(meta)
        header["sha256"] = _digest(raw)
    return json.dumps(header) + "\n" + base64.b64encode(raw).decode("ascii")


def _decode(text: str, *, expect: Optional[dict] = None) -> np.ndarray:
    """Decode one framed chunk. With ``expect`` (the integrity fields
    the KEY promised: epoch/step/bucket/chunk), verify the embedded
    header and the payload sha256 — a mismatch raises `_ChunkReject`
    instead of returning bytes that would be silently averaged."""
    head, _, body = text.partition("\n")
    try:
        meta = json.loads(head)
        raw = base64.b64decode(body, validate=True)
    except (ValueError, json.JSONDecodeError) as exc:
        raise _ChunkReject(f"unparseable chunk framing: {exc}") from exc
    if expect is not None:
        for k, v in expect.items():
            if meta.get(k) != v:
                raise _ChunkReject(
                    f"chunk header {k}={meta.get(k)!r} != expected {v!r} "
                    "(replayed stale key or cross-step duplicate)")
        want = meta.get("sha256")
        if want is not None and _digest(raw) != want:
            raise _ChunkReject("payload sha256 mismatch (torn KV write)")
        n = int(meta["n"]) * np.dtype(meta["dtype"]).itemsize
        if len(raw) != n:
            raise _ChunkReject(
                f"payload is {len(raw)} bytes, header says {n} (torn)")
    return np.frombuffer(raw, dtype=np.dtype(meta["dtype"]),
                         count=int(meta["n"]))


def _encode_state_array(arr: np.ndarray) -> dict:
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "b64": base64.b64encode(
                np.ascontiguousarray(arr).tobytes()).decode("ascii")}


def _decode_state_array(d: dict) -> np.ndarray:
    raw = base64.b64decode(d["b64"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(
        d["shape"]).copy()


class DcnExchanger:
    """Chunked, prefetch-overlapped cross-slice averaging over a host KV
    transport (see the module docstring for the protocol and the
    degraded-mode escalation ladder).

    Args:
      transport: a `resilience.cluster` transport (``set``/``get``/
        ``delete``, optionally ``prune_prefix``) or a ``"file:<dir>"``
        spec resolved to a `FileTransport`.
      local_slices: the slice id THIS process belongs to, as a one-element
        sequence (the JAX package's signature). A port process drives one
        card, so it is one rank of one slice; more than one local slice
        is refused.
      slices: ALL live slice ids (the cross-slice reduction set).
      partition_mb: per-level bucket partition — the DCN message size
        (`ops.fusion.chunk_bounds`); a `PlanSpace` searched axis.
      retries: per-chunk retries after the first attempt
        (``DEAR_DCN_RETRIES``; only consulted in degraded mode).
      staleness: the staleness budget in rounds (``DEAR_DCN_STALENESS``);
        0 keeps the strict synchronous contract.
      injector: optional `resilience.inject.FaultInjector` for the
        ``dcn_slow``/``dcn_drop``/``dcn_flap``/``dcn_partition`` kinds.
    """

    def __init__(
        self,
        transport,
        *,
        local_slices: Sequence[int],
        slices: Sequence[int],
        partition_mb: float = 4.0,
        timeout_s: Optional[float] = None,
        retries: Optional[int] = None,
        staleness: Optional[int] = None,
        namespace: str = "dcn",
        injector=None,
        sample_cap: int = 256,
    ):
        if isinstance(transport, str) and transport.startswith("file:"):
            from dear_pytorch_tpu_torch.resilience.cluster import FileTransport

            transport = FileTransport(transport[len("file:"):])
        self._transport = transport
        self.local_slices: Tuple[int, ...] = tuple(
            sorted(int(s) for s in local_slices))
        if not self.local_slices:
            raise ValueError("local_slices must name at least one slice")
        if len(self.local_slices) > 1:
            raise ValueError(
                f"local_slices={self.local_slices}: a process of the port "
                "drives one card, so it is one rank of ONE slice (the JAX "
                "package's one-process nested-mesh emulation of several "
                "slices has no counterpart here); a slice's ranks are a "
                "process group (comm.backend.slice_group)")
        self.slices: Tuple[int, ...] = tuple(sorted(int(s) for s in slices))
        if not set(self.local_slices) <= set(self.slices):
            raise ValueError(
                f"local slices {self.local_slices} not in the live set "
                f"{self.slices}")
        # None (or <= 0) = one chunk per bucket, the chunk_bounds contract
        self.partition_mb = (None if partition_mb is None
                             else float(partition_mb))
        if timeout_s is None:
            timeout_s = float(os.environ.get(DCN_TIMEOUT_ENV, "")
                              or _DEFAULT_TIMEOUT_S)
        self.timeout_s = float(timeout_s)
        if retries is None:
            retries = int(os.environ.get(DCN_RETRIES_ENV, "")
                          or _DEFAULT_RETRIES)
        self.retries = max(int(retries), 0)
        if staleness is None:
            staleness = int(os.environ.get(DCN_STALENESS_ENV, "") or 0)
        self.staleness_budget = max(int(staleness), 0)
        self._ns = f"deardcn/{namespace}"
        self.epoch = 0
        self.injector = injector
        self.exchanges = 0           # the fault clock (1-based per call)
        self._seq = 0                # monotone publish sequence (forensics)
        self._published: List[Tuple[int, List[str]]] = []  # (step, keys)
        # SDC sentinel leg (resilience.sdc): when armed, each exchange
        # records the dotted-hex checksum of its committed include-set
        # mean for the guard's fingerprint vote; resolved once here so
        # the disabled path costs one attribute read per exchange
        from dear_pytorch_tpu_torch.resilience import sdc as _sdc_mod

        self._sdc_fp = _sdc_mod.sdc_enabled()
        self.last_mean_fp = ""
        self._stale_epochs: List[int] = []
        self._samples: List[Tuple[float, float]] = []
        self._sample_cap = int(sample_cap)
        # -- degraded-mode (ladder) state --------------------------------
        #: consecutive unmerged rounds per live slice (replica-identical:
        #: derived from the shared participation decision every round)
        self._staleness: Dict[int, int] = {}
        #: slices escalated past the budget — no longer waited for; the
        #: membership layer owns them from here
        self._escalated: Set[int] = set()
        #: per-LOCAL-slice error-feedback residual: the unmerged partial
        #: (per bucket, float32, in gradient units) carried into the next
        #: round's publish — mass-preserving, checkpointed via state_dict
        self._residual: Dict[int, List[np.ndarray]] = {}
        #: consecutive rounds with no remote participation record at all
        #: (total inbound isolation — self-evict past budget)
        self._blind_rounds = 0
        # -- cross-iteration prefetch ------------------------------------
        self._staged: Dict[Tuple[int, int, int, int], np.ndarray] = {}
        self._staged_lock = threading.Lock()
        self._prefetch_thread: Optional[threading.Thread] = None
        self._last_geometry: Optional[Tuple[int, list]] = None

    # -- membership ---------------------------------------------------------

    @property
    def num_slices(self) -> int:
        return len(self.slices)

    @property
    def degraded(self) -> bool:
        """True when the escalation ladder (retry → skip+EF → evict) is
        armed; False keeps the strict synchronous contract."""
        return self.staleness_budget >= 1

    def set_slices(self, slices: Sequence[int],
                   *, epoch: Optional[int] = None) -> None:
        """Renormalize the cross-slice reduction to a NEW live slice set
        (elastic slice loss / rejoin). Key namespaces are epoch-scoped, so
        pre-transition partials can never be averaged into post-transition
        steps; the superseded epoch's subtree is GC'd DEFERRED (after the
        first completed exchange at the new epoch — a slow peer may still
        be reading it mid-transition, the `membership._commit` lesson).
        Ladder state is re-anchored to the new set: staleness clocks and
        escalations of departed slices are dropped (the membership layer
        resolved them), admitted slices start fresh at staleness 0; LOCAL
        residuals are kept — an eviction must not lose the survivors'
        deferred gradient mass."""
        new = tuple(sorted(int(s) for s in slices))
        live_local = tuple(s for s in self.local_slices if s in new)
        if not live_local:
            raise ValueError(
                f"renormalizing to {new} would drop every local slice "
                f"{self.local_slices} — an evicted slice exits for "
                "relaunch instead of exchanging")
        old_epoch = self.epoch
        changed = new != self.slices
        if epoch is not None and int(epoch) != self.epoch:
            self.epoch = int(epoch)
            self._stale_epochs.append(old_epoch)
            self._published = []
        self.slices = new
        self._staleness = {s: self._staleness.get(s, 0) for s in new}
        self._escalated &= set(new)
        self._blind_rounds = 0
        with self._staged_lock:
            self._staged.clear()
        if changed:
            tr = _telemetry.get_tracer()
            if tr.enabled:
                tr.count("dcn.renorms")
                tr.event("dcn.renorm", slices=",".join(map(str, new)),
                         epoch=self.epoch)

    # -- ladder state (checkpointed) ----------------------------------------

    def state_dict(self) -> dict:
        """The ladder's durable state: per-slice staleness clocks and the
        LOCAL error-feedback residuals (bit-exact round-trip). Rides the
        checkpoint sidecar (`utils.checkpoint.save_checkpoint`'s
        ``dcn_state``) so a restore re-seats the deferred gradient mass
        together with the model state it belongs to."""
        return {
            "epoch": self.epoch,
            "staleness": {str(s): int(v)
                          for s, v in self._staleness.items() if v},
            "residual": {
                str(sid): [_encode_state_array(a) for a in bufs]
                for sid, bufs in self._residual.items()
            },
        }

    def load_state_dict(self, state: Optional[dict]) -> None:
        """Restore `state_dict` output. Tolerates None / pre-ladder
        sidecars (fresh state); a structurally alien payload resets to
        zeros instead of guessing (the `_repack_comp_state` posture)."""
        self._residual = {}
        self._staleness = {s: 0 for s in self.slices}
        if not state:
            return
        try:
            for k, v in dict(state.get("staleness", {})).items():
                if int(k) in self.slices:
                    self._staleness[int(k)] = int(v)
            for k, bufs in dict(state.get("residual", {})).items():
                sid = int(k)
                if sid in self.local_slices:
                    self._residual[sid] = [
                        _decode_state_array(d) for d in bufs]
        except (KeyError, TypeError, ValueError):
            self._residual = {}
            self._staleness = {s: 0 for s in self.slices}

    def repack_residual(self, old_plan, new_plan) -> None:
        """Carry the error-feedback residuals across a fusion-plan change
        (elastic rescale, tuner re-bucketing): unpack each bucket row to
        parameter granularity under the old plan, repack under the new —
        the same mass-preserving algebra as `autotune._repack_comp_state`
        (sum of the carried gradient mass is exactly invariant; only the
        bucket boundaries move). A structural mismatch resets to empty
        instead of guessing."""
        if not self._residual:
            return
        import torch

        try:
            new_residual: Dict[int, List[np.ndarray]] = {}
            for sid, bufs in self._residual.items():
                pieces: Dict[int, torch.Tensor] = {}
                for bi, row in enumerate(bufs):
                    pieces.update(F.unpack_bucket(torch.from_numpy(
                        np.array(row, np.float32)), old_plan, bi))
                leaves = [pieces[i] for i in range(len(old_plan.leaves))]
                new_residual[sid] = [
                    F.pack_bucket(leaves, new_plan, nbi,
                                  dtype=torch.float32).numpy()
                    for nbi in range(new_plan.num_buckets)
                ]
            self._residual = new_residual
        except Exception:
            self._residual = {}

    # -- the exchange -------------------------------------------------------

    def _key(self, step: int, bucket: int, chunk: int, sid: int) -> str:
        return (f"{self._ns}/e{self.epoch}/s{step}/b{bucket}/c{chunk}/"
                f"{sid}")

    def _hdr_key(self, step: int, sid: int) -> str:
        # the per-round participation record (phase two of the skip
        # decision) rides the same epoch/step scope as the partials
        return f"{self._ns}/e{self.epoch}/s{step}/hdr/{sid}"

    def _dec_key(self, step: int) -> str:
        # the committed include set for the round: first finisher wins,
        # every rank adopts it (the `decide_once` consensus primitive)
        return f"{self._ns}/e{self.epoch}/s{step}/inc"

    def _gc(self, step: int) -> None:
        """Prune this host's own keys two steps back (every peer that
        reached step ``step`` has fetched step ``step-2``: fetching step
        s-1 required every slice's s-1 publish, which follows its s-2
        fetch), plus any superseded epoch subtrees."""
        keep = {step, step - 1}
        still = []
        for s, keys in self._published:
            if s in keep:
                still.append((s, keys))
                continue
            for k in keys:
                self._transport.delete(k)
        self._published = still
        if self._stale_epochs:
            prune = getattr(self._transport, "prune_prefix", None)
            if prune is not None:
                for e in self._stale_epochs:
                    prune(f"{self._ns}/e{e}")
            self._stale_epochs = []
        with self._staged_lock:
            for k in [k for k in self._staged if k[0] < step]:
                del self._staged[k]

    def exchange(
        self,
        step: int,
        per_slice_bufs: Dict[int, List[np.ndarray]],
        scalars: Optional[Dict[int, float]] = None,
        *,
        partition_mb: Optional[float] = None,
    ) -> Tuple[List[np.ndarray], Optional[float]]:
        """One cross-slice averaging round for training step ``step``.

        ``per_slice_bufs[sid]`` is the list of per-bucket partials this
        host computed for its local slice ``sid`` (each a flat array of
        the bucket's padded size — the intra-slice reduce-scatter mean,
        gathered back over ICI by the caller); ``scalars[sid]`` an
        optional per-slice scalar (the slice-local loss) averaged along
        the same path. Returns ``(means, scalar_mean)`` where ``means``
        is the per-bucket mean over the INCLUDED slice set, in float32
        (strict mode: every live slice; degraded mode: the
        replica-identical participation set, renormalized).

        Replay-safe: rollbacks re-publish under the same keys (atomic
        replace; byte-identical across a slice's ranks — residual state
        is deterministic and checkpointed), and membership transitions
        move the epoch scope, so a replayed step can never consume a
        stale world's partial — and the per-chunk integrity header
        rejects one that tries.
        """
        self.exchanges += 1
        n = self.exchanges
        part = self.partition_mb if partition_mb is None else partition_mb
        drop = False
        if self.injector is not None:
            drop = self.injector.dcn_drop_due(n)
            drop = self.injector.dcn_outage_due(n) or drop
            slow = self.injector.dcn_slow_s_for(n)
            if slow > 0.0:
                time.sleep(slow)
        live_local = [s for s in self.local_slices if s in self.slices]
        remote = [s for s in self.slices if s not in self.local_slices]
        tr = _telemetry.get_tracer()

        # payloads: float32 wire image of the local partials, with any
        # carried error-feedback residual folded in (degraded mode) —
        # the LOCAL contribution and the published bytes must be the
        # same array, so every rank decodes bit-identical values
        nbuf = len(per_slice_bufs[live_local[0]])
        payload: Dict[int, List[np.ndarray]] = {}
        for sid in live_local:
            bufs = [np.asarray(b, np.float32).reshape(-1)
                    for b in per_slice_bufs[sid]]
            res = self._residual.get(sid)
            if res is not None and self.degraded:
                if (len(res) == nbuf
                        and all(r.size == b.size
                                for r, b in zip(res, bufs))):
                    bufs = [b + r.astype(np.float32)
                            for b, r in zip(bufs, res)]
                else:
                    self._residual.pop(sid, None)  # plan moved under us
            payload[sid] = bufs
        bounds = [
            F.chunk_bounds(int(payload[live_local[0]][g].size),
                           payload[live_local[0]][g].dtype.itemsize, part)
            for g in range(nbuf)
        ]
        self._last_geometry = (nbuf, bounds)

        # 1. publish every local slice's chunks (atomic per chunk), each
        # framed with the wire-integrity header
        published: List[str] = []
        bytes_out = 0
        if not drop:
            for sid in live_local:
                for g, flat in enumerate(payload[sid]):
                    for j, (lo, hi) in enumerate(bounds[g]):
                        self._seq += 1
                        key = self._key(step, g, j, sid)
                        meta = {"epoch": self.epoch, "step": int(step),
                                "bucket": g, "chunk": j,
                                "seq": self._seq}
                        self._transport.set(key, _encode(
                            flat[lo:hi], meta=meta))
                        published.append(key)
                        bytes_out += (hi - lo) * flat.dtype.itemsize
                if scalars is not None:
                    key = self._key(step, -1, 0, sid)
                    self._transport.set(key, json.dumps(
                        {"scalar": float(scalars[sid]),
                         "epoch": self.epoch, "step": int(step)}))
                    published.append(key)
            self._published.append((step, published))
        # the cross-iteration prefetch is joined only now, after this
        # slice published: a peer's prefetch thread may be waiting for
        # exactly these chunks (the JAX module joins it before publishing,
        # so two slices in lockstep each waited out the other's whole
        # fetch budget every round)
        self._join_prefetch()

        # 2. fetch remote contributions
        contrib: Dict[int, List[np.ndarray]] = {
            sid: payload[sid] for sid in live_local}
        scalar_contrib: Dict[int, float] = (
            {sid: float(scalars[sid]) for sid in live_local}
            if scalars is not None else {})
        if self.degraded:
            arrived = self._fetch_degraded(
                step, remote, nbuf, bounds, contrib, scalar_contrib,
                scalars is not None, tr)
            include = self._participation_round(
                step, live_local, arrived, drop, published, tr)
            self._fill_decided(step, include, nbuf, bounds, contrib,
                               scalar_contrib, scalars is not None, tr)
            self._apply_ladder(step, live_local, include, payload, tr)
        else:
            self._fetch_strict(step, remote, nbuf, bounds, contrib,
                               scalar_contrib, scalars is not None, tr)
            include = list(self.slices)

        world = float(len(include))
        order = [s for s in sorted(contrib) if s in include]
        means = [
            sum(contrib[sid][g] for sid in order) / world
            for g in range(nbuf)
        ]
        scalar_mean = (
            sum(scalar_contrib[sid] for sid in order) / world
            if scalars is not None else None)
        if self._sdc_fp:
            # SDC sentinel leg: checksum the COMMITTED include-set mean
            # (host buffers already in hand — no extra transfer) so the
            # cross-slice exchange is voted on exactly like the device
            # buckets; the guard appends this to its health-sync
            # fingerprint (`resilience.sdc.SdcSentinel.local_fingerprint`)
            from dear_pytorch_tpu_torch.resilience import sdc as _sdc

            self.last_mean_fp = ".".join(
                f"{_sdc.fingerprint_array(m):08x}" for m in means)
            if tr.enabled:
                tr.count("dcn.mean_fingerprints")
        if tr.enabled:
            tr.count("dcn.exchanges")
            tr.count("dcn.bytes",
                     bytes_out + self._bytes_in)
            tr.count("dcn.chunks", sum(len(b) for b in bounds))
        self._gc(step)
        return means, scalar_mean

    # -- strict fetch (the legacy one-ahead prefetch pipeline) --------------

    def _fetch_strict(self, step, remote, nbuf, bounds, contrib,
                      scalar_contrib, want_scalar, tr) -> None:
        """Fetch EVERY remote chunk or die trying: the one-ahead prefetch
        pipeline — the next get is in flight on a worker thread while
        this one is decoded and staged (and the whole phase overlaps the
        peers' publishes). Contributions are STAGED per slice and summed
        afterwards in sorted-slice order: float addition is not
        associative, and ranks on different slices see different
        local/remote splits — accumulate-as-fetched would give each rank
        a bitwise-different mean and trip the guard's desync sentinel on
        a healthy fleet."""
        for sid in remote:
            contrib[sid] = [
                np.zeros((int(bounds[g][-1][1]),), np.float32)
                for g in range(nbuf)
            ]
        fetch_list: List[Tuple[int, int, int]] = [
            (sid, g, j)
            for sid in remote
            for g in range(nbuf)
            for j in range(len(bounds[g]))
        ]
        if want_scalar:
            fetch_list += [(sid, -1, 0) for sid in remote]

        def _get(sid: int, g: int, j: int) -> Tuple[np.ndarray, float]:
            # poll until a VERIFYING value lands: a torn/replayed value
            # at the key is rejected and the poll continues — the honest
            # publisher's atomic replace will supersede it (rollback
            # replays re-publish the same keys)
            t0 = time.monotonic()
            deadline = t0 + self.timeout_s
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise DcnChunkReject(
                        f"slice {sid} bucket {g} chunk {j}: no verifying "
                        f"value within {self.timeout_s:.1f}s (persistent "
                        "torn/replayed payload)")
                val = self._transport.get(self._key(step, g, j, sid),
                                          left)
                if g < 0:
                    try:
                        meta = json.loads(val)
                        if (meta.get("epoch") == self.epoch
                                and meta.get("step") == int(step)):
                            return meta, time.monotonic() - t0
                        raise _ChunkReject("stale scalar")
                    except (ValueError, _ChunkReject):
                        self._count_reject(sid, g, j, tr)
                        time.sleep(0.005)
                        continue
                try:
                    decoded = _decode(val, expect={
                        "epoch": self.epoch, "step": int(step),
                        "bucket": g, "chunk": j})
                    return decoded, time.monotonic() - t0
                except _ChunkReject:
                    self._count_reject(sid, g, j, tr)
                    time.sleep(0.005)

        self._bytes_in = 0
        pending: Optional[threading.Thread] = None
        slot: List = [None, None]  # (value | exception, (sid, g, j))

        def _spawn(item):
            def work():
                try:
                    slot[0] = _get(*item)
                except BaseException as exc:  # re-raised on the caller
                    slot[0] = exc
                slot[1] = item
            t = threading.Thread(target=work, daemon=True,
                                 name="dear-dcn-prefetch")
            t.start()
            return t

        try:
            for i, item in enumerate(fetch_list):
                if pending is None:
                    pending = _spawn(item)
                pending.join()
                got, at = slot[0], slot[1]
                pending = (_spawn(fetch_list[i + 1])
                           if i + 1 < len(fetch_list) else None)
                if isinstance(got, BaseException):
                    self._raise_fetch(got, at, tr)
                val, secs = got
                sid, g, j = at
                if g < 0:
                    scalar_contrib[sid] = float(val["scalar"])
                    self._bytes_in += len(json.dumps(val))
                else:
                    lo, hi = bounds[g][j]
                    contrib[sid][g][lo:hi] = val.astype(np.float32)
                    # samples and byte counters record the RAW payload
                    # size: the α-β fit's β must be seconds-per-payload-
                    # byte, the unit `plan_comm_accounting` prices 'dcn'
                    # rows in — recording the base64-framed text length
                    # would skew β by the ~4/3 framing overhead (an
                    # emulation-substrate cost, not a link property)
                    if len(self._samples) < self._sample_cap:
                        self._samples.append((float(val.nbytes), secs))
                    self._bytes_in += int(val.nbytes)
        finally:
            # a failed round must not leave a prefetch thread publishing
            # into the slot after we re-raise (daemon thread: best-effort)
            pending = None

    # -- degraded fetch (rung 1: retry inside a per-slice budget) -----------

    def _fetch_degraded(self, step, remote, nbuf, bounds, contrib,
                        scalar_contrib, want_scalar, tr) -> List[int]:
        """Fetch what arrives: per-chunk `resilience.retry` attempts with
        decorrelated-jitter backoff, each slice bounded by a
        ``timeout_s`` per-step budget. A slice whose budget exhausts is
        simply NOT in the returned arrived set — the participation round
        (rung 2) decides what that means fleet-wide. Escalated slices
        (rung 3) are skipped outright: the membership layer owns them."""
        from dear_pytorch_tpu_torch.resilience.cluster import PeerTimeout
        from dear_pytorch_tpu_torch.resilience.retry import RetryError, retry_call

        self._bytes_in = 0
        arrived: List[int] = []
        per_attempt = max(self.timeout_s / (self.retries + 1), 0.05)
        for sid in remote:
            if sid in self._escalated:
                continue
            deadline = time.monotonic() + self.timeout_s
            bufs = [np.zeros((int(bounds[g][-1][1]),), np.float32)
                    for g in range(nbuf)]
            sc: Optional[float] = None
            ok = True
            items = [(g, j) for g in range(nbuf)
                     for j in range(len(bounds[g]))]
            if want_scalar:
                items.append((-1, 0))
            for g, j in items:
                staged = self._take_staged(step, sid, g, j, tr)
                if staged is not None and g >= 0:
                    lo, hi = bounds[g][j]
                    bufs[g][lo:hi] = staged.astype(np.float32)
                    self._bytes_in += int(staged.nbytes)
                    continue

                def _attempt(sid=sid, g=g, j=j, deadline=deadline):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise PeerTimeout(
                            f"slice {sid} per-step fetch budget exhausted")
                    t0 = time.monotonic()
                    val = self._transport.get(
                        self._key(step, g, j, sid),
                        min(per_attempt, left))
                    if g < 0:
                        meta = json.loads(val)
                        if (meta.get("epoch") != self.epoch
                                or meta.get("step") != int(step)):
                            self._count_reject(sid, g, j, tr)
                            raise _ChunkReject("stale scalar")
                        return meta, time.monotonic() - t0
                    try:
                        decoded = _decode(val, expect={
                            "epoch": self.epoch, "step": int(step),
                            "bucket": g, "chunk": j})
                    except _ChunkReject:
                        self._count_reject(sid, g, j, tr)
                        raise
                    return decoded, time.monotonic() - t0

                try:
                    val, secs = retry_call(
                        _attempt,
                        attempts=self.retries + 1,
                        base_delay_s=0.01, max_delay_s=0.25,
                        max_elapsed_s=max(
                            deadline - time.monotonic(), 0.001),
                        retry_on=(PeerTimeout, _ChunkReject),
                        name="dcn.fetch",
                    )
                except (RetryError, PeerTimeout, _ChunkReject):
                    ok = False
                    break  # budget spent — don't burn it per chunk
                if g < 0:
                    sc = float(val["scalar"])
                else:
                    lo, hi = bounds[g][j]
                    bufs[g][lo:hi] = val.astype(np.float32)
                    if len(self._samples) < self._sample_cap:
                        self._samples.append((float(val.nbytes), secs))
                    self._bytes_in += int(val.nbytes)
            if ok:
                contrib[sid] = bufs
                if want_scalar and sc is not None:
                    scalar_contrib[sid] = sc
                arrived.append(sid)
        return arrived

    # -- degraded rung 2: the replica-identical participation round ---------

    def _participation_round(self, step, live_local, arrived, drop,
                             published, tr) -> List[int]:
        """Two-phase include/exclude (the `evaluate_health_views` idiom):
        each slice publishes the set of peers whose partials it fetched,
        gathers every record it can, and proposes exactly the slices
        that appear in EVERY gathered record (a slice anyone missed is
        excluded everywhere — including on its own ranks, which is what
        makes the mean replica-identical). A slice whose record itself
        never arrives is excluded and its staleness clock runs.

        Gathering alone is NOT replica-identical — two ranks of the same
        slice race their wall-clock deadlines against a late record and
        can land on different sides of it — so the round's include set
        is COMMITTED through ``decide_once`` (first finisher wins) and
        every rank adopts the winner; a rank whose outbound link is down
        this round (``drop``) cannot write, so it only reads the
        decision. What remains open is total silence: a fleet where no
        slice can write the decision falls back to its local gather,
        and simultaneous symmetric outages there are caught by the
        guard's desync sentinel — the window this protocol cannot
        close."""
        from dear_pytorch_tpu_torch.resilience.cluster import PeerTimeout

        have = sorted(set(live_local) | set(arrived))
        if not drop:
            for sid in live_local:
                key = self._hdr_key(step, sid)
                self._transport.set(key, json.dumps(
                    {"epoch": self.epoch, "step": int(step),
                     "have": have}))
                published.append(key)
        gathered: Dict[int, List[int]] = {
            sid: have for sid in live_local}
        short = max(self.timeout_s / (self.retries + 1), 0.05)
        for sid in self.slices:
            if sid in gathered or sid in self._escalated:
                continue
            # a slice that delivered its partials is alive: give its
            # record TWICE the per-step budget — a rank whose own
            # publish was suppressed reaches this gather almost
            # immediately, while the (alive) peer only writes its record
            # after burning its full fetch budget on the missing chunks;
            # a single-budget wait expires just before that record lands
            # and the two sides compute DIFFERENT include sets (the
            # desync the sentinel exists to catch, but here avoidable).
            # A slice that delivered nothing gets the short wait — its
            # absence means exclusion either way, don't stall on it.
            wait = 2.0 * self.timeout_s if sid in arrived else short
            try:
                rec = json.loads(
                    self._transport.get(self._hdr_key(step, sid), wait))
                if (rec.get("epoch") == self.epoch
                        and rec.get("step") == int(step)):
                    gathered[sid] = [int(x) for x in rec.get("have", [])]
            except (PeerTimeout, ValueError):
                pass
        include = [
            s for s in self.slices
            if s in gathered
            and all(s in h for h in gathered.values())
        ]
        # commit the round's include set: the first rank to finish
        # gathering writes it, everyone else adopts the winner — the
        # decision is ONE durable value, not N racing local computations
        # (two ranks of one slice must never land on different sides of
        # a record's deadline). A rank whose outbound link is down this
        # round cannot write; it reads the fleet's decision instead.
        adopted_remote = False
        winner = None
        if include and not drop:
            winner = self._transport.decide_once(
                self._dec_key(step), json.dumps(include))
            published.append(self._dec_key(step))
        else:
            try:
                winner = self._transport.get(self._dec_key(step),
                                             self.timeout_s)
                adopted_remote = True  # someone reachable committed it
            except (PeerTimeout, ValueError):
                winner = None
        if winner is not None:
            try:
                include = [int(x) for x in json.loads(winner)
                           if int(x) in self.slices]
            except (ValueError, TypeError):
                pass  # torn decision value: keep the local proposal
        # total-isolation backstop: an INBOUND-dead slice gathers no
        # remote records (and reads no remote decision), so every view
        # it sees is its own and it would happily include (only) itself
        # forever. Count blind rounds and self-evict one round AFTER
        # remote escalation would have fired — so a healthy survivor
        # whose only peer went dark escalates that peer (and stops
        # expecting records from it) before its own blind clock can
        # reach the tripwire.
        expected = [s for s in self.slices
                    if s not in self.local_slices
                    and s not in self._escalated]
        got_remote = (any(s not in live_local for s in gathered)
                      or adopted_remote)
        if expected and not got_remote:
            self._blind_rounds += 1
            if self._blind_rounds > self.staleness_budget + 1:
                if tr.enabled:
                    tr.count("dcn.self_evicts")
                    tr.event("dcn.self_evict", slice=live_local[0],
                             blind=self._blind_rounds, epoch=self.epoch)
                raise DcnSelfEvict(
                    f"no remote participation record for "
                    f"{self._blind_rounds} rounds (budget "
                    f"{self.staleness_budget}) — this slice is isolated "
                    "from the fleet; exiting for relaunch + rejoin")
        else:
            self._blind_rounds = 0
        if not include:
            raise DcnPeerTimeout(
                f"participation round for step {step} produced an empty "
                f"include set (gathered {sorted(gathered)}) — no slice "
                "is mutually reachable")
        return include

    def _fill_decided(self, step, include, nbuf, bounds, contrib,
                      scalar_contrib, want_scalar, tr) -> None:
        """Honor the committed include set: a rank that adopted a
        decision covering a slice whose fetch budget IT had given up on
        must still produce that slice's contribution — the winner
        demonstrably fetched it, so the chunks are published and this
        read completes without the retry ladder. Failing here would mean
        this rank averages a different set than the fleet decided, which
        is exactly the desync the decision exists to prevent — so an
        unfillable slice is a hard round failure, not a skip."""
        missing = [sid for sid in include if sid not in contrib]
        for sid in missing:
            deadline = time.monotonic() + self.timeout_s
            bufs = [np.zeros((int(bounds[g][-1][1]),), np.float32)
                    for g in range(nbuf)]
            items = [(g, j) for g in range(nbuf)
                     for j in range(len(bounds[g]))]
            if want_scalar:
                items.append((-1, 0))
            for g, j in items:
                left = max(deadline - time.monotonic(), 0.05)
                try:
                    val = self._transport.get(
                        self._key(step, g, j, sid), left)
                    if g < 0:
                        meta = json.loads(val)
                        if (meta.get("epoch") != self.epoch
                                or meta.get("step") != int(step)):
                            raise _ChunkReject("stale scalar")
                        scalar_contrib[sid] = float(meta["scalar"])
                        continue
                    decoded = _decode(val, expect={
                        "epoch": self.epoch, "step": int(step),
                        "bucket": g, "chunk": j})
                except (_ChunkReject, ValueError) as exc:
                    self._count_reject(sid, g, j, tr)
                    raise DcnChunkReject(
                        f"slice {sid} is in the committed include set "
                        f"but its chunk b{g}/c{j} does not verify: "
                        f"{exc}") from exc
                except Exception as exc:
                    raise DcnPeerTimeout(
                        f"slice {sid} is in the committed include set "
                        f"but its chunk b{g}/c{j} cannot be read "
                        f"({exc}) — this rank cannot average what the "
                        "fleet decided") from exc
                lo, hi = bounds[g][j]
                bufs[g][lo:hi] = decoded.astype(np.float32)
                self._bytes_in += int(decoded.nbytes)
            contrib[sid] = bufs

    # -- degraded rung 2/3: staleness clocks, EF residual, escalation -------

    def _apply_ladder(self, step, live_local, include, payload, tr) -> None:
        excluded = [s for s in self.slices if s not in include
                    and s not in self._escalated]
        if excluded and tr.enabled:
            tr.count("dcn.degraded_rounds")
            tr.count("dcn.skips", len(excluded))
        for s in self.slices:
            if s in include:
                self._staleness[s] = 0
            else:
                self._staleness[s] = self._staleness.get(s, 0) + 1
        # error feedback: an excluded LOCAL slice carries its whole
        # published payload (partial + any prior residual — already
        # folded in) forward; an included one has merged its mass
        for sid in live_local:
            if sid in include:
                self._residual.pop(sid, None)
            else:
                self._residual[sid] = [
                    np.array(b, np.float32, copy=True)
                    for b in payload[sid]]
                if tr.enabled:
                    tr.count("dcn.residual_carries")
        # escalation: local past budget → self-evict (exit for relaunch,
        # rejoin re-enters); remote past budget → stop waiting, the
        # membership layer's slice-granular eviction is the last rung
        for sid in live_local:
            if self._staleness.get(sid, 0) > self.staleness_budget:
                if tr.enabled:
                    tr.count("dcn.self_evicts")
                    tr.event("dcn.self_evict", slice=sid,
                             stale=self._staleness[sid],
                             epoch=self.epoch)
                raise DcnSelfEvict(
                    f"local slice {sid} unmerged for "
                    f"{self._staleness[sid]} rounds (budget "
                    f"{self.staleness_budget}) — the fleet is averaging "
                    "without this slice; exiting for relaunch + rejoin")
        for sid in self.slices:
            if (sid not in self.local_slices
                    and sid not in self._escalated
                    and self._staleness.get(sid, 0)
                    > self.staleness_budget):
                self._escalated.add(sid)
                if tr.enabled:
                    tr.count("dcn.escalations")
                    tr.event("dcn.escalate", slice=sid,
                             stale=self._staleness[sid],
                             epoch=self.epoch)

    # -- cross-iteration prefetch (the staleness>=1 overlap primitive) ------

    def prefetch(self, step: int) -> None:
        """Arm a background fetch of this step's REMOTE chunks while the
        local backward program is still running on device (call it right
        after dispatching the grads program — `parallel.dear` does). A
        peer that is AHEAD has already published this step's partials;
        staging them here moves their wire time under the backward pass,
        which is exactly the cross-iteration overlap the ``staleness=1``
        bounded-stale contract makes legal (ROADMAP item 1c). Uses the
        previous round's chunk geometry; a no-op before the first
        exchange, in strict mode, or while a prior prefetch is live."""
        if not self.degraded or self._last_geometry is None:
            return
        if self._prefetch_thread is not None:
            return
        nbuf, bounds = self._last_geometry
        remote = [s for s in self.slices
                  if s not in self.local_slices
                  and s not in self._escalated]
        if not remote:
            return
        items = [(sid, g, j) for sid in remote for g in range(nbuf)
                 for j in range(len(bounds[g]))]
        epoch = self.epoch
        per_get = max(self.timeout_s / (self.retries + 1), 0.05)
        deadline = time.monotonic() + self.timeout_s

        def work():
            # bounded by ONE timeout budget across all chunks: the thread
            # must be joinable at exchange time even when a peer never
            # publishes (the round's own retry/skip budget owns that case)
            for sid, g, j in items:
                left = deadline - time.monotonic()
                if left <= 0:
                    return
                try:
                    val = self._transport.get(
                        self._key(step, g, j, sid), min(per_get, left))
                    decoded = _decode(val, expect={
                        "epoch": epoch, "step": int(step),
                        "bucket": g, "chunk": j})
                except Exception:
                    continue  # not published yet — the round fetches it
                with self._staged_lock:
                    self._staged[(int(step), sid, g, j)] = decoded

        t = threading.Thread(target=work, daemon=True,
                             name="dear-dcn-xiter-prefetch")
        t.start()
        self._prefetch_thread = t

    def _join_prefetch(self) -> None:
        t = self._prefetch_thread
        if t is not None:
            t.join(self.timeout_s + 1.0)
            self._prefetch_thread = None

    def _take_staged(self, step, sid, g, j, tr) -> Optional[np.ndarray]:
        with self._staged_lock:
            val = self._staged.pop((int(step), sid, g, j), None)
        if val is not None and tr.enabled:
            tr.count("dcn.prefetch_hits")
        return val

    # -- shared plumbing ----------------------------------------------------

    _bytes_in = 0

    def _count_reject(self, sid, g, j, tr) -> None:
        if tr.enabled:
            tr.count("dcn.chunk_rejects")
            tr.event("dcn.chunk_reject", slice=sid, bucket=g, chunk=j,
                     epoch=self.epoch)

    def _raise_fetch(self, exc: BaseException, at, tr) -> None:
        from dear_pytorch_tpu_torch.resilience.cluster import PeerTimeout

        sid, g, j = at
        if isinstance(exc, PeerTimeout):
            if tr.enabled:
                tr.count("dcn.peer_timeouts")
                tr.event("dcn.peer_timeout", slice=sid, bucket=g,
                         chunk=j, epoch=self.epoch)
            raise DcnPeerTimeout(
                f"slice {sid} never published bucket {g} chunk {j} "
                f"(epoch {self.epoch}) within {self.timeout_s:.1f}s — "
                "dead slice, partition, or dropped publish") from exc
        raise exc

    # -- link fit -----------------------------------------------------------

    def samples(self) -> List[Tuple[float, float]]:
        """Per-remote-chunk ``(bytes, seconds)`` fetch timings — the raw
        material for the DCN-level α-β fit (`overlap.fit_dcn`). Noisy by
        construction (the first fetch of a step also pays peer skew);
        the least-squares fit absorbs that as α."""
        return list(self._samples)
