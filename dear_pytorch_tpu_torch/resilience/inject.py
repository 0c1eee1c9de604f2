"""Deterministic fault injection — the chaos layer that makes recovery

The port of ``dear_pytorch_tpu/resilience/inject.py``, its imports retargeted
onto the port's tracer.
paths *testable*.

The reference's failure handling could only be validated by killing real
cluster jobs; this framework's recovery code (`utils.guard.GuardedTrainer`
rollback, checkpoint fallback, preemption saves, the step watchdog) would
otherwise be best-effort branches nothing ever exercises. `FaultInjector`
schedules faults at exact trainer step numbers (or pseudo-randomly from a
seed — still fully deterministic), so a chaos run is reproducible
byte-for-byte and CI can assert the *recovery*, not just the fault.

Fault kinds (all fire exactly once per scheduled entry):

  ``nan``           poison the step's batch (first float leaf -> NaN), so
                    real NaN gradients flow through the real train step
  ``exc``           raise `InjectedFault` from inside the guarded step
  ``hang``          sleep ``arg`` seconds before the step (a hung
                    collective, as seen by the host) — watchdog fodder
  ``slow``          from step ``N`` ON, sleep ``arg`` seconds before
                    EVERY step (fires once; the latency persists) — a
                    straggling rank in training chaos drills, a slow
                    replica creating admission backpressure in the
                    serving storm (``slow@10:0.05:r1``)
  ``ckpt_corrupt``  flip bytes in the newest committed checkpoint payload
                    on disk (exercises the checksum-manifest fallback)
  ``preempt``       SIGTERM to the own process (a simulated maintenance
                    preemption; pair with `resilience.preempt`)
  ``corrupt_resp``  serving-path only: flip bytes in one response payload
                    AFTER it was checksum-signed (`serving.replica` calls
                    `corrupt_payload` per response), so the router's
                    sha256 verification must catch and re-dispatch it;
                    a training run never consumes this kind
  ``flip``          silent data corruption: from step ``N`` ON, set the
                    low bit of one element of gradient-bucket ``arg``'s
                    padded tail in the state entering every step (fires
                    once; the corruption persists — a stuck ALU lane).
                    The value is validly checksummed everywhere
                    downstream and the padding never feeds the loss, so
                    wire integrity AND the loss-bits desync sentinel are
                    both blind to it; only the cross-rank per-bucket
                    fingerprint vote (`resilience.sdc`) can catch it
                    (`GuardedTrainer._attempt` drives `flip_bucket_for`
                    per attempt)
  ``flip_logits``   serving-path silent corruption: from request ``N``
                    ON, XOR the low bit of the first generated token of
                    every response BEFORE checksum-signing (fires once;
                    persists — the serving twin of ``flip``). The
                    payload verifies clean at the router; only the
                    1-in-N shadow-replay vote on a second replica can
                    catch it (`serving.replica` drives `corrupt_tokens`
                    per response)
  ``torn_seg``      feedback-log only: the Nth segment FLUSH publishes
                    its payload but never its manifest (a crash between
                    the two writes of the manifest-LAST commit), and the
                    buffered records are lost with it — the ingest reader
                    must walk past the torn segment, never crash
                    (`online.feedback` drives `torn_segment` per flush)
  ``dup_feedback``  feedback-log only: the Nth record APPEND re-appends
                    an already-committed record verbatim (an at-least-
                    once producer retry), so the reader's seq-based dedup
                    must absorb it (`online.feedback` drives
                    `duplicate_feedback` per append)
  ``dcn_slow``      cross-slice transport only: from the Nth DCN
                    exchange ON, sleep ``arg`` seconds before every
                    exchange (fires once; the latency persists) — a
                    congested or degraded DCN link, i.e. a straggler
                    SLICE (`comm.dcn.DcnExchanger` drives
                    `dcn_slow_s_for` per exchange)
  ``dcn_drop``      cross-slice transport only: the Nth DCN exchange
                    suppresses its outbound publish once (a transient
                    partition / lost message); in strict mode the peer
                    fetches time out and the guard rolls back, in
                    degraded mode the ladder's skip rung absorbs it
                    (`dcn_drop_due` per exchange)
  ``dcn_flap``      cross-slice transport only: from the Nth DCN
                    exchange, ``arg`` (default 1) DROP/RECOVER cycles —
                    outbound publish suppressed on exchanges N, N+2,
                    N+4, ... for ``arg`` cycles, delivered in between
                    (a flapping DCN link). The canonical SUB-budget
                    transient: with `DEAR_DCN_STALENESS` >= 1 the
                    degraded exchange must absorb every cycle with
                    zero guard rollbacks (``dcn_outage_due`` per
                    exchange)
  ``dcn_partition`` cross-slice transport only: from the Nth DCN
                    exchange, outbound publish suppressed for ``arg``
                    SECONDS of wall time (a sustained partition). Sized
                    past the staleness budget it must walk the whole
                    ladder: skip rounds, then slice-granular eviction,
                    then rejoin. Wall-clock armed (the partitioned
                    process keeps exchanging at its own pace), so runs
                    are deterministic in outcome, not in exact round
                    count (``dcn_outage_due`` per exchange)

Enable from the environment — ``DEAR_FAULTS="nan@6,exc@9,hang@12:0.5,
ckpt_corrupt@15,preempt@18"`` — or construct a `FaultInjector` in code and
hand it to `GuardedTrainer`. Telemetry (when enabled): counter
``faults.injected`` plus one ``fault.injected`` event per firing.

**Rank targeting** (multi-host chaos): suffix a spec with ``:rN`` to fire
the fault on process ``N`` only — ``DEAR_FAULTS="nan@6:r1,exc@9:r0"``
NaN-poisons rank 1's step-6 batch and raises on rank 0 at step 9; other
ranks *skip* the fault (recorded in ``FaultInjector.skipped``, never
``fired``). Arg and rank compose: ``hang@12:0.5:r1``. This is what makes
the coordinated recovery paths (`resilience.cluster`) testable: one rank
fails, every rank must recover identically.

**Slice targeting** (multi-slice chaos): ``:sK`` fires the fault on
every rank of slice ``K`` only — ``DEAR_FAULTS="dcn_slow@3:0.05:s0"``
turns slice 0 into a straggler while the other slices' schedules drain
the entry as ``skipped``. ``own_slice`` resolves from the elastic env
contract (``DEAR_ELASTIC_RANK // DEAR_ELASTIC_RANKS_PER_SLICE``) unless
passed explicitly; ``:rN`` and ``:sK`` are mutually exclusive in one
spec (a rank already implies its slice).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dear_pytorch_tpu_torch.observability import tracer as _telemetry

logger = logging.getLogger("dear_pytorch_tpu_torch")

FAULT_ENV = "DEAR_FAULTS"

KINDS = ("nan", "exc", "hang", "slow", "ckpt_corrupt", "preempt",
         "corrupt_resp", "torn_seg", "dup_feedback", "dcn_slow",
         "dcn_drop", "dcn_flap", "dcn_partition", "poison_feedback",
         "bad_version", "flip", "flip_logits")

__all__ = [
    "FAULT_ENV", "KINDS", "Fault", "InjectedFault", "FaultInjector",
    "parse_faults", "poison_pytree", "corrupt_latest_checkpoint",
    "flip_state_bucket",
]


class InjectedFault(RuntimeError):
    """The exception an ``exc`` fault raises inside the train step."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: ``kind`` fires at trainer step ``step``
    (1-based, counting attempted steps; DCN kinds count exchanges);
    ``arg`` is kind-specific (``hang``/``slow``/``dcn_slow`` seconds;
    unused otherwise); ``rank`` restricts the fault to one process index
    and ``slice_id`` to every rank of one slice (None = untargeted;
    mutually exclusive)."""

    kind: str
    step: int
    arg: float = 0.0
    rank: Optional[int] = None
    slice_id: Optional[int] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}: valid kinds are "
                f"{', '.join(KINDS)}"
            )
        if self.step < 1:
            raise ValueError(f"fault step must be >= 1, got {self.step}")
        if self.rank is not None and self.rank < 0:
            raise ValueError(
                f"fault rank must be a process index >= 0, got {self.rank}")
        if self.slice_id is not None and self.slice_id < 0:
            raise ValueError(
                f"fault slice must be a slice id >= 0, got {self.slice_id}")
        if self.rank is not None and self.slice_id is not None:
            raise ValueError(
                "a fault targets a rank OR a slice, not both "
                "(a rank already implies its slice)")


_SPEC_FORMAT = ("use kind@step[:arg][:rRANK|:sSLICE], e.g. 'nan@6', "
                "'hang@12:0.5', rank-targeted 'nan@6:r1,exc@9:r0', or "
                "slice-targeted 'dcn_slow@3:0.05:s0'")


def parse_faults(spec: str) -> Tuple[Fault, ...]:
    """Parse a ``kind@step[:arg][:rRANK]`` comma list into `Fault`s."""
    out: List[Fault] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, sep, rest = part.partition("@")
        if not sep:
            raise ValueError(
                f"{FAULT_ENV}: bad fault spec {part!r} ({_SPEC_FORMAT})"
            )
        step_s, *toks = rest.split(":")
        try:
            step = int(step_s)
        except ValueError as exc:
            raise ValueError(
                f"{FAULT_ENV}: bad fault spec {part!r}: {exc}"
            ) from None
        arg, rank, slice_id = 0.0, None, None
        for tok in toks:
            if tok[:1] in ("r", "R"):
                if not tok[1:].isdigit():
                    raise ValueError(
                        f"{FAULT_ENV}: bad rank spec {tok!r} in {part!r}: "
                        f"a rank is 'r' + a process index ({_SPEC_FORMAT})"
                    )
                if rank is not None:
                    raise ValueError(
                        f"{FAULT_ENV}: duplicate rank spec in {part!r} "
                        f"({_SPEC_FORMAT})"
                    )
                rank = int(tok[1:])
                continue
            if tok[:1] in ("s", "S"):
                if not tok[1:].isdigit():
                    raise ValueError(
                        f"{FAULT_ENV}: bad slice spec {tok!r} in "
                        f"{part!r}: a slice is 's' + a slice id "
                        f"({_SPEC_FORMAT})"
                    )
                if slice_id is not None:
                    raise ValueError(
                        f"{FAULT_ENV}: duplicate slice spec in {part!r} "
                        f"({_SPEC_FORMAT})"
                    )
                slice_id = int(tok[1:])
                continue
            try:
                arg = float(tok)
            except ValueError:
                raise ValueError(
                    f"{FAULT_ENV}: bad fault spec {part!r}: {tok!r} is "
                    f"neither a float arg, an rRANK, nor an sSLICE "
                    f"({_SPEC_FORMAT})"
                ) from None
        out.append(Fault(kind=kind, step=step, arg=arg, rank=rank,
                         slice_id=slice_id))
    return tuple(out)


def _float_leaf(x) -> bool:
    if torch.is_tensor(x):
        return x.is_floating_point()
    dt = getattr(x, "dtype", None)
    return dt is not None and np.issubdtype(np.dtype(dt), np.floating)


def poison_pytree(tree):
    """Copy of ``tree`` (a tensor, a numpy array, or dicts, lists and
    tuples of them) with every element of the first floating-point leaf
    set to NaN — real NaN gradients through the real backward pass. The
    leaves are walked in the JAX package's pytree order (a dict by sorted
    key), and the NaN copy lives where the leaf did (host or card). The
    whole leaf (not one element) is poisoned so the fault lands no matter
    which rows of a global batch this process holds — the contract
    rank-targeted ``nan`` faults rely on."""
    done = [False]

    def walk(x):
        if done[0]:
            return x
        if isinstance(x, dict):
            out = dict(x)
            for k in sorted(x):
                out[k] = walk(x[k])
            return out
        if isinstance(x, (list, tuple)):
            items = [walk(v) for v in x]
            if hasattr(x, "_fields"):   # a NamedTuple
                return type(x)(*items)
            return type(x)(items)
        if _float_leaf(x):
            done[0] = True
            if torch.is_tensor(x):
                return torch.full_like(x, float("nan"))
            return np.full_like(x, np.nan)
        return x

    out = walk(tree)
    if not done[0]:
        raise ValueError("no floating-point leaf to poison in this batch")
    return out


def corrupt_latest_checkpoint(directory: str) -> Optional[int]:
    """Overwrite the head of the largest payload file in the newest
    committed checkpoint with garbage; returns the corrupted step (None
    when no checkpoint exists). Deterministic: same tree -> same bytes."""
    from dear_pytorch_tpu_torch.utils import checkpoint as ckpt

    step = ckpt.latest_step(directory)
    if step is None:
        return None
    root = os.path.join(directory, f"step_{step:010d}")
    target, size = None, -1
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        for fn in sorted(filenames):
            p = os.path.join(dirpath, fn)
            s = os.path.getsize(p)
            if s > size:
                target, size = p, s
    if target is None:
        return None
    with open(target, "r+b") as f:
        f.write(b"\xff" * min(64, max(size, 1)))
    logger.warning("inject: corrupted checkpoint step %d (%s)", step, target)
    return step


class FaultInjector:
    """Fires scheduled `Fault`s at their step numbers.

    Call sites (`GuardedTrainer.step` wires both):

      - ``before_step(step, directory=...)`` — raises / hangs / corrupts /
        preempts when a matching fault is due,
      - ``poison_batch(step, batch)`` — applies a due ``nan`` fault.

    Every fault fires exactly once; ``fired`` records the history and
    ``pending`` what is still scheduled. Rank-targeted faults
    (``Fault(rank=N)`` / ``kind@step:rN``) fire only when ``own_rank``
    (default: `comm.backend.rank`, resolved lazily so construction
    can precede distributed bootstrap) matches; on other ranks they are
    consumed into ``skipped`` at their step, so schedules drain
    identically on every process.
    """

    def __init__(self, faults: Sequence[Fault] = (), *,
                 kill: bool = True, own_rank: Optional[int] = None,
                 own_slice: Optional[int] = None):
        self._by_step: Dict[int, List[Fault]] = {}
        for f in faults:
            self._by_step.setdefault(int(f.step), []).append(f)
        self.fired: List[Fault] = []
        self.skipped: List[Fault] = []  # rank/slice-targeted, not here
        #: persistent per-step latency armed by ``slow`` faults (additive
        #: when several fire); every later `before_step` sleeps this long
        self.slow_s: float = 0.0
        #: persistent per-DCN-exchange latency armed by ``dcn_slow``
        #: faults (the straggler-slice analog of ``slow_s``)
        self.dcn_slow_s: float = 0.0
        #: armed ``dcn_flap`` cycles: (first exchange, cycle count)
        self._flaps: List[Tuple[int, int]] = []
        #: wall-clock deadline of an armed ``dcn_partition`` (monotonic)
        self._partition_until: float = 0.0
        #: persistent SDC armed by ``flip`` (bucket index) and
        #: ``flip_logits`` (bool) — a stuck lane, not a hiccup
        self._flip_bucket: Optional[int] = None
        self._flip_logits = False
        self._own_rank = own_rank
        self._own_slice = own_slice
        # kill=False turns ``preempt`` into a no-op marker (tests that
        # assert scheduling without installing a SIGTERM handler)
        self._kill = kill

    @property
    def own_rank(self) -> int:
        if self._own_rank is None:
            from dear_pytorch_tpu_torch.comm import backend

            self._own_rank = backend.rank()
        return self._own_rank

    @property
    def own_slice(self) -> Optional[int]:
        """This process's slice id (None outside slice-granular fleets):
        explicit construction wins; otherwise the elastic env contract —
        ``DEAR_ELASTIC_RANK // DEAR_ELASTIC_RANKS_PER_SLICE``."""
        if self._own_slice is None:
            rank = os.environ.get("DEAR_ELASTIC_RANK", "").strip()
            rps = os.environ.get(
                "DEAR_ELASTIC_RANKS_PER_SLICE", "").strip()
            if rank and rps and int(rps) > 0:
                self._own_slice = int(rank) // int(rps)
        return self._own_slice

    @classmethod
    def from_env(cls, env: Optional[str] = None) -> Optional["FaultInjector"]:
        """Injector from ``DEAR_FAULTS`` (None when unset/empty)."""
        raw = (env if env is not None
               else os.environ.get(FAULT_ENV, "")).strip()
        if not raw:
            return None
        return cls(parse_faults(raw))

    @classmethod
    def from_seed(cls, seed: int, *, horizon: int, rate: float = 0.02,
                  kinds: Sequence[str] = ("nan", "exc")) -> "FaultInjector":
        """Pseudo-random but fully deterministic schedule: each step in
        ``[1, horizon]`` carries one fault with probability ``rate``, the
        kind drawn uniformly from ``kinds``. Same seed -> same schedule."""
        rng = np.random.default_rng(seed)
        faults = [
            Fault(kind=str(rng.choice(list(kinds))), step=step)
            for step in range(1, int(horizon) + 1)
            if rng.random() < rate
        ]
        return cls(faults)

    @property
    def pending(self) -> int:
        return sum(len(v) for v in self._by_step.values())

    def _take(self, step: int, kinds: Tuple[str, ...]) -> List[Fault]:
        due = self._by_step.get(int(step))
        if not due:
            return []
        matched = [f for f in due if f.kind in kinds]
        if not matched:
            return []
        remaining = [f for f in due if f.kind not in kinds]
        if remaining:
            self._by_step[int(step)] = remaining
        else:
            del self._by_step[int(step)]
        # rank/slice-targeted faults are consumed everywhere but fire
        # only on their target — every process's schedule drains at the
        # same steps
        taken, skipped = [], []
        for f in matched:
            if f.rank is not None and f.rank != self.own_rank:
                skipped.append(f)
            elif f.slice_id is not None and f.slice_id != self.own_slice:
                skipped.append(f)
            else:
                taken.append(f)
        self.fired.extend(taken)
        self.skipped.extend(skipped)
        tr = _telemetry.get_tracer()
        for f in skipped:
            logger.info("inject: %s at step %d targets %s "
                        "(this is rank %d, slice %s); skipped",
                        f.kind, step,
                        (f"rank {f.rank}" if f.rank is not None
                         else f"slice {f.slice_id}"),
                        self.own_rank, self.own_slice)
        for f in taken:
            logger.warning("inject: firing %s at step %d", f.kind, step)
            if tr.enabled:
                tr.count("faults.injected")
                tr.event("fault.injected", kind=f.kind, step=f.step,
                         arg=f.arg)
        return taken

    def before_step(self, step: int, *,
                    directory: Optional[str] = None) -> None:
        """Fire every non-batch fault due at ``step``. Raises
        `InjectedFault` for an ``exc`` fault (after firing any co-scheduled
        hang/corrupt/preempt, so stacked faults all land)."""
        raise_after = None
        for f in self._take(step, ("hang", "slow", "ckpt_corrupt",
                                   "preempt", "exc")):
            if f.kind == "hang":
                time.sleep(f.arg)
            elif f.kind == "slow":
                # one-shot arming of a PERSISTENT latency: a straggler,
                # not a single hiccup — the slowdown below applies to
                # this and every subsequent step
                self.slow_s += max(float(f.arg), 0.0)
            elif f.kind == "ckpt_corrupt":
                if directory is not None:
                    corrupt_latest_checkpoint(directory)
                else:
                    logger.warning(
                        "inject: ckpt_corrupt at step %d skipped "
                        "(no checkpoint directory at this call site)", step)
            elif f.kind == "preempt":
                if self._kill:
                    os.kill(os.getpid(), signal.SIGTERM)
            else:  # exc
                raise_after = f
        if self.slow_s > 0.0:
            time.sleep(self.slow_s)
        if raise_after is not None:
            raise InjectedFault(
                f"injected step failure at step {raise_after.step}"
            )

    def poison_batch(self, step: int, batch):
        """Apply a due ``nan`` fault to ``batch`` (returned unchanged
        otherwise). A batch with no floating-point leaf (all-integer
        token batches) cannot carry a NaN — the fault degrades to an
        `InjectedFault` step error so the recovery path still fires
        instead of the chaos harness killing the run it is testing."""
        if self._take(step, ("nan",)):
            try:
                return poison_pytree(batch)
            except ValueError as exc:
                raise InjectedFault(
                    f"nan fault at step {step} found no float leaf to "
                    f"poison ({exc}); degraded to a step error"
                ) from None
        return batch

    def torn_segment(self, flush_no: int) -> bool:
        """True when a due ``torn_seg`` fault fires for this segment
        flush (the feedback writer's flush counter is the step clock) —
        the writer then publishes the segment payload WITHOUT its
        manifest and drops the buffered records, simulating a crash
        between the two writes of the manifest-LAST commit protocol.
        The data-path analog of ``ckpt_corrupt``: what must survive is
        the READER (`online.feedback.FeedbackReader` walks past)."""
        return bool(self._take(flush_no, ("torn_seg",)))

    def duplicate_feedback(self, append_no: int) -> bool:
        """True when a due ``dup_feedback`` fault fires for this record
        append (the feedback writer's append counter is the step clock) —
        the writer then re-appends an already-committed record verbatim,
        an at-least-once producer retry the reader's monotonic-seq dedup
        must absorb exactly-once (``online.dedup_hits``)."""
        return bool(self._take(append_no, ("dup_feedback",)))

    def poison_burst(self, append_no: int) -> int:
        """Burst size (0 = not due) when a ``poison_feedback`` fault
        fires for this record append (the feedback writer's append
        counter is the step clock) — the writer then pushes ``arg``
        (default 8) schema-violating/outlier/oversize records through
        the REAL append path, so they are stamped, committed, and
        ledger-accounted like any client feedback. What must survive is
        the TRAINER: `online.quality.QualityGate` rejects every one
        (``online.records_rejected_*``) while the cursor still advances
        past them — poisoning costs freshness, never correctness."""
        for f in self._take(append_no, ("poison_feedback",)):
            return max(int(f.arg), 1) if f.arg else 8
        return 0

    def bad_version_due(self, publish_no: int) -> bool:
        """True when a due ``bad_version`` fault fires for this weight
        publication (`online.publish.VersionPublisher`'s publish counter
        is the step clock) — the publisher then poisons the params to
        NaN before the store write, publishing a version that fails the
        serving-side finiteness probe. What must survive is the FLEET:
        the router's canary verdict fails the version, the rollback
        marker retires it, and the backfilled replicas converge on the
        last good version (`serving.router.CanaryController`)."""
        return bool(self._take(publish_no, ("bad_version",)))

    def dcn_slow_s_for(self, exchange_no: int) -> float:
        """Persistent cross-slice latency due at this DCN exchange (the
        exchanger's exchange counter is the clock): a due ``dcn_slow``
        fault ARMS ``dcn_slow_s`` once — a congested DCN link is a
        condition, not a hiccup — and every later exchange on this
        process sleeps that long before fetching. Slice-target it
        (``dcn_slow@3:0.05:s0``) to make one slice the straggler."""
        for f in self._take(exchange_no, ("dcn_slow",)):
            self.dcn_slow_s += max(float(f.arg), 0.0)
        return self.dcn_slow_s

    def dcn_drop_due(self, exchange_no: int) -> bool:
        """True when a due ``dcn_drop`` fault fires for this DCN
        exchange — the exchanger then suppresses its outbound publish
        once (a transient partition). What must survive is the FLEET:
        peer fetches time out into `comm.dcn.DcnPeerTimeout`, the guard
        rolls every slice back in lockstep, and the replayed exchange
        publishes normally (the fault fired exactly once)."""
        return bool(self._take(exchange_no, ("dcn_drop",)))

    def dcn_outage_due(self, exchange_no: int) -> bool:
        """True while an armed ``dcn_flap`` or ``dcn_partition`` fault
        suppresses THIS exchange's outbound publish.

        ``dcn_flap@N:K`` arms at exchange ``N`` and suppresses exchanges
        ``N, N+2, ..., N+2(K-1)`` — K drop/recover cycles, the flapping
        link whose every cycle the degraded ladder's retry/skip rungs
        must absorb without a rollback. ``dcn_partition@N:SECS`` arms at
        exchange ``N`` and suppresses every exchange for the next SECS
        of wall time — the sustained outage that must walk past the
        staleness budget into eviction. Wall-clock on purpose: the
        partitioned slice keeps stepping at its own (skipped) pace, so
        the outage spans however many rounds that takes — deterministic
        in outcome, not in round count."""
        for f in self._take(exchange_no, ("dcn_flap",)):
            self._flaps.append(
                (int(exchange_no), max(int(f.arg), 1) if f.arg else 1))
        for f in self._take(exchange_no, ("dcn_partition",)):
            self._partition_until = max(
                self._partition_until,
                time.monotonic() + max(float(f.arg), 0.0))
        out = False
        for n0, k in self._flaps:
            rel = int(exchange_no) - n0
            if 0 <= rel < 2 * k and rel % 2 == 0:
                out = True
        if time.monotonic() < self._partition_until:
            out = True
        return out

    def corrupt_payload(self, step: int, data: bytes) -> bytes:
        """Apply a due ``corrupt_resp`` fault to an outbound response
        payload (returned unchanged otherwise) — the serving replica
        calls this AFTER checksum-signing, so the consumer's integrity
        check is what must catch the damage (`serving.router`)."""
        if self._take(step, ("corrupt_resp",)):
            head = bytes(b ^ 0xFF for b in data[:16])
            return head + data[16:]
        return data

    def flip_bucket_for(self, step: int) -> Optional[int]:
        """Bucket index to silently corrupt at this step (None = no SDC
        armed). A due ``flip`` fault ARMS the corruption once — a stuck
        compute lane is a condition, not a hiccup — and every later
        attempt on this process re-applies the same bit-flip, so the
        fault REPRODUCES on the post-rollback replay and the SDC arbiter
        convicts it as deterministic (`resilience.sdc`). ``arg`` selects
        the bucket (`flip_state_bucket` clamps it to the plan's range
        and flips the bucket's last real element)."""
        for f in self._take(step, ("flip",)):
            self._flip_bucket = max(int(f.arg), 0)
        return self._flip_bucket

    def corrupt_tokens(self, step: int, tokens):
        """Apply an armed ``flip_logits`` fault to a response's token
        list (returned unchanged otherwise) — the serving replica calls
        this BEFORE checksum-signing, so the payload verifies clean at
        the router and only the shadow-replay vote can catch the damage
        (the serving twin of ``flip``). Persistent once armed, like the
        training-side flip."""
        for _ in self._take(step, ("flip_logits",)):
            self._flip_logits = True
        if self._flip_logits and tokens:
            tokens = list(tokens)
            tokens[0] = int(tokens[0]) ^ 1
        return tokens


def flip_state_bucket(state, bucket: int, plan=None, *,
                      rank: Optional[int] = None):
    """Set the low bit of one element of bucket ``bucket``'s fp32 master —
    the injected silent corruption `GuardedTrainer._attempt` applies to
    the state ENTERING a step when a ``flip`` fault is armed.

    The flipped element is the bucket's LAST REAL parameter element
    (``plan`` gives the bucket's true ``size``; without a plan, the
    buffer's last element), at its index ``idx`` in the padded bucket.
    One low mantissa bit is a ~2^-23 relative perturbation: every
    downstream float32 reduction (matmul accumulations, the loss mean)
    rounds it away for multiple steps, so the loss-bits sentinel stays
    blind — while the bucket's EXACT uint32 wraparound checksum differs at
    the very next step's fingerprint. (A flip in the padded tail would be
    quieter still, but the update rewrites the pad region every step.)

    The port's ``state.shards[bucket]`` is this rank's shard in the
    sharded modes (the whole padded bucket in the replicated ones): the
    bit is set in place, on the shard's device, by the rank whose shard
    holds ``idx`` (``rank``, default `comm.backend.rank`); on any other
    rank nothing changes. Idempotent by construction (``|=``, not XOR):
    re-applying on every attempt keeps the corruption persistent without
    toggling itself off. Returns ``(state, bucket_used, idx)``."""
    nbuckets = len(state.shards)
    if nbuckets == 0:
        return state, None, None
    bucket = min(max(int(bucket), 0), nbuckets - 1)
    shard = state.shards[bucket]
    n = shard.numel()
    if plan is not None and getattr(plan, "buckets", None):
        b = plan.buckets[bucket]
        idx = min(int(b.size), int(b.padded_size)) - 1
        lo = 0 if n == b.padded_size else (
            (rank if rank is not None else _own_rank()) * n)
    else:
        idx, lo = n - 1, 0
    local = idx - lo
    if 0 <= local < n:
        with torch.no_grad():
            flat = shard.view(-1)
            if shard.element_size() == 4:
                flat.view(torch.int32)[local:local + 1].bitwise_or_(1)
            else:  # non-4-byte dtypes: the low bit of the element's byte
                k = local * shard.element_size()
                flat.view(torch.uint8)[k:k + 1].bitwise_or_(1)
    return state, bucket, idx


def _own_rank() -> int:
    from dear_pytorch_tpu_torch.comm import backend

    return backend.rank()
