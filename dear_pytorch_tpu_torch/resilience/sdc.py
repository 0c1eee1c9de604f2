"""Silent-data-corruption (SDC) sentinel: fingerprint voting, replay
blame, and a durable host-keyed quarantine ledger.

Every other fault the stack survives is fail-stop or *detectably*
corrupt (sha256 on checkpoints, DCN chunk headers, signed serving
responses). A flaky chip that computes a validly-checksummed **wrong**
gradient defeats all of that: the bytes are self-consistent, only the
*value* is wrong. DeAR's decoupled schedule hands us the antidote:
post-reduce bucket state is replica-identical by construction, so a
cheap per-bucket checksum voted across ranks pinpoints a silent
corruption to a (rank, bucket) within one health-check interval —
long before loss drift would.

The pieces, bottom up:

  - **fingerprints** — `parallel.dear` emits ``metrics['sdc_fp']``, a
    uint32-per-bucket wraparound checksum over the post-update bucket
    buffers, computed IN-PROGRAM (bitcast + integer sum: exact,
    order-independent, psum-completed when sharded). The guard fetches
    it only at check cadence and threads the hex encoding through the
    coordinated health exchange (`cluster.evaluate_health_views`); the
    hierarchical schedule's DCN leg checksums the committed include-set
    mean the same way (`comm.dcn.DcnExchanger.last_mean_fp`).
  - **vote** — `vote` takes the gathered per-rank fingerprint strings
    and returns the minority (rank, bucket) suspects under a strict
    per-bucket majority (>= 3 voters; with two voters a disagreement is
    still surfaced as a desync — caught, not localized).
  - **replay blame** — `SdcSentinel.note_votes` drives the arbiter: a
    first vote against a host opens a case and the verdict's rollback
    *is* the replay — every rank (the suspect AND its healthy peers)
    restores the last verified checkpoint and the deterministic
    pipeline sidecar re-runs the suspect window on the identical data
    shard. The NEXT vote is the comparison: reproduced divergence means
    a deterministic fault (conviction); a clean re-run means transient
    SDC (a strike).
  - **quarantine** — `SdcLedger` appends first-writer-wins records
    (`transport.decide_once`, the include-set idiom) keyed by *host
    identity*, never rank id: strike accounting follows the host across
    process incarnations, and `launch/supervisor.py` consults the
    ledger before any relaunch/backfill so a quarantined host is never
    re-seated. Every rank appends the same deterministic record for the
    same vote; record-equality dedupe collapses them to one event.
  - **probation** — `probation_selftest` is the known-answer re-entry
    gate (matmul against an independent reference + bitwise stability
    across a burn-in + a local-device psum): `probation_gate` runs it
    BEFORE a quarantined host's rejoin request is filed, and the module
    CLI (``python -m dear_pytorch_tpu_torch.resilience.sdc --selftest``) lets
    the supervisor run it out-of-process for a drained host.

The serving twin (router shadow-replay of 1-in-N responses, exact under
greedy-deterministic decode) lives in `serving.router` and strikes into
the same ledger.

Everything here is torch-free at module scope (the supervisor and router
import it); `probation_selftest` imports torch lazily. This is the port of
``dear_pytorch_tpu/resilience/sdc.py``; the fingerprint is
`parallel.dear.TrainStep`'s ``metrics["sdc_fp"]``, a device-side
``view(torch.int32)`` sum per bucket.
"""

from __future__ import annotations

import json
import os
import socket
from collections import Counter
from typing import Dict, List, Optional, Tuple

from dear_pytorch_tpu_torch.observability import tracer as _telemetry

__all__ = [
    "SDC_ENV", "STRIKES_ENV", "HOST_ENV", "LEDGER_ENV", "SHADOW_ENV",
    "PROBATION_ENV", "QUARANTINE_RC", "SdcQuarantined", "sdc_enabled",
    "host_identity", "encode_fingerprints", "fingerprint_array", "vote",
    "SdcLedger", "ledger_from_dir", "SdcSentinel", "probation_selftest",
    "probation_gate",
]

#: master switch: "1" arms the sentinel (fingerprint emission in the
#: compiled step, the vote on the health exchange, ledger writes)
SDC_ENV = "DEAR_SDC"
#: strikes (transient-SDC verdicts) a host absorbs before quarantine
STRIKES_ENV = "DEAR_SDC_STRIKES"
#: this process's host identity — the ledger key (the supervisor exports
#: it per seat; rank ids are NOT stable across backfills, hosts are)
HOST_ENV = "DEAR_SDC_HOST"
#: ledger root directory (defaults to <DEAR_ELASTIC_DIR>/sdc)
LEDGER_ENV = "DEAR_SDC_LEDGER"
#: serving twin: shadow-replay every Nth completed response (0 = off)
SHADOW_ENV = "DEAR_SDC_SHADOW_EVERY"
#: probation self-test burn-in repeats
PROBATION_ENV = "DEAR_SDC_PROBATION_STEPS"

#: exit code of a rank draining itself off a quarantined host — the
#: supervisor reads it as "seat me again on a FRESH host" (a planned
#: shrink, not a failure: it does not consume the relaunch budget)
QUARANTINE_RC = 75


class SdcQuarantined(RuntimeError):
    """This rank's host was convicted (or struck out) in the quarantine
    ledger and its planned-shrink drain has committed — the process must
    exit with `QUARANTINE_RC` so the supervisor backfills elsewhere."""

    rc = QUARANTINE_RC


def sdc_enabled() -> bool:
    """The disabled-path gate (one env-dict lookup + compare; budgeted
    by scripts/check_telemetry_overhead.py under the 1 us contract)."""
    return os.environ.get(SDC_ENV, "") == "1"


def host_identity(rank: Optional[int] = None) -> str:
    """This process's ledger key: the supervisor-exported host id when
    present, else the real hostname (suffixed by rank for single-host
    process clusters, where ranks simulate hosts)."""
    h = os.environ.get(HOST_ENV, "").strip()
    if h:
        return h
    base = socket.gethostname() or "localhost"
    return f"{base}-r{rank}" if rank is not None else base


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------


def fingerprint_array(a) -> int:
    """Host-side reference checksum: uint32 wraparound sum over the
    float32 view of ``a`` — the same arithmetic the compiled step emits
    (bitcast + integer sum is exact and order-independent, unlike any
    float reduction). Used for the DCN committed-mean leg and tests."""
    import numpy as np

    x = np.ascontiguousarray(np.asarray(a, dtype=np.float32))  # dearlint: disable=hot-path-sync
    if x.size == 0:
        return 0
    return int(x.view(np.uint32).astype(np.uint64).sum() & 0xFFFFFFFF)


def encode_fingerprints(words) -> str:
    """uint32-per-bucket checksums -> the compact dotted-hex string that
    rides the health payload (one 8-hex-digit word per bucket)."""
    import numpy as np

    arr = np.asarray(words).reshape(-1)  # dearlint: disable=hot-path-sync
    return ".".join(f"{int(w) & 0xFFFFFFFF:08x}" for w in arr)


def vote(fps: Dict[int, str]) -> List[Tuple[int, int]]:
    """Per-bucket majority vote over the gathered fingerprint strings.

    ``fps`` maps rank -> dotted-hex fingerprint (empty string = no
    fingerprint this round; such ranks abstain). Returns the minority
    ``(rank, bucket)`` suspects. Requires >= 3 comparable voters and a
    strict majority per bucket — with fewer voters, blame is impossible
    and the caller falls back to plain desync detection. Ranks whose
    bucket count disagrees with the majority shape (mid-rescale
    stragglers) abstain rather than poison the vote."""
    voters = {int(r): s.split(".") for r, s in fps.items() if s}
    if len(voters) < 3:
        return []
    shape = Counter(len(v) for v in voters.values()).most_common(1)[0][0]
    voters = {r: v for r, v in voters.items() if len(v) == shape}
    if len(voters) < 3:
        return []
    suspects: List[Tuple[int, int]] = []
    for b in range(shape):
        tally = Counter(v[b] for v in voters.values())
        winner, n = tally.most_common(1)[0]
        if n * 2 <= len(voters):
            continue  # no strict majority: nobody to blame this bucket
        for r in sorted(voters):
            if voters[r][b] != winner:
                suspects.append((r, b))
    return suspects


# ---------------------------------------------------------------------------
# The quarantine ledger
# ---------------------------------------------------------------------------


class SdcLedger:
    """Durable, host-keyed event ledger over any transport with the
    ``decide_once``/``list_prefix``/``get`` surface (`FileTransport` in
    production, `LocalTransport`/`SimTransport` in tests).

    Records are appended first-writer-wins at sequence-numbered keys
    ``<ns>/hosts/<host>/<n>``. Replicated writers (every rank appending
    the same deterministic vote outcome) dedupe by record equality; a
    genuine race (two *different* records) lands both, ordered. State is
    a pure fold over the event sequence:

      - ``strike``      — transient-SDC verdict; counts toward strikeout
      - ``conviction``  — deterministic fault reproduced on replay;
                          implies quarantine
      - ``quarantine``  — strike threshold crossed
      - ``readmit``     — probation self-test passed; clears everything
    """

    def __init__(self, transport, *, ns: str = "sdc",
                 strike_threshold: Optional[int] = None,
                 timeout_s: float = 5.0):
        self.transport = transport
        self.ns = ns.strip("/")
        if strike_threshold is None:
            strike_threshold = int(os.environ.get(STRIKES_ENV, "3"))
        self.strike_threshold = max(int(strike_threshold), 1)
        self.timeout_s = float(timeout_s)

    def _key(self, host: str, n: int) -> str:
        return f"{self.ns}/hosts/{host}/{n}"

    def events(self, host: str) -> List[dict]:
        names = self.transport.list_prefix(f"{self.ns}/hosts/{host}")
        out: List[dict] = []
        for n in sorted(int(x) for x in names if x.isdigit()):
            try:
                # ledger reads happen at vote/seat cadence, never per
                # step — the rendezvous is deliberate
                out.append(json.loads(self.transport.get(  # dearlint: disable=dcn-blocking
                    self._key(host, n), self.timeout_s)))
            except Exception:  # noqa: BLE001 — a torn/missing slot ends
                break          # the readable prefix; later events wait
        return out

    def _append(self, host: str, record: dict) -> None:
        """First-writer-wins append at the next free sequence slot. A
        peer landing the IDENTICAL record satisfies the append (the
        replicated-writer dedupe); a different record bumps us to the
        next slot."""
        payload = json.dumps(record, sort_keys=True)
        n = len(self.transport.list_prefix(f"{self.ns}/hosts/{host}"))
        while True:
            won = self.transport.decide_once(self._key(host, n), payload)
            if won == payload:
                return
            try:
                if json.loads(won) == record:
                    return
            except ValueError:
                pass
            n += 1

    def state(self, host: str) -> dict:
        strikes = 0
        quarantined = convicted = False
        evs = self.events(host)
        for e in evs:
            kind = e.get("kind")
            if kind == "strike":
                strikes += 1
            elif kind == "conviction":
                convicted = quarantined = True
            elif kind == "quarantine":
                quarantined = True
            elif kind == "readmit":
                strikes = 0
                quarantined = convicted = False
        return {"strikes": strikes, "quarantined": quarantined,
                "convicted": convicted, "events": len(evs)}

    def quarantined(self, host: str) -> bool:
        return self.state(host)["quarantined"]

    def strike(self, host: str, **info) -> dict:
        """Record a transient-SDC strike; crossing the threshold writes
        the quarantine record too. Returns the post-write state."""
        self._append(host, {"kind": "strike", **info})
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.count("sdc.strikes")
        st = self.state(host)
        if not st["quarantined"] and st["strikes"] >= self.strike_threshold:
            self._append(host, {"kind": "quarantine", "why": "strikeout",
                                "strikes": st["strikes"]})
            if tr.enabled:
                tr.count("sdc.quarantines")
                tr.event("sdc.quarantine", host=host, why="strikeout")
            st = self.state(host)
        return st

    def convict(self, host: str, **info) -> dict:
        """Record a reproduced (deterministic) fault — conviction implies
        quarantine. Idempotent while the host stays quarantined."""
        if not self.state(host)["quarantined"]:
            self._append(host, {"kind": "conviction", **info})
            tr = _telemetry.get_tracer()
            if tr.enabled:
                tr.count("sdc.convictions")
                tr.count("sdc.quarantines")
                tr.event("sdc.quarantine", host=host, why="conviction")
        return self.state(host)

    def readmit(self, host: str, **info) -> dict:
        """Probation passed: clear quarantine and strike history."""
        self._append(host, {"kind": "readmit", **info})
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.count("sdc.readmits")
        return self.state(host)

    def hosts(self) -> List[str]:
        return list(self.transport.list_prefix(f"{self.ns}/hosts"))

    def quarantined_hosts(self) -> List[str]:
        return [h for h in self.hosts() if self.quarantined(h)]


def ledger_from_dir(path: str, **kwargs) -> SdcLedger:
    """A `SdcLedger` over a `FileTransport` rooted at ``path`` — the
    shape both the supervisor (torch-free) and the workers share."""
    from dear_pytorch_tpu_torch.resilience.cluster import FileTransport

    return SdcLedger(FileTransport(path), **kwargs)


# ---------------------------------------------------------------------------
# The per-rank sentinel (vote bookkeeping + replay arbitration)
# ---------------------------------------------------------------------------


class SdcSentinel:
    """Per-rank driver: host identity, ledger handle, and the replay
    arbiter's case state.

    The arbiter needs no side channel: a vote's verdict is not-ok, so
    every rank — suspect and healthy peers alike — rolls back to the
    last verified checkpoint and the deterministic pipeline re-runs the
    suspect window on the identical data shard. That coordinated re-run
    IS the replay; the next vote is the comparison. `note_votes` is a
    pure function of the gathered views, so every rank advances an
    identical case state and appends identical ledger records (which
    `SdcLedger._append` dedupes to one event)."""

    def __init__(self, *, host: str, ledger: Optional[SdcLedger] = None):
        self.host = host
        self.ledger = ledger
        #: host -> the open case from its first (unconfirmed) vote
        self.open_cases: Dict[str, dict] = {}
        #: hosts this process has seen convicted or struck out
        self.convicted: set = set()
        #: the most recent vote's suspects, as (rank, bucket, host) —
        #: chaos verdicts read this to assert localization
        self.last_suspects: List[list] = []
        #: set once our OWN host lands in the ledger: the guard announces
        #: a planned-shrink drain at the next sync and stops checkpointing
        self.drain_requested = False

    @classmethod
    def from_env(cls, *, rank: Optional[int] = None,
                 ledger_dir: Optional[str] = None,
                 strike_threshold: Optional[int] = None
                 ) -> Optional["SdcSentinel"]:
        """Build the sentinel when `DEAR_SDC` is armed; None otherwise.
        The ledger root falls back to ``<DEAR_ELASTIC_DIR>/sdc`` so a
        supervisor-spawned fleet shares one ledger with no extra
        plumbing."""
        if not sdc_enabled():
            return None
        root = (ledger_dir or os.environ.get(LEDGER_ENV, "")).strip()
        if not root:
            elastic = os.environ.get("DEAR_ELASTIC_DIR", "").strip()
            root = os.path.join(elastic, "sdc") if elastic else ""
        ledger = (ledger_from_dir(root, strike_threshold=strike_threshold)
                  if root else None)
        return cls(host=host_identity(rank), ledger=ledger)

    def local_fingerprint(self, words, extra: str = "") -> str:
        """Encode this rank's per-bucket checksums for the health
        payload; ``extra`` appends the DCN committed-mean leg so the
        cross-slice exchange is voted on exactly like the buckets."""
        s = "" if words is None else encode_fingerprints(words)
        if extra:
            s = f"{s}.{extra}" if s else extra
        return s

    def note_votes(self, suspects, hosts_by_rank: Dict[int, str], *,
                   step: int, voted: bool = True) -> dict:
        """Advance the arbiter with one sync's vote outcome. Returns the
        actions taken: ``opened`` (first vote: case opened, the rollback
        replay runs next), ``convicted`` (reproduced after replay, or
        struck out), ``struck`` (clean replay: transient). A sync where
        no vote was decidable (``voted=False`` — too few
        fingerprint-bearing peers reached it) leaves open cases pending
        instead of mistaking silence for a clean replay."""
        actions = {"opened": [], "convicted": [], "struck": []}
        if not voted:
            return actions
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.count("sdc.votes")
            if suspects:
                tr.count("sdc.suspected", len(suspects))
        self.last_suspects = [
            [int(r), int(b), hosts_by_rank.get(r, "")] for r, b in suspects]
        fresh: Dict[str, Tuple[int, int]] = {}
        for r, b in suspects:
            h = hosts_by_rank.get(r) or f"rank{r}"
            if h not in self.convicted:
                fresh.setdefault(h, (int(r), int(b)))
        for h, case in list(self.open_cases.items()):
            if h in fresh:
                # the rollback replay reproduced the divergence on the
                # same data: deterministic fault
                self.open_cases.pop(h)
                self.convicted.add(h)
                actions["convicted"].append(h)
                fresh.pop(h)
                if tr.enabled:
                    tr.event("sdc.conviction", host=h, rank=case["rank"],
                             bucket=case["bucket"], step=case["step"])
                if self.ledger is not None:
                    self.ledger.convict(
                        h, rank=case["rank"], bucket=case["bucket"],
                        step=case["step"], reproduced_at=int(step))
            else:
                # clean replay: the corruption did not reproduce —
                # transient SDC, a strike against the host
                self.open_cases.pop(h)
                actions["struck"].append(h)
                if self.ledger is not None:
                    st = self.ledger.strike(
                        h, rank=case["rank"], bucket=case["bucket"],
                        step=case["step"], cleared_at=int(step))
                    if st["quarantined"]:
                        self.convicted.add(h)
                        actions["convicted"].append(h)
        for h, (r, b) in fresh.items():
            self.open_cases[h] = {"rank": r, "bucket": b, "step": int(step)}
            actions["opened"].append(h)
            if tr.enabled:
                tr.event("sdc.case_opened", host=h, rank=r, bucket=b,
                         step=int(step))
        if self.host in self.convicted:
            self.drain_requested = True
        return actions


# ---------------------------------------------------------------------------
# Probation: the known-answer re-entry gate
# ---------------------------------------------------------------------------


def probation_selftest(*, steps: Optional[int] = None, seed: int = 7,
                       device=None) -> dict:
    """Known-answer burn-in for a host coming off quarantine: a matmul
    checked against an independent (numpy) reference, bitwise stability
    of the device's product across ``steps`` repeats, and a sum over the
    host's local cards whose exact integer result is known in closed
    form. A flaky card fails the stability leg even when any single
    answer looks plausible. The products run with torch on ``device``:
    the card unless the caller asks for ``"cpu"`` (`_device.
    resolve_device`; no card raises). torch is imported lazily — callers
    on the torch-free side (supervisor) run it via the module CLI in a
    subprocess."""
    import numpy as np
    import torch

    from dear_pytorch_tpu_torch._device import resolve_device

    if steps is None:
        steps = int(os.environ.get(PROBATION_ENV, "8"))
    steps = max(int(steps), 2)
    dev = resolve_device(device)

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    b = rng.standard_normal((64, 64)).astype(np.float32)
    want = np.dot(a, b)
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)

    first = torch.matmul(ta, tb).cpu().numpy()
    matmul_ok = bool(np.allclose(first, want, rtol=1e-4, atol=1e-4))
    stable_ok = True
    for _ in range(steps - 1):
        again = torch.matmul(ta, tb).cpu().numpy()
        if again.tobytes() != first.tobytes():
            stable_ok = False
            break

    cards = ([torch.device("cuda", i)
              for i in range(torch.cuda.device_count())]
             if dev.type == "cuda" else [dev])
    ndev = len(cards)
    x = np.arange(ndev * 8, dtype=np.float32).reshape(ndev, 8)
    want_sum = x.sum(axis=0)

    def local_sum():
        rows = [torch.from_numpy(x[i]).to(c) for i, c in enumerate(cards)]
        total = rows[0].clone()
        for r in rows[1:]:
            total += r.to(cards[0])
        return total.cpu().numpy()

    got = local_sum()
    # small exact-integer floats: the sum must be EXACT
    allreduce_ok = bool((got == want_sum).all())
    for _ in range(steps - 1):
        rep = local_sum()
        if rep.tobytes() != got.tobytes():
            allreduce_ok = False
            break

    ok = matmul_ok and stable_ok and allreduce_ok
    tr = _telemetry.get_tracer()
    if tr.enabled:
        tr.count("sdc.selftests")
        tr.event("sdc.selftest", ok=ok, matmul=matmul_ok,
                 stable=stable_ok, allreduce=allreduce_ok, steps=steps)
    return {"ok": ok, "matmul": matmul_ok, "stable": stable_ok,
            "allreduce": allreduce_ok, "steps": int(steps)}


def probation_gate(ledger: Optional[SdcLedger], host: str, *,
                   steps: Optional[int] = None, device=None) -> bool:
    """The re-entry gate, run BEFORE a rejoin request is filed: a
    quarantined host must pass the known-answer self-test, which writes
    its readmit record; a clean host passes through. Returns False when
    the host must NOT rejoin."""
    if ledger is None or not ledger.quarantined(host):
        return True
    result = probation_selftest(steps=steps, device=device)
    if result["ok"]:
        ledger.readmit(host, proof="selftest", steps=result["steps"])
        return True
    return False


def main(argv: Optional[List[str]] = None) -> int:
    """CLI for the supervisor's out-of-process probation run:

        python -m dear_pytorch_tpu_torch.resilience.sdc --selftest \\
            --ledger <dir> --host <host> [--device cpu]

    Exit 0 and a readmit record on pass; exit 1 on fail."""
    import argparse

    ap = argparse.ArgumentParser(prog="dear_pytorch_tpu_torch.resilience.sdc")
    ap.add_argument("--selftest", action="store_true", required=True)
    ap.add_argument("--ledger", default="")
    ap.add_argument("--host", default="")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    result = probation_selftest(steps=args.steps, device=args.device)
    if result["ok"] and args.ledger and args.host:
        ledger_from_dir(args.ledger).readmit(
            args.host, proof="selftest", steps=result["steps"])
    print(json.dumps({"host": args.host, **result}), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
