"""Thread-safe span/event tracer with pluggable exporters — the port of
``dear_pytorch_tpu/observability/tracer.py``.

The event model (shared by every consumer in this package):

  span     a named host-side interval with nesting depth and attributes —
           ``with tracer.span("pack", bucket=3): ...``
  event    a named instant — ``tracer.event("rebuild", buckets=7)``
  counter  a named monotonic accumulator — ``tracer.count("steps")``,
           ``tracer.count("rs_bytes", 1.5e6)``

Exporters adapt records onto a chrome trace (`utils.chrome_trace.
TraceWriter` — view in Perfetto) and JSONL (one JSON object per line,
the JAX package's ``JsonlWriter`` format), plus an in-memory exporter for
tests and report assembly. An exporter sees every finished span and
instant event; counters are pull-only (snapshot). The run-health snapshot
sinks (``prom:`` / ``stream:``, the JAX package's
``observability/export.py``) are not ported yet: asking for one raises
``NotImplementedError`` naming ROADMAP Queue 1 item 12.

Process-global tracer: ``get_tracer()`` returns the module-global instance
— a `NullTracer` unless telemetry was enabled by ``configure(...)`` or the
``DEAR_TELEMETRY`` env var (read once, on first use):

  DEAR_TELEMETRY=1                          counters + in-memory events
  DEAR_TELEMETRY=chrome:/tmp/t.json         + chrome trace file
  DEAR_TELEMETRY=jsonl:/tmp/t.jsonl         + JSONL event log
  DEAR_TELEMETRY=chrome:/a.json,jsonl:/b.jsonl   any comma mix of sinks

Disabled-mode cost contract (tests/test_torch_observability.py):
``get_tracer()`` is a module-dict lookup, ``.enabled`` is a class
attribute read, and instrumented call sites gate on it —

    tr = get_tracer()
    if tr.enabled:
        tr.count("dear.steps")

so a disabled tracer allocates nothing and executes two lookups per
instrumented site. `NullTracer.span` additionally returns one shared
no-op context manager, so even un-gated ``with tr.span(...)`` sites
allocate nothing.

Host-side only, by design: device-side timing belongs to
``torch.profiler``; this tracer names the host events the profiler cannot
— plan rebuilds, tuner decisions, step dispatch. A span around an eager
step measures its host enqueue time, not the card's.
"""

from __future__ import annotations

import os
import threading
import time
import json
import math
from typing import Callable, NamedTuple, Optional, Sequence

__all__ = [
    "SpanRecord", "EventRecord", "Exporter", "MemoryExporter",
    "ChromeTraceExporter", "JsonlExporter", "Tracer", "NullTracer",
    "get_tracer", "set_tracer", "configure", "configure_from_env",
    "disable", "snapshot", "process_index", "TELEMETRY_ENV", "JsonlWriter",
]

TELEMETRY_ENV = "DEAR_TELEMETRY"


class SpanRecord(NamedTuple):
    """One finished span (times in microseconds since tracer creation)."""

    name: str
    t0_us: float
    dur_us: float
    tid: int          # small per-thread ordinal (0 = first thread seen)
    depth: int        # nesting depth within its thread (0 = top level)
    attrs: dict


class EventRecord(NamedTuple):
    """One instant event."""

    name: str
    ts_us: float
    attrs: dict


class Exporter:
    """Exporter interface (duck-typed; subclassing is optional)."""

    def span(self, rec: SpanRecord) -> None:  # pragma: no cover - interface
        pass

    def event(self, rec: EventRecord) -> None:  # pragma: no cover
        pass

    def close(self) -> None:  # pragma: no cover - interface
        pass


class MemoryExporter(Exporter):
    """Collect records in lists — tests and report assembly."""

    def __init__(self):
        self.spans: list[SpanRecord] = []
        self.events: list[EventRecord] = []
        self._lock = threading.Lock()

    def span(self, rec: SpanRecord) -> None:
        with self._lock:
            self.spans.append(rec)

    def event(self, rec: EventRecord) -> None:
        with self._lock:
            self.events.append(rec)


class ChromeTraceExporter(Exporter):
    """Spans/events onto a `utils.chrome_trace.TraceWriter` (Perfetto
    'X' complete events / 'i' instants; the writer's background thread
    keeps file IO off the training loop)."""

    def __init__(self, path_or_writer):
        from dear_pytorch_tpu_torch.utils.chrome_trace import TraceWriter

        if isinstance(path_or_writer, TraceWriter):
            self._writer, self._owned = path_or_writer, False
        else:
            self._writer, self._owned = TraceWriter(path_or_writer), True

    def span(self, rec: SpanRecord) -> None:
        self._writer.event(rec.name, rec.t0_us, rec.dur_us, tid=rec.tid,
                           **rec.attrs)

    def event(self, rec: EventRecord) -> None:
        self._writer.instant(rec.name, **rec.attrs)

    def close(self) -> None:
        if self._owned:
            self._writer.close()


def _json_safe(v):
    """NaN/Inf are not strict JSON (stringified), and numpy/torch scalars
    and arrays coerce to host python values — duck-typed via ``tolist``.
    Recursive (the JAX package's ``export._json_safe``)."""
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if not isinstance(v, (str, bytes, bool, int, float, type(None))):
        to_list = getattr(v, "tolist", None)
        if callable(to_list):
            return _json_safe(to_list())
    return v


class JsonlWriter:
    """Append-only JSON-lines writer: one object per line, flushed eagerly
    (a crashed run keeps everything up to the failure) — the line format of
    the JAX package's ``observability.export.JsonlWriter``."""

    def __init__(self, path: str, *, append: bool = False):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "a" if append else "w")

    def write(self, rec: dict) -> None:
        line = json.dumps(_json_safe(rec)) + "\n"
        with self._lock:
            if self._f is None:
                raise ValueError(f"JsonlWriter({self.path!r}) is closed")
            self._f.write(line)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


class JsonlExporter(Exporter):
    """Spans/events as JSONL records (`JsonlWriter`; ``kind``
    discriminates). Also accepts an object with a ``log(**record)`` method
    (a metrics logger) or a ``write(dict)`` one (a `JsonlWriter`)."""

    def __init__(self, path_or_writer, *, all_ranks: bool = False):
        self._log = None        # MetricsLogger compatibility path
        self._writer = None
        self._owned = False
        if hasattr(path_or_writer, "log"):          # a MetricsLogger
            self._log = path_or_writer.log
        elif hasattr(path_or_writer, "write"):      # a JsonlWriter
            self._writer = path_or_writer
        else:
            if not all_ranks and process_index() != 0:
                return  # inactive rank: drop records (matches MetricsLogger)
            self._writer = JsonlWriter(path_or_writer)
            self._owned = True

    def _write(self, **rec) -> None:
        if self._log is not None:
            self._log(**rec)
        elif self._writer is not None:
            self._writer.write(rec)

    def span(self, rec: SpanRecord) -> None:
        self._write(kind="span", name=rec.name,
                    t0_us=round(rec.t0_us, 3),
                    dur_us=round(rec.dur_us, 3),
                    tid=rec.tid, depth=rec.depth, **rec.attrs)

    def event(self, rec: EventRecord) -> None:
        self._write(kind="event", name=rec.name,
                    ts_us=round(rec.ts_us, 3), **rec.attrs)

    def close(self) -> None:
        if self._owned and self._writer is not None:
            self._writer.close()


def process_index() -> int:
    """This process's rank in ``torch.distributed``'s default group, and 0
    without one (a plain-python process is its own rank 0) — the rank
    lookup the rank-0-gated sinks share."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


class _Span:
    """Context manager for one live span. Re-entrant per instance is NOT
    supported (each ``tracer.span(...)`` call makes a fresh one)."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tr = self._tracer
        self._t0 = tr._now_us()
        self._depth = tr._push()
        tr._enter_live(self)
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        tr._exit_live(self)
        tr._pop()
        rec = SpanRecord(self.name, self._t0, tr._now_us() - self._t0,
                         tr._tid(), self._depth, self.attrs)
        for e in tr._exporters:
            e.span(rec)
        return False


class _NullSpan:
    """Shared, stateless no-op span — the disabled fast path allocates
    nothing per call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe tracer. All methods may be called from any thread; spans
    nest per-thread (a ``threading.local`` stack tracks depth) and counters
    are a single locked dict."""

    enabled = True

    def __init__(self, exporters: Sequence[Exporter] = (),
                 clock: Callable[[], float] = time.perf_counter):
        self._exporters = list(exporters)
        self._clock = clock
        self._t0 = clock()
        self._counters: dict[str, float] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: dict[int, int] = {}
        self._live: dict[int, "_Span"] = {}

    # -- time / thread bookkeeping ------------------------------------------

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _push(self) -> int:
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        return depth

    def _pop(self) -> None:
        self._local.depth = max(getattr(self._local, "depth", 1) - 1, 0)

    def _enter_live(self, span: "_Span") -> None:
        with self._lock:
            self._live[id(span)] = span

    def _exit_live(self, span: "_Span") -> None:
        with self._lock:
            self._live.pop(id(span), None)

    # -- the event model -----------------------------------------------------

    def span(self, name: str, **attrs) -> _Span:
        """``with tracer.span("pack", bucket=3): ...``"""
        return _Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        rec = EventRecord(name, self._now_us(), attrs)
        for e in self._exporters:
            e.event(rec)

    def count(self, name: str, value: float = 1) -> None:
        """Add ``value`` to the monotonic counter ``name``."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def counters(self) -> dict[str, float]:
        """Point-in-time copy of every counter."""
        with self._lock:
            return dict(self._counters)

    def live_spans(self) -> list[dict]:
        """Snapshot of currently-OPEN spans (entered, not yet exited),
        oldest first — what the host is inside of right now."""
        now = self._now_us()
        with self._lock:
            live = list(self._live.values())
        out = []
        for s in live:
            t0 = getattr(s, "_t0", None)
            if t0 is None:  # racing __enter__; not meaningfully open yet
                continue
            out.append({"name": s.name, "age_us": round(now - t0, 3),
                        "attrs": dict(s.attrs)})
        out.sort(key=lambda d: -d["age_us"])
        return out

    def add_exporter(self, exporter: Exporter) -> None:
        self._exporters.append(exporter)

    def exporters(self) -> tuple:
        """Read-only view of the attached exporters."""
        return tuple(self._exporters)

    def close(self) -> None:
        for e in self._exporters:
            e.close()


class NullTracer:
    """Disabled tracer: every operation is a no-op; ``span`` returns one
    shared context manager. ``enabled`` is False so instrumented sites can
    skip even the no-op calls."""

    enabled = False

    def span(self, name: str, **attrs) -> _NullSpan:  # noqa: ARG002
        return _NULL_SPAN

    def event(self, name: str, **attrs) -> None:  # noqa: ARG002
        pass

    def count(self, name: str, value: float = 1) -> None:  # noqa: ARG002
        pass

    def counters(self) -> dict[str, float]:
        return {}

    def live_spans(self) -> list[dict]:
        return []

    def add_exporter(self, exporter) -> None:  # noqa: ARG002
        raise RuntimeError(
            "telemetry is disabled; call observability.configure(...) or "
            f"set {TELEMETRY_ENV} before adding exporters"
        )

    def exporters(self) -> tuple:
        return ()

    def close(self) -> None:
        pass


_NULL_TRACER = NullTracer()
# The process-global tracer. Starts as a sentinel so the first get_tracer()
# can consult DEAR_TELEMETRY exactly once; after that it is either the
# NullTracer singleton or a live Tracer, and get_tracer() is one module
# dict lookup + an identity check.
_tracer: Optional[object] = None
_config_lock = threading.Lock()


def get_tracer():
    """The process-global tracer (NullTracer when telemetry is off)."""
    tr = _tracer
    if tr is None:
        return configure_from_env()
    return tr


def set_tracer(tracer) -> None:
    """Install an explicit tracer (tests; embedding applications)."""
    global _tracer
    with _config_lock:
        _tracer = tracer


def configure(*, chrome: Optional[str] = None, jsonl: Optional[str] = None,
              prom: Optional[str] = None, stream: Optional[str] = None,
              memory: bool = True,
              exporters: Sequence[Exporter] = ()) -> Tracer:
    """Enable telemetry with the given sinks and install the tracer
    process-globally. Returns the live tracer. The in-memory exporter is
    on by default so `snapshot()` always has events to summarize.
    ``prom``/``stream`` (the run-health snapshot sinks) raise: they are not
    ported yet."""
    _stream_exporters(prom, stream)
    exp: list[Exporter] = list(exporters)
    if memory:
        exp.append(MemoryExporter())
    if chrome:
        exp.append(ChromeTraceExporter(chrome))
    if jsonl:
        exp.append(JsonlExporter(jsonl))
    tracer = Tracer(exp)
    set_tracer(tracer)
    return tracer


def _stream_exporters(prom: Optional[str], stream: Optional[str]) -> None:
    """The ``prom:``/``stream:`` run-health snapshot sinks live in the JAX
    package's ``observability/export.py``, which is not ported yet."""
    if prom or stream:
        raise NotImplementedError(
            "the prom:/stream: run-health sinks (observability/export.py) "
            "are not ported yet: ROADMAP Queue 1 item 12")


def disable() -> None:
    """Turn telemetry off (closes the current tracer's exporters)."""
    global _tracer
    with _config_lock:
        if isinstance(_tracer, Tracer):
            _tracer.close()
        _tracer = _NULL_TRACER


def configure_from_env(env: Optional[str] = None):
    """Resolve ``DEAR_TELEMETRY`` into a tracer and install it.

    Spec grammar: falsy ('', '0', 'false', 'no', unset) -> disabled;
    '1'/'true'/'mem' -> counters + memory exporter; otherwise a comma list
    of ``chrome:<path>`` / ``jsonl:<path>`` / ``prom:<path>`` /
    ``stream:<path>`` sink specs.
    """
    global _tracer
    with _config_lock:
        if _tracer is not None:
            return _tracer
        raw = (env if env is not None
               else os.environ.get(TELEMETRY_ENV, "")).strip()
        if raw.lower() in ("", "0", "false", "no"):
            _tracer = _NULL_TRACER
            return _tracer
        sinks: dict[str, Optional[str]] = {
            "chrome": None, "jsonl": None, "prom": None, "stream": None}
        if raw.lower() not in ("1", "true", "yes", "mem", "memory"):
            for part in raw.split(","):
                kind, _, path = part.strip().partition(":")
                if kind in sinks and path:
                    sinks[kind] = path
                else:
                    raise ValueError(
                        f"{TELEMETRY_ENV}: bad sink spec {part!r} (use "
                        "'1', or a comma list of 'chrome:<path>', "
                        "'jsonl:<path>', 'prom:<path>', 'stream:<path>')"
                    )
        _stream_exporters(sinks["prom"], sinks["stream"])
        exp: list[Exporter] = [MemoryExporter()]
        if sinks["chrome"]:
            exp.append(ChromeTraceExporter(sinks["chrome"]))
        if sinks["jsonl"]:
            exp.append(JsonlExporter(sinks["jsonl"]))
        _tracer = Tracer(exp)
        return _tracer


def snapshot() -> dict:
    """JSON-safe summary of the global tracer: enabled flag, counters, and
    per-span-name aggregate timing (count + total µs) when the in-memory
    exporter is attached (the JAX bench's ``telemetry`` block)."""
    tr = get_tracer()
    out: dict = {"enabled": bool(tr.enabled), "counters": tr.counters()}
    if not tr.enabled:
        return out
    for e in getattr(tr, "_exporters", ()):
        if isinstance(e, MemoryExporter):
            agg: dict[str, dict] = {}
            for rec in list(e.spans):
                a = agg.setdefault(rec.name, {"count": 0, "total_us": 0.0})
                a["count"] += 1
                a["total_us"] = round(a["total_us"] + rec.dur_us, 3)
            out["spans"] = agg
            out["events"] = len(e.events)
            break
    return out
