"""Chrome-trace (about://tracing / Perfetto) event writer — the port of
``TraceWriter`` of ``dear_pytorch_tpu/utils/chrome_trace.py``.

`TraceWriter` is a lightweight host-side event log in Chrome trace format:
step markers, plan rebuilds, tuner decisions. A background thread drains a
queue so the training loop never blocks on file IO (the reference's
dear/chrome_profiler.py:13-117 design). Device-side timelines come from
``torch.profiler``, which the JAX module's ``timeline`` (a
``jax.profiler`` switch) has no part in here.
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
import time

__all__ = ["TraceWriter"]


class TraceWriter:
    """Asynchronous Chrome-trace JSON writer.

    Events use the 'X' (complete) phase: name, ts/dur in microseconds.
    `event()` may be called from the training loop at any rate; a daemon
    thread collects them, and `close()` (or the context manager) writes
    the file."""

    def __init__(self, path: str, pid: int = 0):
        self._path = path
        self._pid = pid
        self._q: queue.Queue = queue.Queue()
        self._events: list[dict] = []
        self._t0 = time.perf_counter()
        self._closed = False
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def event(self, name: str, start_us: float, dur_us: float,
              tid: int = 0, **args) -> None:
        self._q.put({
            "name": name, "ph": "X", "ts": start_us, "dur": dur_us,
            "pid": self._pid, "tid": tid, "args": args,
        })

    @contextlib.contextmanager
    def span(self, name: str, tid: int = 0, **args):
        t0 = self._now_us()
        try:
            yield
        finally:
            self.event(name, t0, self._now_us() - t0, tid=tid, **args)

    def instant(self, name: str, **args) -> None:
        self._q.put({
            "name": name, "ph": "i", "ts": self._now_us(), "s": "g",
            "pid": self._pid, "tid": 0, "args": args,
        })

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            self._events.append(item)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=5)
        with open(self._path, "w") as f:
            json.dump({"traceEvents": self._events,
                       "displayTimeUnit": "ms"}, f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
