"""Structured training-metrics logging (JSONL) — the port of
``dear_pytorch_tpu/utils/metrics.py``: the observability layer the
reference reduces to rank-0 ``print`` + log-scraping regexes (SURVEY.md
§5: ``log()`` helpers, dear/imagenet_benchmark.py:139-142; results
recovered by ``extract_log`` pattern-matching, benchmarks.py:119-128).

`MetricsLogger` writes through the tracer's `JsonlWriter`
(`observability.tracer`; the JAX package's ``observability/export.py`` is
ROADMAP Queue 1 item 12), whose line format and strict-JSON rules are the
JAX writer's: NaN and infinities become their ``repr`` strings, numpy and
torch scalars and arrays host values. The record shape is JAX's: a
wall-clock ``time`` (seconds since logger creation, rounded to 1 µs), an
optional ``step``, every keyword as a JSON scalar (a one-element tensor or
array as its item, a larger one as a list), rank 0 only (the in-step
metrics are already reduced over the ranks). One record per call, one
JSON object per line, flushed eagerly so a crashed run keeps everything
logged up to the failure. A tensor on the card costs a device sync when
logged.
"""

from __future__ import annotations

import json
import time
import warnings
from typing import Optional

import numpy as np

from dear_pytorch_tpu_torch.observability.tracer import (
    JsonlWriter,
    _json_safe,
    process_index,
)

__all__ = ["MetricsLogger", "read_metrics"]


class MetricsLogger:
    """Append-only JSONL metrics writer.

    >>> ml = MetricsLogger("/tmp/run/metrics.jsonl")
    >>> ml.log(step=10, loss=0.3, img_per_sec=1890.0)
    >>> ml.close()

    Each record carries ``step`` (if given), a wall-clock ``time`` (seconds
    since logger creation), and every keyword as a JSON scalar.
    """

    def __init__(self, path: str, *, all_ranks: bool = False,
                 append: bool = False):
        self._active = all_ranks or process_index() == 0
        self._w: Optional[JsonlWriter] = None
        self.path = path
        if self._active:
            self._w = JsonlWriter(path, append=append)
        self._t0 = time.time()

    @staticmethod
    def _scalar(v):
        if isinstance(v, (str, bool)) or v is None:
            return v
        if hasattr(v, "detach"):            # a torch tensor, on any device
            v = v.detach().cpu().numpy()
        arr = np.asarray(v)
        if arr.size == 1:
            return _json_safe(arr.reshape(()).item())
        return _json_safe(arr.tolist())

    def log(self, step: Optional[int] = None, **values) -> None:
        if not self._active:
            return
        rec = {"time": round(time.time() - self._t0, 6)}
        if step is not None:
            rec["step"] = int(step)
        for k, v in values.items():
            rec[k] = self._scalar(v)
        self._w.write(rec)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None
            self._active = False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_metrics(path: str) -> list[dict]:
    """Parse a JSONL metrics file back into records.

    A torn FINAL line (crash mid-write) is expected and dropped silently;
    an undecodable line in the middle of the file means real corruption, so
    it is reported with its line number rather than vanishing.
    """
    out = []
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError as e:
            if i == len(lines) - 1:
                continue  # torn last line from a crash: tolerated
            warnings.warn(
                f"{path}:{i + 1}: skipping undecodable metrics line ({e})",
                stacklevel=2,
            )
    return out
