"""Secret redaction for forensic dumps and exported run context.

The port of ``dear_pytorch_tpu/observability/redaction.py``, its imports retargeted
onto the port's tracer.

Failure reports want the ``DEAR_*`` environment (fault schedules, telemetry
sinks, cluster knobs) because it is what makes a dump replayable — but env
blocks are exactly where credentials leak into logs and scrape endpoints.
Every consumer that writes environment context out of the process goes
through this module first:

  - `resilience.watchdog.StepWatchdog` forensic dumps,
  - `observability.flight.FlightRecorder.dump` (rollback / hang context),
  - `observability.export.PromFileExporter` (the Prometheus text file's
    env comment header).

Redaction is key-driven: a variable whose NAME matches `SENSITIVE_KEY_RE`
(token/secret/key/password/credential/auth/cookie) has its value replaced
with ``REDACTED``; everything else passes through verbatim. Value-driven
guessing is deliberately avoided — a heuristic that sometimes hides fault
schedules or file paths would make dumps unreproducible, while the key
convention is enforceable in code review.

Stdlib-only (no torch): the watchdog must be able to redact while the
process is wedged, and `scripts/check_telemetry_overhead.py` loads the
observability hot-path modules standalone.
"""

from __future__ import annotations

import os
import re
from typing import Mapping, Optional

__all__ = ["REDACTED", "SENSITIVE_KEY_RE", "redact_env", "is_sensitive_key"]

REDACTED = "[redacted]"

#: Key-name fragments that mark a value as secret-bearing. ``key`` is
#: matched as its own underscore-delimited word (``DEAR_SSH_KEY``,
#: ``WANDB_KEY``) so names merely containing the letters (``MONKEY``)
#: pass through; every other fragment matches anywhere.
SENSITIVE_KEY_RE = re.compile(
    r"(?:token|secret|password|passwd|credential|api_?key|auth|cookie"
    r"|private|(?:^|_)keys?(?:_|$))", re.IGNORECASE,
)


def is_sensitive_key(key: str) -> bool:
    return SENSITIVE_KEY_RE.search(key) is not None


def redact_env(
    environ: Optional[Mapping[str, str]] = None,
    *,
    prefix: str = "DEAR_",
) -> dict:
    """The ``prefix``-selected slice of ``environ`` with secret-bearing
    values masked. Defaults to the live process environment and the
    framework's own ``DEAR_*`` namespace (the replay-relevant context a
    dump should carry); pass ``prefix=""`` to redact an arbitrary
    mapping."""
    if environ is None:
        environ = os.environ
    out = {}
    for k in sorted(environ):
        if prefix and not k.startswith(prefix):
            continue
        out[k] = REDACTED if is_sensitive_key(k) else str(environ[k])
    return out
