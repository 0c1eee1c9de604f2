"""Resilience — the port of ``dear_pytorch_tpu/resilience``:

  - `inject`    — deterministic, step-scheduled chaos (NaN batches, raised
                  step errors, hangs, corrupted checkpoints, SIGTERM
                  preemption, silent bit-flips) via ``DEAR_FAULTS`` or code;
  - `watchdog`  — heartbeat-fed hang detector: dumps open spans and every
                  thread's stack and aborts with the last-good step;
  - `preempt`   — SIGTERM -> flag -> emergency synchronous checkpoint at
                  the next step boundary (`utils.guard.GuardedTrainer`);
  - `retry`     — bounded deterministic retry of transient host-side I/O;
  - `cluster`   — host-level consensus for multi-process recovery over the
                  c10d store (or the host gloo group, or a directory);
  - `sdc`       — the per-bucket fingerprint vote, the replay arbiter and
                  the host-keyed quarantine ledger.

Elastic membership and the capacity policy (``membership``, ``scale``)
are ROADMAP Queue 1 item 9b.
"""

from dear_pytorch_tpu_torch.resilience.cluster import (  # noqa: F401
    ClusterCoordinator,
    ClusterError,
    DesyncError,
    FileTransport,
    HealthVerdict,
    LocalTransport,
    PeerTimeout,
    StoreTransport,
)
from dear_pytorch_tpu_torch.resilience.inject import (  # noqa: F401
    FAULT_ENV,
    Fault,
    FaultInjector,
    InjectedFault,
    corrupt_latest_checkpoint,
    parse_faults,
    poison_pytree,
)
from dear_pytorch_tpu_torch.resilience.preempt import (  # noqa: F401
    PreemptionHandler,
)
from dear_pytorch_tpu_torch.resilience.retry import (  # noqa: F401
    RetryError,
    retry_call,
    retryable,
)
from dear_pytorch_tpu_torch.resilience.watchdog import (  # noqa: F401
    StepWatchdog,
    WatchdogReport,
)
