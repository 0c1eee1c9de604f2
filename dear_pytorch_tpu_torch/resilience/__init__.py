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
                  the host-keyed quarantine ledger;
  - `membership` — elastic membership epochs: survivor shrink, rejoin,
                  scale-up and drain over a store that outlives any rank
                  (`comm.backend.regroup` forms each epoch's group);
  - `scale`     — the capacity-driven supervisor policy
                  (`launch.supervisor` executes its decisions).
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
from dear_pytorch_tpu_torch.resilience.membership import (  # noqa: F401
    ElasticCluster,
    ElasticVerdict,
    EvictedError,
    MembershipView,
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
from dear_pytorch_tpu_torch.resilience.scale import (  # noqa: F401
    CapacityHint,
    ScaleDecision,
    ScalePolicy,
    read_capacity_file,
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
