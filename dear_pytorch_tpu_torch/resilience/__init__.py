"""Resilience — the port's part of ``dear_pytorch_tpu/resilience``: so far
`retry` (bounded, deterministically jittered retry of transient host-side
failures), which the input pipeline's fetches use. The rest of the JAX
package (fault injection, watchdog, preemption, cluster consensus,
membership, scaling, SDC) is ROADMAP Queue 1 item 9."""

from dear_pytorch_tpu_torch.resilience.retry import (  # noqa: F401
    RetryError,
    retry_call,
    retryable,
)
