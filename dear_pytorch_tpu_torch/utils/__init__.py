"""Utilities of the port: the α-β cost model (`perf_model`), the step and
collective profilers (`profiling`), the Chrome-trace writer
(`chrome_trace`), the JSONL metrics logger (`metrics`), checkpoints
(`checkpoint`) and the guarded trainer (`guard`)."""

from dear_pytorch_tpu_torch.utils.guard import GuardedTrainer  # noqa: F401
from dear_pytorch_tpu_torch.utils.metrics import MetricsLogger  # noqa: F401
