"""dear_pytorch_tpu_torch — the PyTorch and CUDA port of dear_pytorch_tpu.

A second package beside the JAX one, which stays the reference it is held
against. It imports torch and numpy, never jax, flax or optax, and nothing
of ``dear_pytorch_tpu``. Its entry points run on the CUDA card unless the
caller passes ``device="cpu"``.

Ported so far:

  - slice 1, the serving path: GPT-2 served through
    `serving.engine.DecodeEngine` over the ring KV cache, with the decode
    attention in a hand-written Hopper flash-attention forward kernel
    (`ops.flash_attention`, ``csrc/flash_fwd.cu``);
  - slice 2, the training path: GPT-2 trained with the DeAR schedule
    (`parallel.dear`, ``mode="dear"``; `benchmarks.gpt` is its CLI) over a
    `comm.backend` process group, with the flash-attention backward
    (``csrc/flash_bwd.cu``) and the per-bucket shard update
    (`ops.fused_sgd`, ``csrc/fused_update.cu``) as hand-written kernels;
  - slices 3 and 4: ``mode="dear-fused"`` with the ring kernels
    (``csrc/ring.cu`` over `comm.ring`) and ``--ring-projections`` with the
    ring collective matmul (``csrc/ring_matmul.cu``);
  - slice 5: the overhead probe (`scripts.overhead_probe`) with its
    elementwise kernel (`ops.overhead_probe`, ``csrc/overhead_probe.cu``);
  - slices 10–12: ResNet with BatchNorm state, BERT, ViT, the rest of the
    model zoo, BERT serving and the bench entry (`bench`);
  - slice 13: the baseline schedules (``mode="allreduce"``, ``"rsag"``,
    ``"rb"``, ``"bytescheduler"``, ``"fsdp"``), the ``exclude_parts``
    ablations of ``"dear"``, and the round-robin `Communicator`
    (`comm.communicator`, exported here as the JAX package exports its
    own);
  - slice 14: gradient compression (`ops.compression`), LAMB, remat;
  - slice 15: runtime tuning (`tuning`: BO, wait-time and plan-space
    tuners over live rebuilds with exact state repacking, MG-WFBP, ASC,
    MGS-SGD), the tracer, counters and cost model they read
    (`observability`, `utils.profiling`), and `TrainStep.multi_step` with
    the CLIs' ``--scan-steps``;
  - slice 16: the input pipeline (`runtime`: the C++ producers of
    ``csrc/dear_runtime.cpp``, built with g++ at first use, and the numpy
    pipeline) streamed through pinned memory by the CLIs' ``--pipeline``,
    `resilience.retry`, `utils.metrics`, the sweep driver, scaling and
    collective sweeps (`benchmarks`), the bench line's telemetry block, and
    the overlap audit with its report (`observability.overlap`,
    `observability.report`).
"""

from dear_pytorch_tpu_torch.comm.communicator import Communicator  # noqa: F401

__version__ = "0.1.0"
