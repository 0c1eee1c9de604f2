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
    (`ops.fused_sgd`, ``csrc/fused_update.cu``) as hand-written kernels.
"""

__version__ = "0.1.0"
