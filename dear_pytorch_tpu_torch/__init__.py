"""dear_pytorch_tpu_torch — the PyTorch and CUDA port of dear_pytorch_tpu.

A second package beside the JAX one, which stays the reference it is held
against. It imports torch and numpy, never jax, flax or optax, and nothing
of ``dear_pytorch_tpu``. Its entry points run on the CUDA card unless the
caller passes ``device="cpu"``.

Ported so far (slice 1, the serving path): GPT-2 served through
`serving.engine.DecodeEngine` over the ring KV cache, with the decode
attention in a hand-written Hopper flash-attention forward kernel
(`ops.flash_attention`, ``csrc/flash_fwd.cu``).
"""

__version__ = "0.1.0"
