"""Native host runtime — the port of ``dear_pytorch_tpu/runtime``: the C++
ring-buffer batch producers (``csrc/dear_runtime.cpp``, built by `build`)
behind `pipeline.Pipeline`, the pure-numpy `pipeline.NumpyPipeline`, and
the batch specs of the benchmark CLIs."""

from dear_pytorch_tpu_torch.runtime.pipeline import (  # noqa: F401
    NumpyPipeline,
    Pipeline,
    SyntheticSpec,
    bert_spec,
    gpt_spec,
    image_spec,
    mnist_spec,
    native_available,
    now_ns,
)
