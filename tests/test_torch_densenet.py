"""The port's DenseNets (dear_pytorch_tpu_torch.models.densenet) against
the JAX package's flax DenseNets on the CPU: DenseNet-121 and -201 at full
width on 64 px images, in train mode (fp32, the updated BN statistics too)
and eval mode (fp32 and bf16), and a DenseNet cut to two blocks of three
layers in bf16 train mode. The setup, the weights and the tolerances are
tests/test_torch_zoo.py's (`check_forward`); a file of its own, so that a
parallel run spreads the zoo's heaviest compiles over its workers.
"""

import pytest

from tests.test_torch_zoo import DENSENET_CASES, case_ids, check_forward
from tests.test_torch_zoo import few_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("name,train,dtype", DENSENET_CASES,
                         ids=case_ids(DENSENET_CASES))
def test_forward_matches_flax(name, train, dtype):
    """Logits and (train mode) the running statistics against flax."""
    check_forward(name, train, dtype)
