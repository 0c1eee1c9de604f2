"""The port's Inception-v4 (dear_pytorch_tpu_torch.models.inception)
against the JAX package's flax model on the CPU: train mode in fp64 on
both sides at 107 px (the fp32 train-mode forward is ill-conditioned at
this size in both packages), eval mode in fp32 and bf16 at 75 px, the
smallest input its VALID reductions allow. The setup, the weights and the
tolerances are tests/test_torch_zoo.py's (`check_forward`); a file of its
own, so that a parallel run spreads the zoo's heaviest compiles over its
workers. The SAME average pool's border is held in
tests/test_torch_zoo.py.
"""

import pytest

from tests.test_torch_zoo import INCEPTION_CASES, case_ids, check_forward
from tests.test_torch_zoo import few_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("name,train,dtype", INCEPTION_CASES,
                         ids=case_ids(INCEPTION_CASES))
def test_forward_matches_flax(name, train, dtype):
    """Logits and (train mode) the running statistics against flax."""
    check_forward(name, train, dtype)
