"""Runtime auto-tuning of the communication plan — the port of
``dear_pytorch_tpu/tuning``:

  - Bayesian optimization over the fusion threshold (`bo.Tuner`;
    reference dear/tuner.py + dopt_rsag_bo.py);
  - the wait-time heuristic deriving bucket-split flags from layer timing
    (`wait_time`; reference dear/dopt_rsag_wt.py);
  - the plan-space search (`planspace.PlanTuner`): fusion threshold x
    compressor x comm/gather wire dtype x mode (dear / dear-fused) x remat
    in one mixed bandit/BO search, pruned by the α-β cost model;
  - the analytic bucketizers MG-WFBP (`mgwfbp`), ASC and MGS-SGD
    (`sparse_groups`).

`autotune.AutoTuner` drives the first three against a live training loop,
rebuilding the train step (and repacking its state exactly) when a new
plan is adopted.
"""

from dear_pytorch_tpu_torch.tuning.autotune import (  # noqa: F401
    AutoTuner,
    repack_state,
)
from dear_pytorch_tpu_torch.tuning.bo import (  # noqa: F401
    BayesianOptimizer,
    Tuner,
)
from dear_pytorch_tpu_torch.tuning.mgwfbp import (  # noqa: F401
    mgwfbp_layer_groups,
    plan_mgwfbp,
)
from dear_pytorch_tpu_torch.tuning.planspace import (  # noqa: F401
    Axis,
    PlanConfig,
    PlanSpace,
    PlanTuner,
)
from dear_pytorch_tpu_torch.tuning.sparse_groups import (  # noqa: F401
    asc_layer_groups,
    mgs_layer_groups,
    plan_asc,
    plan_mgs,
)
from dear_pytorch_tpu_torch.tuning.wait_time import (  # noqa: F401
    estimate_layer_backward_times,
    wait_time_flags,
)
