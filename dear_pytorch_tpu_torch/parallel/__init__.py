"""Parallel training schedules: the DeAR schedule (`parallel.dear`) and
sequence parallelism (`parallel.sp`: ring, ring-flash, zigzag and Ulysses
attention over an sp group, `parallel.ring_attention`). The function
``ring_attention`` is not re-exported here: its name is the submodule's
(``from dear_pytorch_tpu_torch.parallel import ring_attention`` is the
module)."""

from dear_pytorch_tpu_torch.parallel.dear import (  # noqa: F401
    DearState,
    TrainStep,
    build_train_step,
)
from dear_pytorch_tpu_torch.parallel.ring_attention import (  # noqa: F401
    full_attention,
    make_ring_attention_impl,
    make_ring_flash_attention_impl,
    make_ulysses_attention_impl,
    ring_flash_attention,
    ulysses_attention,
    zigzag_permutation,
    zigzag_positions,
    zigzag_ring_flash_attention,
)
from dear_pytorch_tpu_torch.parallel.sp import (  # noqa: F401
    make_sp_bert_loss_fn,
    make_sp_gpt_loss_fn,
    shard_sp_batch,
    sp_bert_model,
    sp_gpt_model,
)
