"""Horovod-style start-state helpers — the port of ``dear_pytorch_tpu/api.py``.

Every process builds its own copy of the model (and optimizer state); these
broadcast rank 0's tensors over the process group so that all ranks start
from the same values, the reference's "rank 0 decides the initial state"
contract. At world 1 they are the identity.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import collectives as C

__all__ = ["broadcast_optimizer_state", "broadcast_parameters", "world_info"]


def _tensors(obj):
    """Every tensor in a module, tensor, mapping, sequence or NamedTuple."""
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def broadcast_parameters(params: Any, root_rank: int = 0,
                         group=None) -> Any:
    """Overwrite every tensor in ``params`` (in place) with ``root_rank``'s
    values and return ``params``. Identity at world 1."""
    if root_rank != 0:
        raise NotImplementedError(
            "broadcast root other than rank 0 is not supported")
    g = backend.group() if group is None else group
    if dist.get_world_size(g) == 1:
        return params
    with torch.no_grad():
        for t in _tensors(params):
            C.broadcast(t, root_rank, g)
    return params


def broadcast_optimizer_state(state: Any, root_rank: int = 0,
                              group=None) -> Any:
    """Broadcast a `DearState` or any nest of optimizer tensors from rank
    0 (host-side values such as step counts are the same on every rank by
    construction)."""
    return broadcast_parameters(state, root_rank, group)


def world_info() -> dict:
    """A snapshot for launchers and logs."""
    return {"process_index": backend.rank(), "process_count": backend.size(),
            "local_rank": backend.local_rank()}
