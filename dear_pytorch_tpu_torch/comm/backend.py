"""Process group bootstrap — the port of ``dear_pytorch_tpu/comm/backend.py``.

One ``torch.distributed`` group per process: NCCL when the process runs on
a CUDA card of its own, gloo on the CPU. The launcher contract is the JAX
package's: ``DEAR_NUM_PROCESSES`` / ``DEAR_PROCESS_ID`` /
``DEAR_COORDINATOR_ADDRESS`` (or their ``JAX_*`` names; the first set one
wins, a non-integer raises naming the variable). The coordinator address is
``host:port`` (a TCP rendezvous), or a ``tcp://`` or ``file://`` URL. With
no launcher variables set, the group is a single rank that meets itself at
``tcp://127.0.0.1:<free port>``. A failed NCCL start raises; nothing falls
back to gloo.

Unlike the JAX package, one process drives one device here, so ``rank()``
and ``size()`` are both the process and the data-parallel world. Rank r of
a host takes card ``local_rank() % device_count``. When the launcher says
a host runs more ranks than it has cards (``local_size()``: the JAX
package's ``DEAR_LOCAL_SIZE`` and standard names, 1 when none is set; e.g.
two ranks on a one-card machine), ranks share a card, and NCCL refuses two
ranks on one device: the group is then gloo while the tensors stay on the
card (`card_shared()`). Handles, barriers and the loss mean go through the
host (`comm.collectives` stages CUDA tensors through host copies on such a
group, and only there), and the data legs of ``mode="dear-fused"`` are the
ring kernels alone (`comm.ring`), which need no collective library. At one
card per rank, NCCL stays.
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Optional

import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch._device import resolve_device

__all__ = [
    "barriar", "barrier", "card_shared", "device", "group", "init",
    "is_initialized", "launched_size", "local_rank", "local_size", "rank",
    "shutdown", "size",
]

_lock = threading.Lock()
_device: Optional[torch.device] = None


def _env_int(*names: str) -> Optional[int]:
    """The first set variable among ``names`` as an int."""
    for k in names:
        v = os.environ.get(k, "").strip()
        if v:
            try:
                return int(v)
            except ValueError:
                raise ValueError(
                    f"{k}={v!r} is not an integer (launcher contract: "
                    "see launch/README.md)") from None
    return None


def launched_size() -> int:
    """The world the launcher variables name (``DEAR_NUM_PROCESSES`` or
    ``JAX_NUM_PROCESSES``); 1 when none is set."""
    return _env_int("DEAR_NUM_PROCESSES", "JAX_NUM_PROCESSES") or 1


def _coordinator() -> Optional[str]:
    for k in ("DEAR_COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"):
        v = os.environ.get(k, "").strip()
        if v:
            return v if "://" in v else f"tcp://{v}"
    return None


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(device=None) -> dist.ProcessGroup:
    """Join (or form) the process group and return it; idempotent.

    ``device``: where this process's tensors live — the card by default
    (raises without one; ``"cuda"`` or None take this rank's card,
    ``local_rank() % device_count``), ``"cpu"`` for a gloo group. With the
    launcher variables set, the world is ``DEAR_NUM_PROCESSES`` ranks
    meeting at ``DEAR_COORDINATOR_ADDRESS``; otherwise a single rank."""
    global _device
    with _lock:
        dev = resolve_device(device)
        if dist.is_initialized():
            if _device is not None and dev.type != _device.type:
                raise ValueError(f"the process group runs on {_device}, "
                                 f"not {dev}")
            return dist.group.WORLD
        world = launched_size()
        rank_ = _env_int("DEAR_PROCESS_ID", "JAX_PROCESS_ID")
        if world > 1:
            addr = _coordinator()
            if rank_ is None or addr is None:
                raise RuntimeError(
                    f"a {world}-process launch needs DEAR_PROCESS_ID and "
                    "DEAR_COORDINATOR_ADDRESS (or the JAX_* names)")
        else:
            rank_, addr = 0, f"tcp://127.0.0.1:{_free_port()}"
        if dev.type == "cuda":
            if device is None or torch.device(device).index is None:
                dev = torch.device(
                    "cuda", local_rank() % torch.cuda.device_count())
            torch.cuda.set_device(dev)
            backend = "gloo" if _shares_card(world) else "nccl"
        elif dev.type == "cpu":
            backend = "gloo"
        else:
            raise RuntimeError(f"no process-group backend for {dev}")
        dist.init_process_group(backend, init_method=addr, rank=rank_,
                                world_size=world)
        _device = dev
        return dist.group.WORLD


def is_initialized() -> bool:
    return dist.is_initialized()


def shutdown() -> None:
    """Tear the group down; safe to call more than once."""
    global _device
    with _lock:
        if dist.is_initialized():
            dist.destroy_process_group()
        _device = None


def group() -> dist.ProcessGroup:
    """The group (formed on the card if there is none yet)."""
    return dist.group.WORLD if dist.is_initialized() else init()


def device() -> torch.device:
    """The device this process's group runs on."""
    group()
    return _device


def rank() -> int:
    """This process's rank (0 before any group exists)."""
    return dist.get_rank() if dist.is_initialized() else 0


def size() -> int:
    """The number of processes (1 before any group exists)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index on its host, from the launcher's variables."""
    for k in ("DEAR_LOCAL_RANK", "LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK",
              "SLURM_LOCALID"):
        v = os.environ.get(k)
        if v is not None:
            return int(v)
    return 0


def local_size() -> int:
    """The number of processes on this host, from the launcher's variables
    (the JAX package's names); 1 when none is set."""
    for k in ("DEAR_LOCAL_SIZE", "LOCAL_WORLD_SIZE",
              "OMPI_COMM_WORLD_LOCAL_SIZE", "SLURM_NTASKS_PER_NODE"):
        v = os.environ.get(k)
        if v is not None:
            return int(v)
    return 1


def _shares_card(world: int) -> bool:
    return world > 1 and local_size() > torch.cuda.device_count()


def card_shared() -> bool:
    """Whether this host's ranks share its cards (the group is then gloo
    over tensors on the card)."""
    dev = device()
    return dev.type == "cuda" and _shares_card(size())


def barrier() -> None:
    """Block until every process reaches this point."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


#: the reference's spelling (comm_core.cpp:15 exports ``barriar``)
barriar = barrier
