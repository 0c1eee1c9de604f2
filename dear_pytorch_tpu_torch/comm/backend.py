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

`init` builds the c10d store the ranks rendezvous at explicitly (a
``FileStore`` for a ``file://`` address, else a ``TCPStore``) and keeps it
(`store()`): the cluster layer's store transport
(`resilience.cluster.StoreTransport`) exchanges its health views through
it. At world > 1 it also forms a second gloo group over the same ranks,
`host_group()`, for the host-level collectives
(`comm.collectives.allreduce`, `host_allgather`) and the checkpoint
commit's barrier: the cluster layer runs them from a side thread with a
deadline, where a collective on the training step's group would
interleave with the step's own and could hang it. `shutdown` releases
both.

Elastic membership (`regroup`): the JAX package rebuilds a mesh inside one
process when the membership changes; here every rank is a process, a dead
rank breaks the group, and a ``TCPStore`` hosted by rank 0 dies with rank
0. So each committed membership epoch gets groups of its own: `regroup`
releases the previous epoch's groups without a collective on them (an
abort, then the destroy) and re-initialises the default group, and at
world > 1 the host group, over the view's members — the rank is the
member's index in ``view.members`` — at a ``PrefixStore`` scoped to the
epoch over a store that outlives every rank (a ``FileStore`` under
``DEAR_ELASTIC_DIR``, the supervisor's contract). The rendezvous may take
as long as a rejoin, but each collective of an epoch's groups is bounded
by a quarter of the membership's peer timeout
(``DEAR_CLUSTER_TIMEOUT_SECS``): a collective stuck on a dead (or on a
failed) peer ends as a step error well before the peers' health sync gives
up on this rank.
"""

from __future__ import annotations

import atexit
import datetime
import os
import socket
import threading
from typing import Optional
from urllib.parse import urlparse

import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch._device import resolve_device

__all__ = [
    "barriar", "barrier", "card_shared", "data_plane_timeout", "device",
    "elastic_store", "epoch", "group", "host_group", "init",
    "is_initialized", "launched_size", "local_rank", "local_size", "rank",
    "regroup", "shutdown", "size", "store",
]

_lock = threading.Lock()
_device: Optional[torch.device] = None
_store = None
_host_group = None
#: the TCP store's rendezvous deadline (torch's default for a tcp://
#: init_method)
_TIMEOUT = datetime.timedelta(minutes=30)
#: the membership epoch of the current groups (None: `init`'s fixed world)
_epoch: Optional[int] = None
#: the store that outlives every rank (`elastic_store`), once opened
_elastic_store = None


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


@atexit.register
def _release() -> None:
    """Drop this module's references to the host group and the store
    before the interpreter finalizes: a gloo group still referenced from a
    module then is torn down during finalization, which now and then
    aborts the process after its work is done (tests/
    test_torch_spawn_teardown.py)."""
    global _store, _host_group, _elastic_store
    _store = _host_group = _elastic_store = None


def _make_store(addr: str, rank_: int, world: int):
    """The c10d store at ``addr``: a ``FileStore`` for ``file://<path>``,
    else a ``TCPStore`` that rank 0 hosts at ``tcp://host:port``."""
    url = urlparse(addr)
    if url.scheme == "file":
        return dist.FileStore(url.path, world)
    if url.scheme != "tcp" or not url.hostname or not url.port:
        raise ValueError(f"coordinator address {addr!r}: expected host:port, "
                         "tcp://host:port or file://path")
    return dist.TCPStore(url.hostname, url.port, world, rank_ == 0,
                         timeout=_TIMEOUT)


def init(device=None) -> dist.ProcessGroup:
    """Join (or form) the process group and return it; idempotent.

    ``device``: where this process's tensors live — the card by default
    (raises without one; ``"cuda"`` or None take this rank's card,
    ``local_rank() % device_count``), ``"cpu"`` for a gloo group. With the
    launcher variables set, the world is ``DEAR_NUM_PROCESSES`` ranks
    meeting at ``DEAR_COORDINATOR_ADDRESS``; otherwise a single rank."""
    global _device, _store, _host_group
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
        _store = _make_store(addr, rank_, world)
        dist.init_process_group(backend, store=_store, rank=rank_,
                                world_size=world)
        _host_group = (dist.new_group(backend="gloo") if world > 1
                       else None)
        _device = dev
        return dist.group.WORLD


def is_initialized() -> bool:
    return dist.is_initialized()


def shutdown() -> None:
    """Tear the group down (and the host group, and release the store);
    safe to call more than once."""
    global _device, _store, _host_group, _epoch
    with _lock:
        if dist.is_initialized():
            dist.destroy_process_group()
        _device = _store = _host_group = _epoch = None


# ---------------------------------------------------------------------------
# elastic membership: one group per membership epoch
# ---------------------------------------------------------------------------

#: the supervisor's contract: the directory of the store that outlives
#: every rank (`resilience.membership.ELASTIC_DIR_ENV`)
_ELASTIC_DIR_ENV = "DEAR_ELASTIC_DIR"
#: the membership's peer timeout (`resilience.cluster.TIMEOUT_ENV`, its
#: default `resilience.cluster.DEFAULT_TIMEOUT_S`)
_PEER_TIMEOUT_ENV = "DEAR_CLUSTER_TIMEOUT_SECS"
_PEER_TIMEOUT_S = 120.0


def _peer_timeout_s() -> float:
    return float(os.environ.get(_PEER_TIMEOUT_ENV, "").strip()
                 or _PEER_TIMEOUT_S)


def data_plane_timeout() -> datetime.timedelta:
    """The bound on each collective of an epoch's groups: a quarter of the
    membership's peer timeout, within [1 s, 30 min]. A rank blocked on a
    peer that failed (and moved on to the health sync) times out and
    reaches the sync itself well inside the peers' deadline."""
    secs = min(max(_peer_timeout_s() / 4.0, 1.0), _TIMEOUT.total_seconds())
    return datetime.timedelta(seconds=secs)


def _rendezvous_timeout() -> datetime.timedelta:
    """How long an epoch's rendezvous may take: every member arrives once
    its transition is done, a rejoiner after its admission (the JAX
    package's rejoin window, ten peer timeouts and at least a minute)."""
    return datetime.timedelta(seconds=max(10.0 * _peer_timeout_s(), 60.0))


def elastic_store(root: Optional[str] = None):
    """The store every epoch's groups rendezvous at: a ``FileStore`` in
    ``root`` (default: ``DEAR_ELASTIC_DIR``), which outlives every rank.
    Opened once per process."""
    global _elastic_store
    if _elastic_store is None:
        root = root or os.environ.get(_ELASTIC_DIR_ENV, "").strip()
        if not root:
            raise RuntimeError(
                f"regroup needs a store that outlives every rank: set "
                f"{_ELASTIC_DIR_ENV} (the supervisor does) or pass store=")
        os.makedirs(root, exist_ok=True)
        _elastic_store = dist.FileStore(os.path.join(root, "c10d_store"),
                                        -1)
    return _elastic_store


def _release_groups() -> None:
    """Release the current groups without a collective on them: abort
    each (under NCCL a dead peer would otherwise hang the communicator
    until its timeout; under gloo it fails the queued work), then destroy
    them. No barrier, no flush."""
    global _host_group, _store
    if dist.is_initialized():
        for pg in (_host_group, dist.group.WORLD):
            if pg is None:
                continue
            try:
                pg.abort()
            except Exception:   # a group its own error already tore down
                pass
        dist.destroy_process_group()
    _host_group = _store = None


def regroup(view, device=None, *, store=None) -> Optional[dist.ProcessGroup]:
    """Form the groups of a committed membership view (a
    `resilience.membership.MembershipView`: ``epoch``, ``members``,
    ``rank``, ``world``) and return the data-plane group; idempotent per
    epoch. The previous epoch's groups are released first, without a
    collective on them. The rank is ``view.members.index(view.rank)``; the
    groups rendezvous on a ``PrefixStore`` scoped to ``view.epoch`` over
    ``store`` (default `elastic_store`); gloo where the ranks share a
    card (`init`'s rule), NCCL otherwise, gloo on the CPU. A rank that is
    not in ``view.members`` (it is leaving) only releases its groups and
    gets None. Every member calls it, a rejoiner at its admitted epoch
    included. Afterwards `group`, `host_group`, `store`, `rank`, `size`
    and `epoch` report the new epoch's."""
    global _device, _store, _host_group, _epoch
    with _lock:
        if (_epoch is not None and int(view.epoch) == _epoch
                and dist.is_initialized()):
            return dist.group.WORLD
        if _device is not None and device is None:
            dev = _device
        else:
            dev = resolve_device(device)
        base = store if store is not None else elastic_store()
        _release_groups()
        _epoch = None
        members = tuple(int(m) for m in view.members)
        if int(view.rank) not in members:
            _device = dev
            return None
        rank_, world = members.index(int(view.rank)), len(members)
        if dev.type == "cuda":
            if device is None or torch.device(device).index is None:
                slot = (local_rank() if _env_int("DEAR_LOCAL_RANK",
                                                 "LOCAL_RANK") is not None
                        else int(view.rank))
                dev = torch.device("cuda", slot % torch.cuda.device_count())
            torch.cuda.set_device(dev)
            backend = "gloo" if _shares_card(world) else "nccl"
        elif dev.type == "cpu":
            backend = "gloo"
        else:
            raise RuntimeError(f"no process-group backend for {dev}")
        st = dist.PrefixStore(f"dear_epoch/{int(view.epoch)}/", base)
        dist.init_process_group(backend, store=st, rank=rank_,
                                world_size=world,
                                timeout=_rendezvous_timeout())
        _host_group = (dist.new_group(backend="gloo",
                                      timeout=_rendezvous_timeout())
                       if world > 1 else None)
        for pg in (dist.group.WORLD, _host_group):
            if pg is not None:
                pg.set_timeout(data_plane_timeout())
        _store, _device, _epoch = st, dev, int(view.epoch)
        return dist.group.WORLD


def epoch() -> Optional[int]:
    """The membership epoch of the current groups (None when they are
    `init`'s fixed world)."""
    return _epoch


def group() -> dist.ProcessGroup:
    """The group (formed on the card if there is none yet)."""
    return dist.group.WORLD if dist.is_initialized() else init()


def store():
    """The c10d store the ranks rendezvoused at (forms the group first if
    there is none yet)."""
    group()
    return _store


def host_group() -> Optional[dist.ProcessGroup]:
    """The gloo group of the host-level collectives (module docstring);
    None at world 1, where they are the identity."""
    group()
    return _host_group


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
