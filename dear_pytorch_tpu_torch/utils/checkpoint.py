"""Checkpoint / resume for `DearState` — the port of
``dear_pytorch_tpu/utils/checkpoint.py``.

Every save uses the JAX package's local format (`local_save`,
`local_restore`): one raw-bytes blob plus a JSON index of
``(dtype, shape, offset, nbytes)`` per leaf, committed by the atomic
rename of a temporary directory; a stale step directory is renamed aside,
never deleted first. The index's dtype names are the JAX package's
(``float32``, ``bfloat16``, ``int64``, ...), so a blob either package
writes loads in the other. The port's index entries also carry each
leaf's ``name`` (JAX's reader ignores the extra key).

What a step holds, per rank (`save_checkpoint`): the rank's fp32 master
shards (``shards.<g>``; the whole padded buckets in the replicated
modes, and on per-host storage at world > 1, below), the per-element
optimizer state and its host scalars
(``opt.<g>.<key>``: SGD's ``initialized``, AdamW's and LAMB's ``t`` as
0-dim tensors), the compressor state (``comp.<g>`` or
``comp.<g>.<key>``), the model state — the buffers that
``model_state_template`` named (``buffers.<name>``; JAX carries them in
``DearState.model_state``, the port keeps them in the model) — and the
``step``. A sidecar ``meta_<step>.json`` holds the plan fingerprint and
``plan_desc``, the input pipeline's ``state_dict``, ``mem_epoch`` and the
sha256 checksum manifest over the step directory; its I/O goes through
`resilience.retry`.

Storage models (JAX :28-39):

  - **shared** (the default): the step directory holds one blob per rank
    (``rank_<r>/`` at world > 1; the blob itself at world 1). Every rank
    writes its own into the step's temporary directory; after a barrier
    on the host group (`comm.backend.host_group`) rank 0 commits the
    rename and writes the sidecar and the manifest.
  - **per-host** (``DEAR_CKPT_SHARED=0``): every rank owns its directory
    outright — it writes its blob, sidecar, manifest and retention — and
    saves are synchronous. As in the JAX package (:293-303: "this process
    owns the whole directory, so it writes the whole state"), every rank's
    blob holds the WHOLE state at world > 1: the sharded masters and
    per-element optimizer state are gathered over the current epoch's
    group into whole padded buckets before the write (the compressor
    state stays this rank's). A lost host's shard then survives on every
    other host, and `elastic_restore` reads a per-host step from the
    rank's own directory alone, at any world. Per-host views can diverge
    (one host's disk corrupts a step the others kept), which the cluster
    layer's consensus restore reconciles.

Restores go into the live `parallel.dear.TrainStep`, in place
(`restore_checkpoint` -> `TrainStep.load_state`): the step's tensors are
updated in place by every step, and in the replicated modes the masters
ARE the model's buffers. `elastic_restore` re-packs a step saved under
another plan (another threshold, another world, another membership
epoch) by parameter name.

Asynchronous saves (``asynchronous=True``) snapshot the device tensors
into pinned host buffers on a side stream, behind an event recorded after
the step's update, and return; a writer thread writes them to disk. The
next step's in-place update waits for the snapshot's event
(`TrainStep.hold_for_snapshot`) before it overwrites the masters. The
sidecar is written eagerly with no manifest; `write_manifest` backfills it
once `wait_for_checkpoints` returns (`GuardedTrainer.finalize` does). At
world > 1 on shared storage the commit (barrier and rename) happens at the
next `wait_for_checkpoints`, on the main thread of every rank.

The object-store tier (JAX :880-1225): `CheckpointStreamer` uploads
committed step dirs to a `utils.objectstore` store on a daemon thread
(files, sidecar, then the manifest, the commit marker, under
`resilience.retry`; an exhausted retry falls back to local-only retention
for that step), `remote_steps` lists the committed uploads and
`restore_from_object_store` materializes one locally, every file
re-hashed against the remote manifest.

The hierarchical schedule's exchanger state (``save_checkpoint(
dcn_state=)``, `read_dcn_state`; JAX checkpoint.py:269-322, :409-418)
rides the sidecar under ``"dcn"``, in the JAX package's JSON (a
`comm.dcn.DcnExchanger` ``state_dict()``), so each package reads the
other's.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import queue
import shutil
import threading
from typing import Optional

import torch
import torch.distributed as dist

from dear_pytorch_tpu_torch.ops import fusion as F
from dear_pytorch_tpu_torch.parallel import dear as D
from dear_pytorch_tpu_torch.resilience.retry import RetryError, retry_call

logger = logging.getLogger("dear_pytorch_tpu_torch")

__all__ = [
    "PlanMismatchError", "SHARED_ENV", "CheckpointStreamer",
    "elastic_restore", "has_async_checkpointer", "is_local_checkpoint",
    "latest_step", "latest_valid_step", "local_restore", "local_save",
    "per_host_storage", "plan_desc", "plan_fingerprint", "plan_from_desc",
    "prune_checkpoints", "prune_future_steps", "prune_orphaned_tmp",
    "read_dcn_state", "read_mem_epoch", "read_pipeline_state",
    "read_sidecar", "remote_steps", "restore_checkpoint",
    "restore_from_object_store", "save_checkpoint", "valid_steps",
    "verify_checkpoint", "wait_for_checkpoints", "write_manifest",
]

class PlanMismatchError(ValueError):
    """The checkpoint was packed under a different fusion plan than the
    live train step's (another threshold, world size, or membership
    epoch). `GuardedTrainer._restore_step` catches exactly this type to
    route into the `elastic_restore` re-pack path."""


def _dtype_name(dtype) -> str:
    """The JAX package's name of a dtype (``float32``, ``bfloat16``)."""
    return str(dtype).replace("torch.", "")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint leaf dtype {name!r} has no torch "
                         "counterpart")
    return dt


def plan_fingerprint(plan: F.FusionPlan) -> str:
    """Stable hash of everything that determines buffer layout — the JAX
    package's (checkpoint.py:67), over the port's plan: the same leaf list
    (names, shapes, dtype names) and buckets give the same string."""
    desc = {
        "world": plan.world,
        "leaves": [(s.name, list(s.shape), _dtype_name(s.dtype))
                   for s in plan.leaves],
        "buckets": [
            [list(b.leaf_ids), b.padded_size] for b in plan.buckets
        ],
    }
    epoch = int(getattr(plan, "epoch", 0) or 0)
    if epoch:
        desc["epoch"] = epoch
    return hashlib.sha256(
        json.dumps(desc, sort_keys=True).encode()
    ).hexdigest()[:16]


def plan_desc(plan: F.FusionPlan) -> dict:
    """JSON-serializable description from which the plan's buffer layout
    can be REBUILT — the sidecar payload that makes `elastic_restore`
    possible on another plan."""
    return {
        "world": plan.world,
        "epoch": int(getattr(plan, "epoch", 0) or 0),
        "leaves": [
            {"name": s.name, "layer": s.layer, "shape": list(s.shape),
             "dtype": _dtype_name(s.dtype)}
            for s in plan.leaves
        ],
        "groups": [list(b.leaf_ids) for b in plan.buckets],
    }


def plan_from_desc(desc: dict) -> F.FusionPlan:
    """Rebuild a `FusionPlan` from `plan_desc` output (the port's plans
    need no pytree structure: the leaf order is the description's)."""
    specs = tuple(
        F.LeafSpec(name=d["name"], layer=d["layer"], shape=tuple(d["shape"]),
                   dtype=_torch_dtype(d["dtype"]),
                   size=int(max(1, _prod(d["shape"]))))
        for d in desc["leaves"]
    )
    plan = F._build_plan(specs, [list(g) for g in desc["groups"]],
                         desc["world"])
    epoch = int(desc.get("epoch", 0) or 0)
    if epoch:
        import dataclasses as _dc

        plan = _dc.replace(plan, epoch=epoch)
    return plan


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def _ckpt_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def _meta_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"meta_{step:010d}.json")


# ---------------------------------------------------------------------------
# the local format
# ---------------------------------------------------------------------------

SHARED_ENV = "DEAR_CKPT_SHARED"

#: Filenames of the local checkpoint format (the JAX package's).
_LOCAL_INDEX = "dear_local.json"
_LOCAL_BLOB = "dear_local.bin"
_LOCAL_TMP_MARK = ".local-tmp"


def per_host_storage() -> bool:
    """True when ``DEAR_CKPT_SHARED=0`` declares per-host checkpoint
    directories: every process owns its directory outright."""
    return os.environ.get(SHARED_ENV, "").strip().lower() in (
        "0", "false", "no")


def _rank() -> int:
    from dear_pytorch_tpu_torch.comm import backend

    return backend.rank()


def _world() -> int:
    from dear_pytorch_tpu_torch.comm import backend

    return backend.size()


def _owns_directory_io() -> bool:
    """Which process performs sidecar/retention I/O in a checkpoint
    directory: rank 0 on shared storage, every rank on per-host storage."""
    return _rank() == 0 or per_host_storage()


def _flatten(state) -> list:
    """``[(name or None, leaf)]``: a mapping's items in order, or a
    sequence's leaves."""
    if isinstance(state, dict):
        return list(state.items())
    if torch.is_tensor(state):
        return [(None, state)]
    return [(None, x) for x in state]


def _as_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.detach()
    if isinstance(x, bool):
        return torch.tensor(x, dtype=torch.bool)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int64)
    if isinstance(x, float):
        return torch.tensor(x, dtype=torch.float32)
    import numpy as np

    arr = np.ascontiguousarray(np.asarray(x))
    return torch.from_numpy(arr.copy())


def _raw(t: torch.Tensor) -> memoryview:
    """A CPU tensor's bytes, whatever its dtype (bf16 included)."""
    flat = t.contiguous().reshape(-1)
    if flat.numel() == 0:
        return memoryview(b"")
    return memoryview(flat.view(torch.uint8).numpy())


def _write_local(tmp: str, items) -> None:
    """The blob and its index into directory ``tmp`` (``items``:
    ``[(name or None, CPU tensor)]``)."""
    os.makedirs(tmp, exist_ok=True)
    index, off = [], 0
    with open(os.path.join(tmp, _LOCAL_BLOB), "wb") as f:
        for name, t in items:
            raw = _raw(t)
            ent = {"dtype": _dtype_name(t.dtype), "shape": list(t.shape),
                   "offset": off, "nbytes": raw.nbytes}
            if name is not None:
                ent["name"] = name
            index.append(ent)
            f.write(raw)
            off += raw.nbytes
    with open(os.path.join(tmp, _LOCAL_INDEX), "w") as f:
        json.dump({"leaves": index}, f)


def _commit(tmp: str, step_dir: str) -> None:
    """The atomic commit: rename ``tmp`` to ``step_dir``; a stale step
    directory (from before a rollback) is renamed aside first, then
    removed, so the only committed copy of the step is never deleted
    before its replacement appears (JAX :201-213)."""
    if os.path.isdir(step_dir):
        aside = step_dir + _LOCAL_TMP_MARK + "-old"
        if os.path.isdir(aside):
            shutil.rmtree(aside)
        os.rename(step_dir, aside)
        os.rename(tmp, step_dir)
        shutil.rmtree(aside, ignore_errors=True)
    else:
        os.rename(tmp, step_dir)


def local_save(step_dir: str, state) -> None:
    """Write ``state`` — a sequence of tensors, numpy arrays or Python
    scalars, or a mapping of them by name — in the local format: one
    raw-bytes blob plus a JSON index of (dtype, shape, offset, nbytes) per
    leaf, committed by atomic directory rename (JAX :168). Overwrites an
    existing step directory (a replay after a rollback re-reaches it)."""
    items = [(n, _as_tensor(x).cpu()) for n, x in _flatten(state)]
    tmp = step_dir + _LOCAL_TMP_MARK
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)   # crash leftover from an interrupted save
    _write_local(tmp, items)
    _commit(tmp, step_dir)


def is_local_checkpoint(step_dir: str) -> bool:
    return os.path.exists(os.path.join(step_dir, _LOCAL_INDEX))


def _read_local(step_dir: str) -> list:
    """``[(index entry, CPU tensor)]`` of a local-format directory."""
    with open(os.path.join(step_dir, _LOCAL_INDEX)) as f:
        index = json.load(f)["leaves"]
    with open(os.path.join(step_dir, _LOCAL_BLOB), "rb") as f:
        blob = bytearray(f.read())
    out = []
    for ent in index:
        dt = _torch_dtype(ent["dtype"])
        n = _prod(ent["shape"]) if ent["shape"] else 1
        if n == 0:
            t = torch.zeros(ent["shape"], dtype=dt)
        else:
            t = torch.frombuffer(blob, dtype=dt, count=n,
                                 offset=ent["offset"]).reshape(ent["shape"])
        out.append((ent, t.clone()))
    return out


def local_restore(step_dir: str, template):
    """Restore a `local_save` directory (either package's) into the
    structure and devices of ``template`` (a sequence of tensors, or a
    mapping by name in the saved order): a list, or a dict of the
    template's keys, of tensors on each template leaf's device."""
    leaves = _read_local(step_dir)
    t_leaves = _flatten(template)
    if len(t_leaves) != len(leaves):
        raise ValueError(
            f"local checkpoint under {step_dir} has {len(leaves)} leaves "
            f"but the template has {len(t_leaves)} — restoring into a "
            "different model/optimizer structure")
    out = [x.to(t.device) if torch.is_tensor(t) else x
           for (_, t), (_, x) in zip(t_leaves, leaves)]
    if isinstance(template, dict):
        return dict(zip(template, out))
    return out


# ---------------------------------------------------------------------------
# what a rank's blob holds
# ---------------------------------------------------------------------------


def _state_items(state: D.DearState, ts: D.TrainStep) -> list:
    """``[(name, tensor or host scalar)]`` of this rank's part of a step
    (module docstring), in a fixed order."""
    items = []
    for g, s in enumerate(state.shards):
        items.append((f"shards.{g}", s))
    for g, o in enumerate(state.opt_state):
        for k, v in o.items():
            items.append((f"opt.{g}.{k}", v))
    for g, c in enumerate(state.comp_state):
        if torch.is_tensor(c):
            items.append((f"comp.{g}", c))
        elif isinstance(c, dict):
            for k, v in c.items():
                items.append((f"comp.{g}.{k}", v))
    live = dict(ts.model.named_buffers())
    for n in ts.model_state_names:
        items.append((f"buffers.{n}", live[n]))
    items.append(("step", int(state.step)))
    return items


def _whole_state_items(state: D.DearState, ts: D.TrainStep) -> list:
    """`_state_items` with every sharded master and per-element optimizer
    tensor gathered over ``ts``'s group into its whole padded bucket —
    what a per-host blob holds at world > 1. Every rank calls it, in the
    same order."""
    from dear_pytorch_tpu_torch.comm import collectives as C

    items = _state_items(state, ts)
    if not ts.sharded or ts.world == 1:
        return items
    ts._wait_model_state()
    out = []
    for name, x in items:
        if (torch.is_tensor(x) and x.dim() > 0
                and (name.startswith("shards.")
                     or name.startswith("opt."))):
            x = C.all_gather(x.detach(), ts.group)
        out.append((name, x))
    return out


def _rank_dir(step_dir: str, rank: int) -> str:
    """Where rank ``rank``'s blob lives in a committed (or temporary) step
    directory: ``rank_<r>/`` when the directory holds several ranks'
    blobs, else the directory itself."""
    sub = os.path.join(step_dir, f"rank_{rank:05d}")
    return sub if os.path.isdir(sub) else step_dir


def _layout_dir(step_dir: str, rank: int, world: int) -> str:
    """Where a save puts rank ``rank``'s blob."""
    if world > 1 and not per_host_storage():
        return os.path.join(step_dir, f"rank_{rank:05d}")
    return step_dir


def _host_barrier() -> None:
    from dear_pytorch_tpu_torch.comm import backend

    if backend.size() > 1:
        dist.barrier(group=backend.host_group())


def _snapshot(items, pool: Optional[dict]) -> tuple:
    """Host copies of the items' tensors, for CUDA tensors into pinned
    buffers (reused from ``pool`` when the shape and dtype match): the
    masters, the optimizer and the compressor state on a side stream
    behind an event recorded on the current stream — so after the step's
    update — and the model's buffers on the current stream itself, in
    order before the next forward updates them; CPU tensors are cloned.
    Returns ``(items on the host, the side copy's event or None, every
    copy's events)``: the train step holds its next in-place update for
    the first, the writer waits for all of them."""
    out, events = [], []
    cuda = [x for _, x in items if torch.is_tensor(x) and x.is_cuda]
    side = None
    if cuda:
        dev = cuda[0].device
        cur = torch.cuda.current_stream(dev)
        side = _side_stream(dev)
        side.wait_event(cur.record_event())
    for n, x in items:
        if not torch.is_tensor(x):
            out.append((n, _as_tensor(x)))
            continue
        if not x.is_cuda:
            out.append((n, x.detach().clone()))
            continue
        buf = pool.get(n) if pool is not None else None
        if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            if pool is not None:
                pool[n] = buf
        with torch.cuda.stream(cur if n.startswith("buffers.") else side):
            buf.copy_(x.detach(), non_blocking=True)
        out.append((n, buf))
    hold = None
    if side is not None:
        hold = side.record_event()
        events = [hold, cur.record_event()]
    return out, hold, events


_side_streams: dict = {}


def _side_stream(dev):
    s = _side_streams.get(dev)
    if s is None:
        s = _side_streams[dev] = torch.cuda.Stream(dev)
    return s


# ---------------------------------------------------------------------------
# asynchronous saves
# ---------------------------------------------------------------------------


class _AsyncCheckpointer:
    """One writer thread for every asynchronous save of this process;
    saves are serialized (a new save waits for the previous one), and a
    write's exception surfaces at the next `wait`. ``hold`` (a
    ``threading.Event`` or None) lets a test hold the writer back."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._pending = 0
        self._cv = threading.Condition()
        self._error: Optional[BaseException] = None
        #: pinned host buffers by leaf name, reused across saves
        self.pool: dict = {}
        #: shared storage at world > 1: (tmp, step_dir, directory, step,
        #: meta) commits that wait for the main thread's barrier
        self._commits: list = []
        self.hold: Optional[threading.Event] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dear-ckpt-writer")
        self._thread.start()

    def submit(self, fn) -> None:
        with self._cv:
            self._pending += 1
        self._q.put(fn)

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            try:
                if self.hold is not None:
                    self.hold.wait()
                fn()
            except BaseException as exc:  # surfaced by wait()
                with self._cv:
                    self._error = exc
            finally:
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    def wait(self) -> None:
        with self._cv:
            self._cv.wait_for(lambda: self._pending == 0)
            err, self._error = self._error, None
        commits, self._commits = self._commits, []
        if commits:
            _host_barrier()   # every rank's blob is written
            if _rank() == 0:
                for tmp, step_dir, directory, step, meta in commits:
                    _commit(tmp, step_dir)
                    meta["manifest"] = None
                    _write_sidecar(directory, step, meta)
            _host_barrier()
        if err is not None:
            raise err


_async_ckptr: Optional[_AsyncCheckpointer] = None


def _get_async_checkpointer() -> _AsyncCheckpointer:
    global _async_ckptr
    if _async_ckptr is None:
        _async_ckptr = _AsyncCheckpointer()
    return _async_ckptr


def wait_for_checkpoints() -> None:
    """Block until every `save_checkpoint(asynchronous=True)` has committed
    (and, at world > 1 on shared storage, commit them: every rank must
    call it at the same point); re-raises a failed write. No-op when none
    is in flight."""
    if _async_ckptr is not None:
        _async_ckptr.wait()


def has_async_checkpointer() -> bool:
    """True once any async save ran in this process — after which a
    temporary directory in a checkpoint directory may be a live in-flight
    write, not a crash leftover."""
    return _async_ckptr is not None


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def save_checkpoint(
    directory: str, state: D.DearState, ts: D.TrainStep,
    *, asynchronous: bool = False,
    pipeline_state: Optional[dict] = None,
    mem_epoch: Optional[int] = None,
    dcn_state: Optional[dict] = None,
) -> str:
    """Write a checkpoint for the state's current step; returns its path.
    Every rank calls it. ``ts`` is the live `TrainStep` (the JAX package
    takes its plan; the port's step carries the plan, the rank and the
    model's buffers).

    ``asynchronous=True`` returns once the device tensors' snapshot is
    enqueued (module docstring); call `wait_for_checkpoints` before
    reading the files or exiting. ``pipeline_state`` (a `runtime.pipeline`
    ``state_dict()``) and ``mem_epoch`` ride in the sidecar, and so does
    ``dcn_state`` (a `comm.dcn.DcnExchanger` ``state_dict()``: the
    degraded-mode residuals and staleness clocks, which belong to THESE
    parameters; `read_dcn_state` recovers it). On per-host storage at
    world > 1 the blob holds the whole state, gathered over ``ts``'s group
    first (module docstring)."""
    step = int(state.step)
    path = _ckpt_dir(directory, step)
    rank, world = ts.rank, ts.world
    per_host = per_host_storage()
    if asynchronous and world > 1 and per_host:
        logger.warning("checkpoint: per-host storage saves synchronously "
                       "(asynchronous=True ignored)")
        asynchronous = False
    meta = {"plan": plan_fingerprint(ts.plan), "step": step,
            "plan_desc": plan_desc(ts.plan)}
    if pipeline_state is not None:
        meta["pipeline"] = pipeline_state
    if mem_epoch is not None:
        meta["mem_epoch"] = int(mem_epoch)
    if dcn_state is not None:
        meta["dcn"] = dcn_state
    tmp = path + _LOCAL_TMP_MARK
    mine = _layout_dir(tmp, rank, world)
    if os.path.isdir(mine):
        shutil.rmtree(mine)   # this rank's crash leftover
    os.makedirs(directory, exist_ok=True)
    if asynchronous:
        ac = _get_async_checkpointer()
        ac.wait()   # the previous save's buffers are reused
        items, hold, events = _snapshot(_state_items(state, ts), ac.pool)
        if hold is not None:
            ts.hold_for_snapshot(hold)
        shared_multi = world > 1

        def write():
            for ev in events:
                ev.synchronize()
            _write_local(mine, items)
            if not shared_multi:
                _commit(tmp, path)

        if shared_multi:
            ac._commits.append((tmp, path, directory, step, dict(meta)))
        ac.submit(write)
        if not shared_multi and _owns_directory_io():
            # eager sidecar (JAX :311-328): restore reaches it only
            # through a committed step directory; the manifest is
            # backfilled by `write_manifest` after the write commits
            meta["manifest"] = None
            _write_sidecar(directory, step, meta)
        return path
    # synchronous: plain copies to the host, in stream order
    raw_items = (_whole_state_items(state, ts) if per_host and world > 1
                 else _state_items(state, ts))
    items = [(n, x.detach().cpu() if torch.is_tensor(x) else _as_tensor(x))
             for n, x in raw_items]
    _write_local(mine, items)
    if world > 1 and not per_host:
        _host_barrier()   # every rank's blob is in the temporary dir
        if rank == 0:
            for name in os.listdir(tmp):   # an older world's leftovers
                if (name.startswith("rank_") and name[5:].isdigit()
                        and int(name[5:]) >= world):
                    shutil.rmtree(os.path.join(tmp, name))
            _commit(tmp, path)
    else:
        _commit(tmp, path)
    if _owns_directory_io():
        meta["manifest"] = _build_manifest(path)
        _write_sidecar(directory, step, meta)
    if world > 1 and not per_host:
        _host_barrier()   # committed before any rank reads it
    return path


# ---------------------------------------------------------------------------
# manifests and sidecars (the JAX package's)
# ---------------------------------------------------------------------------


def _file_digest(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()[:16]


def _build_manifest(step_dir: str) -> dict:
    """``{relpath: {"sha256": h16, "bytes": n}}`` over every regular file
    in the committed step dir."""
    out = {}
    root = os.path.abspath(step_dir)
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        for fn in sorted(filenames):
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, root)
            out[rel] = {"sha256": _file_digest(p),
                        "bytes": os.path.getsize(p)}
    return out


def _write_sidecar(directory: str, step: int, meta: dict) -> None:
    """Atomic sidecar write with retry (transient shared-fs failures must
    not kill the save path the guard's recovery depends on)."""
    path = _meta_path(directory, step)

    def _write():
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)

    retry_call(_write, name="checkpoint.sidecar_write",
               retry_on=(OSError,), attempts=3, base_delay_s=0.05)


def write_manifest(directory: str, step: int) -> bool:
    """Backfill the checksum manifest for a COMMITTED async save (call
    after `wait_for_checkpoints`). Returns False when the step dir or its
    sidecar is missing (the async write failed) — nothing to manifest."""
    if not _owns_directory_io():
        return False
    step_dir = _ckpt_dir(directory, step)
    meta_path = _meta_path(directory, step)
    if not (os.path.isdir(step_dir) and os.path.exists(meta_path)):
        return False
    with open(meta_path) as f:
        meta = json.load(f)
    meta["manifest"] = _build_manifest(step_dir)
    _write_sidecar(directory, step, meta)
    return True


def read_sidecar(directory: str, step: int) -> Optional[dict]:
    """The sidecar metadata for a step (None when missing/unreadable)."""
    try:
        with open(_meta_path(directory, step)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_pipeline_state(directory: str, step: int) -> Optional[dict]:
    """The input-pipeline ``state_dict()`` persisted with a checkpoint
    (None when absent): feed it to ``Pipeline.load_state_dict`` so a
    restore resumes the data stream where the checkpoint was taken."""
    meta = read_sidecar(directory, step)
    return meta.get("pipeline") if meta else None


def read_dcn_state(directory: str, step: int) -> Optional[dict]:
    """The cross-slice exchanger ``state_dict()`` persisted with a
    checkpoint (None when the save had none). Feed it to
    `comm.dcn.DcnExchanger.load_state_dict` so a rollback re-seats the
    error-feedback residual with the parameters it was deferred against —
    without it a restore drops (or, after replay, double counts) the
    skipped rounds' gradient mass."""
    meta = read_sidecar(directory, step)
    return meta.get("dcn") if meta else None


def read_mem_epoch(directory: str, step: int) -> Optional[int]:
    """The elastic membership epoch stamped into a checkpoint's sidecar
    (None when absent)."""
    meta = read_sidecar(directory, step)
    if meta is None or "mem_epoch" not in meta:
        return None
    return int(meta["mem_epoch"])


def _step_names(names) -> list:
    return [int(n[len("step_"):]) for n in names
            if n.startswith("step_") and n[len("step_"):].isdigit()]


def prune_future_steps(directory: str, *, above: int) -> list:
    """Delete every checkpoint step STRICTLY NEWER than ``above`` — an
    abandoned timeline after a restore to an older step (JAX :431).
    Returns the pruned steps (newest first)."""
    from dear_pytorch_tpu_torch.observability import tracer as _telemetry

    if not _owns_directory_io():
        return []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    stale = sorted((s for s in _step_names(names) if s > above),
                   reverse=True)
    for s in stale:
        shutil.rmtree(_ckpt_dir(directory, s), ignore_errors=True)
        try:
            os.remove(_meta_path(directory, s))
        except OSError:
            pass
    if stale:
        logger.warning(
            "checkpoint: pruned %d stale future step(s) %s after restore "
            "to step %d (abandoned timeline)", len(stale), stale, above)
        tr = _telemetry.get_tracer()
        if tr.enabled:
            tr.count("ckpt.future_steps_pruned", len(stale))
            tr.event("ckpt.future_steps_prune", above=above,
                     pruned=len(stale))
    return stale


def verify_checkpoint(directory: str, step: int) -> bool:
    """Re-hash a checkpoint against its sidecar manifest: False on a
    missing/unreadable sidecar or any size/digest mismatch; True when the
    manifest matches or is absent (an unfinalized async save)."""
    try:
        with open(_meta_path(directory, step)) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return False
    manifest = meta.get("manifest")
    if not manifest:
        return True
    root = _ckpt_dir(directory, step)
    for rel, ent in manifest.items():
        p = os.path.join(root, rel)
        try:
            if os.path.getsize(p) != ent["bytes"]:
                return False
            if _file_digest(p) != ent["sha256"]:
                return False
        except OSError:
            return False
    return True


#: (directory, step, sidecar mtime) already reported corrupt
_corrupt_reported: set = set()


def _report_corrupt(directory: str, step: int) -> None:
    """Log + count one corruption event per (directory, step, sidecar
    mtime)."""
    from dear_pytorch_tpu_torch.observability import tracer as _telemetry

    try:
        stamp = int(os.path.getmtime(_meta_path(directory, step)))
    except OSError:
        stamp = 0
    key = (os.path.abspath(directory), step, stamp)
    if key in _corrupt_reported:
        return
    _corrupt_reported.add(key)
    logger.error(
        "checkpoint: step %d failed checksum verification; "
        "falling back to the previous checkpoint", step)
    tr = _telemetry.get_tracer()
    if tr.enabled:
        tr.count("ckpt.corrupt_detected")
        tr.event("ckpt.corrupt", step=step)


def valid_steps(directory: str, *, below: Optional[int] = None,
                limit: Optional[int] = None) -> list:
    """Every committed step whose checkpoint passes checksum verification,
    newest first (at most ``limit``; ``below`` restricts to strictly older
    steps). Corrupted steps are walked past, counted once each as
    ``ckpt.corrupt_detected``. One host's local view for the cluster
    layer's consensus restore."""
    if not os.path.isdir(directory):
        return []
    steps = sorted((s for s in _step_names(os.listdir(directory))
                    if below is None or s < below), reverse=True)
    out: list = []
    for step in steps:
        if verify_checkpoint(directory, step):
            out.append(step)
            if limit is not None and len(out) >= limit:
                break
        else:
            _report_corrupt(directory, step)
    return out


def latest_valid_step(directory: str, *,
                      below: Optional[int] = None) -> Optional[int]:
    """Newest step whose checkpoint verifies (the corruption-fallback
    walk)."""
    steps = valid_steps(directory, below=below, limit=1)
    return steps[0] if steps else None


def latest_step(directory: str) -> Optional[int]:
    """Newest committed step (temporary directories excluded)."""
    if not os.path.isdir(directory):
        return None
    steps = _step_names(os.listdir(directory))
    return max(steps) if steps else None


def _default_step(directory: str) -> Optional[int]:
    """Step choice for ``step=None`` restores: the newest verified step in
    a single process; across processes the newest committed one (every
    process must restore the same step; JAX :604-615)."""
    if _world() > 1:
        return latest_step(directory)
    return latest_valid_step(directory)


def _is_tmp(name: str) -> bool:
    return name.startswith("step_") and _LOCAL_TMP_MARK in name


def prune_orphaned_tmp(directory: str) -> list:
    """Delete crash-orphaned temporary step directories — call on STARTUP,
    before any async save is in flight. Returns what was removed."""
    if not _owns_directory_io() or not os.path.isdir(directory):
        return []
    removed = []
    for name in sorted(os.listdir(directory)):
        if _is_tmp(name):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
            removed.append(name)
    if removed:
        logger.warning(
            "checkpoint: pruned %d crash-orphaned tmp dir(s) under %s: %s",
            len(removed), directory, ", ".join(removed))
    return removed


def prune_checkpoints(directory: str, *, max_keep: int,
                      skip_tmp_step: Optional[int] = None) -> None:
    """Keep-last-k retention GC (JAX :642): keep the newest ``max_keep``
    committed checkpoints; delete older step dirs and their sidecars,
    crash-leftover temporary dirs, and orphan sidecars whose save never
    committed. ``skip_tmp_step`` protects an in-flight async write's
    temporary dir and its eagerly written sidecar."""
    if not _owns_directory_io():
        return
    max_keep = max(int(max_keep), 1)
    try:
        names = os.listdir(directory)
    except OSError:
        return
    steps = sorted(_step_names(names))
    for name in names:
        if _is_tmp(name):
            if (skip_tmp_step is not None
                    and name.startswith(f"step_{skip_tmp_step:010d}.")):
                continue  # in-flight async write, not a crash leftover
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    for s in steps[:-max_keep]:
        shutil.rmtree(_ckpt_dir(directory, s), ignore_errors=True)
        try:
            os.remove(_meta_path(directory, s))
        except OSError:
            pass
    committed = set(steps)
    for name in names:
        if name.startswith("meta_") and name.endswith(".json.tmp"):
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass
            continue
        if not (name.startswith("meta_") and name.endswith(".json")):
            continue
        digits = name[len("meta_"):-len(".json")]
        if not digits.isdigit():
            continue
        s = int(digits)
        if s not in committed and s != skip_tmp_step:
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def _read_rank(step_dir: str, rank: int) -> dict:
    """``{name: CPU tensor}`` of rank ``rank``'s blob in a step dir."""
    return {ent.get("name", str(i)): t for i, (ent, t)
            in enumerate(_read_local(_rank_dir(step_dir, rank)))}


def _host_value(t: torch.Tensor, like):
    """A saved 0-dim tensor back as the live state's host scalar type."""
    if isinstance(like, bool):
        return bool(t.item())
    if isinstance(like, int):
        return int(t.item())
    if isinstance(like, float):
        return float(t.item())
    return t


def _image(saved: dict, state: D.DearState, ts: D.TrainStep) -> dict:
    """`TrainStep.load_state`'s arguments from a blob saved under the live
    plan; a structural mismatch raises."""
    want = [n for n, _ in _state_items(state, ts)]
    if sorted(want) != sorted(saved):
        missing = sorted(set(want) - set(saved))
        extra = sorted(set(saved) - set(want))
        raise ValueError(
            "checkpoint leaves do not match the live step (restoring into a "
            f"different model/optimizer structure): missing {missing[:6]}, "
            f"unexpected {extra[:6]}")
    def mine(name: str, g: int, live):
        # a per-host blob holds whole buckets (save_checkpoint): this
        # rank's part of a sharded one
        t = saved[name]
        if (torch.is_tensor(live) and live.dim() > 0
                and t.numel() != live.numel()
                and t.numel() == ts.plan.buckets[g].padded_size):
            n = ts.plan.buckets[g].shard_size
            t = t.reshape(-1)[ts.rank * n:(ts.rank + 1) * n]
        return t

    shards = [mine(f"shards.{g}", g, s) for g, s in enumerate(state.shards)]
    opt = [{k: _host_value(mine(f"opt.{g}.{k}", g, v), v)
            for k, v in o.items()}
           for g, o in enumerate(state.opt_state)]
    comp = []
    for g, c in enumerate(state.comp_state):
        if torch.is_tensor(c):
            comp.append(saved[f"comp.{g}"])
        elif isinstance(c, dict):
            comp.append({k: saved[f"comp.{g}.{k}"] for k in c})
        else:
            comp.append(c)
    buffers = {n: saved[f"buffers.{n}"] for n in ts.model_state_names}
    return {"shards": shards, "opt_state": opt, "comp_state": comp,
            "buffers": buffers, "step": int(saved["step"].item())}


def restore_checkpoint(
    directory: str,
    ts: D.TrainStep,
    *,
    step: Optional[int] = None,
    template: Optional[D.DearState] = None,
) -> D.DearState:
    """Restore a checkpoint into the live ``ts``, in place
    (`TrainStep.load_state`), and return the restored state. ``template``
    is the live state the restore overwrites (default: the state ``ts``
    last returned, ``ts.last_state``). When ``step`` is None, restores
    the newest checkpoint that passes checksum verification (single
    process; across processes the newest committed one). Raises
    `PlanMismatchError` if the checkpoint was written under a different
    fusion plan."""
    if step is None:
        step = _default_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no (valid) checkpoints under {directory}")
    with open(_meta_path(directory, step)) as f:
        meta = json.load(f)
    live = plan_fingerprint(ts.plan)
    if meta["plan"] != live:
        raise PlanMismatchError(
            f"checkpoint step {step} was packed under plan {meta['plan']} "
            f"but the train step uses plan {live}; rebuild the step with "
            "the original plan, or restore with elastic_restore")
    state = template if template is not None else ts.last_state
    if state is None:
        raise ValueError("the train step has no live state: call ts.init() "
                         "first (the restore writes into its tensors)")
    saved = _read_rank(_ckpt_dir(directory, step), ts.rank)
    return ts.load_state(state, **_image(saved, state, ts))


def elastic_restore(
    directory: str,
    ts: D.TrainStep,
    *,
    step: Optional[int] = None,
    template: Optional[D.DearState] = None,
) -> D.DearState:
    """Restore a checkpoint written under a DIFFERENT fusion plan — another
    threshold, another world or another membership epoch — into the live
    ``ts``, in place. The old buckets come from the step dir: every old
    rank's blob on shared storage, or on per-host storage the rank's own
    blob, which holds the whole state at world > 1. The sidecar's
    ``plan_desc`` rebuilds the old layout; the masters, the per-element
    optimizer state and its host scalars are carried by parameter name,
    as are the model state and the step. The compressor state is carried
    at the same world and reset (with a log line) across a world change
    (JAX's rule). Every rank calls it."""
    if step is None:
        step = _default_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no (valid) checkpoints under {directory}")
    with open(_meta_path(directory, step)) as f:
        meta = json.load(f)
    if "plan_desc" not in meta:
        raise ValueError(
            f"checkpoint step {step} predates plan_desc sidecars; elastic "
            "restore needs the original layout description")
    old = plan_from_desc(meta["plan_desc"])
    if ({s.name for s in old.leaves} != {s.name for s in ts.plan.leaves}):
        raise ValueError(
            "checkpoint parameters do not match the live model (leaf names "
            "differ) — elastic restore resizes worlds, it does not migrate "
            "architectures")
    state = template if template is not None else ts.last_state
    if state is None:
        raise ValueError("the train step has no live state: call ts.init() "
                         "first (the restore writes into its tensors)")
    step_dir = _ckpt_dir(directory, step)
    mine = _read_rank(step_dir, min(ts.rank, old.world - 1))
    full = _full_buckets(step_dir, old, ts, mine)
    keys = sorted({k.split(".", 2)[2] for k in mine
                   if k.startswith("opt.0.")})
    dev = ts.device

    def by_name(name_fmt: str) -> dict:
        bufs = [full[name_fmt.format(g=g)] for g in range(old.num_buckets)]
        return F.unpack_all(bufs, old, cast=False)

    def this_rank(named: dict, g: int) -> torch.Tensor:
        flat = F.pack_bucket({n: t.to(dev) for n, t in named.items()},
                             ts.plan, g, dtype=torch.float32)
        if not ts.sharded:
            return flat
        n = ts.plan.buckets[g].shard_size
        return flat[ts.rank * n:(ts.rank + 1) * n]

    params = by_name("shards.{g}")
    per_elem = {k: by_name("opt.{g}." + k) for k in keys
                if mine[f"opt.0.{k}"].dim() > 0}
    scalars = {k: mine[f"opt.0.{k}"] for k in keys
               if mine[f"opt.0.{k}"].dim() == 0}
    shards = [this_rank(params, g) for g in range(ts.plan.num_buckets)]
    opt = []
    for g, o in enumerate(state.opt_state):
        entry = {}
        for k, v in o.items():
            if torch.is_tensor(v):
                if k not in per_elem:
                    raise ValueError(f"optimizer state {k!r} is not in the "
                                     "checkpoint")
                entry[k] = this_rank(per_elem[k], g)
            elif k in scalars:
                entry[k] = _host_value(scalars[k], v)
        opt.append(entry)
    comp = list(state.comp_state)
    if any(torch.is_tensor(c) or isinstance(c, dict) for c in comp):
        saved_comp = [k for k in mine if k.startswith("comp.")]
        if old.world == ts.world and saved_comp:
            def comp_full(key_fmt):
                return F.unpack_all([mine[key_fmt.format(g=g)].float()
                                     for g in range(old.num_buckets)],
                                    old, cast=False)

            comp = []
            for g, c in enumerate(state.comp_state):
                if torch.is_tensor(c):
                    comp.append(F.pack_bucket(
                        {n: t.to(dev) for n, t in
                         comp_full("comp.{g}").items()}, ts.plan, g,
                        dtype=c.dtype))
                elif isinstance(c, dict):
                    comp.append({k: F.pack_bucket(
                        {n: t.to(dev) for n, t in
                         comp_full("comp.{g}." + k).items()}, ts.plan, g,
                        dtype=c[k].dtype) for k in c})
                else:
                    comp.append(c)
        else:
            logger.warning("elastic restore: compressor state not carried "
                           "across a world change; error-feedback "
                           "residuals reset")
            comp = [torch.zeros_like(c) if torch.is_tensor(c) else
                    ({k: torch.zeros_like(v) for k, v in c.items()}
                     if isinstance(c, dict) else c) for c in comp]
    buffers = {n: mine[f"buffers.{n}"] for n in ts.model_state_names
               if f"buffers.{n}" in mine}
    return ts.load_state(state, shards=shards, opt_state=opt,
                         comp_state=comp, buffers=buffers,
                         step=int(mine["step"].item()))


def _full_buckets(step_dir: str, old: F.FusionPlan, ts: D.TrainStep,
                  mine: dict) -> dict:
    """``{"shards.<g>" | "opt.<g>.<k>": the full padded old bucket}``: the
    blob's own buffers when they are whole (world 1, a replicated mode, a
    per-host blob at world > 1), else the old ranks' shards concatenated
    (read from a shared step dir, or at the same world gathered over the
    group from each rank's own blob)."""
    names = [k for k in mine if k.startswith("shards.")
             or (k.startswith("opt.") and mine[k].dim() > 0)]
    whole = all(mine[f"shards.{b.index}"].numel() == b.padded_size
                for b in old.buckets)
    if whole:
        return {k: mine[k] for k in names}
    ranks = [os.path.join(step_dir, f"rank_{r:05d}")
             for r in range(old.world)]
    if all(os.path.isdir(p) for p in ranks):
        blobs = [mine if r == ts.rank else _read_rank(step_dir, r)
                 for r in range(old.world)]
        return {k: torch.cat([b[k].reshape(-1) for b in blobs])
                for k in names}
    if old.world != ts.world:
        raise ValueError(
            f"checkpoint {step_dir} holds one rank's shards of a world-"
            f"{old.world} plan and no other rank's blob: it cannot be "
            f"restored at world {ts.world} (per-host saves hold the whole "
            "state at world > 1)")
    from dear_pytorch_tpu_torch.comm import collectives as C

    return {k: C.all_gather(mine[k].reshape(-1).to(ts.device),
                            ts.group).cpu() for k in names}


# ---------------------------------------------------------------------------
# the durable remote tier: checkpoint streaming to an object store
# ---------------------------------------------------------------------------

#: Remote key layout (under the store's root/prefix):
#:   steps/<step:010d>/files/<relpath>   the step dir payload
#:   steps/<step:010d>/sidecar.json      the local sidecar metadata
#:   steps/<step:010d>/MANIFEST.json     written LAST — the commit marker
#: A remote step EXISTS iff its manifest does (object stores have no
#: rename; the last-written manifest is the atomic commit point).
_REMOTE_STEPS = "steps"
_REMOTE_MANIFEST = "MANIFEST.json"
_REMOTE_SIDECAR = "sidecar.json"


def _remote_step_key(step: int) -> str:
    return f"{_REMOTE_STEPS}/{int(step):010d}"


def remote_steps(store) -> list:
    """Committed remote steps, newest first — a step counts only once its
    ``MANIFEST.json`` landed (it is uploaded last, so a crash mid-upload
    leaves an invisible partial, never a restorable-looking torn step)."""
    out = set()
    for key in store.list(_REMOTE_STEPS):
        parts = key.split("/")
        if (len(parts) >= 3 and parts[-1] == _REMOTE_MANIFEST
                and parts[1].isdigit()):
            out.add(int(parts[1]))
    return sorted(out, reverse=True)


class CheckpointStreamer:
    """Background uploader: stream committed step dirs to an object store.

    The durable-tier half of the multi-tier retention contract (the JAX
    package's docs/RESILIENCE.md "Autoscaling"):

      - **every-step local** — the checkpoint directory keeps what the
        guard's ``max_keep`` retention decides; nothing here touches it.
      - **every-Nth remote** — `enqueue` uploads steps on the
        ``upload_every`` cadence (upload bandwidth is the scarce resource
        on a training host; N spreads it).
      - **last-K pinned** — remote retention always keeps the newest
        ``pin_last`` uploads; older uploads survive only on the
        ``keep_every`` archive cadence (0 = prune them), bounding remote
        spend for the life of the service.

    Uploads run on ONE daemon thread off the training path: `enqueue` is
    a queue put, the worker waits for the step to commit locally (async
    saves land late), verifies the checksum manifest, uploads files →
    sidecar → manifest (commit marker last), all under
    `resilience.retry` backoff. **An exhausted retry never raises into
    training**: it counts ``ckpt.upload_errors``, logs the fallback to
    local-only retention for that step, and the worker moves on — a dead
    bucket degrades durability, not the run. ``ckpt.uploads`` counts
    committed uploads.

    A fully-lost fleet (or a scale-from-zero cold start) restores from
    the remote tier alone via `restore_from_object_store` — zero loss of
    progress past the newest uploaded step.
    """

    def __init__(
        self,
        directory: str,
        store,
        *,
        upload_every: int = 1,
        pin_last: int = 2,
        keep_every: int = 0,
        attempts: int = 4,
        base_delay_s: float = 0.1,
        max_delay_s: float = 2.0,
        commit_wait_s: float = 60.0,
    ):
        import queue
        import threading

        self.directory = directory
        self._store = store
        self.upload_every = max(int(upload_every), 1)
        self.pin_last = max(int(pin_last), 1)
        self.keep_every = max(int(keep_every), 0)
        self._attempts = max(int(attempts), 1)
        self._base_delay_s = float(base_delay_s)
        self._max_delay_s = float(max_delay_s)
        self._commit_wait_s = float(commit_wait_s)
        self.uploaded: list = []
        self.failed: list = []
        self._q: "queue.Queue" = queue.Queue()
        self._pending = 0
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="dear-ckpt-streamer")
        self._thread.start()

    # -- producer side (the training loop) -----------------------------------

    def enqueue(self, step: int, *, force: bool = False) -> bool:
        """Queue one committed (or committing) step for upload; returns
        False when the step is off the remote cadence (``force=True``
        bypasses the cadence — emergency saves must reach the durable
        tier no matter where they land) or the streamer is closed. Never
        blocks the training loop."""
        step = int(step)
        if self._closed or (not force and step % self.upload_every != 0):
            return False
        with self._cv:
            self._pending += 1
        self._q.put(step)
        return True

    def flush(self, timeout_s: Optional[float] = None) -> bool:
        """Wait for every enqueued upload to finish (committed or given
        up); True when the queue drained within the timeout."""
        with self._cv:
            return self._cv.wait_for(lambda: self._pending == 0,
                                     timeout=timeout_s)

    def close(self, timeout_s: float = 30.0) -> None:
        """Drain and stop the worker (call at training end; `flush` first
        if the last upload must be durable)."""
        if self._closed:
            return
        self._closed = True
        self.flush(timeout_s)
        self._q.put(None)
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "CheckpointStreamer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker side ---------------------------------------------------------

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._upload(item)
            except Exception:  # the worker must outlive any one upload
                logger.exception(
                    "checkpoint: unexpected streamer failure at step %s "
                    "(local-only retention for it)", item)
                self.failed.append(int(item))
            finally:
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    def _wait_local_commit(self, step: int) -> Optional[dict]:
        """Block (bounded) until the step is committed AND verified
        locally — an async save's dir appears only on commit, and an
        unverifiable step must never become the durable tier's truth."""
        import time

        deadline = time.monotonic() + self._commit_wait_s
        while True:
            meta = read_sidecar(self.directory, step)
            if (meta is not None
                    and os.path.isdir(_ckpt_dir(self.directory, step))
                    and verify_checkpoint(self.directory, step)):
                return meta
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.1)

    def _upload(self, step: int) -> None:
        from dear_pytorch_tpu_torch.observability import tracer as _telemetry

        tr = _telemetry.get_tracer()
        meta = self._wait_local_commit(step)
        if meta is None:
            logger.error(
                "checkpoint: step %d never committed/verified locally "
                "within %.0fs; not uploaded", step, self._commit_wait_s)
            if tr.enabled:
                tr.count("ckpt.upload_errors")
                tr.event("ckpt.upload_error", step=step,
                         why="local_commit_timeout")
            self.failed.append(step)
            return
        step_dir = _ckpt_dir(self.directory, step)
        # the sidecar manifest was just re-verified by _wait_local_commit
        # — reuse it instead of sha256-hashing the whole step dir a
        # second time (manifest-less sidecars — async saves before their
        # finalize backfill — hash here once)
        files = meta.get("manifest") or _build_manifest(step_dir)
        base = _remote_step_key(step)

        def _put():
            for rel in sorted(files):
                self._store.put_file(f"{base}/files/{rel}",
                                     os.path.join(step_dir, rel))
            self._store.put_bytes(f"{base}/{_REMOTE_SIDECAR}",
                                  json.dumps(meta).encode())
            # the commit marker goes LAST: a reader that sees it can
            # trust every byte above it is fully written
            self._store.put_bytes(
                f"{base}/{_REMOTE_MANIFEST}",
                json.dumps({"step": step, "files": files}).encode())

        try:
            retry_call(_put, name="ckpt.upload", attempts=self._attempts,
                       base_delay_s=self._base_delay_s,
                       max_delay_s=self._max_delay_s,
                       retry_on=(OSError, KeyError))
        except RetryError as exc:
            # the durable tier is best-effort from the run's point of
            # view: training continues on local-only retention and the
            # next cadence step tries the store again
            logger.error(
                "checkpoint: upload of step %d exhausted its retry "
                "budget (%s); falling back to LOCAL-ONLY retention for "
                "it", step, exc)
            if tr.enabled:
                tr.count("ckpt.upload_errors")
                tr.event("ckpt.upload_error", step=step, why="retry_exhausted")
            self.failed.append(step)
            return
        self.uploaded.append(step)
        logger.info("checkpoint: step %d uploaded to the remote tier", step)
        if tr.enabled:
            tr.count("ckpt.uploads")
            tr.event("ckpt.upload", step=step, files=len(files))
        self._prune_remote(step)

    def _prune_remote(self, uploaded_step: int) -> None:
        """Remote retention: newest ``pin_last`` uploads are pinned;
        older ones survive only on the ``keep_every`` archive cadence.
        Remote steps NUMERICALLY NEWER than the one just uploaded are an
        abandoned timeline (uploads are chronological on the one worker
        thread, so a smaller step number after a larger one proves a
        consensus rollback happened in between) — they are pruned
        unconditionally, mirroring `prune_future_steps` locally; leaving
        them would hand a cold start dead-timeline state newer than
        anything the live fleet holds."""
        try:
            steps = remote_steps(self._store)
        except Exception:
            return  # a listing error must not fail the upload that ran
        stale = [s for s in steps if s > uploaded_step]
        if stale:
            logger.warning(
                "checkpoint: pruning %d abandoned-timeline remote step(s) "
                "%s after upload of step %d (post-rollback)", len(stale),
                stale, uploaded_step)
        live = [s for s in steps if s <= uploaded_step]
        for s in stale + live[self.pin_last:]:
            if (s <= uploaded_step and self.keep_every
                    and s % self.keep_every == 0):
                continue
            try:
                self._store.delete_prefix(_remote_step_key(s))
            except Exception:
                pass  # retention is best-effort; retried next upload


def restore_from_object_store(store, directory: str,
                              *, step: Optional[int] = None,
                              ) -> Optional[int]:
    """Cold-start restore: materialize the newest (or given) remote step
    into ``directory`` so the ordinary local restore path
    (`restore_checkpoint` / `elastic_restore` + sidecar reads) works on a
    machine that has NEVER trained — a scale-from-zero start or a
    fully-lost fleet. Every downloaded file is **re-hashed against the
    remote manifest** (a bit-flip in the bucket or on the wire must not
    become a poisoned restore); a corrupted remote step is walked past to
    the next older one, exactly like the local corruption-fallback walk.
    Returns the restored step (None when nothing restorable is remote).
    Counts ``ckpt.remote_restores``."""
    import shutil

    from dear_pytorch_tpu_torch.observability import tracer as _telemetry

    tr = _telemetry.get_tracer()
    candidates = remote_steps(store)
    if step is not None:
        candidates = [s for s in candidates if s == int(step)]
    os.makedirs(directory, exist_ok=True)
    for s in candidates:
        base = _remote_step_key(s)
        try:
            manifest = json.loads(
                store.get_bytes(f"{base}/{_REMOTE_MANIFEST}"))
            meta = json.loads(store.get_bytes(f"{base}/{_REMOTE_SIDECAR}"))
        except (KeyError, ValueError) as exc:
            logger.error(
                "checkpoint: remote step %d unreadable (%s); walking to "
                "the previous upload", s, exc)
            continue
        if not manifest.get("files"):
            # a manifest listing no files is not a checkpoint (torn or
            # rewritten remote object): corrupt, walk past it
            logger.error(
                "checkpoint: remote step %d manifest lists no files; "
                "walking to the previous upload", s)
            if tr.enabled:
                tr.event("ckpt.remote_corrupt", step=s, file="<manifest>")
            continue
        step_dir = _ckpt_dir(directory, s)
        tmp = step_dir + _LOCAL_TMP_MARK  # swept by prune_orphaned_tmp
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        ok = True
        for rel, ent in sorted(manifest.get("files", {}).items()):
            dest = os.path.join(tmp, rel)
            try:
                store.get_file(f"{base}/files/{rel}", dest)
            except KeyError:
                ok = False
            else:
                ok = (os.path.getsize(dest) == ent["bytes"]
                      and _file_digest(dest) == ent["sha256"])
            if not ok:
                logger.error(
                    "checkpoint: remote step %d failed sha256 reverify on "
                    "%s; walking to the previous upload", s, rel)
                if tr.enabled:
                    tr.event("ckpt.remote_corrupt", step=s, file=rel)
                break
        if not ok:
            shutil.rmtree(tmp, ignore_errors=True)
            continue
        if os.path.isdir(step_dir):
            shutil.rmtree(step_dir)
        os.rename(tmp, step_dir)  # the local step dir appears atomically
        if not meta.get("manifest"):
            # an async save's sidecar may predate its manifest backfill;
            # the remote manifest IS the verified truth now
            meta["manifest"] = manifest.get("files", {})
        _write_sidecar(directory, s, meta)
        logger.warning(
            "checkpoint: cold-start restored step %d from the remote "
            "tier into %s", s, directory)
        if tr.enabled:
            tr.count("ckpt.remote_restores")
            tr.event("ckpt.remote_restore", step=s)
        return s
    return None
