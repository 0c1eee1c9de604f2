"""Batch pipeline over the native ring buffer (numpy fallback included) —
the port of ``dear_pytorch_tpu/runtime/pipeline.py``, line for line: the
same specs, seeds, streams and state dicts, so a `NumpyPipeline` batch is
byte-identical to the JAX package's for the same seed, epoch, shard and
``num_shards``, and so is a native `Pipeline`'s at ``nthreads=1`` (one
producer draws from one RNG in slot order). What ``next()`` returns is
host arrays (fresh copies, safe to hold), as in JAX; putting them on the
card is the caller's job (`benchmarks.runner.stage_global`).

A `SyntheticSpec` declares the batch as named (shape, dtype, distribution)
fields; `Pipeline` produces dicts of numpy arrays, generated by the C++
producer threads (csrc/dear_runtime.cpp) while the training loop runs.
``image_spec`` / ``bert_spec`` mirror the reference's synthetic benchmark
inputs (dear/imagenet_benchmark.py:97-103, dear/bert_benchmark.py:90-99);
images are NHWC here, as in JAX (the ImageNet CLI permutes them on the
card).

Deterministic resume and elastic resharding: both pipelines carry a
**data-shard assignment** (``shard`` of ``num_shards``, folded into the
generator seed so different shards draw disjoint streams) and expose
``state_dict()`` / ``load_state_dict()`` — step position, shard
assignment, and (numpy backend) the exact PRNG state — for a checkpoint
sidecar (`utils.checkpoint`; `utils.guard.GuardedTrainer`'s ``pipeline=``), so a restore
resumes the data stream at the checkpointed position instead of silently
replaying or skipping batches (``pipeline.resumes`` counter). On a
membership change `reshard()` reassigns this consumer's slice of the data
(``pipeline.reshards``): the post-reshard stream is a pure function of
(seed, epoch, shard, num_shards, step), so every survivor — and a later
rejoiner — derives the identical assignment independently.

The native backend's producers draw asynchronously on C++ threads, so its
mid-stream position is not exactly replayable: its state dict records the
logical position and reseeds deterministically (``exact: false``); the
numpy backend round-trips bit-exactly.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import threading
from typing import Optional

import numpy as np

from dear_pytorch_tpu_torch.observability import tracer as _telemetry
from dear_pytorch_tpu_torch.resilience.retry import retry_call
from dear_pytorch_tpu_torch.runtime import build as B

logger = logging.getLogger("dear_pytorch_tpu_torch")

__all__ = ["Field", "NumpyPipeline", "Pipeline", "SyntheticSpec",
           "bert_spec", "gpt_spec", "image_spec", "mnist_spec",
           "native_available", "now_ns"]

def _fetch_attempts() -> int:
    """Acquire attempts per `Pipeline.next` call. The caller's
    ``timeout_ms`` is split EVENLY across attempts, so the documented
    total wall time is unchanged — the retry absorbs a transiently
    starved producer (GC pause, CPU contention) by re-arming the wait,
    while a dead producer still fails at ``timeout_ms``. Read per call
    (like every other resilience knob) so
    ``DEAR_PIPELINE_FETCH_RETRIES=1`` disables splitting no matter when
    it is set."""
    return max(int(os.environ.get("DEAR_PIPELINE_FETCH_RETRIES", "3")), 1)


def _count_stall(timeout_ms: int, *, attempts: int,
                 exhausted: bool) -> None:
    """Stall telemetry: ``pipeline.stall_timeouts`` counts every acquire
    attempt that timed out (including ones a retry later absorbed —
    the early-warning signal); ``pipeline.stalls`` counts fetches that
    exhausted their whole budget and surfaced `TimeoutError`."""
    tr = _telemetry.get_tracer()
    if not tr.enabled:
        return
    if attempts:
        tr.count("pipeline.stall_timeouts", attempts)
    if exhausted:
        tr.count("pipeline.stalls")
        tr.event("pipeline.stall", timeout_ms=timeout_ms)


def native_available() -> bool:
    return B.load() is not None


def _fold_seed(seed: int, epoch: int, shard: int, num_shards: int,
               pos: int = 0) -> int:
    """Deterministic 32-bit seed for one (membership epoch, shard slot,
    stream position) assignment — a pure function every rank computes
    independently, so a reshard after host loss (or a rejoiner rebuilding
    its pipeline) lands on the identical stream without any coordination.
    ``pos`` is the logical position of a mid-stream reseed (the native
    backend cannot seek, so a resume at produced=N must NOT restart the
    position-0 stream — that would replay batches 0..N-1's data)."""
    if epoch == 0 and shard == 0 and num_shards <= 1 and pos == 0:
        return int(seed)  # the pre-elastic stream, byte-for-byte
    x = (int(seed) * 1_000_003 + int(epoch) * 7_919
         + int(shard) * 104_729 + int(num_shards) * 31
         + int(pos) * 2_654_435_761) & 0x7FFFFFFF
    return x


def _count_reshard(**attrs) -> None:
    tr = _telemetry.get_tracer()
    if tr.enabled:
        tr.count("pipeline.reshards")
        tr.event("pipeline.reshard", **attrs)


def _count_resume(**attrs) -> None:
    tr = _telemetry.get_tracer()
    if tr.enabled:
        tr.count("pipeline.resumes")
        tr.event("pipeline.resume", **attrs)


class _ShardState:
    """Shared shard/seed bookkeeping for both pipeline backends."""

    def _init_shard(self, seed: int, shard: int, num_shards: int,
                    epoch: int = 0) -> None:
        self._seed = int(seed)
        self._shard = int(shard)
        self._num_shards = max(int(num_shards), 1)
        self._epoch = int(epoch)

    @property
    def shard(self) -> int:
        return self._shard

    @property
    def num_shards(self) -> int:
        return self._num_shards

    def _base_state(self, backend: str, exact: bool) -> dict:
        return {
            "backend": backend,
            "exact": exact,
            "slot_bytes": self.spec.slot_bytes,
            "fields": [f.name for f in self.spec.fields],
            "produced": int(self.produced),
            "seed": self._seed,
            "shard": self._shard,
            "num_shards": self._num_shards,
            "epoch": self._epoch,
        }

    def _check_state(self, state: dict) -> None:
        if (state.get("slot_bytes") != self.spec.slot_bytes
                or state.get("fields") != [f.name for f in self.spec.fields]):
            raise ValueError(
                "pipeline state was captured for a different batch spec "
                f"({state.get('fields')} vs "
                f"{[f.name for f in self.spec.fields]})"
            )


def now_ns() -> int:
    lib = B.load()
    if lib is not None:
        return int(lib.dear_now_ns())
    import time

    return time.monotonic_ns()


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    shape: tuple
    kind: int
    p0: float = 0.0
    p1: float = 0.0

    @property
    def dtype(self):
        return np.float32 if self.kind in (
            B.KIND_NORMAL_F32, B.KIND_UNIFORM_F32
        ) else np.int32

    @property
    def count(self) -> int:
        return int(math.prod(self.shape))

    @property
    def nbytes(self) -> int:
        return self.count * 4


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    """A batch layout: fields are packed contiguously into one slot."""

    fields: tuple

    @property
    def slot_bytes(self) -> int:
        return sum(f.nbytes for f in self.fields)

    def offsets(self):
        out, off = [], 0
        for f in self.fields:
            out.append(off)
            off += f.nbytes
        return out


def image_spec(batch: int, image_size: int = 224, classes: int = 1000,
               channels: int = 3) -> SyntheticSpec:
    return SyntheticSpec((
        Field("image", (batch, image_size, image_size, channels),
              B.KIND_NORMAL_F32, 0.0, 1.0),
        Field("label", (batch,), B.KIND_UNIFORM_I32, 0, classes),
    ))


def mnist_spec(batch: int) -> SyntheticSpec:
    return SyntheticSpec((
        Field("image", (batch, 28, 28, 1), B.KIND_NORMAL_F32, 0.0, 1.0),
        Field("label", (batch,), B.KIND_UNIFORM_I32, 0, 10),
    ))


def bert_spec(batch: int, seq_len: int, vocab: int = 30522,
              masked_fraction: float = 0.15) -> SyntheticSpec:
    return SyntheticSpec((
        Field("input_ids", (batch, seq_len), B.KIND_UNIFORM_I32, 0, vocab),
        Field("token_type_ids", (batch, seq_len), B.KIND_CONST_I32, 0),
        Field("attention_mask", (batch, seq_len), B.KIND_CONST_I32, 1),
        Field("masked_lm_labels", (batch, seq_len),
              B.KIND_BERNOULLI_MASKED_I32, masked_fraction, vocab),
        Field("next_sentence_labels", (batch,), B.KIND_UNIFORM_I32, 0, 2),
    ))


def gpt_spec(batch: int, seq_len: int, vocab: int = 50257) -> SyntheticSpec:
    """Causal-LM batch: token ids only (the loss derives next-token
    targets by shifting)."""
    return SyntheticSpec((
        Field("input_ids", (batch, seq_len), B.KIND_UNIFORM_I32, 0, vocab),
    ))


class Pipeline(_ShardState):
    """Ring-buffer batch producer backed by the native library.

    ``next()`` returns ``{name: np.ndarray}`` — fresh copies safe to hold
    (the underlying slot returns to the producers immediately).
    Falls back to `NumpyPipeline` when the native library is unavailable.
    """

    def __new__(cls, spec: SyntheticSpec, *, nslots: int = 4,
                nthreads: int = 2, seed: int = 0, shard: int = 0,
                num_shards: int = 1):
        if cls is Pipeline and B.load() is None:
            return NumpyPipeline(spec, seed=seed, shard=shard,
                                 num_shards=num_shards)
        return super().__new__(cls)

    def __init__(self, spec: SyntheticSpec, *, nslots: int = 4,
                 nthreads: int = 2, seed: int = 0, shard: int = 0,
                 num_shards: int = 1):
        self.spec = spec
        self._init_shard(seed, shard, num_shards)
        self._nslots, self._nthreads = int(nslots), int(nthreads)
        lib = B.load()
        assert lib is not None
        self._lib = lib
        self._slot_bytes = spec.slot_bytes
        self._h = None
        self._resumed_at = 0  # logical stream position of the last (re)seed
        self._consumed = 0    # batches delivered since that (re)seed
        self._create()
        self._closed = False

    def _create(self) -> None:
        spec = self.spec
        segs = (B.Segment * len(spec.fields))()
        for i, (f, off) in enumerate(zip(spec.fields, spec.offsets())):
            segs[i] = B.Segment(off, f.count, f.kind, float(f.p0),
                                float(f.p1))
        self._h = self._lib.dear_pipeline_create(
            spec.slot_bytes, self._nslots, self._nthreads,
            _fold_seed(self._seed, self._epoch, self._shard,
                       self._num_shards, pos=self._resumed_at),
            segs, len(spec.fields)
        )
        if not self._h:
            raise RuntimeError("dear_pipeline_create failed")

    def _recreate(self) -> None:
        """Tear down the producer threads and restart them under the
        current (seed, epoch, shard) assignment — the native stream has no
        mid-flight seek, so reshard/resume restart the generators.
        ``produced`` already includes ``_resumed_at``, so the new position
        is an assignment, not an accumulation (+= would double-count every
        pre-reshard segment on the second reshard of a shrink-then-rejoin
        sequence)."""
        old = int(self.produced)
        self._lib.dear_pipeline_destroy(self._h)
        self._resumed_at = old
        self._consumed = 0
        self._create()

    # -- elastic shard assignment + resume -----------------------------------

    def reshard(self, shard: int, num_shards: int, *, epoch: int = 0) -> None:
        """Reassign this consumer's slice of the data after a membership
        change. Deterministic: the new stream is a pure function of
        (seed, epoch, shard, num_shards), so every survivor computes the
        identical assignment with no coordination."""
        self._init_shard(self._seed, shard, num_shards, epoch)
        self._recreate()
        _count_reshard(shard=shard, num_shards=num_shards, epoch=epoch)

    def state_dict(self) -> dict:
        """Logical stream position (batches the consumer fetched) for
        checkpoint sidecars. ``exact`` is False: the native producers
        draw on asynchronous C++ threads, so resume reseeds
        deterministically at the recorded position rather than replaying
        the precise interleaving (the numpy backend is the bit-exact
        one)."""
        return self._base_state("native", exact=False)

    def load_state_dict(self, state: dict) -> None:
        self._check_state(state)
        self._init_shard(state["seed"], state["shard"],
                         state["num_shards"], state.get("epoch", 0))
        # position FIRST, then the rebuild: the recorded position is
        # folded into the generator seed, so the resumed stream draws
        # fresh data instead of replaying the position-0 stream's
        # batches 0..produced-1
        self._resumed_at = int(state["produced"])
        self._consumed = 0
        self._lib.dear_pipeline_destroy(self._h)
        self._create()
        _count_resume(produced=int(state["produced"]), backend="native")

    def next(self, timeout_ms: int = 10_000) -> dict:
        tr = _telemetry.get_tracer()
        if not tr.enabled:
            return self._fetch(timeout_ms)
        tr.count("pipeline.batches")
        with tr.span("pipeline.next", backend="native"):
            return self._fetch(timeout_ms)

    def _fetch(self, timeout_ms: int) -> dict:
        attempts = _fetch_attempts()
        if attempts <= 1:
            try:
                return self._next(timeout_ms)
            except TimeoutError:
                _count_stall(timeout_ms, attempts=1, exhausted=True)
                raise
        from dear_pytorch_tpu_torch.resilience.retry import RetryError

        # split the budget so total wall time stays ~timeout_ms; no
        # backoff sleep — each attempt already blocks for its slice
        slice_ms = max(timeout_ms // attempts, 1)
        try:
            return retry_call(
                self._next_counted, slice_ms, name="pipeline.next",
                attempts=attempts, base_delay_s=0.0,
                retry_on=(TimeoutError,),
            )
        except RetryError as exc:
            # per-attempt timeouts were already counted by _next_counted
            _count_stall(timeout_ms, attempts=0, exhausted=True)
            # callers see the documented TimeoutError contract either way
            raise TimeoutError(
                f"pipeline produced no batch in {attempts} x "
                f"{slice_ms}ms"
            ) from exc

    def _next_counted(self, timeout_ms: int) -> dict:
        """`_next` with stall accounting: a timed-out acquire attempt is
        an input-pipeline stall signal (starved producers) even when a
        later retry attempt absorbs it."""
        try:
            return self._next(timeout_ms)
        except TimeoutError:
            _count_stall(timeout_ms, attempts=1, exhausted=False)
            raise

    def _next(self, timeout_ms: int) -> dict:
        data = B.ctypes.c_void_p()
        slot = self._lib.dear_pipeline_acquire(
            self._h, B.ctypes.byref(data), timeout_ms
        )
        if slot < 0:
            raise TimeoutError("pipeline produced no batch in time")
        try:
            raw = (B.ctypes.c_char * self._slot_bytes).from_address(
                data.value
            )
            buf = np.frombuffer(raw, dtype=np.uint8)
            out = {}
            for f, off in zip(self.spec.fields, self.spec.offsets()):
                arr = buf[off:off + f.nbytes].view(f.dtype).reshape(f.shape)
                out[f.name] = arr.copy()  # slot is recycled on release
        finally:
            self._lib.dear_pipeline_release(self._h, slot)
        self._consumed += 1
        return out

    @property
    def produced(self) -> int:
        """Batches DELIVERED to the consumer (plus any resumed offset) —
        NOT the producer threads' fill count, which runs up to ``nslots``
        ahead: a position based on the producer count would ratchet the
        recorded stream position forward by ~nslots on every save→restore
        cycle with nothing consumed."""
        return self._resumed_at + self._consumed

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._lib.dear_pipeline_destroy(self._h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass


class NumpyPipeline(_ShardState):
    """Pure-numpy stand-in with the same interface (no toolchain needed).

    This is the **bit-exact** backend: `state_dict` captures the PRNG
    bit-generator state, so `load_state_dict` resumes the stream at the
    precise batch the checkpoint was taken at."""

    def __init__(self, spec: SyntheticSpec, *, seed: int = 0,
                 shard: int = 0, num_shards: int = 1, **_):
        self.spec = spec
        self._init_shard(seed, shard, num_shards)
        self._rng = np.random.default_rng(
            _fold_seed(self._seed, self._epoch, self._shard,
                       self._num_shards))
        self._count = 0
        self._lock = threading.Lock()

    # -- elastic shard assignment + deterministic resume ---------------------

    def reshard(self, shard: int, num_shards: int, *, epoch: int = 0) -> None:
        """Reassign this consumer's data slice after a membership change;
        the post-reshard stream is a pure function of (seed, epoch, shard,
        num_shards) — identical on every rank that computes the same
        assignment."""
        with self._lock:
            self._init_shard(self._seed, shard, num_shards, epoch)
            self._rng = np.random.default_rng(
                _fold_seed(self._seed, self._epoch, self._shard,
                           self._num_shards))
        _count_reshard(shard=shard, num_shards=num_shards, epoch=epoch)

    def state_dict(self) -> dict:
        """JSON-safe exact stream position (PCG64 state ints serialize
        losslessly through the sidecar)."""
        with self._lock:
            out = self._base_state("numpy", exact=True)
            out["rng"] = self._rng.bit_generator.state
            return out

    def load_state_dict(self, state: dict) -> None:
        self._check_state(state)
        with self._lock:
            self._init_shard(state["seed"], state["shard"],
                             state["num_shards"], state.get("epoch", 0))
            self._count = int(state["produced"])
            rng_state = state.get("rng")
            if rng_state:
                self._rng = np.random.default_rng(
                    _fold_seed(self._seed, self._epoch, self._shard,
                               self._num_shards))
                self._rng.bit_generator.state = rng_state
            else:
                # a sidecar written by the native backend (e.g. the .so
                # stopped loading on relaunch and this is the fallback):
                # no PRNG state to restore bit-exactly — reseed at the
                # recorded position like the native resume does, so the
                # stream continues with fresh draws instead of silently
                # replaying batches 0..produced-1
                logger.warning(
                    "pipeline: resuming a native-backend sidecar on the "
                    "numpy backend — position-seeded (not bit-exact) "
                    "resume at produced=%d", self._count)
                self._rng = np.random.default_rng(
                    _fold_seed(self._seed, self._epoch, self._shard,
                               self._num_shards, pos=self._count))
        _count_resume(produced=int(state["produced"]), backend="numpy")

    def next(self, timeout_ms: int = 0) -> dict:
        tr = _telemetry.get_tracer()
        if not tr.enabled:
            return self._next(timeout_ms)
        tr.count("pipeline.batches")
        with tr.span("pipeline.next", backend="numpy"):
            return self._next(timeout_ms)

    def _next(self, timeout_ms: int = 0) -> dict:
        del timeout_ms  # generation is synchronous here
        with self._lock:
            out = {}
            for f in self.spec.fields:
                if f.kind == B.KIND_NORMAL_F32:
                    out[f.name] = self._rng.normal(
                        f.p0, f.p1, f.shape
                    ).astype(np.float32)
                elif f.kind == B.KIND_UNIFORM_F32:
                    out[f.name] = self._rng.uniform(
                        f.p0, f.p1, f.shape
                    ).astype(np.float32)
                elif f.kind == B.KIND_UNIFORM_I32:
                    out[f.name] = self._rng.integers(
                        int(f.p0), int(f.p1), f.shape, dtype=np.int32
                    )
                elif f.kind == B.KIND_CONST_I32:
                    out[f.name] = np.full(f.shape, int(f.p0), np.int32)
                elif f.kind == B.KIND_BERNOULLI_MASKED_I32:
                    keep = self._rng.random(f.shape) < f.p0
                    vals = self._rng.integers(0, int(f.p1), f.shape,
                                              dtype=np.int32)
                    out[f.name] = np.where(keep, vals, -1).astype(np.int32)
                else:
                    out[f.name] = np.zeros(f.shape, np.int32)
            self._count += 1
            return out

    @property
    def produced(self) -> int:
        return self._count

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
