"""The ring transport of ``mode="dear-fused"``: what replaces the TPU's
``pltpu.make_async_remote_copy`` and the DMA / REGULAR semaphores of
``dear_pytorch_tpu/ops/collective_matmul.py::_ring_rounds`` (:130-193) and
``_ring_scratch`` (:196).

Each rank owns one ring buffer per leg (``"ag"``: the all-gather K4;
``"rs"``: the reduce-scatter + update K5 ring): two comm slots sized for
the plan's largest shard in fp32, then an arrival and a credit flag per
slot and kernel block (``csrc/ring.cu`` describes the protocol). A rank's
kernels write the hop into its RIGHT neighbour's slots and raise that
neighbour's arrival flags, and raise its LEFT neighbour's credit flags when
a slot is free again, so each rank needs pointers into both neighbours'
buffers.

A third leg, ``"cm"``, carries the ring collective matmul (K6, K7, K8 of
``csrc/ring_matmul.cu``) when a ring is built with ``cm_elems``: a header
of flags, then one slot per hop (W - 1) of ``cm_elems`` fp32 elements,
the largest ``kc * N`` of the projections (K8's partials travel in fp32).
It has its own buffer, flags and call counter because those kernels run
on the compute stream during forward and backward while K4 and the K5
ring run on the comm stream: the two sequences interleave differently on
each rank, and each must pair up across ranks on its own.

  - `Ring`: one rank per process. The buffers are allocated with
    ``cudaMalloc`` (through the built ``csrc/ring.cu``), their CUDA IPC
    handles exchanged once over the process group's object collectives,
    and the neighbours' handles opened in this process. This serves ranks
    that share one card (two processes time-slicing it) and ranks on cards
    of their own (peer access over NVLink) alike. `Ring.close` frees them
    after a barrier, so no rank frees memory a neighbour may still write.
  - `LocalRing`: W ranks in ONE process on one card, each launch driving
    all W ranks' blocks together (a cooperative launch: every block
    resident at once, since they wait on each other). For checking and
    timing the kernels at real shard sizes without several processes.

Registered outputs (`Ring.register_outputs`, `LocalRing.register_outputs`):
gather buffers the ring owns and maps into each rank's LEFT neighbour, as
it does the slots, each followed by one "ready" flag per kernel block. The
all-gather K4 writes every chunk straight into the right neighbour's
registered output (its "direct" route, ``csrc/ring.cu``) and needs no slot.
The train step registers its persistent per-bucket gather buffers once,
when it is built; the model's parameters are views of them. On a `Ring`
they are ``cudaMalloc``ed through ``csrc/ring.cu`` (an IPC handle maps
the start of an allocation, so they cannot be carved from PyTorch's
caching allocator) and wrapped as tensors through
``__cuda_array_interface__``: they live until `Ring.close`.

The flags are never reset: each ring counts its calls per leg, and the
kernels compare against values derived from that count (``epoch``). Every
rank must therefore issue its ring calls in the same order; the train step
does (`parallel.dear`). On the CPU a `Ring` is just the group: the ring's
plain version runs its hops over `comm.collectives.ring_shift`, and a
registered output is a plain tensor registered nowhere.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

__all__ = ["LEGS", "LocalRing", "Ring", "matmul_lib", "ring_lib"]

#: the legs, each with its own buffers, flags and call counter ("cm" only
#: when the ring is built with ``cm_elems``)
LEGS = ("ag", "rs", "cm")

_lib = None
_mm_lib = None


def ring_lib() -> ctypes.CDLL:
    """The built ``csrc/ring.cu`` (compiled at first use)."""
    global _lib
    if _lib is None:
        from dear_pytorch_tpu_torch.ops import _build

        lib = _build.load("ring")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        u32 = ctypes.c_uint
        lib.ring_all_gather.argtypes = [ptr, i32, i32, i64, i32, i32, i32,
                                        u32, i32, ptr]
        lib.ring_rs_update.argtypes = [ptr, i32, i32, i64, i32, i32, ptr,
                                       i32, i32, i32, u32, i32, ptr]
        lib.ring_alloc.argtypes = [i64, ctypes.POINTER(ptr), ptr]
        lib.ring_open.argtypes = [ptr, ctypes.POINTER(ptr)]
        lib.ring_close.argtypes = [ptr]
        lib.ring_free.argtypes = [ptr]
        lib.ring_error_string.argtypes = [i32]
        lib.ring_error_string.restype = ctypes.c_char_p
        for fn in (lib.ring_all_gather, lib.ring_rs_update, lib.ring_alloc,
                   lib.ring_open, lib.ring_close, lib.ring_free,
                   lib.ring_blocks, lib.ring_max_groups,
                   lib.ring_handle_size):
            fn.restype = i32
        _lib = lib
    return _lib


def matmul_lib() -> ctypes.CDLL:
    """The built ``csrc/ring_matmul.cu`` (compiled at first use)."""
    global _mm_lib
    if _mm_lib is None:
        from dear_pytorch_tpu_torch.ops import _build

        lib = _build.load("ring_matmul")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.rmm_forward, lib.rmm_dx):
            fn.argtypes = [ptr, i32, i32, i64, i64, i64, i64, i32,
                           ctypes.c_uint, i32, i32, i32, ptr]
        lib.rmm_dw.argtypes = [ptr, i32, i32, i64, i64, i64, i64, i32,
                               ctypes.c_uint, i32, i64, i32, i64, i32, ptr]
        for fn in (lib.rmm_forward, lib.rmm_dx, lib.rmm_dw, lib.rmm_blocks):
            fn.restype = i32
        lib.rmm_blocks.argtypes = [i32, i32]
        lib.rmm_header_bytes.argtypes = []
        lib.rmm_header_bytes.restype = i64
        lib.rmm_error_string.argtypes = [i32]
        lib.rmm_error_string.restype = ctypes.c_char_p
        _mm_lib = lib
    return _mm_lib


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: "
                           + ring_lib().ring_error_string(err).decode())


def _layout(max_elems: int) -> tuple:
    """(slot bytes, arrive offset, credit offset, total bytes) of one leg's
    buffer: two fp32 slots of ``max_elems``, then the two flag arrays."""
    blocks = ring_lib().ring_blocks()
    slot = -(-max(1, max_elems) * 4 // 256) * 256
    arrive = 2 * slot
    credit = arrive + 2 * blocks * 4
    return slot, arrive, credit, credit + 2 * blocks * 4


def _ready_offset(nbytes: int) -> int:
    """Where a registered output's "ready" flags start: after its data,
    at a 256-byte boundary."""
    return -(-max(1, nbytes) // 256) * 256


def _device_memory(ptr: int, nbytes: int, dtype, device) -> torch.Tensor:
    """``nbytes`` of device memory at ``ptr`` (owned elsewhere) as a flat
    tensor of ``dtype``: uint8 through ``__cuda_array_interface__`` (which
    has no bfloat16), then viewed."""

    class _Memory:
        __cuda_array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                    "data": (ptr, False), "version": 3,
                                    "strides": None}

    return torch.as_tensor(_Memory(), device=device).view(dtype)


def _cm_layout(cm_elems: int, world: int) -> tuple:
    """(slot bytes, total bytes) of the cm leg's buffer: the flag header,
    then W - 1 slots of ``cm_elems`` fp32 elements."""
    slot = -(-max(1, cm_elems) * 4 // 256) * 256
    return slot, matmul_lib().rmm_header_bytes() + (world - 1) * slot


def _leg_bytes(leg: str, max_elems: int, cm_elems: int, world: int) -> int:
    if leg == "cm":
        return _cm_layout(cm_elems, world)[1]
    return _layout(max_elems)[3]


def _legs(cm_elems: int) -> tuple:
    return LEGS if cm_elems > 0 else LEGS[:2]


def _link(own: int, right: int, left: int, max_elems: int) -> tuple:
    """The 8 pointers a rank's kernel block needs (csrc/ring.cu's order):
    its slots, the right neighbour's slots, its arrival flags, the right
    neighbour's, its credit flags, the left neighbour's."""
    slot, arrive, credit, _ = _layout(max_elems)
    return (own, own + slot, right, right + slot, own + arrive,
            right + arrive, own + credit, left + credit)


class Ring:
    """This rank's end of the ring over ``group`` on ``device``, with slots
    for shards of up to ``max_elems`` elements and, with ``cm_elems``, the
    ring-matmul leg for hops of up to ``cm_elems`` fp32 elements. Built on
    every rank at the same point (it exchanges handles over the group)."""

    stacked = False
    cooperative = False

    def __init__(self, group, device, max_elems: int, cm_elems: int = 0):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.right = (self.rank + 1) % self.world
        self.left = (self.rank - 1) % self.world
        self.device = torch.device(device)
        self.max_elems = int(max_elems)
        self.cm_elems = int(cm_elems)
        self.legs = _legs(self.cm_elems)
        self.calls = dict.fromkeys(self.legs, 0)
        self._own: dict = {}
        self._opened: dict = {}
        self._links: dict = {}
        self._outputs: dict = {}   # data_ptr -> (bytes, direct link)
        self._out_own: list = []
        self._out_opened: list = []
        self.closed = False
        if self.device.type == "cuda" and self.world > 1:
            self._connect()

    def _connect(self) -> None:
        lib = ring_lib()
        handles = {}
        with torch.cuda.device(self.device):
            for leg in self.legs:
                total = _leg_bytes(leg, self.max_elems, self.cm_elems,
                                   self.world)
                ptr = ctypes.c_void_p()
                handle = ctypes.create_string_buffer(lib.ring_handle_size())
                check(lib.ring_alloc(total, ctypes.byref(ptr), handle),
                      "ring buffer allocation")
                self._own[leg] = ptr.value
                handles[leg] = handle.raw
            every = [None] * self.world
            dist.all_gather_object(every, handles, group=self.group)
            peers = {}
            for peer in sorted({self.right, self.left}):
                for leg in self.legs:
                    ptr = ctypes.c_void_p()
                    check(lib.ring_open(every[peer][leg], ctypes.byref(ptr)),
                          f"opening rank {peer}'s ring buffer")
                    peers[peer, leg] = ptr.value
            self._opened = peers
        for leg in LEGS[:2]:
            self._links[leg] = _link(self._own[leg],
                                     peers[self.right, leg],
                                     peers[self.left, leg], self.max_elems)
        if "cm" in self.legs:
            self._links["cm"] = (self._own["cm"], peers[self.right, "cm"],
                                 peers[self.left, "cm"])
        dist.barrier(group=self.group)

    def next_epoch(self, leg: str) -> int:
        """Count a call of ``leg``; the count is the kernel's epoch."""
        self.calls[leg] += 1
        return self.calls[leg]

    @property
    def cm_slot_bytes(self) -> int:
        """Bytes of one slot of the ring-matmul leg."""
        return _cm_layout(self.cm_elems, self.world)[0]

    def links(self, leg: str) -> list:
        """[(rank, its link pointers)] for the ranks one launch drives: 8
        for "ag" and "rs" (csrc/ring.cu's order); for "cm" the leg buffers
        of the rank, its right and its left neighbour."""
        if self.closed:
            raise RuntimeError("the ring is closed")
        return [(self.rank, self._links[leg])]

    def register_outputs(self, sizes, dtype) -> list:
        """Registered gather outputs: one zeroed ``(n,)`` tensor of
        ``dtype`` for each ``n`` in ``sizes``, which the all-gather's
        direct route fills, writing straight into the right neighbour's.
        Every rank calls it at the same point with the same sizes (the
        handles are exchanged over the group). They live until `close`. On
        the CPU, or at world 1: plain zeroed tensors, registered nowhere."""
        sizes = [int(n) for n in sizes]
        if self.device.type != "cuda" or self.world == 1:
            return [torch.zeros(n, dtype=dtype, device=self.device)
                    for n in sizes]
        if self.closed:
            raise RuntimeError("the ring is closed")
        lib = ring_lib()
        esize = torch.empty((), dtype=dtype).element_size()
        flags = lib.ring_blocks() * 4
        outs, mine = [], []
        with torch.cuda.device(self.device):
            for n in sizes:
                nbytes = n * esize
                ptr = ctypes.c_void_p()
                handle = ctypes.create_string_buffer(lib.ring_handle_size())
                check(lib.ring_alloc(_ready_offset(nbytes) + flags,
                                     ctypes.byref(ptr), handle),
                      "registered output allocation")
                self._out_own.append(ptr.value)
                outs.append(_device_memory(ptr.value, nbytes, dtype,
                                           self.device))
                mine.append((nbytes, handle.raw))
            every = [None] * self.world
            dist.all_gather_object(every, mine, group=self.group)
            theirs = every[self.right]
            if [b for b, _ in theirs] != [b for b, _ in mine]:
                raise ValueError(
                    f"rank {self.right} registered outputs of "
                    f"{[b for b, _ in theirs]} bytes, this rank of "
                    f"{[b for b, _ in mine]}")
            for out, (nbytes, handle) in zip(outs, theirs):
                ptr = ctypes.c_void_p()
                check(lib.ring_open(handle, ctypes.byref(ptr)),
                      f"opening rank {self.right}'s registered output")
                self._out_opened.append(ptr.value)
                own, at = out.data_ptr(), _ready_offset(nbytes)
                self._outputs[own] = (nbytes,
                                      (ptr.value, own + at, ptr.value + at))
        dist.barrier(group=self.group)
        return outs

    def direct_links(self, out: torch.Tensor):
        """[(rank, (the right neighbour's output, this output's ready
        flags, the right neighbour's))] when the ring registered ``out``
        (`register_outputs`), else None."""
        rec = self._outputs.get(out.data_ptr())
        if rec is None or rec[0] != out.numel() * out.element_size():
            return None
        if self.closed:
            raise RuntimeError("the ring is closed")
        return [(self.rank, rec[1])]

    def close(self) -> None:
        """Free the buffers and the registered outputs once every rank is
        done with them: wait for this rank's kernels, a barrier, close the
        neighbours' mappings, a second barrier, free. Every rank calls it;
        a second call does nothing."""
        if self.closed or not self._own:
            self.closed = True
            return
        lib = ring_lib()
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)
        with torch.cuda.device(self.device):
            for ptr in [*self._opened.values(), *self._out_opened]:
                check(lib.ring_close(ptr), "closing a peer's ring buffer")
            dist.barrier(group=self.group)
            for ptr in [*self._own.values(), *self._out_own]:
                check(lib.ring_free(ptr), "freeing the ring buffer")
        self._own, self._opened, self._links = {}, {}, {}
        self._outputs, self._out_own, self._out_opened = {}, [], []
        self.closed = True


class LocalRing:
    """A ring of ``world`` ranks that all live in this process on one
    card: the ring collectives then take stacked ``[world, ...]`` inputs
    and drive every rank in one launch. ``max_elems``: the largest shard;
    ``cm_elems``: as for `Ring`. On the CPU it holds no buffers (the
    stacked plain versions run)."""

    stacked = True
    cooperative = True
    group = None

    def __init__(self, world: int, device, max_elems: int,
                 cm_elems: int = 0):
        self.world = int(world)
        self.device = torch.device(device)
        self.max_elems = int(max_elems)
        self.cm_elems = int(cm_elems)
        self.legs = _legs(self.cm_elems)
        self.calls = dict.fromkeys(self.legs, 0)
        self._bufs: dict = {}
        self._outputs: dict = {}   # data_ptr -> (output, ready flags)
        if self.device.type == "cuda" and self.world > 1:
            lib = ring_lib()
            if self.world > lib.ring_max_groups():
                raise ValueError(f"a LocalRing drives at most "
                                 f"{lib.ring_max_groups()} ranks in one "
                                 f"launch, got {self.world}")
            for leg in self.legs:
                total = _leg_bytes(leg, self.max_elems, self.cm_elems,
                                   self.world)
                self._bufs[leg] = [
                    torch.zeros(total, dtype=torch.uint8, device=self.device)
                    for _ in range(self.world)]

    def next_epoch(self, leg: str) -> int:
        self.calls[leg] += 1
        return self.calls[leg]

    cm_slot_bytes = Ring.cm_slot_bytes

    def links(self, leg: str) -> list:
        bufs = [b.data_ptr() for b in self._bufs[leg]]
        w = self.world
        if leg == "cm":
            return [(r, (bufs[r], bufs[(r + 1) % w], bufs[(r - 1) % w]))
                    for r in range(w)]
        return [(r, _link(bufs[r], bufs[(r + 1) % w], bufs[(r - 1) % w],
                          self.max_elems)) for r in range(w)]

    def register_outputs(self, sizes, dtype) -> list:
        """Registered gather outputs, one zeroed ``[world, n]`` tensor of
        ``dtype`` for each ``n`` in ``sizes`` (row r is rank r's), with a
        tensor of ready flags beside each on the card. On the CPU: plain
        zeroed tensors, registered nowhere."""
        outs = [torch.zeros(self.world, int(n), dtype=dtype,
                            device=self.device) for n in sizes]
        if self.device.type == "cuda" and self.world > 1:
            blocks = ring_lib().ring_blocks()
            for out in outs:
                self._outputs[out.data_ptr()] = (out, torch.zeros(
                    self.world, blocks, dtype=torch.int32,
                    device=self.device))
        return outs

    def direct_links(self, out: torch.Tensor):
        rec = self._outputs.get(out.data_ptr())
        if rec is None or rec[0].shape != out.shape \
                or rec[0].dtype != out.dtype:
            return None
        own, ready = rec
        w = self.world
        return [(r, (own[(r + 1) % w].data_ptr(), ready[r].data_ptr(),
                     ready[(r + 1) % w].data_ptr())) for r in range(w)]

    def close(self) -> None:
        self._bufs, self._outputs = {}, {}

