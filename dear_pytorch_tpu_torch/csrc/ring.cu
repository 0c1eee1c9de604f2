// The two ring collectives of mode "dear-fused" for Hopper (sm_90a):
//
//   K4, `ring_ag_*`: the ring all-gather of a flat shard, (n,) -> (W*n,),
//     chunk order = rank order. Replaces the TPU kernel
//     dear_pytorch_tpu/ops/collective_matmul.py::_ag_kernel (:218, via
//     `ring_all_gather` :240). Data movement only: bitwise equal to a tiled
//     all-gather.
//   K5 ring, `ring_rs_*`: the ring reduce-scatter of a bucket's gradient
//     with the partial sums travelling in fp32, fused with the shard update
//     at the last hop. Replaces the TPU kernel _rs_update_kernel (:317, via
//     `fused_reduce_scatter_update` :396). Rank i's partial starts as its
//     local chunk (i-1) mod W and, after the receive of round r, holds chunk
//     (i-1-r) mod W, to which it adds its local copy (converted to fp32, one
//     __fadd_rn: never contracted); at r = W-1 the partial is chunk i summed
//     over every rank, and the update of csrc/shard_update.cuh (shared with
//     csrc/fused_update.cu) runs on the owned shard. The first hop carries
//     the local chunk in the gradient's own dtype (bf16 on the main path),
//     and the receiver widens it when it adds its own chunk: fp32 of a bf16
//     value is exact, so the partials are bitwise those of a first hop sent
//     in fp32 (JAX's `fill0`, :346), with half its bytes. Bitwise equal to
//     the stacked plain version in dear_pytorch_tpu_torch/ops/
//     collective_matmul.py.
//
// Transport (what replaces pltpu.make_async_remote_copy and the DMA /
// REGULAR semaphores of `_ring_rounds` :130-193): each rank owns one ring
// buffer per leg, [slot 0 | slot 1 | arrive[2][kBlocks] | credit[2][kBlocks]],
// mapped into its neighbours through CUDA IPC (or, for W ranks in one
// process, plain pointers). Round r (1..W-1) of a rank reads its slot r%2;
// the hop that feeds it is written by the left neighbour straight into that
// slot, then published with __threadfence_system() and a system-scope
// release store of the slot's arrival flag; the reader polls the flag with a
// system-scope acquire load. When a reader has consumed a slot, it raises
// the slot's credit flag in its LEFT neighbour's buffer, and the writer
// waits for that credit before it overwrites the slot. Every block owns one
// range of the chunk and its own pair of flags per slot, so a hop is
// complete per block and no grid-wide barrier is needed; the grid is
// kBlocks blocks per rank, so the compute stream keeps the rest of the SMs.
//
// K4's two routes (the host picks one per call; collective_matmul.py's
// `ag_route`):
//   - "slot": the TPU kernel's dataflow. A rank copies each chunk into its
//     output and forwards it into the right neighbour's slot; the next
//     round reads it back from its own slot. Per rank (2W-1)·n + (W-1)·2·n
//     elements move (5n at W = 2). Any output takes it: the checks,
//     `TrainStep.gather_params`, the overhead probe.
//   - "direct": the output is one the ring registered (comm/ring.py,
//     `register_outputs`: the train step's persistent gather buffers, of
//     which the model's parameters are views), mapped into the LEFT
//     neighbour like the slots. A rank writes its own chunk into its own
//     output AND straight into the right neighbour's output at that chunk's
//     offset; round r >= 1 forwards the chunk that just arrived in its own
//     output to the right neighbour's. No slot: 3n elements per rank at
//     W = 2, which is (1 + W)·n, the bound. The arrival and credit flags are
//     the slot route's (credits raised as if a slot had been read, so the
//     two routes may follow each other on one leg in any order).
//     Writing into a neighbour's live parameters needs one more flag per
//     registered output and block, "ready": the receiver raises it to the
//     call's epoch when its launch begins, and a writer waits for it before
//     its first store. That is enough because of stream order
//     (parallel/dear.py): the receiver's K4 on a buffer runs on its comm
//     stream after `_on_comm` made that stream wait for an event recorded on
//     the compute stream when `_gather` was called, and every reader of the
//     buffer's previous contents is enqueued on the compute stream before
//     that: the forward of the step (its modules' pre-hooks wait for the
//     previous gather, `_wait_gathers`), the backward that reads the
//     forward's saved tensors (`loss.backward()` returns before
//     `_fused_gathers`), with every microbatch. The next step's forward
//     waits for this call's completion event. So when the receiver's launch
//     begins, no reader of the old contents is left, and no reader of the
//     new ones has started.
//
// Flags are never reset. The host passes the leg's call counter `epoch`
// (1, 2, ...; the same on every rank because every rank issues the same
// calls in the same order), and the hop into round h of call e carries the
// value e*W + h; "ready" carries e. A writer of hop h waits for the credit of
// the slot's previous use: hop h-2 of this call, or the last hop of the same
// parity of call e-1. So a fast rank's next call can never overwrite a slot
// that a slow rank still reads.
//
// Ranks in two processes on one card run only because the GPU time-slices
// between their contexts, so every wait backs off with __nanosleep and has a
// deadline on %globaltimer (csrc/ring_sync.cuh, shared with ring_matmul.cu):
// past it the kernel prints what it waited for and traps, so a broken ring
// fails loudly instead of hanging.
//
// A third leg, "cm", carries the ring collective matmul (K6, K7, K8 in
// csrc/ring_matmul.cu). It has buffers, flags and a call counter of its own:
// those kernels run on the compute stream during forward and backward while
// K4 and the K5 ring run on the comm stream, so the legs' calls interleave
// differently on different ranks and could not share one slot sequence.
//
// What bounds it on this card: bytes, and with kBlocks blocks per rank the
// bytes each block keeps in flight. Both kernels take one of two widths:
//   - "vector" (every shard offset and pointer 16-byte aligned): Hopper's
//     bulk asynchronous copies. Each block runs a ring of shared-memory
//     stages (kStageBytes in all, so two blocks fit an SM: W = 8 ranks in
//     one cooperative launch are 256 blocks on 132 SMs), fed by
//     one-dimensional TMA loads (cp.async.bulk ... mbarrier::complete_tx)
//     that one thread issues: ~64-80 KB in flight per block, where the
//     threads' own 16-byte loads kept ~16 KB.
//     K4 is one warp whose lane 0 does everything (`pipe_copy`): a stage
//     that arrives is bulk-stored (cp.async.bulk.global.shared::cta) to
//     each destination and reloaded once the stores have read it; no
//     thread touches the bytes. The K5 ring's first hop is the same copy.
//     Its later rounds are warp-specialised (`rs_round`): the producer
//     loads the local chunk, the arriving hop and, at the last hop, the
//     parameter and its state into a stage; 16 compute warps read their
//     quads out of it, free it, then convert, add, update (update_one with
//     the optimizer kind fixed at compile time) and write with 16-byte
//     stores. Why so: stores issued by the producer would hold every
//     refill behind them, and a stage freed only after the compute warps'
//     stores would make each tile wait for its stores; 16 warps rather
//     than 8 hide more of update_one's dependent chains.
//   - "scalar" (anything else): the threads' own loads and stores, four in
//     flight per thread, through L2 (ld/st.global.cg) where a peer's slot or
//     output is touched; a unit is one element, or for the K5 ring four
//     where the shard's size and pointers allow (8-byte bf16 accesses: a
//     bf16 shard of 4 mod 8 elements, which the bulk copies cannot take).
// Ordering between the async proxy (bulk copies) and the flags: a block's
// bulk stores are complete (cp.async.bulk.wait_group 0, not .read) before
// fence.proxy.async, __threadfence_system() and the release of the hop's
// arrival flag; the compute warps' stores are released by their arrive on
// the round's `fin` barrier, which the producer waits for before the same
// fences; a reader issues its bulk loads of a slot or an arrived chunk only
// after the flag's acquire and fence.proxy.async.global. Bulk copies move
// between L2 and shared memory, so the ld.global.cg policy of the scalar
// width is not needed there: no L1 line of a peer's data is ever read.
//
// Built by dear_pytorch_tpu_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface; called through ctypes by
// dear_pytorch_tpu_torch/ops/collective_matmul.py and comm/ring.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include "hopper.cuh"
#include "ring_sync.cuh"
#include "shard_update.cuh"

namespace {

using hopper::mbar_expect_tx;
using hopper::smem_u32;

constexpr int kThreads = 256;
// the K5 ring's vector width: a producer warp and 16 compute warps, a
// thread per 4 elements of a stage's tile
constexpr int kRsThreads = 544;
constexpr int kBlocks = kRingBlocks;  // blocks per rank, and flags per slot
constexpr int kMaxGroups = 8;         // ranks in one launch (a LocalRing)
constexpr int kStageBytes = 96 * 1024;  // a block's stages (two per SM fit)
constexpr int kBarBytes = 256;          // the stages' mbarriers, before them
constexpr int kMaxStages = 8;
constexpr int kAgTile = 16 * 1024;      // K4: bytes per stage
constexpr int kAgStages = kStageBytes / kAgTile;
constexpr int kRsTile = 4 * (kRsThreads - 32);   // K5 ring: elements per stage

// One rank's view of the ring: its own slots and flags, its right
// neighbour's slots and arrival flags, its left neighbour's credit flags.
struct Link {
  char* slot[2];
  char* rslot[2];
  unsigned* arrive;   // [2][kBlocks], written by the left neighbour
  unsigned* rarrive;
  unsigned* credit;   // [2][kBlocks], written by the right neighbour
  unsigned* lcredit;
};

struct AgGroup {
  int rank;
  const char* x;
  char* out;
  char* rout;         // direct: the right neighbour's registered output
  unsigned* ready;    // direct: [kBlocks] of this rank's output
  unsigned* rready;   // direct: the right neighbour's
  Link l;
};

struct AgArgs {
  AgGroup g[kMaxGroups];
  int world;
  int esize;
  unsigned epoch;
  long long n;
};

struct RsGroup {
  int rank;
  const char* gbuf;
  float* p;
  float* s1;
  float* s2;
  Link l;
};

struct RsArgs {
  RsGroup g[kMaxGroups];
  Args up;
  int world;
  int stages;
  int stride;   // bytes of one stage
  int depth;    // the first hop's store groups a block keeps pending
  unsigned epoch;
  long long n;
};

__device__ __forceinline__ unsigned hop_val(unsigned e, int world, int h) {
  return e * (unsigned)world + (unsigned)h;
}

// The credit a writer of hop h (into the right neighbour's slot h%2) waits
// for: the reader's release of that slot's previous use.
__device__ __forceinline__ unsigned credit_need(unsigned e, int world,
                                                int h) {
  if (h >= 3) return hop_val(e, world, h - 2);
  const int last = ((world - 1) % 2 == h % 2) ? world - 1 : world - 2;
  if (last < 1 || e <= 1) return 0;
  return hop_val(e - 1, world, last);
}

// Round r's flag waits (one thread): the arrival of its hop, then the
// credit of the slot it forwards into (`credit` false: it forwards into no
// slot, the direct route).
__device__ __forceinline__ void flag_waits(const Link& l, unsigned e,
                                           int world, int rank, int r,
                                           bool credit) {
  const int b = blockIdx.x;
  if (r >= 1)
    spin_until(l.arrive + (r & 1) * kBlocks + b, hop_val(e, world, r),
               "arrival", rank, r);
  if (credit && r < world - 1)
    spin_until(l.credit + ((r + 1) & 1) * kBlocks + b,
               credit_need(e, world, r + 1), "credit", rank, r);
}

// Round r's signals (one thread), once every store of the round is complete
// (bulk ones too: the fence orders the async proxy's writes first).
__device__ __forceinline__ void flag_signals(const Link& l, unsigned e,
                                             int world, int r) {
  const int b = blockIdx.x;
  asm volatile("fence.proxy.async;" ::: "memory");
  __threadfence_system();
  if (r < world - 1)
    st_release_sys(l.rarrive + ((r + 1) & 1) * kBlocks + b,
                   hop_val(e, world, r + 1));
  if (r >= 1)
    st_release_sys(l.lcredit + (r & 1) * kBlocks + b, hop_val(e, world, r));
}

// This block's range [lo, hi) of a chunk of n elements: ranges of a
// multiple of 8 elements, so 16-byte aligned in bf16 and fp32 alike.
__device__ __forceinline__ void block_range(long long n, long long& lo,
                                            long long& hi) {
  const long long per = ((n + kBlocks - 1) / kBlocks + 7) / 8 * 8;
  lo = min(n, (long long)blockIdx.x * per);
  hi = min(n, lo + per);
}

// ---------------------------------------------------------------------------
// bulk asynchronous copies: the vector width
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Every bulk store group but the `pending` newest has read its shared
// memory (0 <= pending < kMaxStages; the instruction takes a constant).
__device__ __forceinline__ void bulk_wait_read(int pending) {
  switch (pending) {
#define RING_WAIT_READ(k) \
  case k:                 \
    asm volatile("cp.async.bulk.wait_group.read " #k ";" ::: "memory"); \
    break;
    RING_WAIT_READ(0) RING_WAIT_READ(1) RING_WAIT_READ(2) RING_WAIT_READ(3)
    RING_WAIT_READ(4) RING_WAIT_READ(5) RING_WAIT_READ(6)
#undef RING_WAIT_READ
    default:
      asm volatile("cp.async.bulk.wait_group.read 7;" ::: "memory");
  }
}

// Every bulk store is complete: its writes are performed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Wait for phase `parity` of `bar`, or trap past the ring's deadline.
__device__ void mbar_wait_or_trap(uint64_t* bar, unsigned parity, int rank,
                                  int round) {
  const uint32_t addr = smem_u32(bar);
  unsigned long long t0 = 0;
  unsigned tries = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (++tries % 256) continue;
    const unsigned long long now = global_ns();
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > kDeadlineNs) {
      printf("ring: rank %d round %d block %d thread %d waited %llu s for a "
             "bulk copy; trapping\n", rank, round, (int)blockIdx.x,
             (int)threadIdx.x, (now - t0) / 1000000000ull);
      __trap();
    }
  }
}

// A block's ring of stages in dynamic shared memory: `stages` stages of
// `stride` bytes after the mbarriers, of which `depth` are being stored and
// the rest loading. Two sets of barriers with a use counter each (use u:
// stage u % stages, barrier phase (u / stages) & 1): `bar` for copies that
// one thread issues and waits for alone (`pipe_copy`: K4, the K5 ring's
// first hop), `full` and `done` for the K5 ring's compute rounds, which
// consumer warps wait for. Every round leaves every stage free, so the two
// may share the stages; a consumer waits only on compute uses, so it can
// never mistake a copy's phase for the one it waits for.
struct Pipe {
  char* stage0;
  uint64_t* bar;
  uint64_t* full;
  uint64_t* done;
  uint64_t* fin;    // a compute round's end: every consumer warp's stores
  int stages;
  int stride;
  int depth;
  unsigned used;    // uses of `bar`
  unsigned cused;   // uses of `full` and `done`
  unsigned rounds;  // compute rounds (uses of `fin`)

  __device__ char* stage(unsigned u) const {
    return stage0 + (long long)(u % stages) * stride;
  }
  __device__ uint64_t* barrier(unsigned u) const { return bar + u % stages; }
  __device__ unsigned parity(unsigned u) const {
    return (u / stages) & 1u;
  }
};

// Thread 0 initialises the barriers (`bar` and `full`: one arrival each, by
// the thread that arms it; `done`: one per consumer warp); the caller
// synchronises the block before other threads wait.
__device__ Pipe pipe_init(unsigned char* smem, int stages, int stride,
                          int depth, int consumer_warps) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  Pipe p{reinterpret_cast<char*>(smem) + kBarBytes, bars, bars + kMaxStages,
         bars + 2 * kMaxStages, bars + 3 * kMaxStages, stages, stride, depth,
         0u, 0u, 0u};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(p.bar + s, 1);
      if (consumer_warps > 0) {
        hopper::mbar_init(p.full + s, 1);
        hopper::mbar_init(p.done + s, consumer_warps);
      }
    }
    if (consumer_warps > 0) hopper::mbar_init(p.fin, consumer_warps);
    hopper::mbar_fence_init();
  }
  return p;
}

__device__ __forceinline__ long long tiles(long long len, long long tile) {
  return (len + tile - 1) / tile;
}

// One thread: bytes [0, len) of `src` into `d0` and, when set, `d1`,
// through the stages (a stage's `stride` bytes at a time). `stages - depth`
// stages keep loading while the `depth` newest are stored; a stage is loaded
// again once the store group that read it is done reading. Returns with
// every store complete.
__device__ void pipe_copy(Pipe& p, const char* src, char* d0, char* d1,
                          long long len, int rank, int round) {
  const long long tile = p.stride;
  const long long nt = tiles(len, tile);
  auto issue = [&](long long t) {
    const unsigned u = p.used + (unsigned)t;
    const unsigned bytes = (unsigned)min(tile, len - t * tile);
    mbar_expect_tx(p.barrier(u), bytes);
    bulk_load(p.stage(u), src + t * tile, bytes, p.barrier(u));
  };
  long long issued = 0;
  for (; issued < nt && issued < p.stages - p.depth; ++issued) issue(issued);
  for (long long t = 0; t < nt; ++t) {
    const unsigned u = p.used + (unsigned)t;
    mbar_wait_or_trap(p.barrier(u), p.parity(u), rank, round);
    const unsigned bytes = (unsigned)min(tile, len - t * tile);
    bulk_store(d0 + t * tile, p.stage(u), bytes);
    if (d1) bulk_store(d1 + t * tile, p.stage(u), bytes);
    bulk_commit();
    if (issued < nt) {   // into the stage of tile t-depth, once read
      bulk_wait_read(p.depth);
      issue(issued++);
    }
  }
  bulk_wait_all();
  p.used += (unsigned)nt;
}

// ---------------------------------------------------------------------------
// K4: ring all-gather
// ---------------------------------------------------------------------------

// The vector width: one warp per block, lane 0 issues every copy.
template <bool Direct>
__global__ void __launch_bounds__(kThreads, 2)
ring_ag_bulk_kernel(const AgArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  const AgGroup& g = a.g[blockIdx.y];
  const int W = a.world, my = g.rank, b = blockIdx.x;
  const unsigned e = a.epoch;
  Pipe p = pipe_init(smem, kAgStages, kAgTile, kAgStages / 2, 0);
  long long lo, hi;
  block_range(a.n, lo, hi);
  const long long cb = a.n * a.esize, lo_b = lo * a.esize;
  const long long len = (hi - lo) * a.esize;
  if (Direct) st_release_sys(g.ready + b, e);   // this call has begun here
  for (int r = 0; r < W; ++r) {
    const long long at = (long long)((my - r + W) % W) * cb + lo_b;
    flag_waits(g.l, e, W, my, r, !Direct);
    if (r >= 1) hopper::fence_proxy_async_global();
    if (Direct) {
      if (r == 0) {
        spin_until(g.rready + b, e, "ready", my, r);
        pipe_copy(p, g.x + lo_b, g.out + at, g.rout + at, len, my, r);
      } else if (r < W - 1) {
        pipe_copy(p, g.out + at, g.rout + at, nullptr, len, my, r);
      }
    } else {
      const char* src = r == 0 ? g.x + lo_b : g.l.slot[r & 1] + lo_b;
      char* fwd = r < W - 1 ? g.l.rslot[(r + 1) & 1] + lo_b : nullptr;
      pipe_copy(p, src, g.out + at, fwd, len, my, r);
    }
    flag_signals(g.l, e, W, r);
  }
}

// The scalar width: copy units [lo, hi) of `src` (read through L2 when a
// peer wrote it) to `d0` and, when set, `d1`, four loads in flight per
// thread.
template <typename U>
__device__ __forceinline__ void ag_pass(const U* __restrict__ src,
                                        bool from_peer, U* __restrict__ d0,
                                        U* __restrict__ d1, long long lo,
                                        long long hi) {
  const long long bd = blockDim.x;
  long long i = lo + threadIdx.x;
  for (; i + 3 * bd < hi; i += 4 * bd) {
    U v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = from_peer ? __ldcg(src + i + k * bd) : src[i + k * bd];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __stcg(d0 + i + k * bd, v[k]);
      if (d1) __stcg(d1 + i + k * bd, v[k]);
    }
  }
  for (; i < hi; i += bd) {
    const U v = from_peer ? __ldcg(src + i) : src[i];
    __stcg(d0 + i, v);
    if (d1) __stcg(d1 + i, v);
  }
}

template <typename U, bool Direct>
__global__ void __launch_bounds__(kThreads, 2)
ring_ag_kernel(const AgArgs a) {
  const AgGroup& g = a.g[blockIdx.y];
  const int W = a.world, my = g.rank, b = blockIdx.x;
  const unsigned e = a.epoch;
  long long lo, hi;
  block_range(a.n, lo, hi);
  const U* x = reinterpret_cast<const U*>(g.x);
  U* out = reinterpret_cast<U*>(g.out);
  U* rout = reinterpret_cast<U*>(g.rout);
  if (Direct && threadIdx.x == 0) st_release_sys(g.ready + b, e);
  for (int r = 0; r < W; ++r) {
    const long long at = (long long)((my - r + W) % W) * a.n;
    if (threadIdx.x == 0) {
      flag_waits(g.l, e, W, my, r, !Direct);
      if (Direct && r == 0) spin_until(g.rready + b, e, "ready", my, r);
    }
    __syncthreads();
    if (Direct) {
      if (r == 0)
        ag_pass<U>(x, false, out + at, rout + at, lo, hi);
      else if (r < W - 1)
        ag_pass<U>(out + at, true, rout + at, nullptr, lo, hi);
    } else {
      const U* src = r == 0 ? x : reinterpret_cast<const U*>(g.l.slot[r & 1]);
      U* fwd = r < W - 1 ? reinterpret_cast<U*>(g.l.rslot[(r + 1) & 1])
                         : nullptr;
      ag_pass<U>(src, r > 0, out + at, fwd, lo, hi);
    }
    __syncthreads();
    if (threadIdx.x == 0) flag_signals(g.l, e, W, r);
  }
}

// ---------------------------------------------------------------------------
// K5 ring: reduce-scatter + update
// ---------------------------------------------------------------------------

// Four values of T at index 4q of `base` (shared memory), in fp32.
template <typename T>
__device__ __forceinline__ void quad(const char* base, long long q,
                                     float (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 f = reinterpret_cast<const float4*>(base)[q];
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {   // bf16 -> fp32 is exact: the bits shifted into the high half
    const uint2 u = reinterpret_cast<const uint2*>(base)[q];
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  }
}

// A round r >= 1 of the K5 ring at the vector width, warp-specialised:
// thread 0 (the producer; the rest of its warp has left) issues the bulk
// loads, the 16 warps after it (the consumers) compute. Per tile of `T`
// elements a stage holds the local chunk (G), the arriving hop (In: the
// gradient's dtype after round 0, fp32 after later rounds) and, at the last
// hop (kLast), the parameter and the state vectors the optimizer has. A
// consumer warp waits for a stage's loads (full barrier), converts, adds
// and updates, writes its results with 16-byte stores (the outgoing fp32
// hop into the right neighbour's slot, kHop; the parameter and its state in
// place, kLast) and arrives on the stage's done barrier; the producer waits
// for the done barrier and reloads the stage. No block-wide barrier; the
// round's flag is released after the producer has seen every tile done (a
// consumer's arrive releases its stores, the producer's wait acquires
// them, then the system-scope fence and release of `flag_signals`).
enum RsKind { kHop, kLast };

template <typename G, typename In, int Kind, int Opt = kSgd>
__device__ void rs_round(Pipe& p, const Args& args,
                         const G* loc, const In* in, char* fwd, float* pp,
                         float* s1, float* s2, long long lo, long long hi,
                         int rank, int round) {
  constexpr long long T = kRsTile;
  // the update's arguments with what the ring knows at compile time (its
  // optimizer kind `Opt`, no clip scale), so that update_one's branches on
  // them fold away
  Args up = args;
  up.kind = Opt;
  up.clip = nullptr;
  const long long o_in = T * (long long)sizeof(G), o_x = o_in + T * 4;
  constexpr bool one = Kind == kLast && Opt != kSgd;
  constexpr bool two = Kind == kLast && Opt == kAdamW;
  const long long nt = tiles(hi - lo, T);
  // A block whose range is empty (the trailing blocks of a short shard) has
  // no tile in any round and touches no barrier: its consumers, waiting on
  // no stage, would otherwise complete two phases of `fin` before the
  // producer waits for the first, whose parity would then never match
  // again. Producer and consumers compute the same nt.
  if (nt == 0) return;
  auto len = [&](long long t) { return min(T, hi - lo - t * T); };
  if (threadIdx.x == 0) {
    auto issue = [&](long long t) {
      const unsigned u = p.cused + (unsigned)t;
      const long long e0 = lo + t * T, m = len(t);
      char* s = p.stage(u);
      uint64_t* bar = p.full + u % p.stages;
      const unsigned gb = (unsigned)(m * sizeof(G));
      const unsigned ib = (unsigned)(m * sizeof(In));
      const unsigned fb = (unsigned)(m * 4);
      mbar_expect_tx(bar, gb + ib + (Kind == kLast ? fb * (1 + one + two)
                                                   : 0u));
      bulk_load(s, loc + e0, gb, bar);
      bulk_load(s + o_in, in + e0, ib, bar);
      if (Kind == kLast) {
        bulk_load(s + o_x, pp + e0, fb, bar);
        if (one) bulk_load(s + o_x + T * 4, s1 + e0, fb, bar);
        if (two) bulk_load(s + o_x + 2 * T * 4, s2 + e0, fb, bar);
      }
    };
    long long issued = 0;   // no stores of its own: every stage loads
    for (; issued < nt && issued < p.stages; ++issued) issue(issued);
    for (long long t = 0; t < nt; ++t) {
      const unsigned u = p.cused + (unsigned)t;
      mbar_wait_or_trap(p.done + u % p.stages, p.parity(u), rank, round);
      if (issued < nt) issue(issued++);
    }
    mbar_wait_or_trap(p.fin, p.rounds & 1u, rank, round);
  } else {
    const int q = threadIdx.x - 32;   // this thread's quad of every tile
    for (long long t = 0; t < nt; ++t) {
      const unsigned u = p.cused + (unsigned)t;
      const char* s = p.stage(u);
      const bool mine = q < len(t) / 4;
      const long long at = (lo + t * T) / 4 + q;   // the quad in the shard
      // the quad is read out of the stage, which is then free: the stores
      // that follow need not complete first
      float l[4], h[4];
      float4 pv, av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
      mbar_wait_or_trap(p.full + u % p.stages, p.parity(u), rank, round);
      const float4* x4 = reinterpret_cast<const float4*>(s + o_x);
      if (mine) {
        quad<G>(s, q, l);
        quad<In>(s + o_in, q, h);
        if (Kind == kLast) {
          pv = x4[q];
          if (one) av = x4[T / 4 + q];
          if (two) bv = x4[T / 2 + q];
        }
      }
      __syncwarp();
      if ((q & 31) == 0) hopper::mbar_arrive(p.done + u % p.stages);
      if (!mine) continue;
      float acc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(h[k], l[k]);
      if (Kind == kHop) {
        __stcg(reinterpret_cast<float4*>(fwd) + at,
               make_float4(acc[0], acc[1], acc[2], acc[3]));
        continue;
      }
      update_one(up, 1.f, acc[0], pv.x, av.x, bv.x);
      update_one(up, 1.f, acc[1], pv.y, av.y, bv.y);
      update_one(up, 1.f, acc[2], pv.z, av.z, bv.z);
      update_one(up, 1.f, acc[3], pv.w, av.w, bv.w);
      reinterpret_cast<float4*>(pp)[at] = pv;
      if (one) reinterpret_cast<float4*>(s1)[at] = av;
      if (two) reinterpret_cast<float4*>(s2)[at] = bv;
    }
    // the round's stores are done (the arrive releases them) before the
    // producer's flag
    __syncwarp();
    if ((q & 31) == 0) hopper::mbar_arrive(p.fin);
  }
  p.cused += (unsigned)nt;
  ++p.rounds;
}

// The last hop, with the optimizer kind fixed at compile time.
template <typename G, typename In>
__device__ void rs_last(Pipe& p, const RsArgs& a, const RsGroup& g,
                        const G* loc, const In* in, long long lo,
                        long long hi, int rank, int round) {
  if (a.up.kind == kSgd)
    rs_round<G, In, kLast, kSgd>(p, a.up, loc, in, nullptr, g.p, g.s1, g.s2,
                                 lo, hi, rank, round);
  else if (a.up.kind == kSgdMomentum)
    rs_round<G, In, kLast, kSgdMomentum>(p, a.up, loc, in, nullptr, g.p,
                                         g.s1, g.s2, lo, hi, rank, round);
  else
    rs_round<G, In, kLast, kAdamW>(p, a.up, loc, in, nullptr, g.p, g.s1,
                                   g.s2, lo, hi, rank, round);
}

template <typename G>
__global__ void __launch_bounds__(kRsThreads, 2)
ring_rs_bulk_kernel(const RsArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RsGroup& g = a.g[blockIdx.y];
  const int W = a.world, my = g.rank;
  const unsigned e = a.epoch;
  Pipe p = pipe_init(smem, a.stages, a.stride, a.depth,
                     (kRsThreads - 32) / 32);
  __syncthreads();   // the barriers are ready; from here on, no block barrier
  if (threadIdx.x > 0 && threadIdx.x < 32) return;
  long long lo, hi;
  block_range(a.n, lo, hi);
  const G* gbuf = reinterpret_cast<const G*>(g.gbuf);
  for (int r = 0; r < W; ++r) {
    const int c = ((my - 1 - r) % W + 2 * W) % W;   // the chunk of round r
    const G* loc = gbuf + (long long)c * a.n;
    if (threadIdx.x == 0) {
      flag_waits(g.l, e, W, my, r, true);
      if (r >= 1) hopper::fence_proxy_async_global();
    }
    char* fwd = r < W - 1 ? g.l.rslot[(r + 1) & 1] : nullptr;
    const char* slot = g.l.slot[r & 1];
    const G* in_g = reinterpret_cast<const G*>(slot);
    const float* in_f = reinterpret_cast<const float*>(slot);
    if (r == 0) {   // the local chunk as it is: a copy by the producer
      const long long len = (hi - lo) * (long long)sizeof(G);
      if (threadIdx.x == 0)
        pipe_copy(p, reinterpret_cast<const char*>(loc + lo),
                  fwd + lo * (long long)sizeof(G), nullptr, len, my, r);
    } else if (r == 1 && r == W - 1)
      rs_last<G, G>(p, a, g, loc, in_g, lo, hi, my, r);
    else if (r == 1)
      rs_round<G, G, kHop>(p, a.up, loc, in_g, fwd, g.p, g.s1, g.s2,
                           lo, hi, my, r);
    else if (r == W - 1)
      rs_last<G, float>(p, a, g, loc, in_f, lo, hi, my, r);
    else
      rs_round<G, float, kHop>(p, a.up, loc, in_f, fwd, g.p, g.s1,
                               g.s2, lo, hi, my, r);
    if (threadIdx.x == 0) flag_signals(g.l, e, W, r);
  }
}

// The scalar width. A unit is K elements in one access: K = 4 where the
// shard allows it (16 bytes of fp32, 8 of bf16), else 1.
template <typename T, int K>
struct Pack {
  using type = T;
};
template <>
struct Pack<float, 4> {
  using type = float4;
};
template <>
struct Pack<__nv_bfloat16, 4> {
  using type = uint2;
};

template <typename T, int K>
__device__ __forceinline__ void widen(const typename Pack<T, K>::type& u,
                                      float (&v)[K]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = to_f32(e[k]);
}

// Round 0: the local chunk as it is into the right neighbour's slot, four
// units in flight per thread.
template <typename G, int K>
__device__ void rs_send(const G* __restrict__ loc, G* __restrict__ fwd,
                        long long lo, long long hi) {
  using P = typename Pack<G, K>::type;
  const P* src = reinterpret_cast<const P*>(loc);
  P* dst = reinterpret_cast<P*>(fwd);
  const long long bd = blockDim.x, end = hi / K;
  long long u = lo / K + threadIdx.x;
  for (; u + 3 * bd < end; u += 4 * bd) {
    P v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = src[u + k * bd];
#pragma unroll
    for (int k = 0; k < 4; ++k) __stcg(dst + u + k * bd, v[k]);
  }
  for (; u < end; u += bd) __stcg(dst + u, src[u]);
}

// A round 1 <= r < W-1: the arrived hop (as In) plus the local chunk, in
// fp32, into the right neighbour's slot, four units in flight per thread.
template <typename G, typename In, int K>
__device__ void rs_hop(const G* __restrict__ loc, const In* __restrict__ in,
                       float* __restrict__ fwd, long long lo, long long hi) {
  using PG = typename Pack<G, K>::type;
  using PI = typename Pack<In, K>::type;
  using PF = typename Pack<float, K>::type;
  const PG* lg = reinterpret_cast<const PG*>(loc);
  const PI* ih = reinterpret_cast<const PI*>(in);
  PF* out = reinterpret_cast<PF*>(fwd);
  auto sum = [](const PI& h, const PG& l) {
    float a[K], b[K];
    widen<In, K>(h, a);
    widen<G, K>(l, b);
    PF o;
    float* oe = reinterpret_cast<float*>(&o);
#pragma unroll
    for (int k = 0; k < K; ++k) oe[k] = __fadd_rn(a[k], b[k]);
    return o;
  };
  const long long bd = blockDim.x, end = hi / K;
  long long u = lo / K + threadIdx.x;
  for (; u + 3 * bd < end; u += 4 * bd) {
    PG l[4];
    PI h[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      l[k] = lg[u + k * bd];
      h[k] = __ldcg(ih + u + k * bd);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) __stcg(out + u + k * bd, sum(h[k], l[k]));
  }
  for (; u < end; u += bd) __stcg(out + u, sum(__ldcg(ih + u), lg[u]));
}

// The last hop: the full sum of the owned chunk, then the shard update.
template <typename G, typename In, int K>
__device__ void rs_update(const Args& up, const G* __restrict__ loc,
                          const In* __restrict__ in, float* __restrict__ p,
                          float* __restrict__ s1, float* __restrict__ s2,
                          long long lo, long long hi) {
  using PG = typename Pack<G, K>::type;
  using PI = typename Pack<In, K>::type;
  using PF = typename Pack<float, K>::type;
  const PG* lg = reinterpret_cast<const PG*>(loc);
  const PI* ih = reinterpret_cast<const PI*>(in);
  PF* pp = reinterpret_cast<PF*>(p);
  PF* p1 = reinterpret_cast<PF*>(s1);
  PF* p2 = reinterpret_cast<PF*>(s2);
  const bool one = up.kind != kSgd;
  const bool two = up.kind == kAdamW;
  for (long long u = lo / K + threadIdx.x; u < hi / K; u += blockDim.x) {
    float h[K], l[K];
    widen<In, K>(__ldcg(ih + u), h);
    widen<G, K>(lg[u], l);
    PF pv = pp[u], av = one ? p1[u] : PF{}, bv = two ? p2[u] : PF{};
    float* pe = reinterpret_cast<float*>(&pv);
    float* ae = reinterpret_cast<float*>(&av);
    float* be = reinterpret_cast<float*>(&bv);
#pragma unroll
    for (int k = 0; k < K; ++k)
      update_one(up, 1.f, __fadd_rn(h[k], l[k]), pe[k], ae[k], be[k]);
    pp[u] = pv;
    if (one) p1[u] = av;
    if (two) p2[u] = bv;
  }
}

template <typename G, int K>
__global__ void __launch_bounds__(kThreads, 2)
ring_rs_kernel(const RsArgs a) {
  const RsGroup& g = a.g[blockIdx.y];
  const int W = a.world, my = g.rank;
  long long lo, hi;
  block_range(a.n, lo, hi);
  const G* gbuf = reinterpret_cast<const G*>(g.gbuf);
  for (int r = 0; r < W; ++r) {
    if (threadIdx.x == 0) flag_waits(g.l, a.epoch, W, my, r, true);
    __syncthreads();
    const int c = ((my - 1 - r) % W + 2 * W) % W;   // the chunk of round r
    const G* loc = gbuf + (long long)c * a.n;
    float* fwd = r < W - 1 ? reinterpret_cast<float*>(g.l.rslot[(r + 1) & 1])
                           : nullptr;
    const char* slot = g.l.slot[r & 1];
    if (r == 0) {
      rs_send<G, K>(loc, reinterpret_cast<G*>(g.l.rslot[1]), lo, hi);
    } else if (r == 1 && r == W - 1) {
      rs_update<G, G, K>(a.up, loc, reinterpret_cast<const G*>(slot), g.p,
                         g.s1, g.s2, lo, hi);
    } else if (r == 1) {
      rs_hop<G, G, K>(loc, reinterpret_cast<const G*>(slot), fwd, lo, hi);
    } else if (r == W - 1) {
      rs_update<G, float, K>(a.up, loc, reinterpret_cast<const float*>(slot),
                             g.p, g.s1, g.s2, lo, hi);
    } else {
      rs_hop<G, float, K>(loc, reinterpret_cast<const float*>(slot), fwd, lo,
                          hi);
    }
    __syncthreads();
    if (threadIdx.x == 0) flag_signals(g.l, a.epoch, W, r);
  }
}

// ---------------------------------------------------------------------------
// launching
// ---------------------------------------------------------------------------

void read_link(const long long* v, Link& l) {
  l.slot[0] = reinterpret_cast<char*>(v[0]);
  l.slot[1] = reinterpret_cast<char*>(v[1]);
  l.rslot[0] = reinterpret_cast<char*>(v[2]);
  l.rslot[1] = reinterpret_cast<char*>(v[3]);
  l.arrive = reinterpret_cast<unsigned*>(v[4]);
  l.rarrive = reinterpret_cast<unsigned*>(v[5]);
  l.credit = reinterpret_cast<unsigned*>(v[6]);
  l.lcredit = reinterpret_cast<unsigned*>(v[7]);
}

bool aligned16(long long p) { return p % 16 == 0; }

// One launch of `kernel` over n_groups ranks, `threads` per block and
// `smem` bytes of dynamic shared memory (its limit set first). A
// cooperative launch (all blocks resident at once, checked here and again
// at launch) when one process drives several ranks, whose blocks wait on
// each other.
template <typename A>
cudaError_t launch(const void* kernel, const A& a, int n_groups, int threads,
                   int smem, int cooperative, cudaStream_t stream) {
  const dim3 grid(kBlocks, n_groups), block(threads);
  cudaError_t err = cudaSuccess;
  if (smem > 0)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<A*>(&a)};
  if (!cooperative) {
    err = cudaLaunchKernel(kernel, grid, block, args, smem, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * sms < (long long)kBlocks * n_groups)
    return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(kernel, grid, block, args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The C interface. `groups` is a host array of one record per rank driven
// by this launch (n_groups of them; more than one only for ranks sharing a
// process), each of int64 values:
//   ring_all_gather: rank, x, out, right out, ready, right ready, then the
//                    8 link pointers (the three direct-route pointers 0 on
//                    the slot route)
//   ring_rs_update:  rank, gbuf, param, s1, s2, then the 8 link pointers
// with the link pointers in the order slot0, slot1, right slot0, right
// slot1, arrive, right arrive, credit, left credit. `n` is the shard's
// element count; `epoch` the leg's call counter (from 1); `vector` the
// width the host chose (1: bulk copies), which the call must allow (every
// offset and pointer 16-byte aligned), else cudaErrorInvalidValue and no
// launch. Both launch on `stream`, allocate nothing, and return
// cudaGetLastError() of the launch.

extern "C" int ring_blocks() { return kBlocks; }

extern "C" int ring_max_groups() { return kMaxGroups; }

extern "C" int ring_all_gather(const long long* groups, int n_groups,
                               int world, long long n, int esize, int direct,
                               int vector, unsigned epoch, int cooperative,
                               void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups || world < 2 ||
      (esize != 2 && esize != 4) || n < 0)
    return (int)cudaErrorInvalidValue;
  AgArgs a = {};
  a.world = world;
  a.esize = esize;
  a.epoch = epoch;
  a.n = n;
  bool aligned = (n * esize) % 16 == 0;
  for (int i = 0; i < n_groups; ++i) {
    const long long* v = groups + i * 14;
    a.g[i].rank = (int)v[0];
    a.g[i].x = reinterpret_cast<const char*>(v[1]);
    a.g[i].out = reinterpret_cast<char*>(v[2]);
    a.g[i].rout = reinterpret_cast<char*>(v[3]);
    a.g[i].ready = reinterpret_cast<unsigned*>(v[4]);
    a.g[i].rready = reinterpret_cast<unsigned*>(v[5]);
    read_link(v + 6, a.g[i].l);
    if (direct && (v[3] == 0 || v[4] == 0 || v[5] == 0))
      return (int)cudaErrorInvalidValue;
    for (int k = 1; k < 4; ++k) aligned = aligned && aligned16(v[k]);
    for (int k = 6; k < 10; ++k) aligned = aligned && aligned16(v[k]);
  }
  if (vector && !aligned) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vector)
    return (int)launch(direct ? (const void*)ring_ag_bulk_kernel<true>
                              : (const void*)ring_ag_bulk_kernel<false>,
                       a, n_groups, 32, kBarBytes + kAgStages * kAgTile,
                       cooperative, s);
  const void* kernel =
      esize == 2 ? (direct ? (const void*)ring_ag_kernel<unsigned short, true>
                           : (const void*)ring_ag_kernel<unsigned short, false>)
                 : (direct ? (const void*)ring_ag_kernel<unsigned int, true>
                           : (const void*)ring_ag_kernel<unsigned int, false>);
  return (int)launch(kernel, a, n_groups, kThreads, 0, cooperative, s);
}

extern "C" int ring_rs_update(const long long* groups, int n_groups,
                              int world, long long n, int grad_bf16,
                              int kind, const float* scalars, int initialized,
                              int nesterov, int vector, unsigned epoch,
                              int cooperative, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups || world < 2 || n < 0 ||
      kind < kSgd || kind > kAdamW)
    return (int)cudaErrorInvalidValue;
  RsArgs a = {};
  a.world = world;
  a.epoch = epoch;
  a.n = n;
  a.up.kind = kind;
  a.up.initialized = initialized;
  a.up.nesterov = nesterov;
  a.up.h = Hyper{scalars[0], scalars[1], scalars[2],  scalars[3],
                 scalars[4], scalars[5], scalars[6],  scalars[7],
                 scalars[8], scalars[9], scalars[10], scalars[11]};
  a.up.clip = nullptr;   // dear-fused takes no clip_norm
  const long long gsize = grad_bf16 ? 2 : 4;
  // a stage: the local tile, the hop (at most fp32) and, at the last hop,
  // the parameter and its state
  const int state = (kind != kSgd) + (kind == kAdamW);
  a.stride = (int)(kRsTile * (gsize + 8 + 4 * state) + 127) / 128 * 128;
  a.stages = kStageBytes / a.stride;
  a.depth = a.stages / 2;
  bool aligned = (n * gsize) % 16 == 0;
  // the scalar width's units of 4 elements: every chunk 4 * gsize-aligned,
  // the fp32 vectors and the slots 16-byte aligned
  bool quads = n % 4 == 0;
  for (int i = 0; i < n_groups; ++i) {
    const long long* v = groups + i * 13;
    a.g[i].rank = (int)v[0];
    a.g[i].gbuf = reinterpret_cast<const char*>(v[1]);
    a.g[i].p = reinterpret_cast<float*>(v[2]);
    a.g[i].s1 = reinterpret_cast<float*>(v[3]);
    a.g[i].s2 = reinterpret_cast<float*>(v[4]);
    read_link(v + 5, a.g[i].l);
    for (int k = 1; k < 9; ++k) aligned = aligned && aligned16(v[k]);
    quads = quads && v[1] % (4 * gsize) == 0;
    for (int k = 2; k < 9; ++k) quads = quads && aligned16(v[k]);
  }
  if (vector && !aligned) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vector)
    return (int)launch(grad_bf16
                           ? (const void*)ring_rs_bulk_kernel<__nv_bfloat16>
                           : (const void*)ring_rs_bulk_kernel<float>,
                       a, n_groups, kRsThreads,
                       kBarBytes + a.stages * a.stride, cooperative, s);
  const void* kernel =
      grad_bf16 ? (quads ? (const void*)ring_rs_kernel<__nv_bfloat16, 4>
                         : (const void*)ring_rs_kernel<__nv_bfloat16, 1>)
                : (quads ? (const void*)ring_rs_kernel<float, 4>
                         : (const void*)ring_rs_kernel<float, 1>);
  return (int)launch(kernel, a, n_groups, kThreads, 0, cooperative, s);
}

// Ring buffers and registered outputs: `bytes` of zeroed device memory on
// the current device and its IPC handle (ring_handle_size() bytes into
// `handle`; none when `handle` is null).
extern "C" int ring_handle_size() { return (int)sizeof(cudaIpcMemHandle_t); }

extern "C" int ring_alloc(long long bytes, void** ptr, void* handle) {
  cudaError_t err = cudaMalloc(ptr, (size_t)bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess && handle != nullptr)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  return (int)err;
}

extern "C" int ring_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int ring_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int ring_free(void* ptr) { return (int)cudaFree(ptr); }

extern "C" const char* ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
