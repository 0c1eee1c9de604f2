// The two ring collectives of mode "dear-fused" for Hopper (sm_90a):
//
//   K4, `ring_ag_kernel`: the ring all-gather of a flat shard, (n,) ->
//     (W*n,), chunk order = rank order. Replaces the TPU kernel
//     dear_pytorch_tpu/ops/collective_matmul.py::_ag_kernel (:218, via
//     `ring_all_gather` :240). Data movement only: bitwise equal to a tiled
//     all-gather.
//   K5 ring, `ring_rs_kernel`: the ring reduce-scatter of a bucket's
//     gradient with the partial sums travelling in fp32, fused with the
//     shard update at the last hop. Replaces the TPU kernel
//     _rs_update_kernel (:317, via `fused_reduce_scatter_update` :396).
//     Rank i's partial starts as its local chunk (i-1) mod W and, after the
//     receive of round r, holds chunk (i-1-r) mod W, to which it adds its
//     local copy (converted to fp32, one __fadd_rn: never contracted); at
//     r = W-1 the partial is chunk i summed over every rank, and the update
//     of csrc/shard_update.cuh (shared with csrc/fused_update.cu) runs on
//     the owned shard. Bitwise equal to the stacked plain version in
//     dear_pytorch_tpu_torch/ops/collective_matmul.py.
//
// Transport (what replaces pltpu.make_async_remote_copy and the DMA /
// REGULAR semaphores of `_ring_rounds` :130-193): each rank owns one ring
// buffer per leg, [slot 0 | slot 1 | arrive[2][kBlocks] | credit[2][kBlocks]],
// mapped into its neighbours through CUDA IPC (or, for W ranks in one
// process, plain pointers). Round r (1..W-1) of a rank reads its slot r%2;
// the hop that feeds it is written by the left neighbour straight into that
// slot with ordinary stores, then published with __threadfence_system() and
// a system-scope release store of the slot's arrival flag; the reader polls
// the flag with a system-scope acquire load and reads the slot through L2
// (ld.global.cg). When a reader has consumed a slot (copied it out and
// forwarded it), it raises the slot's credit flag in its LEFT neighbour's
// buffer, and the writer waits for that credit before it overwrites the
// slot. Every block owns one range of the chunk and its own pair of flags
// per slot, so a hop is complete per block and no grid-wide barrier is
// needed; the grid is kBlocks blocks per rank, so the compute stream keeps
// the rest of the SMs.
//
// Flags are never reset. The host passes the leg's call counter `epoch`
// (1, 2, ...; the same on every rank because every rank issues the same
// calls in the same order), and the hop into round h of call e carries the
// value e*W + h. A writer of hop h waits for the credit of the slot's
// previous use: hop h-2 of this call, or the last hop of the same parity of
// call e-1. So a fast rank's next call can never overwrite a slot that a
// slow rank still reads.
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
// What bounds it on this card: bytes. Per rank, K4 reads W-1 arriving
// chunks and its shard and writes W chunks of output and W-1 hops; K5 ring
// reads W local chunks (2 or 4 bytes per element) and W-1 fp32 partials,
// writes W-1 fp32 hops, and reads and writes the fp32 shard and its state.
// The design: 16-byte accesses where every pointer is aligned, four in
// flight per thread; kBlocks blocks of kThreads threads per rank.
//
// Built by dear_pytorch_tpu_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface; called through ctypes by
// dear_pytorch_tpu_torch/ops/collective_matmul.py and comm/ring.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include "ring_sync.cuh"
#include "shard_update.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocks = kRingBlocks;  // blocks per rank, and flags per slot
constexpr int kMaxGroups = 8;         // ranks in one launch (a LocalRing)

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
  Link l;
};

struct AgArgs {
  AgGroup g[kMaxGroups];
  int world;
  int esize;
  int vec;
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
  int vec;
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

// Round r's waits (thread 0), then a block barrier.
__device__ __forceinline__ void round_waits(const Link& l, unsigned e,
                                            int world, int rank, int r) {
  if (threadIdx.x == 0) {
    const int b = blockIdx.x;
    if (r >= 1)
      spin_until(l.arrive + (r & 1) * kBlocks + b, hop_val(e, world, r),
                 "arrival", rank, r);
    if (r < world - 1)
      spin_until(l.credit + ((r + 1) & 1) * kBlocks + b,
                 credit_need(e, world, r + 1), "credit", rank, r);
  }
  __syncthreads();
}

// Round r's signals, after every thread of the block has written its part.
__device__ __forceinline__ void round_signals(const Link& l, unsigned e,
                                              int world, int r) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const int b = blockIdx.x;
    __threadfence_system();
    if (r < world - 1)
      st_release_sys(l.rarrive + ((r + 1) & 1) * kBlocks + b,
                     hop_val(e, world, r + 1));
    if (r >= 1)
      st_release_sys(l.lcredit + (r & 1) * kBlocks + b, hop_val(e, world, r));
  }
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
// K4: ring all-gather
// ---------------------------------------------------------------------------

// Copy units [lo, hi) of `src` (a slot, read through L2, or the local
// shard) to `out` and, when `fwd` is set, to the right neighbour's slot.
template <typename U>
__device__ __forceinline__ void ag_pass(const U* __restrict__ src,
                                        bool from_slot, U* __restrict__ out,
                                        U* __restrict__ fwd, long long lo,
                                        long long hi) {
  const long long bd = blockDim.x;
  long long i = lo + threadIdx.x;
  for (; i + 3 * bd < hi; i += 4 * bd) {
    U v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = from_slot ? __ldcg(src + i + k * bd) : src[i + k * bd];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[i + k * bd] = v[k];
      if (fwd) __stcg(fwd + i + k * bd, v[k]);
    }
  }
  for (; i < hi; i += bd) {
    const U v = from_slot ? __ldcg(src + i) : src[i];
    out[i] = v;
    if (fwd) __stcg(fwd + i, v);
  }
}

template <typename U>
__device__ __forceinline__ void ag_round(const char* src, bool from_slot,
                                         char* out, char* fwd,
                                         long long lo_b, long long hi_b) {
  ag_pass<U>(reinterpret_cast<const U*>(src), from_slot,
             reinterpret_cast<U*>(out), reinterpret_cast<U*>(fwd),
             lo_b / (long long)sizeof(U), hi_b / (long long)sizeof(U));
}

__global__ void __launch_bounds__(kThreads, 2)
ring_ag_kernel(const AgArgs a) {
  const AgGroup& g = a.g[blockIdx.y];
  const int W = a.world, my = g.rank;
  long long lo, hi;
  block_range(a.n, lo, hi);
  const long long chunk = a.n * a.esize;
  for (int r = 0; r < W; ++r) {
    round_waits(g.l, a.epoch, W, my, r);
    const char* src = r == 0 ? g.x : g.l.slot[r & 1];
    char* out = g.out + (long long)((my - r + W) % W) * chunk;
    char* fwd = r < W - 1 ? g.l.rslot[(r + 1) & 1] : nullptr;
    const long long lo_b = lo * a.esize, hi_b = hi * a.esize;
    if (a.vec)
      ag_round<uint4>(src, r > 0, out, fwd, lo_b, hi_b);
    else if (a.esize == 2)
      ag_round<unsigned short>(src, r > 0, out, fwd, lo_b, hi_b);
    else
      ag_round<unsigned int>(src, r > 0, out, fwd, lo_b, hi_b);
    round_signals(g.l, a.epoch, W, r);
  }
}

// ---------------------------------------------------------------------------
// K5 ring: reduce-scatter + update
// ---------------------------------------------------------------------------

template <typename G>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;  // 4 bf16 values
};

// acc = partial + f32(local), elementwise over 4 values
template <typename G>
__device__ __forceinline__ float4 add4(float4 acc, typename Vec4<G>::type l) {
  const G* e = reinterpret_cast<const G*>(&l);
  acc.x = __fadd_rn(acc.x, to_f32(e[0]));
  acc.y = __fadd_rn(acc.y, to_f32(e[1]));
  acc.z = __fadd_rn(acc.z, to_f32(e[2]));
  acc.w = __fadd_rn(acc.w, to_f32(e[3]));
  return acc;
}

template <typename G>
__device__ __forceinline__ float4 to4(typename Vec4<G>::type l) {
  const G* e = reinterpret_cast<const G*>(&l);
  return make_float4(to_f32(e[0]), to_f32(e[1]), to_f32(e[2]), to_f32(e[3]));
}

// A hop: fwd[i] = (in ? in[i] + f32(loc[i]) : f32(loc[i])) over [lo, hi).
template <typename G>
__device__ void rs_hop(const G* __restrict__ loc, const float* __restrict__ in,
                       float* __restrict__ fwd, long long lo, long long hi,
                       int vec) {
  const long long bd = blockDim.x;
  if (vec) {
    using V = typename Vec4<G>::type;
    const V* l4 = reinterpret_cast<const V*>(loc);
    const float4* i4 = reinterpret_cast<const float4*>(in);
    float4* f4 = reinterpret_cast<float4*>(fwd);
    long long q = lo / 4 + threadIdx.x;
    const long long qe = hi / 4;
    for (; q + 3 * bd < qe; q += 4 * bd) {
      V lv[4];
      float4 iv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        lv[k] = l4[q + k * bd];
        if (in) iv[k] = __ldcg(i4 + q + k * bd);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        __stcg(f4 + q + k * bd, in ? add4<G>(iv[k], lv[k]) : to4<G>(lv[k]));
    }
    for (; q < qe; q += bd)
      __stcg(f4 + q, in ? add4<G>(__ldcg(i4 + q), l4[q]) : to4<G>(l4[q]));
    return;
  }
  for (long long i = lo + threadIdx.x; i < hi; i += bd) {
    const float l = to_f32(loc[i]);
    __stcg(fwd + i, in ? __fadd_rn(__ldcg(in + i), l) : l);
  }
}

// The last hop: the full sum of the owned chunk, then the shard update.
template <typename G>
__device__ void rs_update(const Args& up, const G* __restrict__ loc,
                          const float* __restrict__ in, float* __restrict__ p,
                          float* __restrict__ s1, float* __restrict__ s2,
                          long long lo, long long hi, int vec) {
  const bool one = up.kind != kSgd;
  const bool two = up.kind == kAdamW;
  const long long bd = blockDim.x;
  if (vec) {
    using V = typename Vec4<G>::type;
    const V* l4 = reinterpret_cast<const V*>(loc);
    const float4* i4 = reinterpret_cast<const float4*>(in);
    for (long long q = lo / 4 + threadIdx.x; q < hi / 4; q += bd) {
      const float4 acc = add4<G>(__ldcg(i4 + q), l4[q]);
      float4 pv = reinterpret_cast<float4*>(p)[q];
      float4 av = one ? reinterpret_cast<float4*>(s1)[q]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 bv = two ? reinterpret_cast<float4*>(s2)[q]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      const float* ge = reinterpret_cast<const float*>(&acc);
      float* pe = reinterpret_cast<float*>(&pv);
      float* ae = reinterpret_cast<float*>(&av);
      float* be = reinterpret_cast<float*>(&bv);
#pragma unroll
      for (int k = 0; k < 4; ++k) update_one(up, 1.f, ge[k], pe[k], ae[k], be[k]);
      reinterpret_cast<float4*>(p)[q] = pv;
      if (one) reinterpret_cast<float4*>(s1)[q] = av;
      if (two) reinterpret_cast<float4*>(s2)[q] = bv;
    }
    return;
  }
  for (long long i = lo + threadIdx.x; i < hi; i += bd) {
    const float acc = __fadd_rn(__ldcg(in + i), to_f32(loc[i]));
    float pe = p[i];
    float ae = one ? s1[i] : 0.f;
    float be = two ? s2[i] : 0.f;
    update_one(up, 1.f, acc, pe, ae, be);
    p[i] = pe;
    if (one) s1[i] = ae;
    if (two) s2[i] = be;
  }
}

template <typename G>
__global__ void __launch_bounds__(kThreads, 2)
ring_rs_kernel(const RsArgs a) {
  const RsGroup& g = a.g[blockIdx.y];
  const int W = a.world, my = g.rank;
  long long lo, hi;
  block_range(a.n, lo, hi);
  const G* gbuf = reinterpret_cast<const G*>(g.gbuf);
  for (int r = 0; r < W; ++r) {
    round_waits(g.l, a.epoch, W, my, r);
    const int c = ((my - 1 - r) % W + 2 * W) % W;   // the chunk of round r
    const G* loc = gbuf + (long long)c * a.n;
    const float* in =
        r == 0 ? nullptr : reinterpret_cast<const float*>(g.l.slot[r & 1]);
    if (r < W - 1)
      rs_hop<G>(loc, in, reinterpret_cast<float*>(g.l.rslot[(r + 1) & 1]),
                lo, hi, a.vec);
    else
      rs_update<G>(a.up, loc, in, g.p, g.s1, g.s2, lo, hi, a.vec);
    round_signals(g.l, a.epoch, W, r);
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

// One launch of `kernel` over n_groups ranks. A cooperative launch (all
// blocks resident at once, checked here and again at launch) when one
// process drives several ranks, whose blocks wait on each other.
template <typename A>
cudaError_t launch(const void* kernel, const A& a, int n_groups,
                   int cooperative, cudaStream_t stream) {
  const dim3 grid(kBlocks, n_groups), block(kThreads);
  if (!cooperative) {
    void* args[] = {const_cast<A*>(&a)};
    cudaError_t err = cudaLaunchKernel(kernel, grid, block, args, 0, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * sms < (long long)kBlocks * n_groups)
    return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<A*>(&a)};
  err = cudaLaunchCooperativeKernel(kernel, grid, block, args, 0, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The C interface. `groups` is a host array of one record per rank driven
// by this launch (n_groups of them; more than one only for ranks sharing a
// process), each of int64 values:
//   ring_all_gather: rank, x, out, then the 8 link pointers
//   ring_rs_update:  rank, gbuf, param, s1, s2, then the 8 link pointers
// with the link pointers in the order slot0, slot1, right slot0, right
// slot1, arrive, right arrive, credit, left credit. `n` is the shard's
// element count; `epoch` the leg's call counter (from 1). Both launch on
// `stream`, allocate nothing, and return cudaGetLastError() of the launch.

extern "C" int ring_blocks() { return kBlocks; }

extern "C" int ring_max_groups() { return kMaxGroups; }

extern "C" int ring_all_gather(const long long* groups, int n_groups,
                               int world, long long n, int esize,
                               unsigned epoch, int cooperative,
                               void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups || world < 2 ||
      (esize != 2 && esize != 4) || n < 0)
    return (int)cudaErrorInvalidValue;
  AgArgs a = {};
  a.world = world;
  a.esize = esize;
  a.epoch = epoch;
  a.n = n;
  a.vec = (n * esize) % 16 == 0;
  for (int i = 0; i < n_groups; ++i) {
    const long long* v = groups + i * 11;
    a.g[i].rank = (int)v[0];
    a.g[i].x = reinterpret_cast<const char*>(v[1]);
    a.g[i].out = reinterpret_cast<char*>(v[2]);
    read_link(v + 3, a.g[i].l);
    a.vec = a.vec && aligned16(v[1]) && aligned16(v[2]) &&
            aligned16(v[3]) && aligned16(v[4]) && aligned16(v[5]) &&
            aligned16(v[6]);
  }
  return (int)launch((const void*)ring_ag_kernel, a, n_groups, cooperative,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int ring_rs_update(const long long* groups, int n_groups,
                              int world, long long n, int grad_bf16,
                              int kind, const float* scalars, int initialized,
                              int nesterov, unsigned epoch, int cooperative,
                              void* stream) {
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
  a.vec = n % 4 == 0;
  const long long gsize = grad_bf16 ? 2 : 4;
  for (int i = 0; i < n_groups; ++i) {
    const long long* v = groups + i * 13;
    a.g[i].rank = (int)v[0];
    a.g[i].gbuf = reinterpret_cast<const char*>(v[1]);
    a.g[i].p = reinterpret_cast<float*>(v[2]);
    a.g[i].s1 = reinterpret_cast<float*>(v[3]);
    a.g[i].s2 = reinterpret_cast<float*>(v[4]);
    read_link(v + 5, a.g[i].l);
    a.vec = a.vec && v[1] % (4 * gsize) == 0 && aligned16(v[2]) &&
            aligned16(v[3]) && aligned16(v[4]) && aligned16(v[5]) &&
            aligned16(v[6]) && aligned16(v[7]) && aligned16(v[8]);
  }
  const void* kernel = grad_bf16 ? (const void*)ring_rs_kernel<__nv_bfloat16>
                                 : (const void*)ring_rs_kernel<float>;
  return (int)launch(kernel, a, n_groups, cooperative,
                     static_cast<cudaStream_t>(stream));
}

// Ring buffers: `bytes` of zeroed device memory on the current device and
// its IPC handle (ring_handle_size() bytes into `handle`).
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
