// The ring collective matmul for Hopper (sm_90a): a product with a weight
// whose rows are sharded over the ring, the shards streaming around the
// ring inside the kernel. W ranks; rank `my` holds the row shard
// w_shard = w[my*kc : (my+1)*kc, :] of a [K = W*kc, N] weight.
//
//   K6, `cm_fwd`: y = x @ all_gather(w_shard), x [M, K], y [M, N]. Starts on
//     the local shard; the chunk that arrives in round r is owner j = (my-r)
//     mod W's, and adds x[:, j*kc:(j+1)*kc] @ w_j. Replaces the TPU kernel
//     dear_pytorch_tpu/ops/collective_matmul.py::_cm_fwd_kernel (:510, via
//     `allgather_matmul` :631).
//   K7, `cm_dx`: dx[:, j*kc:(j+1)*kc] = dy @ w_jᵀ as the shards re-stream,
//     dy [M, N], dx [M, K]. Replaces _cm_dx_kernel (:545).
//   K8, `cm_dw`: the ring reduce-scatter of xᵀ·dy. Round r adds this rank's
//     block for chunk c = (my-1-r) mod W, x[:, c*kc:(c+1)*kc]ᵀ @ dy, to the
//     fp32 partial from the left and passes it right; after round W-1 the
//     partial is chunk `my` summed over every rank, cast to the weight's
//     dtype: dw_shard [kc, N]. Chunk c's sum thus starts at rank c+1 and
//     adds the ranks in ring order. Replaces _cm_dw_kernel (:572).
// Products accumulate in fp32 and are stored in the inputs' dtype (K8's
// partials travel in fp32). bf16 inputs run on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate); fp32 inputs on the CUDA cores (fmaf;
// never TF32, which would change the numbers).
//
// What bounds them on this card: operations. At the GPT-2 small training
// shapes (M = 8192 tokens per rank, K = 768, W = 2, N = 768 or 3072) each
// call does 2·M·K·N = 9.66 or 38.65 GFLOP on 13–70 MB: over 500 operations
// per byte, above the card's 295 for bf16. The design is a simple tiled
// product: 256 threads, one output tile per step of a block-stride loop
// (128 x 128 for K6 and K7, 64 x 64 for K8, whose output is only kc x N),
// k-slabs of 32 staged through registers into a double-buffered shared
// tile stored as the operand lies in memory (16-byte loads through L2);
// fragments come from shared memory with 32-bit loads where the reduction
// dimension is contiguous and with ldmatrix.trans where it is not. No TMA
// and no wgmma yet: that is the later, faster kernel.
//
// Transport (the "cm" leg of dear_pytorch_tpu_torch/comm/ring.py; the
// protocol of csrc/ring.cu, with one slot per hop): each rank's leg buffer
// is [arrive[kMaxHops][kMaxBlocks] | credit[kMaxHops][kMaxBlocks] | pad to
// kHeader | slot 1 | ... | slot W-1], mapped into its neighbours through
// CUDA IPC (or, for W ranks in one process, plain pointers). Hop h (1..W-1)
// of a call lands in the receiver's slot h: K6 and K7 pass the weight
// chunks on (block b copies its byte range of the chunk), K8 its fp32
// partials (block b its own output tiles). A writer stores the hop into
// the right neighbour's slot, then __threadfence_system() and a
// system-scope release store of its arrival flag (the call's epoch, the
// leg's call counter: the same on every rank because every rank issues its
// ring matmuls in the same order). A K6/K7 block needs the whole chunk, so
// it waits for the arrival flags of all the sender's blocks (one thread per
// flag, system-scope acquire loads; the slot is then read through L2 with
// ld.global.cg); a K8 block only for the one sender block that computed the
// same tiles. A slot is read again for every tile, so it is released only
// when the call ends: each block raises its credit flag in its left
// neighbour's buffer for every slot, and a writer of hop h in call e first
// waits for all the reader's blocks' credits of call e-1 (any of K6-K8 may
// have used the slot then). Flags are never reset.
//
// Co-residency. A block that waits on a peer's flags holds its SM while it
// spins, so a rank's waiting blocks must never keep the blocks it waits for
// (on its peer, and through the peer on itself) from running. With W ranks
// in one process (a LocalRing) every launch is cooperative: all blocks of
// all ranks are resident at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// is checked first), G = SMs / W blocks per rank. With one rank per process
// (a Ring: ranks with cards of their own, or two processes time-slicing
// one card) a rank's kernels of this file run on its compute stream and
// K4 / the K5 ring (kRingBlocks blocks) on its comm stream, at most one of
// each in flight; nothing else in the process spins. The grid is G = SMs -
// kRingBlocks blocks, each needing one SM's room at most (occupancy >= 1 is
// checked), so whichever of the two launches first, the other still finds
// enough SMs that hold none of the first's blocks: both are always fully
// resident together and every flag they wait for is raised by a block that
// runs. Contexts of two processes on one card time-slice and are
// preempted whole, so a context's spinning blocks only delay the other.
// G depends only on the card and the ring, so every call on a ring uses
// the same blocks and flags.
//
// Built by dear_pytorch_tpu_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface; called through ctypes by
// dear_pytorch_tpu_torch/ops/collective_matmul.py and comm/ring.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "ring_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 8;                 // ranks in one launch
constexpr int kMaxHops = kMaxGroups - 1;
constexpr int kMaxBlocks = 256;               // flags per slot
constexpr long long kCreditOff = (long long)kMaxHops * kMaxBlocks * 4;
constexpr long long kHeader = 16384;          // flags, padded
static_assert(2 * kCreditOff <= kHeader, "flags overflow the header");
constexpr int kBK = 32;                       // k-slab
constexpr int kPad = 8;                       // shared-row padding, elements

using bf16 = __nv_bfloat16;

enum Kind { kFwd = 0, kDx = 1, kDw = 2 };

struct CmGroup {
  int rank;
  const char* a;   // K6: x;  K7: dy;     K8: x
  const char* b;   // K6: w;  K7: w;      K8: dy
  char* out;       // K6: y;  K7: dx;     K8: dw
  char* own;       // this rank's leg buffer
  char* right;     // the right neighbour's
  char* left;      // the left neighbour's
};

struct CmArgs {
  CmGroup g[kMaxGroups];
  int world;
  int vec;                 // 16-byte operand loads and paired stores
  unsigned epoch;
  long long m, kc, n;      // K = world * kc
  long long slot_bytes;
};

__device__ __forceinline__ unsigned* arrive_flags(char* buf, int hop) {
  return reinterpret_cast<unsigned*>(buf) + (hop - 1) * kMaxBlocks;
}

__device__ __forceinline__ unsigned* credit_flags(char* buf, int hop) {
  return reinterpret_cast<unsigned*>(buf + kCreditOff) +
         (hop - 1) * kMaxBlocks;
}

__device__ __forceinline__ char* slot(char* buf, int hop, long long bytes) {
  return buf + kHeader + (long long)(hop - 1) * bytes;
}

// Every thread i < gridDim.x waits for flags[i] >= want; then a barrier.
__device__ void wait_all(const unsigned* flags, unsigned want,
                         const char* what, int rank, int round) {
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x)
    spin_until(flags + i, want, what, rank, round);
  __syncthreads();
}

// After every thread of the block has written its part: publish it.
__device__ __forceinline__ void signal(unsigned* flag, unsigned v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release_sys(flag, v);
  }
}

// The end of a call: this block is done with every slot it read.
__device__ void release_slots(const CmGroup& g, int world, unsigned e) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int h = 1; h < world; ++h)
      st_release_sys(credit_flags(g.left, h) + blockIdx.x, e);
  }
}

// Copy bytes [lo, hi) of src to dst (a neighbour's slot), src read
// through L2 when it is a slot.
__device__ void copy_range(char* dst, const char* src, long long lo,
                           long long hi) {
  const long long bd = blockDim.x;
  const bool v16 = (((uintptr_t)src | (uintptr_t)dst) & 15) == 0 &&
                   lo % 16 == 0;
  long long i = lo;
  if (v16) {
    const long long q_hi = lo + (hi - lo) / 16 * 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long q = lo / 16 + threadIdx.x; q < q_hi / 16; q += bd)
      __stcg(d4 + q, __ldcg(s4 + q));
    i = q_hi;
  }
  for (long long j = i + threadIdx.x; j < hi; j += bd)
    dst[j] = __ldcg(reinterpret_cast<const signed char*>(src) + j);
}

// This block's byte range of a chunk of `bytes` bytes: 16-byte multiples.
__device__ __forceinline__ void byte_range(long long bytes, long long& lo,
                                           long long& hi) {
  const long long per = ((bytes + gridDim.x - 1) / gridDim.x + 15) / 16 * 16;
  lo = min(bytes, (long long)blockIdx.x * per);
  hi = min(bytes, lo + per);
}

// ---------------------------------------------------------------------------
// the tile product
// ---------------------------------------------------------------------------

template <typename T>
struct Raw;
template <>
struct Raw<bf16> {
  using type = unsigned short;
};
template <>
struct Raw<float> {
  using type = unsigned int;
};

// An operand slab as it lies in memory: R rows of C contiguous elements,
// row stride `ld`; only rows < rlim and columns < clim exist (zeros
// beyond). `k_in_cols`: the reduction dimension runs along the columns, so
// the next slab is kBK columns on, else kBK rows down.
template <typename T>
struct Operand {
  const T* p;
  long long ld;
  long long rlim, clim;
  bool k_in_cols;

  __device__ void advance() {
    if (k_in_cols) {
      p += kBK;
      clim -= kBK;
    } else {
      p += kBK * ld;
      rlim -= kBK;
    }
  }
};

// Global -> registers -> shared for one R x C slab (shared rows padded to
// C + kPad elements), 16-byte vectors.
template <typename T, int R, int C>
struct Slab {
  static constexpr int VE = 16 / sizeof(T);
  static constexpr int NV = R * C / VE / kThreads;
  static_assert(NV >= 1 && (R * C / VE) % kThreads == 0, "slab size");
  static constexpr int SIZE = R * (C + kPad);
  uint4 v[NV];

  __device__ void load(const Operand<T>& o, bool vec) {
    using U = typename Raw<T>::type;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (C / VE), c = (idx % (C / VE)) * VE;
      const T* src = o.p + r * o.ld + c;
      if (vec) {
        v[i] = (r < o.rlim && c < o.clim)
                   ? __ldcg(reinterpret_cast<const uint4*>(src))
                   : make_uint4(0, 0, 0, 0);
      } else {
        union {
          uint4 all;
          U e[VE];
        } u;
#pragma unroll
        for (int q = 0; q < VE; ++q)
          u.e[q] = (r < o.rlim && c + q < o.clim)
                       ? __ldcg(reinterpret_cast<const U*>(src) + q)
                       : (U)0;
        v[i] = u.all;
      }
    }
  }

  __device__ void store(T* s) const {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (C / VE), c = (idx % (C / VE)) * VE;
      *reinterpret_cast<uint4*>(s + r * (C + kPad) + c) = v[i];
    }
  }
};

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The accumulators of one BM x BN tile, bf16 operands on the tensor cores.
// 8 warps as 2 (rows) x 4 (columns). AK: A's slab is [m][k] (else [k][m]);
// BKM: B's slab is [n][k] (else [k][n]).
template <int BM, int BN, bool AK, bool BKM>
struct MmaTile {
  static constexpr int WTM = BM / 2, WTN = BN / 4;
  static constexpr int MI = WTM / 16, NI = WTN / 8;
  static_assert(MI >= 1 && NI >= 2 && NI % 2 == 0, "warp tile");
  static constexpr int SA = AK ? kBK + kPad : BM + kPad;  // slab row length
  static constexpr int SB = BKM ? kBK + kPad : BN + kPad;
  float c[MI][NI][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) c[i][j][q] = 0.f;
  }

  __device__ void step(const bf16* As, const bf16* Bs) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 4, wn = warp % 4;
    const int g = lane >> 2, t = lane & 3;
    const int q = lane >> 3, i8 = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int row = wm * WTM + mi * 16;
        if (AK) {
          const bf16* p = As + (row + g) * SA + kk + 2 * t;
          a[mi][0] = lds32(p);
          a[mi][1] = lds32(p + 8 * SA);
          a[mi][2] = lds32(p + 8);
          a[mi][3] = lds32(p + 8 * SA + 8);
        } else {
          ldsm_x4_trans(a[mi], As + (kk + i8 + ((q & 2) ? 8 : 0)) * SA +
                                   row + ((q & 1) ? 8 : 0));
        }
      }
#pragma unroll
      for (int ni = 0; ni < NI; ni += 2) {
        const int col = wn * WTN + ni * 8;
        if (BKM) {
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const bf16* p = Bs + (col + 8 * d + g) * SB + kk + 2 * t;
            b[ni + d][0] = lds32(p);
            b[ni + d][1] = lds32(p + 8);
          }
        } else {
          uint32_t r[4];
          ldsm_x4_trans(r, Bs + (kk + i8 + ((q & 1) ? 8 : 0)) * SB + col +
                               ((q & 2) ? 8 : 0));
          b[ni][0] = r[0];
          b[ni][1] = r[1];
          b[ni + 1][0] = r[2];
          b[ni + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_bf16(c[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }

  // emit(row, col, v0, v1): columns col and col + 1 of row (tile-relative)
  template <class E>
  __device__ void epilogue(E&& emit) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 4, wn = warp % 4;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int row = wm * WTM + mi * 16 + g, col = wn * WTN + ni * 8 + 2 * t;
        emit(row, col, c[mi][ni][0], c[mi][ni][1]);
        emit(row + 8, col, c[mi][ni][2], c[mi][ni][3]);
      }
  }
};

// The same for fp32 operands on the CUDA cores: each thread owns a
// (BM/16) x (BN/16) block of the tile.
template <int BM, int BN, bool AK, bool BKM>
struct FmaTile {
  static constexpr int TM = BM / 16, TN = BN / 16;
  static_assert(TN % 2 == 0, "thread tile");
  static constexpr int SA = AK ? kBK + kPad : BM + kPad;
  static constexpr int SB = BKM ? kBK + kPad : BN + kPad;
  float c[TM][TN];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) c[i][j] = 0.f;
  }

  __device__ void step(const float* As, const float* Bs) {
    const int r0 = (threadIdx.x / 16) * TM, c0 = (threadIdx.x % 16) * TN;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = AK ? As[(r0 + i) * SA + k] : As[k * SA + r0 + i];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = BKM ? Bs[(c0 + j) * SB + k] : Bs[k * SB + c0 + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  template <class E>
  __device__ void epilogue(E&& emit) const {
    const int r0 = (threadIdx.x / 16) * TM, c0 = (threadIdx.x % 16) * TN;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; j += 2) emit(r0 + i, c0 + j, c[i][j], c[i][j + 1]);
  }
};

template <typename T, int BM, int BN, bool AK, bool BKM>
struct Gemm {
  using Tile = typename std::conditional<std::is_same<T, bf16>::value,
                                         MmaTile<BM, BN, AK, BKM>,
                                         FmaTile<BM, BN, AK, BKM>>::type;
  using SlabA = Slab<T, AK ? BM : kBK, AK ? kBK : BM>;
  using SlabB = Slab<T, BKM ? BN : kBK, BKM ? kBK : BN>;
  static constexpr int STAGE = SlabA::SIZE + SlabB::SIZE;
};

// acc += A (rows m of the tile) x B (columns n of the tile) over a
// reduction of `kd`, through the two shared stages at `smem`.
template <class G, typename T>
__device__ void gemm_tile(typename G::Tile& acc, Operand<T> a, Operand<T> b,
                          long long kd, bool vec, T* smem) {
  typename G::SlabA la;
  typename G::SlabB lb;
  const int nk = (int)((kd + kBK - 1) / kBK);
  if (nk == 0) return;
  la.load(a, vec);
  lb.load(b, vec);
  la.store(smem);
  lb.store(smem + G::SlabA::SIZE);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    T* cur = smem + (kt & 1) * G::STAGE;
    T* nxt = smem + ((kt + 1) & 1) * G::STAGE;
    if (kt + 1 < nk) {
      a.advance();
      b.advance();
      la.load(a, vec);
      lb.load(b, vec);
    }
    acc.step(cur, cur + G::SlabA::SIZE);
    if (kt + 1 < nk) {
      la.store(nxt);
      lb.store(nxt + G::SlabA::SIZE);
    }
    __syncthreads();
  }
}

// Store v0, v1 (columns col, col + 1) at p (column col), as T, each only
// where col + i < clim.
template <typename T>
__device__ __forceinline__ void store2(T* p, long long clim, int col,
                                       float v0, float v1, bool pair) {
  if constexpr (std::is_same<T, bf16>::value) {
    bf16* q = reinterpret_cast<bf16*>(p);
    if (pair && col + 1 < clim) {
      *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(v0, v1);
      return;
    }
    if (col < clim) q[0] = __float2bfloat16_rn(v0);
    if (col + 1 < clim) q[1] = __float2bfloat16_rn(v1);
  } else {
    float* q = reinterpret_cast<float*>(p);
    if (pair && col + 1 < clim) {
      *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
      return;
    }
    if (col < clim) q[0] = v0;
    if (col + 1 < clim) q[1] = v1;
  }
}

// ---------------------------------------------------------------------------
// the three kernels
// ---------------------------------------------------------------------------

// Make round r's weight chunk readable in this rank (r = 0: the local
// shard; r >= 1: slot r, once every sender block has delivered), and pass
// this block's byte range of it on as hop r + 1.
template <typename T>
__device__ void chunk_round(const CmArgs& a, const CmGroup& g, int r) {
  const int W = a.world;
  const unsigned e = a.epoch;
  if (r >= 1) wait_all(arrive_flags(g.own, r), e, "cm arrival", g.rank, r);
  if (r < W - 1) {
    if (e > 1)
      wait_all(credit_flags(g.own, r + 1), e - 1, "cm credit", g.rank, r);
    long long lo, hi;
    byte_range(a.kc * a.n * (long long)sizeof(T), lo, hi);
    const char* src = r == 0 ? g.b : slot(g.own, r, a.slot_bytes);
    copy_range(slot(g.right, r + 1, a.slot_bytes), src, lo, hi);
    signal(arrive_flags(g.right, r + 1) + blockIdx.x, e);
  }
}

template <typename T>
__device__ __forceinline__ const T* chunk_of(const CmArgs& a,
                                             const CmGroup& g, int r) {
  return reinterpret_cast<const T*>(r == 0 ? g.b
                                           : slot(g.own, r, a.slot_bytes));
}

// K6: y tile by tile, each tile over every round (the first tile's rounds
// bring the chunks in and pass them on).
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1) cm_fwd(const CmArgs a) {
  using G = Gemm<T, BM, BN, true, false>;
  __shared__ __align__(16) T smem[2 * G::STAGE];
  const CmGroup& g = a.g[blockIdx.y];
  const int W = a.world, my = g.rank;
  const long long M = a.m, kc = a.kc, N = a.n, K = W * kc;
  const T* x = reinterpret_cast<const T*>(g.a);
  T* y = reinterpret_cast<T*>(g.out);
  const long long tn = (N + BN - 1) / BN;
  const long long tiles = (M + BM - 1) / BM * tn;
  int ready = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long m0 = t / tn * BM, n0 = t % tn * BN;
    typename G::Tile acc;
    acc.zero();
    for (int r = 0; r < W; ++r) {
      if (r >= ready) {
        chunk_round<T>(a, g, r);
        ready = r + 1;
      }
      const long long j = (my - r + W) % W;
      Operand<T> A{x + m0 * K + j * kc, K, M - m0, kc, true};
      Operand<T> B{chunk_of<T>(a, g, r) + n0, N, kc, N - n0, false};
      gemm_tile<G>(acc, A, B, kc, a.vec, smem);
    }
    acc.epilogue([&](int row, int col, float v0, float v1) {
      if (m0 + row < M)
        store2<T>(y + (m0 + row) * N + n0 + col, N - n0, col, v0, v1, a.vec);
    });
  }
  for (int r = ready; r < W; ++r) chunk_round<T>(a, g, r);
  release_slots(g, W, a.epoch);
}

// K7: round by round, the dx column block of the chunk that round brings.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1) cm_dx(const CmArgs a) {
  using G = Gemm<T, BM, BN, true, true>;
  __shared__ __align__(16) T smem[2 * G::STAGE];
  const CmGroup& g = a.g[blockIdx.y];
  const int W = a.world, my = g.rank;
  const long long M = a.m, kc = a.kc, N = a.n, K = W * kc;
  const T* dy = reinterpret_cast<const T*>(g.a);
  T* dx = reinterpret_cast<T*>(g.out);
  const long long tn = (kc + BN - 1) / BN;
  const long long tiles = (M + BM - 1) / BM * tn;
  for (int r = 0; r < W; ++r) {
    chunk_round<T>(a, g, r);
    const long long j = (my - r + W) % W;
    const T* w = chunk_of<T>(a, g, r);
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long m0 = t / tn * BM, i0 = t % tn * BN;
      typename G::Tile acc;
      acc.zero();
      Operand<T> A{dy + m0 * N, N, M - m0, N, true};
      Operand<T> B{w + i0 * N, N, kc - i0, N, true};
      gemm_tile<G>(acc, A, B, N, a.vec, smem);
      T* o = dx + j * kc + i0;
      acc.epilogue([&](int row, int col, float v0, float v1) {
        if (m0 + row < M)
          store2<T>(o + (m0 + row) * K + col, kc - i0, col, v0, v1, a.vec);
      });
    }
  }
  release_slots(g, W, a.epoch);
}

// K8: round by round, this rank's xᵀ·dy block of that round's chunk plus
// the partial from the left, passed right (or, in the last round, dw).
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1) cm_dw(const CmArgs a) {
  using G = Gemm<T, BM, BN, false, false>;
  __shared__ __align__(16) T smem[2 * G::STAGE];
  const CmGroup& g = a.g[blockIdx.y];
  const int W = a.world, my = g.rank;
  const unsigned e = a.epoch;
  const long long M = a.m, kc = a.kc, N = a.n, K = W * kc;
  const T* x = reinterpret_cast<const T*>(g.a);
  const T* dy = reinterpret_cast<const T*>(g.b);
  T* dw = reinterpret_cast<T*>(g.out);
  const long long tn = (N + BN - 1) / BN;
  const long long tiles = (kc + BM - 1) / BM * tn;
  for (int r = 0; r < W; ++r) {
    const long long c = ((my - 1 - r) % W + 2 * W) % W;
    const float* in =
        r == 0 ? nullptr
               : reinterpret_cast<const float*>(slot(g.own, r, a.slot_bytes));
    float* fwd = r < W - 1 ? reinterpret_cast<float*>(
                                 slot(g.right, r + 1, a.slot_bytes))
                           : nullptr;
    bool waited = false;
    if (fwd != nullptr && e > 1)
      wait_all(credit_flags(g.own, r + 1), e - 1, "cm credit", my, r);
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long i0 = t / tn * BM, n0 = t % tn * BN;
      typename G::Tile acc;
      acc.zero();
      Operand<T> A{x + c * kc + i0, K, M, kc - i0, false};
      Operand<T> B{dy + n0, N, M, N - n0, false};
      gemm_tile<G>(acc, A, B, M, a.vec, smem);
      if (in != nullptr && !waited) {   // the sender block of these tiles
        if (threadIdx.x == 0)
          spin_until(arrive_flags(g.own, r) + blockIdx.x, e, "cm arrival",
                     my, r);
        __syncthreads();
        waited = true;
      }
      acc.epilogue([&](int row, int col, float v0, float v1) {
        const long long i = i0 + row, n = n0 + col;
        if (i >= kc) return;
        if (in != nullptr) {
          if (n < N) v0 = __fadd_rn(v0, __ldcg(in + i * N + n));
          if (n + 1 < N) v1 = __fadd_rn(v1, __ldcg(in + i * N + n + 1));
        }
        if (fwd != nullptr) {
          if (n < N) __stcg(fwd + i * N + n, v0);
          if (n + 1 < N) __stcg(fwd + i * N + n + 1, v1);
        } else {
          store2<T>(dw + i * N + n, N - n0, col, v0, v1, a.vec);
        }
      });
    }
    if (fwd != nullptr) signal(arrive_flags(g.right, r + 1) + blockIdx.x, e);
  }
  release_slots(g, W, a.epoch);
}

// ---------------------------------------------------------------------------
// launching
// ---------------------------------------------------------------------------

// Blocks per rank: a cooperative launch (W ranks in one process) puts
// SMs / W on each rank; one rank per process leaves kRingBlocks SMs for a
// K4 / K5 ring launch beside it (the header's co-residency argument).
int cm_blocks(int sms, int n_groups, int cooperative) {
  const int g = cooperative ? sms / n_groups : sms - kRingBlocks;
  return g < 1 ? 1 : (g > kMaxBlocks ? kMaxBlocks : g);
}

bool aligned16(long long p) { return p % 16 == 0; }

cudaError_t launch(const void* kernel, const CmArgs& a, int n_groups,
                   int cooperative, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const int blocks = cm_blocks(sms, n_groups, cooperative);
  if (per_sm < 1 || (!cooperative && sms <= kRingBlocks))
    return cudaErrorInvalidConfiguration;
  const dim3 grid(blocks, n_groups), block(kThreads);
  void* args[] = {const_cast<CmArgs*>(&a)};
  if (cooperative) {
    if ((long long)per_sm * sms < (long long)blocks * n_groups)
      return cudaErrorCooperativeLaunchTooLarge;
    err = cudaLaunchCooperativeKernel(kernel, grid, block, args, 0, stream);
  } else {
    err = cudaLaunchKernel(kernel, grid, block, args, 0, stream);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
const void* kernel_for(int kind) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (kind == kFwd) return (const void*)cm_fwd<T, 128, 128>;
    if (kind == kDx) return (const void*)cm_dx<T, 128, 128>;
    return (const void*)cm_dw<T, 64, 64>;
  }
  if (kind == kFwd) return (const void*)cm_fwd<T, 64, 64>;
  if (kind == kDx) return (const void*)cm_dx<T, 64, 64>;
  return (const void*)cm_dw<T, 64, 64>;
}

int run(int kind, const long long* groups, int n_groups, int world,
        long long m, long long kc, long long n, long long slot_bytes,
        int bf16_in, unsigned epoch, int cooperative, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups || world < 2 ||
      world > kMaxGroups || m < 0 || kc < 1 || n < 1 || epoch < 1)
    return (int)cudaErrorInvalidValue;
  const long long esize = bf16_in ? 2 : 4;
  const long long hop = kc * n * (kind == kDw ? 4 : esize);
  if (hop > slot_bytes) return (int)cudaErrorInvalidValue;
  CmArgs a = {};
  a.world = world;
  a.epoch = epoch;
  a.m = m;
  a.kc = kc;
  a.n = n;
  a.slot_bytes = slot_bytes;
  const long long ve = 16 / esize;
  a.vec = kc % ve == 0 && n % ve == 0 && slot_bytes % 16 == 0;
  for (int i = 0; i < n_groups; ++i) {
    const long long* v = groups + i * 7;
    CmGroup& g = a.g[i];
    g.rank = (int)v[0];
    g.a = reinterpret_cast<const char*>(v[1]);
    g.b = reinterpret_cast<const char*>(v[2]);
    g.out = reinterpret_cast<char*>(v[3]);
    g.own = reinterpret_cast<char*>(v[4]);
    g.right = reinterpret_cast<char*>(v[5]);
    g.left = reinterpret_cast<char*>(v[6]);
    a.vec = a.vec && aligned16(v[1]) && aligned16(v[2]) && aligned16(v[3]);
    if (!aligned16(v[4]) || !aligned16(v[5]) || !aligned16(v[6]))
      return (int)cudaErrorInvalidValue;
  }
  const void* kernel = bf16_in ? kernel_for<bf16>(kind)
                               : kernel_for<float>(kind);
  return (int)launch(kernel, a, n_groups, cooperative,
                     static_cast<cudaStream_t>(stream));
}

}  // namespace

// The C interface. `groups` is a host array of one record per rank driven
// by this launch (n_groups of them; more than one only for ranks sharing a
// process), each of 7 int64 values: rank, a, b, out, then the leg buffers
// of the rank, its right and its left neighbour. Operands (all contiguous,
// row-major, of one dtype: bf16 when `bf16_in`, else fp32):
//   rmm_forward (K6): a = x [m, world*kc], b = w_shard [kc, n], out = y [m, n]
//   rmm_dx      (K7): a = dy [m, n], b = w_shard [kc, n], out = dx [m, world*kc]
//   rmm_dw      (K8): a = x [m, world*kc], b = dy [m, n], out = dw [kc, n]
// `slot_bytes`: the leg's slot size (>= the hop: kc*n elements, fp32 for
// K8); `epoch`: the leg's call counter (from 1). Each launches on `stream`,
// allocates nothing, and returns cudaGetLastError() of the launch.

extern "C" long long rmm_header_bytes() { return kHeader; }

extern "C" int rmm_forward(const long long* groups, int n_groups, int world,
                           long long m, long long kc, long long n,
                           long long slot_bytes, int bf16_in, unsigned epoch,
                           int cooperative, void* stream) {
  return run(kFwd, groups, n_groups, world, m, kc, n, slot_bytes, bf16_in,
             epoch, cooperative, stream);
}

extern "C" int rmm_dx(const long long* groups, int n_groups, int world,
                      long long m, long long kc, long long n,
                      long long slot_bytes, int bf16_in, unsigned epoch,
                      int cooperative, void* stream) {
  return run(kDx, groups, n_groups, world, m, kc, n, slot_bytes, bf16_in,
             epoch, cooperative, stream);
}

extern "C" int rmm_dw(const long long* groups, int n_groups, int world,
                      long long m, long long kc, long long n,
                      long long slot_bytes, int bf16_in, unsigned epoch,
                      int cooperative, void* stream) {
  return run(kDw, groups, n_groups, world, m, kc, n, slot_bytes, bf16_in,
             epoch, cooperative, stream);
}

extern "C" const char* rmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
