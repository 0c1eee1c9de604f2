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
// partials travel in fp32). bf16 inputs run on the tensor cores; fp32
// inputs on the CUDA cores (fmaf; never TF32, which would change the
// numbers).
//
// What bounds them on this card: operations. At the GPT-2 small training
// shapes (M = 8192 tokens per rank, K = 768, W = 2, N = 768 or 3072) each
// call does 2·M·K·N = 9.66 or 38.65 GFLOP on 13–70 MB: over 500 operations
// per byte, above the card's 295 for bf16.
//
// K6 and K7 take one of two routes (the wrapper picks it:
// ops/collective_matmul.py::cm_core).
//   - The wgmma route (redesigned; bf16 with kc and N multiples of 8, which
//     the main path's calls all are): persistent blocks, block b taking
//     output tiles b, b + G, ... of 128 x BN (BN = 256 for K6 and 192 for
//     K7 by default, the wrapper's CM_TILE_N: measured on the H100 against
//     128 and the other, chip_smoke.py's time_cm_tiles); K7's tiles of all
//     rounds form one sequence, so a round's ragged last wave does not idle
//     the card before the next round. One producer warp streams 64-deep
//     slabs of the reduction by TMA (128-byte swizzle) into as many
//     shared-memory stages as fit (4 to 6), counted on full / empty
//     mbarriers; two consumer warpgroups of 64 rows run wgmma on them (K7:
//     dy and w both K-major, as Q·Kᵀ in flash_fwd.cu; K6: x K-major, the
//     weight chunk MN-major, its BN columns as 64-wide boxes one LBO apart,
//     as K8's dy), one slab's products in flight behind the next, and store
//     each tile through a 64 x 64 staging tile per warpgroup as whole
//     128-byte rows. Each output element is summed by one block in one
//     order: two calls give the same bits.
//     TMA fills zeros only past a tensor map's bounds, so the maps are
//     bounded per chunk: x as {kc, W, M} (a 64-wide box at W = 8, kc = 96,
//     would otherwise read chunk j + 1's columns into K6's sum), each slot
//     as {N, kc} inside one {N, kc, W - 1} map slot_bytes apart (a box past
//     kc rows would otherwise read the slot's stale tail), the local shard
//     as {N, kc}. The three maps of each rank (A, local shard, slots; 128
//     bytes each) live in the kernel's __grid_constant__ parameter beside
//     the common record: 8 ranks fit its 4 KB.
//     The slots are written by ordinary stores (the left neighbour's, or on
//     a LocalRing this rank's own blocks') and read by TMA, the async
//     proxy: the producer warp's lanes acquire the sender blocks' arrival
//     flags (a share each), then __syncwarp and fence.proxy.async.global,
//     before its first load from that slot; it passes that chunk on (W > 2)
//     with the warp's 32 lanes. The consumers first send the local shard on
//     as hop 1 (credit wait, copy, arrival flag, on a named barrier of their
//     256 threads) while the producer already loads round 0; so every wait
//     is either one warp's or the consumers', never a block-wide barrier
//     inside a region only some warps reach. Slots are released at the end
//     of the call, after every consumer has finished with every stage.
//   - The mma route (kept from the first port; fp32, fmaf, never TF32; and
//     bf16 chunks TMA cannot address): 256 threads, one 128 x 128 (bf16) or
//     64 x 64 (fp32) output tile per step of a block-stride loop, k-slabs of
//     32 staged through registers into a double-buffered shared tile stored
//     as the operand lies in memory (16-byte loads through L2); mma.sync
//     m16n8k16 fragments from shared memory with 32-bit loads where the
//     reduction dimension is contiguous and with ldmatrix.trans where it is
//     not.

// K8 (redesigned; it replaces dear_pytorch_tpu/ops/collective_matmul.py::
// _cm_dw_kernel, :572). Its output is only kc x N (384 x 768 or 3072) but
// each element reduces over all M = 8192 rows, so the first design's 72 or
// 288 tiles of 64 x 64, each a serial walk over M on mma.sync, left most of
// 66–100 blocks on one long tile or a ragged fourth wave (30–46 TF/s). Now:
//   - the reduction over M is split across blocks: the output tiles x
//     slabs of 64 rows of M are cut evenly into `ranges` contiguous runs
//     (the wrapper's plan, ops/collective_matmul.py::dw_plan: with no more
//     tiles than blocks, every tile into the same number of segments, one
//     wave — 18 tiles x 3 at N = 768 on 66 blocks; with more, one run per
//     block, stream-K — 66 runs over 72 tiles at N = 3072). A unit is the
//     piece of one run inside one tile; units run round by round, each
//     block its runs in order, and each writes its fp32 partial of the tile
//     to a workspace the wrapper allocates (world x tiles x `contrib`
//     tiles, contrib the most runs that touch one tile). Measured on the
//     H100 (chip_smoke.py's time_dw_plans), more and smaller units lose:
//     each costs a partial store, a fence and a refill of the TMA ring;
//   - the last unit of a tile to finish — an atomicInc on the round's split
//     counter in the leg header, which wraps back to 0 — sums the tile's
//     partials in the order of M (no float atomics: every run and every
//     rank gives the same bits), then does the old epilogue: adds the left
//     neighbour's fp32 partial of that tile, and stores the tile into the
//     right neighbour's slot (raising the arrival flag of THAT tile) or, in
//     the last round, as dw in the inputs' dtype. A unit waits only on the
//     left neighbour's arrival flags and the right one's credits, never on
//     a unit of its own rank;
//   - bf16 operands whose rows TMA can address (W·kc and N multiples of 8)
//     take the wgmma core: 128 x 128 tiles, two consumer warpgroups of 64
//     rows and a producer warp; slabs of 64 rows of M stream through a
//     4-stage ring of shared memory by TMA (xᵀ's and dy's 128 columns each
//     as two 64 x 64 boxes, 128-byte swizzle) counted on mbarriers; both
//     operands are MN-major (M runs down the rows), so wgmma reads them
//     from shared memory with the transpose bits set, one m64n128k16 per
//     warpgroup and 16 rows (dy's two boxes one leading-byte-offset apart;
//     two m64n64k16 read xᵀ twice and measured slower, and 128 x 256
//     tiles slower still), one slab's products in flight behind the next;
//   - fp32 operands, and bf16 ones TMA cannot address, take the mma core:
//     64 x 64 tiles on K6/K7's Gemm, with the same split.

// Transport (the "cm" leg of dear_pytorch_tpu_torch/comm/ring.py; the
// protocol of csrc/ring.cu, with one slot per hop): each rank's leg buffer
// is [arrive[kMaxHops][kMaxTiles] | credit[kMaxHops][kMaxBlocks] | K8's
// split counters[kMaxGroups][kMaxTiles] | pad to kHeader | slot 1 | ... |
// slot W-1] (zeroed when allocated), mapped into its neighbours through
// CUDA IPC (or, for W ranks in one process, plain pointers). Hop h (1..W-1)
// of a call lands in the receiver's slot h: K6 and K7 pass the weight
// chunks on (block b copies its byte range of the chunk, arrival flag b),
// K8 its fp32 partials (the finishing unit of tile t, arrival flag t: after
// the split the block that finishes a tile varies, so arrivals are per
// tile, at most kMaxTiles). A writer stores the hop into
// the right neighbour's slot, then __threadfence_system() and a
// system-scope release store of its arrival flag (the call's epoch, the
// leg's call counter: the same on every rank because every rank issues its
// ring matmuls in the same order). A K6/K7 block needs the whole chunk, so
// it waits for the arrival flags of all the sender's blocks (one thread per
// flag, system-scope acquire loads; the slot is then read through L2 with
// ld.global.cg, or by TMA after a proxy fence on the wgmma route); a K8
// finishing unit only for the arrival flag of its own
// tile. A slot is read again for every tile, so it is released only
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
// checked, after the dynamic shared memory limit is set: K8's wgmma core
// takes ~130 KB, K6's and K7's wgmma route 209–217 KB, with 288 threads:
// one block per SM), so whichever of the two launches first, the other
// still finds enough SMs that hold none of the first's blocks: both are
// always fully
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

#include "hopper.cuh"
#include "ring_sync.cuh"

namespace {

constexpr int kThreads = 256;                 // K6, K7 and K8's mma core
constexpr int kMaxGroups = 8;                 // ranks in one launch
constexpr int kMaxHops = kMaxGroups - 1;
constexpr int kMaxBlocks = 256;               // blocks per rank: credits
constexpr int kMaxTiles = 1024;               // arrivals per slot (K8: tiles)
// the header: arrival flags [hop][kMaxTiles] (K6/K7 index them by block, K8
// by output tile), credit flags [hop][kMaxBlocks], then K8's split counters
// [round][kMaxTiles] (zero between calls: each wraps back to 0)
constexpr long long kCreditOff = (long long)kMaxHops * kMaxTiles * 4;
constexpr long long kCounterOff =
    kCreditOff + (long long)kMaxHops * kMaxBlocks * 4;
constexpr long long kHeader = 69632;          // flags and counters, padded
static_assert(kCounterOff + (long long)kMaxGroups * kMaxTiles * 4 <= kHeader,
              "flags and counters overflow the header");
static_assert(kMaxBlocks <= kMaxTiles, "K6/K7 index arrivals by block");
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
  float* ws;       // K8: the partials, [round][tile][contributor][BM x BN]
};

template <class Group>
struct ArgsOf {
  Group g[kMaxGroups];
  int world;
  int vec;                 // 16-byte operand loads and paired stores
  unsigned epoch;
  long long m, kc, n;      // K = world * kc
  long long slot_bytes;
  // K8: the output tiles x slabs of `slab_rows` rows of M, cut evenly into
  // `ranges` contiguous ranges; `contrib` workspace tiles per output tile
  long long ranges, slab_rows;
  int contrib;
};

// K8's rank record: its wgmma core's tensor maps of x [M, K] and dy [M, N]
// beside the common one. K6 and K7 take the small record (the maps in
// their parameters measured a little slower there); K8 keeps the maps in
// its rank records (as a parameter of their own they measured slower).
struct DwGroup {
  CUtensorMap a_map, b_map;
  CmGroup c;
};

using CmArgs = ArgsOf<CmGroup>;
using DwArgs = ArgsOf<DwGroup>;

__device__ __forceinline__ unsigned* arrive_flags(char* buf, int hop) {
  return reinterpret_cast<unsigned*>(buf) + (hop - 1) * kMaxTiles;
}

__device__ __forceinline__ unsigned* credit_flags(char* buf, int hop) {
  return reinterpret_cast<unsigned*>(buf + kCreditOff) +
         (hop - 1) * kMaxBlocks;
}

__device__ __forceinline__ unsigned* split_counters(char* buf, int round) {
  return reinterpret_cast<unsigned*>(buf + kCounterOff) + round * kMaxTiles;
}

__device__ __forceinline__ char* slot(char* buf, int hop, long long bytes) {
  return buf + kHeader + (long long)(hop - 1) * bytes;
}

// Threads [0, n) of the block wait until every sender block's flag >= want
// (one thread per flag); the caller then brings them together.
__device__ void wait_flags(const unsigned* flags, unsigned want, int tid,
                           int n, const char* what, int rank, int round) {
  for (int i = tid; i < (int)gridDim.x; i += n)
    spin_until(flags + i, want, what, rank, round);
}

// Every thread i < gridDim.x waits for flags[i] >= want; then a barrier.
__device__ void wait_all(const unsigned* flags, unsigned want,
                         const char* what, int rank, int round) {
  wait_flags(flags, want, threadIdx.x, blockDim.x, what, rank, round);
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
// through L2 when it is a slot, by threads [0, n) of the block (this one
// is `tid`); 16-byte vectors four at a time per thread, loads before
// stores.
__device__ void copy_range(char* dst, const char* src, long long lo,
                           long long hi, int tid, int n) {
  constexpr int kBatch = 4;
  const bool v16 = (((uintptr_t)src | (uintptr_t)dst) & 15) == 0 &&
                   lo % 16 == 0;
  long long i = lo;
  if (v16) {
    const long long q_hi = lo + (hi - lo) / 16 * 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long q = lo / 16 + tid; q < q_hi / 16; q += kBatch * n) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (q + u * n < q_hi / 16) v[u] = __ldcg(s4 + q + u * n);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (q + u * n < q_hi / 16) __stcg(d4 + q + u * n, v[u]);
    }
    i = q_hi;
  }
  for (long long j = i + tid; j < hi; j += n)
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

// Pass this block's byte range of round r's weight chunk of `bytes` bytes
// (r = 0: the local shard; r >= 1: slot r, arrived) on as hop r + 1, by
// threads [0, n) of the block (`sync` brings them together): once the
// reader's blocks have released the slot of call epoch - 1, copy, then
// raise arrival flag blockIdx.x.
template <class Args, class Sync>
__device__ void send_chunk(const Args& a, const CmGroup& g, int r,
                           long long bytes, int tid, int n, Sync sync) {
  const unsigned e = a.epoch;
  if (e > 1)
    wait_flags(credit_flags(g.own, r + 1), e - 1, tid, n, "cm credit",
               g.rank, r);
  sync();
  long long lo, hi;
  byte_range(bytes, lo, hi);
  const char* src = r == 0 ? g.b : slot(g.own, r, a.slot_bytes);
  copy_range(slot(g.right, r + 1, a.slot_bytes), src, lo, hi, tid, n);
  sync();
  if (tid == 0) {
    __threadfence_system();
    st_release_sys(arrive_flags(g.right, r + 1) + blockIdx.x, e);
  }
}

// Make round r's weight chunk readable in this rank (r = 0: the local
// shard; r >= 1: slot r, once every sender block has delivered), and pass
// this block's byte range of it on as hop r + 1.
template <typename T>
__device__ void chunk_round(const CmArgs& a, const CmGroup& g, int r) {
  if (r >= 1)
    wait_all(arrive_flags(g.own, r), a.epoch, "cm arrival", g.rank, r);
  if (r < a.world - 1)
    send_chunk(a, g, r, a.kc * a.n * (long long)sizeof(T), threadIdx.x,
               blockDim.x, [] { __syncthreads(); });
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

// ---------------------------------------------------------------------------
// K6 and K7 on the tensor cores: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

// A rank's record on the wgmma route: tensor maps of its A operand (K6: x
// viewed as {kc, W, M}, so that a box never reaches past its chunk's kc
// columns; K7: dy as {N, M}), of its local shard w [kc, N] as {N, kc} and of
// its W - 1 slots as one {N, kc, W - 1} map, slot_bytes apart (a box never
// reaches past kc rows into a slot's stale tail), beside the common record.
// Kept in the kernel's parameter (__grid_constant__, 8 groups fit 4 KB).
struct TcGroup {
  CUtensorMap a_map, w_map, s_map;
  CmGroup c;
};

using TcArgs = ArgsOf<TcGroup>;
static_assert(sizeof(TcArgs) <= 4096, "kernel parameters over 4 KB");

// Shared memory of the wgmma route: as many stages as fit (6, 5 and 4 at
// BN = 128, 192 and 256), each A (BM rows x 64 of the reduction, K-major: x
// or dy) then B (K7: BN rows of w x 64 of the reduction, K-major; K6: 64
// reduction rows x BN columns of w, MN-major, as BN / 64 boxes of 64 x 64),
// 128-byte swizzle; then each consumer warpgroup's 64 x 64 staging tile of
// the epilogue; then the barriers.
template <int BN>
struct TcPlan {
  static constexpr int BM = 128, kSlab = 64;
  static constexpr int kA = BM * kSlab * 2;
  static constexpr int kBox = 64 * kSlab * 2;
  static constexpr int kStage = kA + BN * kSlab * 2;
  static constexpr int kOut = 2 * 64 * 64 * 2;
  static constexpr int kStages = (227 * 1024 - kOut - 2048) / kStage < 6
                                     ? (227 * 1024 - kOut - 2048) / kStage
                                     : 6;
  static constexpr int kOutOff = kStages * kStage;
  static constexpr int kBarOff = kOutOff + kOut;
  static constexpr int kSmem = kBarOff + 16 * kStages + 1024;
  static_assert(BN % 64 == 0 && kStage % 1024 == 0, "1024-byte atoms");
  static_assert(kStages >= 4 && kSmem <= 227 * 1024, "shared memory");
};

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// The producer warp's receive of round r >= 1: every sender block's
// arrival flag (lanes spin on a share each), then the proxy fence that
// lets this warp's TMA read what the senders' ordinary stores wrote into
// slot r; then, but in the last round, chunk r is passed on.
__device__ void recv_chunk(const TcArgs& a, const CmGroup& g, int r,
                           int lane) {
  wait_flags(arrive_flags(g.own, r), a.epoch, lane, 32, "cm arrival", g.rank,
             r);
  __syncwarp();
  hopper::fence_proxy_async_global();
  if (r < a.world - 1)
    send_chunk(a, g, r, a.kc * a.n * 2, lane, 32, [] { __syncwarp(); });
}

// One consumer warpgroup's 64 x BN accumulators (hopper.cuh's m64nN layout)
// stored as bf16 to out[r * ld + c] for rows r < rows and columns c < clim
// (a multiple of 8), through its 64 x 64 staging tile `stage` in shared
// memory, 64 columns at a time: each thread writes its column pairs there
// (16-byte chunk c of row r at chunk c ^ (r mod 8): no two lanes of a
// warp on one bank), then the warpgroup reads it back as 16-byte row
// chunks and stores whole 128-byte rows (direct stores of the column
// pairs would cost 8 partial-sector writes for every 128 bytes).
template <int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           uint8_t* stage, int wg, bf16* out,
                                           long long ld, long long rows,
                                           long long clim) {
  const int tid = threadIdx.x - 128 * wg, lane = threadIdx.x % 32;
  const int r = (tid / 32) * 16 + lane / 4;  // and r + 8; r mod 8 = lane / 4
#pragma unroll
  for (int h = 0; h < BN / 64; ++h) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int jn = 8 * h + c;
      const int off = ((c ^ (lane / 4)) * 16) + 4 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(stage + r * 128 + off) =
          __floats2bfloat162_rn(acc[4 * jn], acc[4 * jn + 1]);
      *reinterpret_cast<__nv_bfloat162*>(stage + (r + 8) * 128 + off) =
          __floats2bfloat162_rn(acc[4 * jn + 2], acc[4 * jn + 3]);
    }
    named_sync(2 + wg, 128);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = tid + 128 * u, row = q / 8, c = q % 8;
      const uint4 v = *reinterpret_cast<const uint4*>(
          stage + row * 128 + ((c ^ (row % 8)) * 16));
      const int col = 64 * h + 8 * c;
      if (row < rows && col < clim)
        *reinterpret_cast<uint4*>(out + row * ld + col) = v;
    }
    named_sync(2 + wg, 128);
  }
}

// K6 (Op kFwd) and K7 (kDx) on the tensor cores. Output tiles of BM x BN
// (K6: of y, each over every round, round 0's local shard first; K7: of
// each round's dx column block, the rounds' tiles in one sequence), block b
// taking tiles b, b + G, ...: one producer warp streams 64-deep slabs of the
// reduction by TMA into a kStages ring counted on mbarriers, two consumer
// warpgroups of 64 rows each run wgmma on them, one slab's products in
// flight behind the next, and store the tile through shared memory. The
// consumers first send the local shard on (hop 1) while the producer loads;
// the producer receives (and passes on) the later rounds' chunks just
// before its first load from each.
template <int Op, int BN>
__global__ void __launch_bounds__(288, 1)
cm_tc(const __grid_constant__ TcArgs a) {
  using namespace hopper;
  using P = TcPlan<BN>;
  constexpr int BM = P::BM, kStages = P::kStages;
  extern __shared__ __align__(128) uint8_t dyn_smem[];
  const TcGroup& tg = a.g[blockIdx.y];
  const CmGroup& g = tg.c;
  const int W = a.world, my = g.rank;
  const long long M = a.m, kc = a.kc, N = a.n;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dyn_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBarOff);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // the consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();
  const long long tn = ((Op == kFwd ? N : kc) + BN - 1) / BN;
  const long long per_round = (M + BM - 1) / BM * tn;
  const long long tiles = Op == kFwd ? per_round : W * per_round;
  // 64-deep slabs of one round's reduction (K6: kc; K7: N) and of a tile
  const int round_slabs = (int)(((Op == kFwd ? kc : N) + 63) / 64);
  const int nslab = Op == kFwd ? W * round_slabs : round_slabs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    int ready = 1;  // rounds this block may read (round 0: the local shard)
    unsigned it = 0;
    for (long long q = blockIdx.x; q < tiles; q += gridDim.x) {
      const long long t = q % per_round;
      const int m0 = (int)(t / tn * BM), c0 = (int)(t % tn * BN);
      for (int s = 0; s < nslab; ++s, ++it) {
        const int r = Op == kFwd ? s / round_slabs : (int)(q / per_round);
        const int k0 = (Op == kFwd ? s % round_slabs : s) * 64;
        for (; ready <= r; ++ready) recv_chunk(a, g, ready, lane);
        if (lane == 0) {
          const int st = it % kStages;
          if (it >= (unsigned)kStages)
            mbar_wait(empty + st, ((it / kStages) - 1) & 1);
          uint8_t* dst = smem + st * P::kStage;
          uint64_t* bar = full + st;
          mbar_expect_tx(bar, P::kStage);
          if (Op == kFwd) {  // x's columns of chunk j; w's rows k0..
            tma_load_3d(dst, &tg.a_map, bar, k0, (my - r + W) % W, m0);
            for (int h = 0; h < BN / 64; ++h) {
              uint8_t* b = dst + P::kA + h * P::kBox;
              if (r == 0)
                tma_load_2d(b, &tg.w_map, bar, c0 + 64 * h, k0);
              else
                tma_load_3d(b, &tg.s_map, bar, c0 + 64 * h, k0, r - 1);
            }
          } else {             // dy's columns k0..; w's rows c0..
            tma_load_2d(dst, &tg.a_map, bar, k0, m0);
            if (r == 0)
              tma_load_2d(dst + P::kA, &tg.w_map, bar, k0, c0);
            else
              tma_load_3d(dst + P::kA, &tg.s_map, bar, k0, c0, r - 1);
          }
        }
        __syncwarp();
      }
    }
    for (; ready < W; ++ready) recv_chunk(a, g, ready, lane);
  } else {
    send_chunk(a, g, 0, kc * N * 2, threadIdx.x, 256,
               [] { named_sync(1, 256); });
    const int wg = warp / 4;
    unsigned it = 0;
    for (long long q = blockIdx.x; q < tiles; q += gridDim.x) {
      const long long t = q % per_round;
      const long long m0 = t / tn * BM, c0 = t % tn * BN;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int s = 0; s < nslab; ++s, ++it) {
        const int st = it % kStages;
        mbar_wait(full + st, (it / kStages) & 1);
        const uint32_t as = smem_u32(smem + st * P::kStage + wg * P::kA / 2);
        const uint32_t bs = smem_u32(smem + st * P::kStage + P::kA);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < P::kSlab / 16; ++kk) {
          if (Op == kFwd)  // w MN-major: 16 rows on, boxes LBO apart
            wgmma_ss<BN, 0, 1>(acc, desc_sw128(as + 32 * kk, 16, 1024),
                               desc_sw128(bs + 2048 * kk, P::kBox, 1024), 1);
          else               // w K-major, as dy
            wgmma_ss<BN, 0, 0>(acc, desc_sw128(as + 32 * kk, 16, 1024),
                               desc_sw128(bs + 32 * kk, 16, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous slab's products are done
        if (s > 0 && lane == 0) mbar_arrive(empty + (it - 1) % kStages);
      }
      wgmma_wait<0>();
      reg_fence(acc);
      if (nslab > 0 && lane == 0) mbar_arrive(empty + (it - 1) % kStages);
      bf16* out;
      long long ld, clim;
      if (Op == kFwd) {
        out = reinterpret_cast<bf16*>(g.out) + c0;
        ld = N;
        clim = N - c0;
      } else {
        const long long j = (my - q / per_round + W) % W;
        ld = W * kc;
        out = reinterpret_cast<bf16*>(g.out) + j * kc + c0;
        clim = kc - c0;
      }
      store_tile<BN>(acc, smem + P::kOutOff + wg * (P::kOut / 2), wg,
                     out + (m0 + 64 * wg) * ld, ld, M - m0 - 64 * wg, clim);
    }
  }
  release_slots(g, W, a.epoch);
}

// ---------------------------------------------------------------------------
// K8: the reduction over M split across blocks
// ---------------------------------------------------------------------------
//
// A work unit is (round, output tile, a run's piece of M in that tile).
// Units run round by round, each block its runs in order; each writes its
// fp32 partial of the tile to the rank's workspace. The last unit of a tile
// to finish (an atomicInc on the round's split counter in the leg header,
// which wraps back to 0) sums the tile's partials in the order of M, adds the
// left neighbour's fp32 partial when the round has one (after its arrival
// flag for THAT tile), and stores the result into the right neighbour's
// slot (raising its arrival flag for the tile) or, in the last round, as dw.

// The wgmma core (bf16 operands TMA can read): 128 x 128 output tiles,
// two consumer warpgroups of 64 rows and one producer warp. Slabs of 64
// rows of M stream through kStages shared-memory stages by TMA: per stage
// xᵀ's 128 columns and dy's 128 columns as two 64-wide boxes each, both
// MN-major (the reduction dim M runs down the rows).
struct WgmmaCore {
  static constexpr int BM = 128, BN = 128, kSlab = 64, kStages = 4;
  static constexpr int kThreads = 288;
  static constexpr int kBox = kSlab * 64 * 2;      // one 64 x 64 box, bytes
  static constexpr int kStage = 4 * kBox;          // A: 2 boxes, B: 2 boxes
  static constexpr int kBarOff = kStages * kStage;
  static constexpr int kSmem = kBarOff + 16 * kStages + 1024;
  uint8_t* smem;
  uint64_t* full;
  uint64_t* empty;
  unsigned count;  // slabs this block has streamed so far

  __device__ void init(uint8_t* raw) {
    smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    full = reinterpret_cast<uint64_t*>(smem + kBarOff);
    empty = full + kStages;
    count = 0;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        hopper::mbar_init(full + s, 1);
        hopper::mbar_init(empty + s, 8);  // the consumer warps
      }
      hopper::mbar_fence_init();
    }
    __syncthreads();
  }

  // out [BM][BN] = x[m0 : m0 + mlen, col0 : col0 + BM]ᵀ · dy[m0 :, n0 : n0
  // + BN]; rows and columns past the operands' ends read as zeros.
  template <class A>
  __device__ void partial(const A& a, const CmGroup&,
                          const CUtensorMap* x_map, const CUtensorMap* y_map,
                          long long c, long long i0, long long n0,
                          long long m0, long long mlen, float* out) {
    using namespace hopper;
    const long long col0 = c * a.kc + i0;
    const int nslab = mlen > 0 ? (int)((mlen + kSlab - 1) / kSlab) : 0;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 8) {
      if (lane == 0) {
        for (int s = 0; s < nslab; ++s) {
          const unsigned j = count + s;
          const int st = j % kStages;
          if (j >= (unsigned)kStages)
            mbar_wait(empty + st, ((j / kStages) - 1) & 1);
          uint8_t* dst = smem + st * kStage;
          const int row = (int)(m0 + (long long)s * kSlab);
          mbar_expect_tx(full + st, kStage);
          tma_load_2d(dst, x_map, full + st, (int)col0, row);
          tma_load_2d(dst + kBox, x_map, full + st, (int)col0 + 64, row);
          tma_load_2d(dst + 2 * kBox, y_map, full + st, (int)n0, row);
          tma_load_2d(dst + 3 * kBox, y_map, full + st, (int)n0 + 64, row);
        }
      }
    } else {
      const int wg = warp / 4;
      float acc[64];  // this warpgroup's 64 rows x the tile's 128 columns
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int s = 0; s < nslab; ++s) {
        const unsigned j = count + s;
        const int st = j % kStages;
        mbar_wait(full + st, (j / kStages) & 1);
        const uint32_t xs = smem_u32(smem + st * kStage + wg * kBox);
        const uint32_t ys = smem_u32(smem + st * kStage + 2 * kBox);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk)   // dy's two 64-wide boxes
          wgmma_m64n128k16_ss<1, 1>(                //   are kBox apart: LBO
              acc, desc_sw128(xs + 2048 * kk, 1024, 1024),
              desc_sw128(ys + 2048 * kk, kBox, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous slab's products are done
        if (s > 0 && lane == 0) mbar_arrive(empty + (j - 1) % kStages);
      }
      wgmma_wait<0>();
      reg_fence(acc);
      if (nslab > 0 && lane == 0)
        mbar_arrive(empty + (count + nslab - 1) % kStages);
      const int g8 = lane / 4, t = lane % 4;
      const int row = wg * 64 + (warp % 4) * 16 + g8;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const int c = 8 * jn + 2 * t;
        *reinterpret_cast<float2*>(out + row * BN + c) =
            make_float2(acc[4 * jn], acc[4 * jn + 1]);
        *reinterpret_cast<float2*>(out + (row + 8) * BN + c) =
            make_float2(acc[4 * jn + 2], acc[4 * jn + 3]);
      }
    }
    count += nslab;
  }
};

// The CUDA-core / mma.sync core (fp32 operands: fmaf, never TF32; bf16
// operands TMA cannot read: ragged rows): 64 x 64 tiles on the Gemm of K6
// and K7, 256 threads.
template <typename T>
struct MmaCore {
  using G = Gemm<T, 64, 64, false, false>;
  static constexpr int BM = 64, BN = 64, kThreads = 256;
  static constexpr int kSmem = 2 * G::STAGE * (int)sizeof(T);
  T* smem;

  __device__ void init(uint8_t* raw) { smem = reinterpret_cast<T*>(raw); }

  template <class A>
  __device__ void partial(const A& a, const CmGroup& g,
                          const CUtensorMap*, const CUtensorMap*, long long c,
                          long long i0, long long n0, long long m0,
                          long long mlen, float* out) {
    const long long K = a.world * a.kc, N = a.n, col0 = c * a.kc + i0;
    const T* x = reinterpret_cast<const T*>(g.a);
    const T* dy = reinterpret_cast<const T*>(g.b);
    typename G::Tile acc;
    acc.zero();
    if (mlen > 0) {
      Operand<T> A{x + m0 * K + col0, K, mlen, a.kc - i0, false};
      Operand<T> B{dy + m0 * N + n0, N, mlen, N - n0, false};
      gemm_tile<G>(acc, A, B, mlen, a.vec, smem);
    }
    acc.epilogue([&](int row, int col, float v0, float v1) {
      *reinterpret_cast<float2*>(out + row * BN + col) = make_float2(v0, v1);
    });
  }
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// The finishing unit's epilogue of one BM x BN tile: the S partials at
// `parts` summed in order, plus the left neighbour's partial `in` (if any),
// stored into the right neighbour's slot `fwd` or as dw. Four columns per
// step with 16-byte loads, the partials' loads issued in batches of kBatch
// before their adds (the adds stay in order),
// two steps per thread in flight: the partials were just written by other
// SMs, so this pass is bound by how many loads are in flight, not by the
// adds.
template <typename T, int BM, int BN, class A>
__device__ void combine_tile(const A& a, const float* parts, int S,
                             long long i0, long long n0, const float* in,
                             float* fwd, T* dw) {
  constexpr int kTile = BM * BN, kBatch = 4, kSteps = 2;
  const long long kc = a.kc, N = a.n;
  const bool v4 = N % 4 == 0;   // 16-byte rows of the slot and of dw
  const int stride = blockDim.x * kSteps;
  for (int base = threadIdx.x; base < kTile / 4; base += stride) {
    float4 v[kSteps];
    int off[kSteps];
    bool live[kSteps];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int idx = base + st * blockDim.x;
      const int row = 4 * idx / BN, col = 4 * idx % BN;
      off[st] = row * BN + col;
      live[st] = idx < kTile / 4 && i0 + row < kc && n0 + col < N;
      v[st] = live[st] ? __ldcg(reinterpret_cast<const float4*>(parts +
                                                                off[st]))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    int sg = 1;
    for (; sg + kBatch <= S; sg += kBatch) {
      float4 p[kSteps][kBatch];
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          p[st][u] = live[st] ? __ldcg(reinterpret_cast<const float4*>(
                                    parts + (sg + u) * kTile + off[st]))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
#pragma unroll
        for (int u = 0; u < kBatch; ++u) v[st] = add4(v[st], p[st][u]);
    }
    for (; sg < S; ++sg)
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
        if (live[st])
          v[st] = add4(v[st], __ldcg(reinterpret_cast<const float4*>(
                                  parts + sg * kTile + off[st])));
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      if (!live[st]) continue;
      const int row = off[st] / BN, col = off[st] % BN;
      const long long i = i0 + row, n = n0 + col;
      float e[4] = {v[st].x, v[st].y, v[st].z, v[st].w};
      const int ne = (int)min(4LL, N - n);
      if (in != nullptr) {
        if (v4) {
          const float4 l = __ldcg(reinterpret_cast<const float4*>(
              in + i * N + n));
          e[0] = __fadd_rn(e[0], l.x);
          e[1] = __fadd_rn(e[1], l.y);
          e[2] = __fadd_rn(e[2], l.z);
          e[3] = __fadd_rn(e[3], l.w);
        } else {
          for (int q = 0; q < ne; ++q)
            e[q] = __fadd_rn(e[q], __ldcg(in + i * N + n + q));
        }
      }
      if (fwd != nullptr) {
        if (v4)
          __stcg(reinterpret_cast<float4*>(fwd + i * N + n),
                 make_float4(e[0], e[1], e[2], e[3]));
        else
          for (int q = 0; q < ne; ++q) __stcg(fwd + i * N + n + q, e[q]);
      } else {
        store2<T>(dw + i * N + n, N - n0, col, e[0], e[1], a.vec);
        store2<T>(dw + i * N + n + 2, N - n0, col + 2, e[2], e[3], a.vec);
      }
    }
  }
}

// The range that holds iteration i of `total`, cut into R ranges
// [floor(q total / R), floor((q + 1) total / R)).
__host__ __device__ inline long long range_of(long long i, long long R,
                                              long long total) {
  return ((i + 1) * R - 1) / total;
}

// K8: round by round, this rank's xᵀ·dy block of that round's chunk plus
// the partial from the left, passed right (or, in the last round, dw).
// Block b takes ranges b, b + G, ...; a range is a run of slabs that may
// span tiles, each piece of one tile a unit; a tile's contributors are the
// ranges that touch it, j = 0, 1, ... in order of M.
template <typename T, class Core>
__global__ void __launch_bounds__(Core::kThreads, 1)
cm_dw(const __grid_constant__ DwArgs a) {
  extern __shared__ __align__(128) uint8_t dyn_smem[];
  __shared__ int finisher;
  constexpr int BM = Core::BM, BN = Core::BN, kTile = BM * BN;
  const DwGroup& dg = a.g[blockIdx.y];
  const CmGroup& g = dg.c;
  const int W = a.world, my = g.rank;
  const unsigned e = a.epoch;
  const long long kc = a.kc, N = a.n, M = a.m, R = a.ranges;
  const long long slab = a.slab_rows;
  T* dw = reinterpret_cast<T*>(g.out);
  const long long tn = (N + BN - 1) / BN;
  const long long tiles = (kc + BM - 1) / BM * tn;
  const long long P = M > 0 ? (M + slab - 1) / slab : 1;  // slabs per tile
  const long long total = tiles * P;
  Core core;
  core.init(dyn_smem);
  for (int r = 0; r < W; ++r) {
    const long long c = ((my - 1 - r) % W + 2 * W) % W;
    const float* in =
        r == 0 ? nullptr
               : reinterpret_cast<const float*>(slot(g.own, r, a.slot_bytes));
    float* fwd = r < W - 1 ? reinterpret_cast<float*>(
                                 slot(g.right, r + 1, a.slot_bytes))
                           : nullptr;
    float* ws = g.ws + (long long)r * tiles * a.contrib * kTile;
    unsigned* counters = split_counters(g.own, r);
    bool credited = false;
    for (long long q = blockIdx.x; q < R; q += gridDim.x) {
      const long long hi = (q + 1) * total / R;
      for (long long it = q * total / R; it < hi;) {
        const long long tile = it / P;
        const long long end = min(hi, (tile + 1) * P);
        const long long first = range_of(tile * P, R, total);
        const int n_parts = (int)(range_of((tile + 1) * P - 1, R, total) -
                                  first + 1);
        const long long i0 = tile / tn * BM, n0 = tile % tn * BN;
        const long long m0 = (it - tile * P) * slab;
        const long long mlen = min(M, (end - tile * P) * slab) - m0;
        core.partial(a, g, &dg.a_map, &dg.b_map, c, i0, n0, m0, mlen,
                     ws + (tile * a.contrib + (q - first)) * kTile);
        it = end;
        __threadfence();  // the partial is visible before the arrival below
        __syncthreads();
        if (threadIdx.x == 0)
          finisher = atomicInc(counters + tile, (unsigned)n_parts - 1) ==
                     (unsigned)n_parts - 1;
        __syncthreads();
        if (!finisher) continue;
        __threadfence();
        if (fwd != nullptr && e > 1 && !credited) {
          wait_all(credit_flags(g.own, r + 1), e - 1, "cm credit", my, r);
          credited = true;
        }
        if (in != nullptr) {   // the left neighbour's partial of this tile
          if (threadIdx.x == 0)
            spin_until(arrive_flags(g.own, r) + tile, e, "cm arrival", my,
                       r);
          __syncthreads();
        }
        combine_tile<T, BM, BN>(a, ws + tile * a.contrib * kTile, n_parts,
                                i0, n0, in, fwd, dw);
        if (fwd != nullptr) signal(arrive_flags(g.right, r + 1) + tile, e);
      }
    }
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

// `params`: the kernel's one parameter (CmArgs or DwArgs); `threads` per
// block and `smem` bytes of dynamic shared memory (its limit set first,
// then the occupancy checked: at least one block per SM).
cudaError_t launch(const void* kernel, void* params, int n_groups,
                   int cooperative, cudaStream_t stream, int threads = kThreads,
                   int smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 0)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  const int blocks = cm_blocks(sms, n_groups, cooperative);
  if (per_sm < 1 || (!cooperative && sms <= kRingBlocks))
    return cudaErrorInvalidConfiguration;
  const dim3 grid(blocks, n_groups), block(threads);
  void* args[] = {params};
  if (cooperative) {
    if ((long long)per_sm * sms < (long long)blocks * n_groups)
      return cudaErrorCooperativeLaunchTooLarge;
    err = cudaLaunchCooperativeKernel(kernel, grid, block, args, smem, stream);
  } else {
    err = cudaLaunchKernel(kernel, grid, block, args, smem, stream);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
const void* kernel_for(int kind) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (kind == kFwd) return (const void*)cm_fwd<T, 128, 128>;
    return (const void*)cm_dx<T, 128, 128>;
  }
  if (kind == kFwd) return (const void*)cm_fwd<T, 64, 64>;
  return (const void*)cm_dx<T, 64, 64>;
}

// The cores of K6, K7 and K8 (the wrapper picks one: `cm_core`, `dw_core`)
enum Core { kMmaCore = 0, kWgmmaCore = 1 };

template <int Op>
const void* tc_kernel(int bn) {
  if (bn == 128) return (const void*)cm_tc<Op, 128>;
  if (bn == 192) return (const void*)cm_tc<Op, 192>;
  if (bn == 256) return (const void*)cm_tc<Op, 256>;
  return nullptr;
}

int tc_smem(int bn) {
  return bn == 128 ? TcPlan<128>::kSmem
                   : bn == 192 ? TcPlan<192>::kSmem : TcPlan<256>::kSmem;
}

// K6 or K7 on the wgmma route, tiles 128 x `bn`: checks that TMA can
// address every operand (bf16, kc and n multiples of 8: 16-byte row
// strides in x, dy, w and the slots) and builds each rank's tensor maps.
int launch_tc(int kind, const CmArgs& a, int n_groups, int bf16_in, int bn,
              int cooperative, cudaStream_t stream) {
  const void* kernel = kind == kFwd ? tc_kernel<kFwd>(bn) : tc_kernel<kDx>(bn);
  if (kernel == nullptr || !bf16_in || a.kc % 8 || a.n % 8 ||
      a.slot_bytes % 16)
    return (int)cudaErrorInvalidValue;
  TcArgs t = {};  // the launch copies it
  t.world = a.world;
  t.vec = a.vec;
  t.epoch = a.epoch;
  t.m = a.m;
  t.kc = a.kc;
  t.n = a.n;
  t.slot_bytes = a.slot_bytes;
  const uint64_t W = a.world, kc = a.kc, n = a.n;
  const uint64_t m = (uint64_t)(a.m > 0 ? a.m : 1);
  const uint32_t rows = kind == kFwd ? 64 : (uint32_t)bn;  // w's box rows
  for (int i = 0; i < n_groups; ++i) {
    const CmGroup& g = a.g[i];
    t.g[i].c = g;
    if (!aligned16((long long)g.a) || !aligned16((long long)g.b) ||
        !aligned16((long long)g.out))
      return (int)cudaErrorInvalidValue;
    cudaError_t err;
    if (kind == kFwd) {  // x [M, W*kc] as {kc, W, M}
      const uint64_t dims[3] = {kc, W, m}, st[2] = {kc * 2, W * kc * 2};
      const uint32_t box[3] = {64, 1, 128};
      err = hopper::make_map(&t.g[i].a_map, g.a, 3, dims, st, box);
    } else {             // dy [M, N]
      const uint64_t dims[2] = {n, m}, st[1] = {n * 2};
      const uint32_t box[2] = {64, 128};
      err = hopper::make_map(&t.g[i].a_map, g.a, 2, dims, st, box);
    }
    const uint64_t w_dims[3] = {n, kc, W - 1};
    const uint64_t w_st[2] = {n * 2, (uint64_t)a.slot_bytes};
    const uint32_t w_box[3] = {64, rows, 1};
    if (err == cudaSuccess)
      err = hopper::make_map(&t.g[i].w_map, g.b, 2, w_dims, w_st, w_box);
    if (err == cudaSuccess)
      err = hopper::make_map(&t.g[i].s_map, g.own + kHeader, 3, w_dims,
                             w_st, w_box);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch(kernel, &t, n_groups, cooperative, stream, 288,
                     tc_smem(bn));
}

// K8 through `core`: checks the plan (tiles within the flags, every
// tile's contributors within the workspace) and, for the wgmma core,
// builds each rank's tensor maps of x and dy.
int launch_dw(const CmArgs& a, int n_groups, int bf16_in, int core,
              int cooperative, cudaStream_t stream) {
  DwArgs d = {};  // the launch copies it; the maps stay zero for the mma core
  for (int i = 0; i < n_groups; ++i) d.g[i].c = a.g[i];
  d.world = a.world;
  d.vec = a.vec;
  d.epoch = a.epoch;
  d.m = a.m;
  d.kc = a.kc;
  d.n = a.n;
  d.slot_bytes = a.slot_bytes;
  d.ranges = a.ranges;
  d.slab_rows = a.slab_rows;
  d.contrib = a.contrib;
  const long long bm = core == kWgmmaCore ? WgmmaCore::BM : 64;
  const long long bn = core == kWgmmaCore ? WgmmaCore::BN : 64;
  const long long tiles = (a.kc + bm - 1) / bm * ((a.n + bn - 1) / bn);
  if (a.ranges < 1 || a.slab_rows < 1 || tiles > kMaxTiles)
    return (int)cudaErrorInvalidValue;
  const long long P = a.m > 0 ? (a.m + a.slab_rows - 1) / a.slab_rows : 1;
  const long long total = tiles * P;
  if (a.ranges > total) return (int)cudaErrorInvalidValue;  // none empty
  for (long long t = 0; t < tiles; ++t)
    if (range_of((t + 1) * P - 1, a.ranges, total) -
            range_of(t * P, a.ranges, total) + 1 > a.contrib)
      return (int)cudaErrorInvalidValue;
  if (core == kMmaCore) {
    if (bf16_in)
      return (int)launch((const void*)cm_dw<bf16, MmaCore<bf16>>, &d,
                         n_groups, cooperative, stream,
                         MmaCore<bf16>::kThreads, MmaCore<bf16>::kSmem);
    return (int)launch((const void*)cm_dw<float, MmaCore<float>>, &d,
                       n_groups, cooperative, stream, MmaCore<float>::kThreads,
                       MmaCore<float>::kSmem);
  }
  const long long K = a.world * a.kc;
  if (core != kWgmmaCore || !bf16_in || K % 8 || a.n % 8 ||
      a.slab_rows % WgmmaCore::kSlab)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_groups; ++i) {
    const CmGroup& g = a.g[i];
    if (!aligned16((long long)g.a) || !aligned16((long long)g.b))
      return (int)cudaErrorInvalidValue;
    const uint64_t m = (uint64_t)(a.m > 0 ? a.m : 1);
    const uint64_t x_dims[2] = {(uint64_t)K, m}, x_st[1] = {(uint64_t)K * 2};
    const uint64_t y_dims[2] = {(uint64_t)a.n, m},
                   y_st[1] = {(uint64_t)a.n * 2};
    const uint32_t box[2] = {64, WgmmaCore::kSlab};
    cudaError_t err =
        hopper::make_map(&d.g[i].a_map, g.a, 2, x_dims, x_st, box);
    if (err == cudaSuccess)
      err = hopper::make_map(&d.g[i].b_map, g.b, 2, y_dims, y_st, box);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch((const void*)cm_dw<bf16, WgmmaCore>, &d, n_groups,
                     cooperative, stream, WgmmaCore::kThreads,
                     WgmmaCore::kSmem);
}

int run(int kind, const long long* groups, int n_groups, int world,
        long long m, long long kc, long long n, long long slot_bytes,
        int bf16_in, unsigned epoch, int cooperative, void* stream,
        int core, long long ranges = 1, int contrib = 1,
        long long slab_rows = 1, int tile_n = 0) {
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
  a.ranges = ranges;
  a.contrib = contrib;
  a.slab_rows = slab_rows;
  const long long ve = 16 / esize;
  a.vec = kc % ve == 0 && n % ve == 0 && slot_bytes % 16 == 0;
  for (int i = 0; i < n_groups; ++i) {
    const long long* v = groups + i * 8;
    CmGroup& g = a.g[i];
    g.rank = (int)v[0];
    g.a = reinterpret_cast<const char*>(v[1]);
    g.b = reinterpret_cast<const char*>(v[2]);
    g.out = reinterpret_cast<char*>(v[3]);
    g.own = reinterpret_cast<char*>(v[4]);
    g.right = reinterpret_cast<char*>(v[5]);
    g.left = reinterpret_cast<char*>(v[6]);
    g.ws = reinterpret_cast<float*>(v[7]);
    a.vec = a.vec && aligned16(v[1]) && aligned16(v[2]) && aligned16(v[3]);
    if (!aligned16(v[4]) || !aligned16(v[5]) || !aligned16(v[6]) ||
        (kind == kDw && (v[7] == 0 || !aligned16(v[7]))))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kDw) return launch_dw(a, n_groups, bf16_in, core, cooperative, s);
  if (core == kWgmmaCore)
    return launch_tc(kind, a, n_groups, bf16_in, tile_n, cooperative, s);
  if (core != kMmaCore) return (int)cudaErrorInvalidValue;
  const void* kernel = bf16_in ? kernel_for<bf16>(kind)
                               : kernel_for<float>(kind);
  return (int)launch(kernel, &a, n_groups, cooperative, s);
}

}  // namespace

// The C interface. `groups` is a host array of one record per rank driven
// by this launch (n_groups of them; more than one only for ranks sharing a
// process), each of 8 int64 values: rank, a, b, out, the leg buffers of the
// rank, its right and its left neighbour, then K8's workspace (0 for K6 and
// K7). Operands (all contiguous, row-major, of one dtype: bf16 when
// `bf16_in`, else fp32):
//   rmm_forward (K6): a = x [m, world*kc], b = w_shard [kc, n], out = y [m, n]
//   rmm_dx      (K7): a = dy [m, n], b = w_shard [kc, n], out = dx [m, world*kc]
//   rmm_dw      (K8): a = x [m, world*kc], b = dy [m, n], out = dw [kc, n]
// `slot_bytes`: the leg's slot size (>= the hop: kc*n elements, fp32 for
// K8); `epoch`: the leg's call counter (from 1). K8 also takes its plan:
// output tiles x slabs of `slab_rows` rows of M (a multiple of 64 for the
// wgmma core) cut into `ranges`, `contrib` workspace tiles per output tile
// (at least the most ranges that touch one tile), and `core` (0: the mma /
// CUDA-core core, 64 x 64 tiles; 1: the wgmma core, 128 x 128 tiles, bf16
// with W*kc and n multiples of 8); its workspace per rank holds world x
// tiles x contrib tiles of fp32. Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() of the launch.

extern "C" long long rmm_header_bytes() { return kHeader; }

// K8's blocks per rank on this device (the plan's G).
extern "C" int rmm_blocks(int n_groups, int cooperative) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return cm_blocks(sms, n_groups, cooperative);
}

extern "C" int rmm_forward(const long long* groups, int n_groups, int world,
                           long long m, long long kc, long long n,
                           long long slot_bytes, int bf16_in, unsigned epoch,
                           int cooperative, int core, int tile_n,
                           void* stream) {
  return run(kFwd, groups, n_groups, world, m, kc, n, slot_bytes, bf16_in,
             epoch, cooperative, stream, core, 1, 1, 1, tile_n);
}

extern "C" int rmm_dx(const long long* groups, int n_groups, int world,
                      long long m, long long kc, long long n,
                      long long slot_bytes, int bf16_in, unsigned epoch,
                      int cooperative, int core, int tile_n, void* stream) {
  return run(kDx, groups, n_groups, world, m, kc, n, slot_bytes, bf16_in,
             epoch, cooperative, stream, core, 1, 1, 1, tile_n);
}

extern "C" int rmm_dw(const long long* groups, int n_groups, int world,
                      long long m, long long kc, long long n,
                      long long slot_bytes, int bf16_in, unsigned epoch,
                      int cooperative, long long ranges, int contrib,
                      long long slab_rows, int core, void* stream) {
  return run(kDw, groups, n_groups, world, m, kc, n, slot_bytes, bf16_in,
             epoch, cooperative, stream, core, ranges, contrib, slab_rows);
}

extern "C" const char* rmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
