// Flash-attention forward for Hopper (sm_90a): exact blockwise
// online-softmax attention with an int32 key-validity mask and optional
// top-left-aligned causal masking. Returns o and the fp32 log-sum-exp.
//
// Replaces the TPU kernel dear_pytorch_tpu/ops/flash_attention.py::_fwd_kernel
// (:97; its function, not its block structure). Built by
// dear_pytorch_tpu_torch/ops/_build.py with nvcc into a shared library with
// a plain C interface; called through ctypes by
// dear_pytorch_tpu_torch/ops/flash_attention.py, whose `fwd_route` picks one
// of three routes from the shape and dtypes alone.
//
// What it computes, per query row i of head bh (b = bh / H, h = bh % H):
//   s_j   = scale * (q_i . k_j)                  (fp32)
//   key j counts iff mask[b, j] > 0 and, when causal, j <= i
//   m     = max(max_j s_j, -1e30)                (the -1e30 floor)
//   o_i   = sum_j exp(s_j - m) v_j / max(l, 1e-30),  l = sum_j exp(s_j - m)
//   lse_i = m + log(max(l, 1e-30))
// so a row with no valid key gives o = 0 and lse = -1e30, not NaN.
//
// Route 2, tensor cores (bf16 in, bf16 out, Sq > 1, D = 64: the training
// step, [16, 1024, 12, 64] causal). Bound: operations (4·D flops per causal
// pair, 25.8 GFLOP at that shape). Design, Hopper's flash-attention forward:
//   - a block owns 128 query rows: two consumer warpgroups of 64 rows and
//     one producer warp (288 threads); a causal grid issues the last, most
//     loaded query tiles first;
//   - the producer fills the Q tile once and a ring of kStages K/V tile
//     stages (128 keys each) in dynamic shared memory with TMA (4-d tensor
//     maps over the strided [B, S, H, D] views, 128-byte swizzle; out-of-
//     bounds rows read as zeros), counted on mbarriers, and packs each key
//     tile's validity (mask > 0, inside Sk and, when causal, before the
//     block's last row) into four 32-bit words beside the stage;
//   - a consumer warpgroup computes S = Q·Kᵀ for its 64 rows by wgmma
//     (m64n128k16, both operands K-major in shared memory), scales the fp32
//     accumulator by scale·log2 e, runs the online softmax in registers in
//     fp32 with exp2, rounds P to bf16 in registers and adds P·V by wgmma
//     with P as the A operand from registers and V as an MN-major B (the
//     transpose bit), then frees the stage;
//   - masks are applied only where a tile needs them: a tile whose key bits
//     are all set and that lies wholly left of the diagonal is not touched
//     (causal tiles past the diagonal are never loaded);
//   - TMA reads any view whose rows lie on 16-byte boundaries, which the
//     wrapper already requires (its _check_views), so no cp.async path is
//     needed.
//
// Route 1, split-K decode (Sq = 1, any dtype: the serving tick, 4 slots x
// 12 heads over a 1024-key cache). Bound: bytes (K and V read once, 4·D
// flops per key). One query row gains nothing from tensor cores; what the
// card needs is more blocks reading at once (slots x heads = 48 rows for
// 132 SMs). Design, flash-decoding: each row's keys are cut into `splits`
// ranges of `split_keys` (the wrapper's plan: 8 x 128 at that shape, 384
// blocks); a block runs the CUDA-core tile loop below over its range and
// writes its partial (m, l, acc[D]) in fp32 to a workspace the wrapper
// allocates; the last block of a row to finish (an atomicInc on a counter
// that wraps back to 0, so the persistent zeroed buffer is zero again
// after every launch) combines the partials in split order, so the result
// does not depend on which block finished last. A split with no valid key
// contributes (m = -1e30, l = 0, acc = 0) and weighs exp(-1e30 - M) = 0
// beside a live one.
//
// Route 0, CUDA cores (everything else: fp32 inputs, bf16 inputs with an
// fp32 output, head dims other than 64): the first, simple design, kept.
//   - one block of 4 warps per (tile of 16 query rows, bh);
//   - the scaled q tile is staged in shared memory as fp32;
//   - a loop over key tiles of 128 keys: the block stages K, V (as fp32,
//     rows padded to D + 1 floats so that lane j reading row j is free of
//     bank conflicts) and the per-key validity in shared memory, with
//     16-byte loads, several in flight per thread;
//   - within a tile, warp w owns keys 32w .. 32w + 31, one key per lane:
//     each lane computes its key's score for every row, the warp keeps an
//     online-softmax state (m, l, acc) per row in registers, and the PV
//     product broadcasts each key's p with a shuffle while each lane owns
//     the output dims lane, lane + 32, ...;
//   - the 4 warps of a block split the keys of every row and merge their
//     partial states through shared memory at the end;
//   - causal rows stop the key loop at the tile holding the diagonal, and
//     the ragged edges of Sq and Sk are masked here, so any length is
//     accepted.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = kWarps * 32;  // keys per tile: one per lane
constexpr int kUnroll = 4;            // 16-byte loads in flight per thread
constexpr int kMaxSplits = 64;
constexpr float kNegBig = -1e30f;     // the TPU kernel's _NEG_BIG
constexpr float kTiny = 1e-30f;       // floor of the softmax denominator
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum Route { kCudaCore = 0, kSplitK = 1, kTensorCore = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;
  void* o;
  float* lse;
  int B, H, Sq, Sk, D;
  // element strides of [B, S, H, D] views; the last dim is contiguous
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long mask_sb;  // mask is [B, Sk] with unit stride along Sk
  float scale;
  int causal;
  // the split-K route: row bh's keys in `splits` ranges of `split_keys`;
  // partials (m, l, acc[D]) in ws[bh][split]; arrivals in counters[bh]
  int splits, split_keys;
  float* ws;
  unsigned* counters;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// routes 0 and 1: CUDA cores
// ---------------------------------------------------------------------------

// Shared memory: q tile [BQ][D], K and V tiles [kBlockK][D + 1], key
// validity [kBlockK]; the final merge reuses the front of the same buffer.
__host__ __device__ inline size_t smem_floats(int bq, int d) {
  size_t tiles = (size_t)bq * d + 2 * (size_t)kBlockK * (d + 1) + kBlockK;
  size_t merge = 2 * (size_t)kWarps * bq + (size_t)kWarps * bq * d;
  return tiles > merge ? tiles : merge;
}

// ND = output dims per lane (ceil(D / 32) rounded up to 2 or 4). SPLIT:
// the decode route (BQ = 1, grid (splits, B*H)); else grid (Sq / BQ, B*H).
template <typename T, typename OutT, int BQ, int ND, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ int last_split;
  const int D = p.D;
  const int ldk = D + 1;
  float* q_s = smem;                  // [BQ][D]
  float* k_s = q_s + BQ * D;          // [kBlockK][ldk]
  float* v_s = k_s + kBlockK * ldk;   // [kBlockK][ldk]
  int* ok_s = reinterpret_cast<int*>(v_s + kBlockK * ldk);  // [kBlockK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int split = SPLIT ? blockIdx.x : 0;
  const int q0 = SPLIT ? 0 : blockIdx.x * BQ;
  const int nq = min(BQ, p.Sq - q0);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int* mg = p.mask + b * p.mask_sb;

  for (int r = warp; r < BQ; r += kWarps) {
    const T* qr = qg + (long long)(q0 + r) * p.q_ss;
    for (int d = lane; d < D; d += 32)
      q_s[r * D + d] = r < nq ? to_f32(qr[d]) * p.scale : 0.f;
  }

  float m[BQ], l[BQ], acc[BQ][ND];
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    m[r] = kNegBig;
    l[r] = 0.f;  // this lane's share of the row's denominator
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) acc[r][dd] = 0.f;
  }

  // causal: keys past the tile's last row count for no row of the tile;
  // a split reads only its own range
  int k_lo = 0;
  int k_end = p.causal ? min(p.Sk, q0 + nq) : p.Sk;
  if (SPLIT) {
    k_lo = split * p.split_keys;
    k_end = min(k_end, k_lo + p.split_keys);
  }
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int vpr = D / kVec;             // 16-byte vectors per row
  const int nvec = kBlockK * vpr;
  for (int kt = k_lo; kt < k_end; kt += kBlockK) {
    __syncthreads();  // q staged / the previous tile fully consumed
    // stage K and V: kUnroll independent 16-byte loads of each in flight
    // per thread, then the fp32 conversion into shared memory
    for (int c0 = tid; c0 < nvec; c0 += kThreads * kUnroll) {
      uint4 kb[kUnroll], vb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kThreads;
        const int j = c / vpr;
        const int kj = kt + j;
        kb[u] = vb[u] = make_uint4(0u, 0u, 0u, 0u);
        if (c < nvec && kj < k_end) {
          const int d0 = (c - j * vpr) * kVec;
          kb[u] = *reinterpret_cast<const uint4*>(kg + kj * p.k_ss + d0);
          vb[u] = *reinterpret_cast<const uint4*>(vg + kj * p.v_ss + d0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kThreads;
        if (c < nvec) {
          const int j = c / vpr;
          float* kd = k_s + j * ldk + (c - j * vpr) * kVec;
          float* vd = v_s + j * ldk + (c - j * vpr) * kVec;
          const T* ke = reinterpret_cast<const T*>(&kb[u]);
          const T* ve = reinterpret_cast<const T*>(&vb[u]);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            kd[e] = to_f32(ke[e]);
            vd[e] = to_f32(ve[e]);
          }
        }
      }
    }
    {  // kThreads == kBlockK: one key's validity per thread
      const int kj = kt + tid;
      ok_s[tid] = kj < k_end && mg[kj] > 0;
    }
    __syncthreads();
    if (kt + warp * 32 >= k_end) continue;  // this warp's keys are all out

    const int jw = warp * 32 + lane;  // this lane's key within the tile
    const int kj = kt + jw;
    const bool key_ok = ok_s[jw] != 0;
    float s[BQ];
#pragma unroll
    for (int r = 0; r < BQ; ++r) s[r] = 0.f;
    const float* krow = k_s + jw * ldk;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < BQ; ++r) s[r] = fmaf(q_s[r * D + d], kd, s[r]);
    }

    // online softmax: new row max over this warp's 32 keys, rescale
#pragma unroll
    for (int r = 0; r < BQ; ++r) {
      const bool ok = key_ok && r < nq && (!p.causal || kj <= q0 + r);
      const float sr = ok ? s[r] : -__int_as_float(0x7f800000);  // -inf
      const float m_new = fmaxf(m[r], fmaxf(warp_max(sr), kNegBig));
      const float alpha = expf(m[r] - m_new);
      s[r] = expf(sr - m_new);  // p; exactly 0 for a key that does not count
      l[r] = l[r] * alpha + s[r];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) acc[r][dd] *= alpha;
      m[r] = m_new;
    }
    // PV: key j's p comes from lane j; this lane owns dims lane + 32 dd
    const float* vtile = v_s + warp * 32 * ldk;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      float vj[ND];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) {
        const int d = lane + 32 * dd;
        vj[dd] = d < D ? vtile[j * ldk + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < BQ; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int dd = 0; dd < ND; ++dd) acc[r][dd] = fmaf(pj, vj[dd], acc[r][dd]);
      }
    }
  }

  // merge the kWarps partial states of each row
  __syncthreads();
  float* m_w = smem;                   // [kWarps][BQ]
  float* l_w = m_w + kWarps * BQ;      // [kWarps][BQ]
  float* a_w = l_w + kWarps * BQ;      // [kWarps][BQ][D]
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    const float lsum = warp_sum(l[r]);
    if (lane == 0) {
      m_w[warp * BQ + r] = m[r];
      l_w[warp * BQ + r] = lsum;
    }
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) {
      const int d = lane + 32 * dd;
      if (d < D) a_w[(warp * BQ + r) * D + d] = acc[r][dd];
    }
  }
  __syncthreads();

  OutT* og = static_cast<OutT*>(p.o) + b * p.o_sb + h * p.o_sh;
  if (!SPLIT || p.splits == 1) {
    for (int i = tid; i < nq * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      float mx = kNegBig;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w * BQ + r]);
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(m_w[w * BQ + r] - mx);
        den += l_w[w * BQ + r] * c;
        num += a_w[(w * BQ + r) * D + d] * c;
      }
      den = fmaxf(den, kTiny);
      og[(long long)(q0 + r) * p.o_ss + d] = from_f32<OutT>(num / den);
      if (d == 0) p.lse[(long long)bh * p.Sq + q0 + r] = mx + logf(den);
    }
    return;
  }

  // split-K (BQ = 1): this block's partial state of row bh, unnormalised
  float* part = p.ws + ((long long)bh * p.splits + split) * (D + 2);
  for (int d = tid; d < D; d += kThreads) {
    float mx = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_w[w] - mx);
      den += l_w[w] * c;
      num += a_w[w * D + d] * c;
    }
    part[2 + d] = num;
    if (d == 0) {
      part[0] = mx;
      part[1] = den;
    }
  }
  __threadfence();  // the partial is visible before this block's arrival
  __syncthreads();
  if (tid == 0)
    last_split = atomicInc(p.counters + bh, (unsigned)p.splits - 1) ==
                 (unsigned)p.splits - 1;   // wraps the counter back to 0
  __syncthreads();
  if (!last_split) return;
  __threadfence();
  const float* row = p.ws + (long long)bh * p.splits * (D + 2);
  for (int d = tid; d < D; d += kThreads) {
    float mx = kNegBig;
    for (int s = 0; s < p.splits; ++s)
      mx = fmaxf(mx, __ldcg(row + s * (D + 2)));
    float den = 0.f, num = 0.f;
    for (int s = 0; s < p.splits; ++s) {   // split order: deterministic
      const float* ps = row + s * (D + 2);
      const float c = expf(__ldcg(ps) - mx);
      den += __ldcg(ps + 1) * c;
      num += __ldcg(ps + 2 + d) * c;
    }
    den = fmaxf(den, kTiny);
    og[d] = from_f32<OutT>(num / den);
    if (d == 0) p.lse[bh] = mx + logf(den);
  }
}

template <typename T, typename OutT, int BQ, int ND, bool SPLIT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(BQ, p.D) * sizeof(float);
  auto kern = flash_fwd_kernel<T, OutT, BQ, ND, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(SPLIT ? p.splits : (p.Sq + BQ - 1) / BQ, p.B * p.H);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename OutT>
cudaError_t launch_cuda_cores(const Params& p, int route,
                              cudaStream_t stream) {
  if (route == kSplitK)
    return p.D <= 64 ? launch<T, OutT, 1, 2, true>(p, stream)
                     : launch<T, OutT, 1, 4, true>(p, stream);
  return p.D <= 64 ? launch<T, OutT, 16, 2, false>(p, stream)
                   : launch<T, OutT, 16, 4, false>(p, stream);
}

// ---------------------------------------------------------------------------
// route 2: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 128;            // query rows per block
constexpr int kBK = 128;            // keys per tile
constexpr int kD = 64;              // head dim: one 128-byte row
constexpr int kStages = 3;          // K/V tile stages
constexpr int kConsumerWarps = 8;   // two warpgroups of 64 rows
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + the producer warp
constexpr int kTile = kBK * kD * 2;                  // bytes; Q's too
constexpr int kQOff = 0;
constexpr int kKOff = kQOff + kTile;
constexpr int kVOff = kKOff + kStages * kTile;
constexpr int kBarOff = kVOff + kStages * kTile;     // q, k[S], v[S], empty[S]
constexpr int kMaskOff = kBarOff + 8 * (1 + 3 * kStages);
constexpr int kSmem = kMaskOff + 16 * kStages + 1024;  // + 1024: alignment
static_assert(kBQ == kBK, "one diagonal tile per query tile");

struct TcParams {
  CUtensorMap q_map, k_map, v_map;  // [B, S, H, D] as dims (D, S, H, B)
  const int* mask;
  long long mask_sb;
  bf16* o;
  long long o_sb, o_ss, o_sh;
  float* lse;
  int B, H, Sq, Sk;
  int q_tiles;
  float scale_log2;  // scale * log2 e
  int causal;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ TcParams p) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(smem + kMaskOff);

  const int BH = p.B * p.H;
  const int bh = blockIdx.x % BH;
  const int qt = p.q_tiles - 1 - blockIdx.x / BH;  // the heaviest first
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qt * kBQ;
  const int nq = min(kBQ, p.Sq - q0);
  const int k_end = p.causal ? min(p.Sk, q0 + nq) : p.Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumerWarps) {
    // the producer: Q once, then K/V tiles through the stages, each with
    // its key-validity words
    const int* mg = p.mask + b * p.mask_sb;
    if (lane == 0) {
      mbar_expect_tx(q_full, kTile);
      tma_load_4d(smem + kQOff, &p.q_map, q_full, 0, q0, h, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      if (j >= kStages) mbar_wait(empty + st, ((j / kStages) - 1) & 1);
      const int kt = j * kBK;
      uint32_t words[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int kj = kt + 32 * w + lane;
        words[w] = __ballot_sync(0xffffffffu, kj < k_end && mg[kj] > 0);
      }
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < 4; ++w) mask_s[st * 4 + w] = words[w];
        mbar_expect_tx(k_full + st, kTile);  // releases the words too
        tma_load_4d(smem + kKOff + st * kTile, &p.k_map, k_full + st, 0, kt,
                    h, b);
        mbar_expect_tx(v_full + st, kTile);
        tma_load_4d(smem + kVOff + st * kTile, &p.v_map, v_full + st, 0, kt,
                    h, b);
      }
      __syncwarp();
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile;
  // this thread holds rows r0 and r0 + 8 (see hopper.cuh's layout note)
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + g;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
  const float neg_inf = -__int_as_float(0x7f800000);

  mbar_wait(q_full, 0);
  const uint32_t q_addr = smem_u32(smem + kQOff) + wg * 64 * 128;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const unsigned par = (j / kStages) & 1;
    const int kt = j * kBK;
    const uint32_t k_addr = smem_u32(smem + kKOff + st * kTile);
    const uint32_t v_addr = smem_u32(smem + kVOff + st * kTile);

    // S = Q Kᵀ: 64 x 128, fp32, over D = 64 in 4 slices of 16
    float s[64];
    mbar_wait(k_full + st, par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_ss<0, 0>(s, desc_sw128(q_addr + 32 * kk, 16, 1024),
                                desc_sw128(k_addr + 32 * kk, 16, 1024), kk);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    // masks where the tile needs them
    const uint32_t* mw = mask_s + st * 4;
    const uint32_t w0 = mw[0], w1 = mw[1], w2 = mw[2], w3 = mw[3];
    const bool diag = p.causal && kt + kBK - 1 > q0;
    if (diag || (w0 & w1 & w2 & w3) != 0xffffffffu) {
      const uint32_t words[4] = {w0, w1, w2, w3};
      const int i0 = q0 + r0, i1 = i0 + 8;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * jn + 2 * t + e;
          const bool bit = (words[jn >> 2] >> (c & 31)) & 1u;
          const int kj = kt + c;
          if (!(bit && (!p.causal || kj <= i0))) s[4 * jn + e] = neg_inf;
          if (!(bit && (!p.causal || kj <= i1))) s[4 * jn + 2 + e] = neg_inf;
        }
      }
    }

    // online softmax in the log2 domain: s2 = s * scale * log2 e
    float mx0 = neg_inf, mx1 = neg_inf;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * jn], s[4 * jn + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * jn + 2], s[4 * jn + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m[0], fmaxf(mx0 * p.scale_log2, kNegBig));
    const float mn1 = fmaxf(m[1], fmaxf(mx1 * p.scale_log2, kNegBig));
    const float a0 = exp2f(m[0] - mn0), a1 = exp2f(m[1] - mn1);
    m[0] = mn0;
    m[1] = mn1;
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pa[8][4];  // P as bf16 A fragments, 16 keys per slice
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const float p0 = exp2f(fmaf(s[4 * jn], p.scale_log2, -mn0));
      const float p1 = exp2f(fmaf(s[4 * jn + 1], p.scale_log2, -mn0));
      const float p2 = exp2f(fmaf(s[4 * jn + 2], p.scale_log2, -mn1));
      const float p3 = exp2f(fmaf(s[4 * jn + 3], p.scale_log2, -mn1));
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      // slice kk = jn / 2: regs 0, 1 = rows g, g + 8 of keys 0-7 of the
      // slice; regs 2, 3 = the same rows, keys 8-15
      pa[jn / 2][(jn & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[jn / 2][(jn & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l[0] = l[0] * a0 + sum0;
    l[1] = l[1] * a1 + sum1;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      o[4 * jn] *= a0;
      o[4 * jn + 1] *= a0;
      o[4 * jn + 2] *= a1;
      o[4 * jn + 3] *= a1;
    }

    // O += P V: 64 x 64 over the tile's 128 keys in 8 slices of 16
    mbar_wait(v_full + st, par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_m64n64k16_rs<1>(o, pa[kk],
                            desc_sw128(v_addr + 2048 * kk, 1024, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    if (lane == 0) mbar_arrive(empty + st);
  }

  // normalise and store: rows r0 and r0 + 8, columns 8 jn + 2 t (+ 1)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = q0 + r0 + 8 * half;
    if (i >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[half], kTiny);
    bf16* orow = p.o + b * p.o_sb + h * p.o_sh + (long long)i * p.o_ss;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
      *reinterpret_cast<uint32_t*>(orow + 8 * jn + 2 * t) =
          pack_bf16(o[4 * jn + 2 * half] * inv, o[4 * jn + 2 * half + 1] * inv);
    if (t == 0)
      p.lse[(long long)bh * p.Sq + i] =
          l[half] > 0.f ? m[half] * kLn2 + logf(l[half]) : kNegBig;
  }
}

cudaError_t launch_tensor_cores(const Params& p, cudaStream_t stream) {
  TcParams t{};
  const void* base[3] = {p.q, p.k, p.v};
  const long long st[3][3] = {{p.q_ss, p.q_sh, p.q_sb},
                              {p.k_ss, p.k_sh, p.k_sb},
                              {p.v_ss, p.v_sh, p.v_sb}};
  CUtensorMap* maps[3] = {&t.q_map, &t.k_map, &t.v_map};
  for (int i = 0; i < 3; ++i) {
    const uint64_t dims[4] = {(uint64_t)kD, (uint64_t)(i ? p.Sk : p.Sq),
                              (uint64_t)p.H, (uint64_t)p.B};
    const uint64_t strides[3] = {(uint64_t)st[i][0] * 2,
                                 (uint64_t)st[i][1] * 2,
                                 (uint64_t)st[i][2] * 2};
    const uint32_t box[4] = {kD, kBK, 1, 1};
    const cudaError_t err =
        hopper::make_map(maps[i], base[i], 4, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  t.mask = p.mask;
  t.mask_sb = p.mask_sb;
  t.o = static_cast<bf16*>(p.o);
  t.o_sb = p.o_sb;
  t.o_ss = p.o_ss;
  t.o_sh = p.o_sh;
  t.lse = p.lse;
  t.B = p.B;
  t.H = p.H;
  t.Sq = p.Sq;
  t.Sk = p.Sk;
  t.q_tiles = (p.Sq + kBQ - 1) / kBQ;
  t.scale_log2 = p.scale * kLog2e;
  t.causal = p.causal;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)t.q_tiles * p.B * p.H;
  flash_fwd_tc_kernel<<<(unsigned)blocks, kThreads, kSmem, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The C interface. Pointers are device pointers; strides are in elements.
// The caller (the Python wrapper) has checked shapes, dtypes (q, k, v all
// fp32, or all bf16), D % 8 == 0 with D <= 128, B * H <= 65535, that the
// last dim of every view is contiguous, and that rows start on 16-byte
// boundaries (base pointers and strides), and picked `route` (0 CUDA
// cores, 1 split-K decode, 2 tensor cores); this checks that the route
// takes the call. The split-K route also takes `splits` ranges of
// `split_keys` keys covering Sk, a workspace `ws` of B*H*splits*(D + 2)
// floats and `counters`, B*H zeroed unsigned ints (zero again when the
// launch ends). Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const int* mask, void* o, float* lse, int B, int H,
                         int Sq, int Sk, int D, long long q_sb, long long q_ss,
                         long long q_sh, long long k_sb, long long k_ss,
                         long long k_sh, long long v_sb, long long v_ss,
                         long long v_sh, long long o_sb, long long o_ss,
                         long long o_sh, long long mask_sb, float scale,
                         int causal, int in_bf16, int out_f32, int route,
                         int splits, int split_keys, float* ws,
                         unsigned* counters, void* stream) {
  Params p{q,    k,    v,    mask, o,    lse,  B,    H,       Sq,
           Sk,   D,    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,    v_sb,
           v_ss, v_sh, o_sb, o_ss, o_sh, mask_sb, scale, causal,
           splits, split_keys, ws, counters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kTensorCore) {
    if (!in_bf16 || out_f32 || D != tc::kD || Sq < 2)
      return (int)cudaErrorInvalidValue;
    return (int)tc::launch_tensor_cores(p, s);
  }
  if (route == kSplitK) {
    if (Sq != 1 || splits < 1 || splits > kMaxSplits || split_keys < 1 ||
        (long long)splits * split_keys < Sk ||
        (splits > 1 && (ws == nullptr || counters == nullptr)))
      return (int)cudaErrorInvalidValue;
  } else if (route != kCudaCore || Sq < 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (!in_bf16)
    err = launch_cuda_cores<float, float>(p, route, s);
  else if (out_f32)
    err = launch_cuda_cores<__nv_bfloat16, float>(p, route, s);
  else
    err = launch_cuda_cores<__nv_bfloat16, __nv_bfloat16>(p, route, s);
  return (int)err;
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
