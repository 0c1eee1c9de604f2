// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV, from
// the forward's fp32 log-sum-exp and delta = rowsum(dO * O), recomputing the
// probabilities P instead of storing them.
//
// Replaces the TPU kernels dear_pytorch_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (dQ) and ::_bwd_dkv_kernel (dK, dV) — their function, not
// their block structure. Built by dear_pytorch_tpu_torch/ops/_build.py with
// nvcc into a shared library with a plain C interface; called through ctypes
// by dear_pytorch_tpu_torch/ops/flash_attention.py.
//
// What both compute, for query row i and key j of head bh (b = bh / H):
//   s_ij  = (scale * q_i) . k_j                             (fp32)
//   valid = mask[b, j] > 0 and, when causal, j <= i          (top-left)
//   p_ij  = valid ? exp(s_ij - lse_i) : 0     (a select, never a product: an
//           all-masked row has lse = -1e30, so s - lse overflows to inf and
//           inf * 0 would be NaN where the TPU kernel's jnp.where gives 0)
//   ds_ij = p_ij * (dO_i . v_j - delta_i)
//   dQ_i  = scale * sum_j ds_ij k_j
//   dV_j  = sum_i p_ij dO_i,   dK_j = sum_i ds_ij (scale * q_i)
// All sums in fp32; outputs in the inputs' dtype or in fp32 (ring
// attention's out_dtype: bf16 inputs, fp32 partial gradients).
//
// What bounds them on this card: at the training shape (B=16, S=1024, H=12,
// D=64, causal, 100.8 M query-key pairs) dQ does 6·D = 384 flops per pair
// (38.7 GFLOP) and dK/dV 8·D = 512 (51.6 GFLOP) on about 25 MB of operands:
// operations, 0.039 and 0.052 ms at 989 TF/s bf16.
//
// Two routes, picked per call by the wrapper's `bwd_route` from the head
// dim and the dtypes alone; there is no fallback between them.
//
// Route 2, tensor cores (bf16 in, bf16 out, D = 64: every K2/K3 call of the
// bf16 training step). Design, K1's tensor-core route (csrc/flash_fwd.cu)
// with one producer warp and two consumer warpgroups (288 threads):
//   - dK/dV: a block owns 128 keys of one bh, a warpgroup 64 of them. The
//     producer loads K and V once by TMA (4-d tensor maps over the strided
//     [B, S, H, D] views, 128-byte swizzle), then fills a ring of stages of
//     64 queries: Q and dO by TMA, lse (times log2 e) and delta with plain
//     loads, every producer lane arriving on the stage's barrier after its
//     stores. A consumer computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ by wgmma
//     (m64n64k16, both operands K-major in shared memory, keys as M), then
//     Pᵀ = valid ? exp2(Sᵀ·scale·log2 e − lse·log2 e) : 0 and
//     dSᵀ = Pᵀ∘(dPᵀ − delta) in fp32 registers, lse and delta indexing
//     the accumulator's columns; rounds Pᵀ and dSᵀ to bf16 A fragments in
//     registers and adds dV += Pᵀ·dO and dK += dSᵀ·Q by wgmma with dO and
//     Q as MN-major B operands: the same shared tile is a K-major B in the first product
//     and an MN-major B in the second (a 128-byte row is one swizzle atom,
//     so both descriptors apply). dK is stored times scale. A causal block
//     starts its query loop at its first key (the TPU kernel's
//     _q_index_map_dkv); a warpgroup skips a stage whose queries all come
//     before its keys; the grid issues the lowest, most loaded key blocks
//     first.
//   - dQ: a block owns 128 query rows of one bh (K1's own structure and
//     grid order: the last, most loaded query tiles first). The producer
//     loads Q and dO once and fills a ring of 64-key K/V stages, packing
//     each key tile's validity (mask > 0, inside Sk and, when causal,
//     before the block's last row) into two 32-bit words beside it. A
//     consumer takes lse and delta of its two rows from global memory once,
//     computes S = Q·Kᵀ and dP = dO·Vᵀ by wgmma (m64n64k16), P and dS as
//     above (row-indexed here), and adds dQ += dS·K with dS from registers
//     and K, read K-major a moment before, as an MN-major B. A causal block
//     stops at the tile that holds its last row's diagonal; a warpgroup
//     skips a tile with no valid key or whose keys all come after its rows.
//     dQ is stored times scale.
//   - registers: 288 threads leave each 168 (three of the nine warps share
//     one SM sub-partition's 16K). K3 holds Sᵀ, dPᵀ, dK and dV (4 x 32
//     fp32) at 64-query stages; K2 holds S, dP and dQ at 64-key stages
//     (at 128 keys S and dP take 64 fp32 each and ptxas reports a spill).
//   - masks (a select, never a product) are applied only to tiles that
//     need them: a causal tile that crosses the diagonal, a tile with an
//     invalid key, a ragged edge. TMA reads rows past Sq or Sk as zeros, and
//     a zero key row would give s = 0 and p = exp(−lse) ≠ 0, so the
//     validity bits, not the zeros, mask them.
//   - S and dP accumulate in fp32 from bf16 operands; P and dS are rounded
//     to bf16 before the second products, as K1 rounds P: within 2e-2 of the
//     largest plain value. No atomics: each output row is owned by one
//     block and summed in a fixed order, so both kernels are bitwise
//     repeatable, and dQ stands alone (ring attention calls it separately).
//
// Route 0, CUDA cores (fp32 inputs; bf16 inputs with fp32 outputs, ring
// attention's out_dtype, which bf16-rounded P and dS cannot meet at 1e-4;
// head dims other than 64): the first, simple design, kept unchanged.
// It runs every product as fp32 fmaf out of shared memory, far above the
// bound. Mirroring csrc/flash_fwd.cu's CUDA-core route:
//   - dQ: one block of 4 warps per (BR query rows, bh). The scaled q rows and
//     dO rows sit in shared memory; a loop over key tiles of 128 keys stages
//     K and V (fp32, rows padded to D + 1 floats: lane j reading row j is
//     free of bank conflicts) with 16-byte loads. Lane j of warp w owns key
//     32w + j: it computes s and dO.v for every row, then ds; the dQ product
//     broadcasts each key's ds with a shuffle while each lane owns the output
//     dims lane, lane + 32, ...; the 4 warps' partial dQ rows are summed
//     through shared memory at the end. A causal block stops its key loop at
//     the tile holding its last row's diagonal (the TPU kernel's _k_index_map
//     clamp).
//   - dK/dV: the same shape with the roles swapped: one block per (BR key
//     rows, bh), a loop over query tiles of 128 queries staging scaled q, dO,
//     lse and delta; lane j owns query 32w + j. A causal block starts at the
//     first query tile that reaches its first key (_q_index_map_dkv).
//   - ragged Sq and Sk edges are masked here, so any length is accepted.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kThreads;  // keys (dQ) or queries (dK/dV) per tile
constexpr int kUnroll = 4;       // 16-byte loads in flight per thread

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* mask;     // [B, Sk], unit stride along Sk
  const float* lse;    // [B * H, Sq], contiguous
  const float* delta;  // [B * H, Sq], contiguous
  void* dq;
  void* dk;
  void* dv;
  int B, H, Sq, Sk, D;
  // element strides (batch, sequence, head) of the [B, S, H, D] views
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  long long mask_sb;
  float scale;
  int causal;
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

// Stage rows row0 .. row0 + kTile - 1 of a [.., S, .., D] view (row stride
// ss) into dst[kTile][ld] as fp32 times mul; rows at or past `limit` are 0.
template <typename T>
__device__ __forceinline__ void stage_tile(float* dst, int ld, const T* src,
                                           long long ss, int row0, int limit,
                                           int D, float mul) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int vpr = D / kVec;
  const int nvec = kTile * vpr;
  for (int c0 = threadIdx.x; c0 < nvec; c0 += kThreads * kUnroll) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      const int j = c / vpr;
      buf[u] = make_uint4(0u, 0u, 0u, 0u);
      if (c < nvec && row0 + j < limit)
        buf[u] = *reinterpret_cast<const uint4*>(
            src + (long long)(row0 + j) * ss + (c - j * vpr) * kVec);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      if (c < nvec) {
        const int j = c / vpr;
        float* d = dst + j * ld + (c - j * vpr) * kVec;
        const T* e = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
        for (int x = 0; x < kVec; ++x) d[x] = to_f32(e[x]) * mul;
      }
    }
  }
}

// Shared memory of both kernels: BR resident rows of two operands, a tile of
// two operands padded to D + 1, and two floats (or one int) per tile row;
// the final merge reuses the front of the same buffer.
__host__ __device__ inline size_t smem_floats(int br, int d) {
  size_t tiles = 2 * (size_t)br * d + 2 * (size_t)kTile * (d + 1) + 2 * kTile;
  size_t merge = 2 * (size_t)kWarps * br * d;
  return tiles > merge ? tiles : merge;
}

// ---------------------------------------------------------------------------
// dQ (the TPU _bwd_dq_kernel)
// ---------------------------------------------------------------------------

template <typename T, typename OutT, int BR, int ND>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* q_s = smem;                 // [BR][D], scaled
  float* do_s = q_s + BR * D;        // [BR][D]
  float* k_s = do_s + BR * D;        // [kTile][ld]
  float* v_s = k_s + kTile * ld;     // [kTile][ld]
  int* ok_s = reinterpret_cast<int*>(v_s + kTile * ld);  // [kTile]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * BR;
  const int nq = min(BR, p.Sq - q0);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int* mg = p.mask + b * p.mask_sb;

  for (int r = warp; r < BR; r += kWarps) {
    const long long qo = (long long)(q0 + r) * p.q_ss;
    const long long doo = (long long)(q0 + r) * p.do_ss;
    for (int d = lane; d < D; d += 32) {
      q_s[r * D + d] = r < nq ? to_f32(qg[qo + d]) * p.scale : 0.f;
      do_s[r * D + d] = r < nq ? to_f32(dog[doo + d]) : 0.f;
    }
  }
  float lse[BR], delta[BR], acc[BR][ND];
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    const long long i = (long long)bh * p.Sq + q0 + r;
    lse[r] = r < nq ? p.lse[i] : 0.f;
    delta[r] = r < nq ? p.delta[i] : 0.f;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) acc[r][dd] = 0.f;
  }

  // causal: keys past the block's last row count for none of its rows
  const int k_end = p.causal ? min(p.Sk, q0 + nq) : p.Sk;
  for (int kt = 0; kt < k_end; kt += kTile) {
    __syncthreads();  // rows staged / the previous tile fully consumed
    stage_tile(k_s, ld, kg, p.k_ss, kt, k_end, D, 1.f);
    stage_tile(v_s, ld, vg, p.v_ss, kt, k_end, D, 1.f);
    {
      const int kj = kt + tid;  // kThreads == kTile: one key per thread
      ok_s[tid] = kj < k_end && mg[kj] > 0;
    }
    __syncthreads();
    if (kt + warp * 32 >= k_end) continue;  // this warp's keys are all out

    const int jw = warp * 32 + lane;  // this lane's key within the tile
    const int kj = kt + jw;
    const bool key_ok = ok_s[jw] != 0;
    float s[BR], dp[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) s[r] = dp[r] = 0.f;
    const float* krow = k_s + jw * ld;
    const float* vrow = v_s + jw * ld;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
      const float vd = vrow[d];
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        s[r] = fmaf(q_s[r * D + d], kd, s[r]);
        dp[r] = fmaf(do_s[r * D + d], vd, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const bool ok = key_ok && r < nq && (!p.causal || kj <= q0 + r);
      const float pr = ok ? expf(s[r] - lse[r]) : 0.f;
      s[r] = pr * (dp[r] - delta[r]);  // ds
    }
    // dQ += ds_j k_j: key j's ds comes from lane j; this lane owns dims
    // lane + 32 dd
    const float* ktile = k_s + warp * 32 * ld;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      float kv[ND];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) {
        const int d = lane + 32 * dd;
        kv[dd] = d < D ? ktile[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int dd = 0; dd < ND; ++dd) acc[r][dd] = fmaf(dsj, kv[dd], acc[r][dd]);
      }
    }
  }

  // sum the kWarps partial rows
  __syncthreads();
  float* a_w = smem;  // [kWarps][BR][D]
#pragma unroll
  for (int r = 0; r < BR; ++r) {
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) {
      const int d = lane + 32 * dd;
      if (d < D) a_w[(warp * BR + r) * D + d] = acc[r][dd];
    }
  }
  __syncthreads();
  OutT* dqg = static_cast<OutT*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  for (int i = tid; i < nq * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += a_w[(w * BR + r) * D + d];
    dqg[(long long)(q0 + r) * p.dq_ss + d] = from_f32<OutT>(sum * p.scale);
  }
}

// ---------------------------------------------------------------------------
// dK and dV (the TPU _bwd_dkv_kernel)
// ---------------------------------------------------------------------------

template <typename T, typename OutT, int BR, int ND>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* k_s = smem;                 // [BR][D]
  float* v_s = k_s + BR * D;         // [BR][D]
  float* q_s = v_s + BR * D;         // [kTile][ld], scaled
  float* do_s = q_s + kTile * ld;    // [kTile][ld]
  float* lse_s = do_s + kTile * ld;  // [kTile]
  float* delta_s = lse_s + kTile;    // [kTile]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.x * BR;
  const int nk = min(BR, p.Sk - k0);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int* mg = p.mask + b * p.mask_sb;

  for (int r = warp; r < BR; r += kWarps) {
    const long long ko = (long long)(k0 + r) * p.k_ss;
    const long long vo = (long long)(k0 + r) * p.v_ss;
    for (int d = lane; d < D; d += 32) {
      k_s[r * D + d] = r < nk ? to_f32(kg[ko + d]) : 0.f;
      v_s[r * D + d] = r < nk ? to_f32(vg[vo + d]) : 0.f;
    }
  }
  bool key_ok[BR];
  float dk[BR][ND], dv[BR][ND];
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    key_ok[r] = r < nk && mg[k0 + r] > 0;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) dk[r][dd] = dv[r][dd] = 0.f;
  }

  // causal: query tiles wholly before the block's first key see none of it
  const int q_begin = p.causal ? (k0 / kTile) * kTile : 0;
  const float* lseg = p.lse + (long long)bh * p.Sq;
  const float* deltag = p.delta + (long long)bh * p.Sq;
  for (int qt = q_begin; qt < p.Sq; qt += kTile) {
    __syncthreads();  // rows staged / the previous tile fully consumed
    stage_tile(q_s, ld, qg, p.q_ss, qt, p.Sq, D, p.scale);
    stage_tile(do_s, ld, dog, p.do_ss, qt, p.Sq, D, 1.f);
    {
      const int qi = qt + tid;  // kThreads == kTile: one query per thread
      lse_s[tid] = qi < p.Sq ? lseg[qi] : 0.f;
      delta_s[tid] = qi < p.Sq ? deltag[qi] : 0.f;
    }
    __syncthreads();
    if (qt + warp * 32 >= p.Sq) continue;  // this warp's queries are all out

    const int iw = warp * 32 + lane;  // this lane's query within the tile
    const int qi = qt + iw;
    float s[BR], ds[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) s[r] = ds[r] = 0.f;
    const float* qrow = q_s + iw * ld;
    const float* dorow = do_s + iw * ld;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
      const float dod = dorow[d];
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        s[r] = fmaf(qd, k_s[r * D + d], s[r]);
        ds[r] = fmaf(dod, v_s[r * D + d], ds[r]);
      }
    }
    const float lse_i = lse_s[iw];
    const float delta_i = delta_s[iw];
    const bool q_ok = qi < p.Sq;
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const bool ok = key_ok[r] && q_ok && (!p.causal || k0 + r <= qi);
      const float pr = ok ? expf(s[r] - lse_i) : 0.f;
      s[r] = pr;                        // p
      ds[r] = pr * (ds[r] - delta_i);   // ds
    }
    // dV_r += p_ir dO_i and dK_r += ds_ir q_i: query i's p and ds come from
    // lane i; this lane owns dims lane + 32 dd
    const float* qtile = q_s + warp * 32 * ld;
    const float* dotile = do_s + warp * 32 * ld;
#pragma unroll 2
    for (int i = 0; i < 32; ++i) {
      float qv[ND], dov[ND];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) {
        const int d = lane + 32 * dd;
        qv[dd] = d < D ? qtile[i * ld + d] : 0.f;
        dov[dd] = d < D ? dotile[i * ld + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float pi = __shfl_sync(0xffffffffu, s[r], i);
        const float dsi = __shfl_sync(0xffffffffu, ds[r], i);
#pragma unroll
        for (int dd = 0; dd < ND; ++dd) {
          dv[r][dd] = fmaf(pi, dov[dd], dv[r][dd]);
          dk[r][dd] = fmaf(dsi, qv[dd], dk[r][dd]);
        }
      }
    }
  }

  // sum the kWarps partial rows of dK and dV
  __syncthreads();
  float* dk_w = smem;                   // [kWarps][BR][D]
  float* dv_w = dk_w + kWarps * BR * D;  // [kWarps][BR][D]
#pragma unroll
  for (int r = 0; r < BR; ++r) {
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) {
      const int d = lane + 32 * dd;
      if (d < D) {
        dk_w[(warp * BR + r) * D + d] = dk[r][dd];
        dv_w[(warp * BR + r) * D + d] = dv[r][dd];
      }
    }
  }
  __syncthreads();
  OutT* dkg = static_cast<OutT*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  OutT* dvg = static_cast<OutT*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  for (int i = tid; i < nk * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float sk = 0.f, sv = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sk += dk_w[(w * BR + r) * D + d];
      sv += dv_w[(w * BR + r) * D + d];
    }
    dkg[(long long)(k0 + r) * p.dk_ss + d] = from_f32<OutT>(sk);
    dvg[(long long)(k0 + r) * p.dv_ss + d] = from_f32<OutT>(sv);
  }
}

template <typename Kern>
cudaError_t launch(Kern kern, int br, int rows, const Params& p,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(br, p.D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + br - 1) / br, p.B * p.H);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// BR = 16 resident rows for D <= 64 (2 output dims per lane), 8 for
// D <= 128 (4 per lane), which keeps the per-thread accumulators in
// registers. OutT: the outputs' dtype (the inputs', or fp32).
template <typename T, typename OutT>
cudaError_t launch_dq(const Params& p, cudaStream_t s) {
  if (p.D <= 64)
    return launch(flash_bwd_dq_kernel<T, OutT, 16, 2>, 16, p.Sq, p, s);
  return launch(flash_bwd_dq_kernel<T, OutT, 8, 4>, 8, p.Sq, p, s);
}

template <typename T, typename OutT>
cudaError_t launch_dkv(const Params& p, cudaStream_t s) {
  if (p.D <= 64)
    return launch(flash_bwd_dkv_kernel<T, OutT, 16, 2>, 16, p.Sk, p, s);
  return launch(flash_bwd_dkv_kernel<T, OutT, 8, 4>, 8, p.Sk, p, s);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const int* mask, const float* lse,
                   const float* delta, void* dq, void* dk, void* dv, int B,
                   int H, int Sq, int Sk, int D, const long long* st,
                   float scale, int causal) {
  return Params{q,      k,      v,      dout,   mask,   lse,    delta,
                dq,     dk,     dv,     B,      H,      Sq,     Sk,
                D,      st[0],  st[1],  st[2],  st[3],  st[4],  st[5],
                st[6],  st[7],  st[8],  st[9],  st[10], st[11], st[12],
                st[13], st[14], st[15], st[16], st[17], st[18], st[19],
                st[20], st[21], scale,  causal};
}


// ---------------------------------------------------------------------------
// route 2: tensor cores (bf16 in and out, D = 64)
// ---------------------------------------------------------------------------

enum Route { kCudaCore = 0, kTensorCore = 2 };  // as csrc/flash_fwd.cu's

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kD = 64;                    // head dim: one 128-byte row
constexpr int kRows = 128;                // a block's own rows (q or k)
constexpr int kConsumerWarps = 8;         // two warpgroups of 64 rows
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + the producer warp
constexpr int kRowTile = kRows * kD * 2;  // bytes of the block's 128 rows
constexpr float kLog2e = 1.4426950408889634f;

// dQ: stages of kDqBK keys (K and V tiles), validity words beside them.
// 288 threads leave a thread 168 registers (9 warps on 4 sub-partitions:
// three share one's 16K), so S and dP are 64 x 64 (m64n64k16): at 128 keys
// they took 64 fp32 each and spilled.
constexpr int kDqBK = 64;
constexpr int kDqStages = 4;
constexpr int kDqWords = kDqBK / 32;
static_assert(kDqBK == 64, "S and dP are m64n64 accumulators");
constexpr int kDqKTile = kDqBK * kD * 2;
constexpr int kDqQOff = 0;
constexpr int kDqDoOff = kDqQOff + kRowTile;
constexpr int kDqKOff = kDqDoOff + kRowTile;
constexpr int kDqVOff = kDqKOff + kDqStages * kDqKTile;
constexpr int kDqBarOff = kDqVOff + kDqStages * kDqKTile;  // q, k, v, empty
constexpr int kDqWordsOff = kDqBarOff + 8 * (1 + 3 * kDqStages);
constexpr int kDqSmem = kDqWordsOff + 4 * kDqWords * kDqStages + 1024;

// dK/dV: stages of kKvBQ queries (Q and dO tiles, lse·log2 e and delta)
constexpr int kKvBQ = 64;
constexpr int kKvStages = 4;
constexpr int kKvQTile = kKvBQ * kD * 2;
constexpr int kKvKOff = 0;
constexpr int kKvVOff = kKvKOff + kRowTile;
constexpr int kKvQOff = kKvVOff + kRowTile;
constexpr int kKvDoOff = kKvQOff + kKvStages * kKvQTile;
constexpr int kKvRowOff = kKvDoOff + kKvStages * kKvQTile;  // lse2, delta
// barriers: kv, full[S], empty[S]
constexpr int kKvBarOff = kKvRowOff + 2 * 4 * kKvBQ * kKvStages;
constexpr int kKvSmem = kKvBarOff + 8 * (1 + 2 * kKvStages) + 1024;

struct TcParams {
  // [B, S, H, D] as dims (D, S, H, B); boxes of the block's 128 rows for
  // its own operands, of one stage for the streamed ones
  CUtensorMap q_map, k_map, v_map, do_map;
  const int* mask;
  long long mask_sb;
  const float* lse;    // [B * H, Sq]
  const float* delta;  // [B * H, Sq]
  bf16* out0;          // dQ, or dK
  bf16* out1;          // dV
  long long o0_sb, o0_ss, o0_sh, o1_sb, o1_ss, o1_sh;
  int B, H, Sq, Sk;
  int tiles;           // row tiles of 128 (queries for dQ, keys for dK/dV)
  float scale, scale_log2;
  int causal;
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Store rows `row` and `row + 8` (this thread's m64n64 accumulator
// fragment: columns 8j + 2t and + 1) times `mul` as bf16; rows at or past
// `limit` are not stored.
__device__ __forceinline__ void store_rows(bf16* base, long long ss, int row,
                                           int limit, int t,
                                           const float (&acc)[32],
                                           float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= limit) continue;
    bf16* out = base + (long long)r * ss;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * t) =
          pack_bf16(acc[4 * j + 2 * half] * mul,
                    acc[4 * j + 2 * half + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// dQ (the TPU _bwd_dq_kernel)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ TcParams p) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kDqBarOff);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kDqStages;
  uint64_t* empty = v_full + kDqStages;
  uint32_t* words_s = reinterpret_cast<uint32_t*>(smem + kDqWordsOff);

  const int BH = p.B * p.H;
  const int bh = blockIdx.x % BH;
  const int qt = p.tiles - 1 - blockIdx.x / BH;  // the most loaded first
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qt * kRows;
  const int nq = min(kRows, p.Sq - q0);
  // causal: keys past the block's last row count for none of its rows
  const int k_end = p.causal ? min(p.Sk, q0 + nq) : p.Sk;
  const int n_tiles = (k_end + kDqBK - 1) / kDqBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumerWarps) {
    // the producer: Q and dO once, then K/V tiles through the stages, each
    // with its key-validity words
    const int* mg = p.mask + b * p.mask_sb;
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * kRowTile);
      tma_load_4d(smem + kDqQOff, &p.q_map, q_full, 0, q0, h, b);
      tma_load_4d(smem + kDqDoOff, &p.do_map, q_full, 0, q0, h, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kDqStages;
      if (j >= kDqStages) mbar_wait(empty + st, ((j / kDqStages) - 1) & 1);
      const int kt = j * kDqBK;
      uint32_t words[kDqWords];
#pragma unroll
      for (int w = 0; w < kDqWords; ++w) {
        const int kj = kt + 32 * w + lane;
        words[w] = __ballot_sync(0xffffffffu, kj < k_end && mg[kj] > 0);
      }
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < kDqWords; ++w)
          words_s[st * kDqWords + w] = words[w];
        mbar_expect_tx(k_full + st, kDqKTile);  // releases the words too
        tma_load_4d(smem + kDqKOff + st * kDqKTile, &p.k_map, k_full + st, 0,
                    kt, h, b);
        mbar_expect_tx(v_full + st, kDqKTile);
        tma_load_4d(smem + kDqVOff + st * kDqKTile, &p.v_map, v_full + st, 0,
                    kt, h, b);
      }
      __syncwarp();
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile;
  // this thread holds rows r0 and r0 + 8 (hopper.cuh's layout note)
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + g;
  const int i0 = q0 + r0, i1 = i0 + 8;
  const float* lse_g = p.lse + (long long)bh * p.Sq;
  const float* delta_g = p.delta + (long long)bh * p.Sq;
  // lse in the log2 domain; rows past Sq are never stored
  const float l0 = i0 < p.Sq ? lse_g[i0] * kLog2e : 0.f;
  const float l1 = i1 < p.Sq ? lse_g[i1] * kLog2e : 0.f;
  const float d0 = i0 < p.Sq ? delta_g[i0] : 0.f;
  const float d1 = i1 < p.Sq ? delta_g[i1] : 0.f;
  const int row_lo = q0 + wg * 64;  // the warpgroup's first row
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  mbar_wait(q_full, 0);
  const uint32_t q_addr = smem_u32(smem + kDqQOff) + wg * 64 * 128;
  const uint32_t do_addr = smem_u32(smem + kDqDoOff) + wg * 64 * 128;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kDqStages;
    const unsigned par = (j / kDqStages) & 1;
    const int kt = j * kDqBK;
    const uint32_t k_addr = smem_u32(smem + kDqKOff + st * kDqKTile);
    const uint32_t v_addr = smem_u32(smem + kDqVOff + st * kDqKTile);

    mbar_wait(k_full + st, par);
    uint32_t words[kDqWords], all = 0xffffffffu, any = 0u;
#pragma unroll
    for (int w = 0; w < kDqWords; ++w) {
      words[w] = words_s[st * kDqWords + w];
      all &= words[w];
      any |= words[w];
    }
    // nothing to add: no key of the tile counts, or (causal) every key
    // lies after every row of this warpgroup
    if (any == 0u || (p.causal && kt > row_lo + 63)) {
      mbar_wait(v_full + st, par);  // the stage is whole before it is freed
      if (lane == 0) mbar_arrive(empty + st);
      continue;
    }

    // S = Q Kᵀ and dP = dO Vᵀ: 64 x 64 each, fp32, over D in 4 slices
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss<0, 0>(s, desc_sw128(q_addr + 32 * kk, 16, 1024),
                               desc_sw128(k_addr + 32 * kk, 16, 1024), kk);
    wgmma_commit();
    mbar_wait(v_full + st, par);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss<0, 0>(dp, desc_sw128(do_addr + 32 * kk, 16, 1024),
                               desc_sw128(v_addr + 32 * kk, 16, 1024), kk);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(s);

    // P = exp(s·scale − lse) where the key counts, else 0 (a select);
    // masks only where the tile needs them
    const bool diag = p.causal && kt + kDqBK - 1 > row_lo;
    if (diag || all != 0xffffffffu) {
#pragma unroll
      for (int jn = 0; jn < kDqBK / 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * jn + 2 * t + e;
          const bool bit = (words[c >> 5] >> (c & 31)) & 1u;
          const int kj = kt + c;
          const bool ok0 = bit && (!p.causal || kj <= i0);
          const bool ok1 = bit && (!p.causal || kj <= i1);
          s[4 * jn + e] =
              ok0 ? exp2f(fmaf(s[4 * jn + e], p.scale_log2, -l0)) : 0.f;
          s[4 * jn + 2 + e] =
              ok1 ? exp2f(fmaf(s[4 * jn + 2 + e], p.scale_log2, -l1)) : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int jn = 0; jn < kDqBK / 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * jn + e] = exp2f(fmaf(s[4 * jn + e], p.scale_log2, -l0));
          s[4 * jn + 2 + e] =
              exp2f(fmaf(s[4 * jn + 2 + e], p.scale_log2, -l1));
        }
      }
    }

    // dS = P (dP − delta), rounded to bf16 A fragments: slice kk = jn / 2
    // holds keys 16 kk .. 16 kk + 15 (regs 0, 1: rows g, g + 8 of its keys
    // 0-7; regs 2, 3: keys 8-15), as K1 packs P
    wgmma_wait<0>();
    reg_fence(dp);
    uint32_t da[kDqBK / 16][4];
#pragma unroll
    for (int jn = 0; jn < kDqBK / 8; ++jn) {
      da[jn / 2][(jn & 1) * 2 + 0] =
          pack_bf16(s[4 * jn] * (dp[4 * jn] - d0),
                    s[4 * jn + 1] * (dp[4 * jn + 1] - d0));
      da[jn / 2][(jn & 1) * 2 + 1] =
          pack_bf16(s[4 * jn + 2] * (dp[4 * jn + 2] - d1),
                    s[4 * jn + 3] * (dp[4 * jn + 3] - d1));
    }

    // dQ += dS K: K, K-major in S = Q Kᵀ, is an MN-major B here (16 keys =
    // 16 rows = 2048 bytes per slice)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqBK / 16; ++kk)
      wgmma_m64n64k16_rs<1>(dq, da[kk],
                            desc_sw128(k_addr + 2048 * kk, 1024, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq);
    if (lane == 0) mbar_arrive(empty + st);
  }

  store_rows(p.out0 + b * p.o0_sb + h * p.o0_sh, p.o0_ss, i0, p.Sq, t, dq,
             p.scale);
}

// ---------------------------------------------------------------------------
// dK and dV (the TPU _bwd_dkv_kernel)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ TcParams p) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  float* lse2_s = reinterpret_cast<float*>(smem + kKvRowOff);  // [S][kKvBQ]
  float* delta_s = lse2_s + kKvStages * kKvBQ;                // [S][kKvBQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + kKvBarOff);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kKvStages;

  const int BH = p.B * p.H;
  const int bh = blockIdx.x % BH;
  const int kt = blockIdx.x / BH;  // the lowest, most loaded keys first
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = kt * kRows;
  // causal: queries before the block's first key see none of its keys
  const int q_begin = p.causal ? k0 : 0;
  const int n_stages =
      q_begin < p.Sq ? (p.Sq - q_begin + kKvBQ - 1) / kKvBQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(full + s, 32);  // every producer lane, after its stores
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumerWarps) {
    // the producer: K and V once, then Q/dO tiles through the stages, each
    // with its queries' lse (times log2 e) and delta
    const float* lse_g = p.lse + (long long)bh * p.Sq;
    const float* delta_g = p.delta + (long long)bh * p.Sq;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * kRowTile);
      tma_load_4d(smem + kKvKOff, &p.k_map, kv_full, 0, k0, h, b);
      tma_load_4d(smem + kKvVOff, &p.v_map, kv_full, 0, k0, h, b);
    }
    for (int j = 0; j < n_stages; ++j) {
      const int st = j % kKvStages;
      if (j >= kKvStages) mbar_wait(empty + st, ((j / kKvStages) - 1) & 1);
      const int qs = q_begin + j * kKvBQ;
      for (int e = lane; e < kKvBQ; e += 32) {
        const int qi = qs + e;
        lse2_s[st * kKvBQ + e] = qi < p.Sq ? lse_g[qi] * kLog2e : 0.f;
        delta_s[st * kKvBQ + e] = qi < p.Sq ? delta_g[qi] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full + st, 2 * kKvQTile);  // and lane 0's arrival
        tma_load_4d(smem + kKvQOff + st * kKvQTile, &p.q_map, full + st, 0,
                    qs, h, b);
        tma_load_4d(smem + kKvDoOff + st * kKvQTile, &p.do_map, full + st, 0,
                    qs, h, b);
      } else {
        mbar_arrive(full + st);  // releases this lane's lse and delta
      }
      __syncwarp();
    }
    return;
  }

  // the consumers: warpgroup wg owns keys 64 wg .. 64 wg + 63 of the block
  // (the accumulators' rows); this thread holds keys kr0 and kr0 + 8, and
  // of each stage the columns (queries) 8j + 2t and + 1
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int kw = k0 + wg * 64;  // the warpgroup's first key
  const int kr0 = kw + (warp % 4) * 16 + g, kr1 = kr0 + 8;
  const int* mg = p.mask + b * p.mask_sb;
  const bool ok_k0 = kr0 < p.Sk && mg[kr0] > 0;
  const bool ok_k1 = kr1 < p.Sk && mg[kr1] > 0;
  const bool keys_all = __all_sync(0xffffffffu, ok_k0 && ok_k1);
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  const uint32_t k_addr = smem_u32(smem + kKvKOff) + wg * 64 * 128;
  const uint32_t v_addr = smem_u32(smem + kKvVOff) + wg * 64 * 128;
  for (int j = 0; j < n_stages; ++j) {
    const int st = j % kKvStages;
    const unsigned par = (j / kKvStages) & 1;
    const int qs = q_begin + j * kKvBQ;
    mbar_wait(full + st, par);
    if (p.causal && qs + kKvBQ - 1 < kw) {  // every key after every query
      if (lane == 0) mbar_arrive(empty + st);
      continue;
    }
    const uint32_t q_addr = smem_u32(smem + kKvQOff + st * kKvQTile);
    const uint32_t do_addr = smem_u32(smem + kKvDoOff + st * kKvQTile);
    const float* lse2 = lse2_s + st * kKvBQ;
    const float* dlt = delta_s + st * kKvBQ;

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 64 keys x 64 queries, fp32, over D
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss<0, 0>(s, desc_sw128(k_addr + 32 * kk, 16, 1024),
                               desc_sw128(q_addr + 32 * kk, 16, 1024), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss<0, 0>(dp, desc_sw128(v_addr + 32 * kk, 16, 1024),
                               desc_sw128(do_addr + 32 * kk, 16, 1024), kk);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(s);

    // Pᵀ = exp(sᵀ·scale − lse) where the pair counts, else 0 (a select);
    // lse indexes the columns. Masks: invalid keys, the causal diagonal,
    // queries past Sq
    const bool masked = !keys_all || (p.causal && kw + 63 > qs) ||
                        qs + kKvBQ > p.Sq;
    if (masked) {
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * jn + 2 * t + e;
          const int qi = qs + c;
          const bool q_ok = qi < p.Sq;
          const bool ok0 = ok_k0 && q_ok && (!p.causal || kr0 <= qi);
          const bool ok1 = ok_k1 && q_ok && (!p.causal || kr1 <= qi);
          const float l = lse2[c];
          s[4 * jn + e] =
              ok0 ? exp2f(fmaf(s[4 * jn + e], p.scale_log2, -l)) : 0.f;
          s[4 * jn + 2 + e] =
              ok1 ? exp2f(fmaf(s[4 * jn + 2 + e], p.scale_log2, -l)) : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l = lse2[8 * jn + 2 * t + e];
          s[4 * jn + e] = exp2f(fmaf(s[4 * jn + e], p.scale_log2, -l));
          s[4 * jn + 2 + e] = exp2f(fmaf(s[4 * jn + 2 + e], p.scale_log2, -l));
        }
      }
    }

    // dSᵀ = Pᵀ (dPᵀ − delta); Pᵀ and dSᵀ as bf16 A fragments (queries are
    // the reduction of the second products)
    wgmma_wait<0>();
    reg_fence(dp);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float c0 = dlt[8 * jn + 2 * t], c1 = dlt[8 * jn + 2 * t + 1];
      pa[jn / 2][(jn & 1) * 2 + 0] = pack_bf16(s[4 * jn], s[4 * jn + 1]);
      pa[jn / 2][(jn & 1) * 2 + 1] = pack_bf16(s[4 * jn + 2], s[4 * jn + 3]);
      da[jn / 2][(jn & 1) * 2 + 0] =
          pack_bf16(s[4 * jn] * (dp[4 * jn] - c0),
                    s[4 * jn + 1] * (dp[4 * jn + 1] - c1));
      da[jn / 2][(jn & 1) * 2 + 1] =
          pack_bf16(s[4 * jn + 2] * (dp[4 * jn + 2] - c0),
                    s[4 * jn + 3] * (dp[4 * jn + 3] - c1));
    }

    // dV += Pᵀ dO and dK += dSᵀ Q: dO and Q, K-major B operands in the
    // first products, are MN-major ones here (16 queries = 2048 bytes)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs<1>(dv, pa[kk],
                            desc_sw128(do_addr + 2048 * kk, 1024, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs<1>(dk, da[kk],
                            desc_sw128(q_addr + 2048 * kk, 1024, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    if (lane == 0) mbar_arrive(empty + st);
  }

  store_rows(p.out0 + b * p.o0_sb + h * p.o0_sh, p.o0_ss, kr0, p.Sk, t, dk,
             p.scale);
  store_rows(p.out1 + b * p.o1_sb + h * p.o1_sh, p.o1_ss, kr0, p.Sk, t, dv,
             1.f);
}

// The tensor maps of q, k, v and dO: boxes of `q_rows` rows for q and dO,
// `k_rows` for k and v.
cudaError_t make_maps(TcParams& t, const Params& p, int q_rows, int k_rows) {
  const void* base[4] = {p.q, p.k, p.v, p.dout};
  const long long st[4][3] = {{p.q_ss, p.q_sh, p.q_sb},
                              {p.k_ss, p.k_sh, p.k_sb},
                              {p.v_ss, p.v_sh, p.v_sb},
                              {p.do_ss, p.do_sh, p.do_sb}};
  CUtensorMap* maps[4] = {&t.q_map, &t.k_map, &t.v_map, &t.do_map};
  for (int i = 0; i < 4; ++i) {
    const bool is_q = i == 0 || i == 3;
    const uint64_t dims[4] = {(uint64_t)kD, (uint64_t)(is_q ? p.Sq : p.Sk),
                              (uint64_t)p.H, (uint64_t)p.B};
    const uint64_t strides[3] = {(uint64_t)st[i][0] * 2,
                                 (uint64_t)st[i][1] * 2,
                                 (uint64_t)st[i][2] * 2};
    const uint32_t box[4] = {(uint32_t)kD,
                             (uint32_t)(is_q ? q_rows : k_rows), 1, 1};
    const cudaError_t err =
        hopper::make_map(maps[i], base[i], 4, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

TcParams tc_params(const Params& p) {
  TcParams t{};
  t.mask = p.mask;
  t.mask_sb = p.mask_sb;
  t.lse = p.lse;
  t.delta = p.delta;
  t.B = p.B;
  t.H = p.H;
  t.Sq = p.Sq;
  t.Sk = p.Sk;
  t.scale = p.scale;
  t.scale_log2 = p.scale * kLog2e;
  t.causal = p.causal;
  return t;
}

cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  TcParams t = tc_params(p);
  const cudaError_t err = make_maps(t, p, kRows, kDqBK);
  if (err != cudaSuccess) return err;
  t.out0 = static_cast<bf16*>(p.dq);
  t.o0_sb = p.dq_sb;
  t.o0_ss = p.dq_ss;
  t.o0_sh = p.dq_sh;
  t.tiles = (p.Sq + kRows - 1) / kRows;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDqSmem);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (long long)t.tiles * p.B * p.H;
  flash_bwd_dq_tc_kernel<<<(unsigned)blocks, kThreads, kDqSmem, stream>>>(t);
  return cudaGetLastError();
}

cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  TcParams t = tc_params(p);
  const cudaError_t err = make_maps(t, p, kKvBQ, kRows);
  if (err != cudaSuccess) return err;
  t.out0 = static_cast<bf16*>(p.dk);
  t.out1 = static_cast<bf16*>(p.dv);
  t.o0_sb = p.dk_sb;
  t.o0_ss = p.dk_ss;
  t.o0_sh = p.dk_sh;
  t.o1_sb = p.dv_sb;
  t.o1_ss = p.dv_ss;
  t.o1_sh = p.dv_sh;
  t.tiles = (p.Sk + kRows - 1) / kRows;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kKvSmem);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (long long)t.tiles * p.B * p.H;
  flash_bwd_dkv_tc_kernel<<<(unsigned)blocks, kThreads, kKvSmem, stream>>>(
      t);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The C interface. Pointers are device pointers, except `strides`: a host
// array of 22 element strides — (batch, sequence, head) of q, k, v, dO, dQ,
// dK, dV in that order (dQ's slots are unused by flash_bwd_dkv and dK's and
// dV's by flash_bwd_dq), then the mask's batch stride. The caller (the
// Python wrapper) has checked shapes, dtypes (q, k, v and dO all fp32, or
// all bf16; the outputs in that dtype or, with `out_f32`, fp32), D % 8 == 0
// with D <= 128, B * H <= 65535, that the last dim of every view is
// contiguous, and that rows start on 16-byte boundaries, and picked `route`
// (0 CUDA cores, 2 tensor cores); this checks that the route takes the
// call. Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() of the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const int* mask,
                            const float* lse, const float* delta, void* dq,
                            int B, int H, int Sq, int Sk, int D,
                            const long long* strides, float scale, int causal,
                            int bf16, int out_f32, int route, void* stream) {
  const Params p = make_params(q, k, v, dout, mask, lse, delta, dq, nullptr,
                               nullptr, B, H, Sq, Sk, D, strides, scale,
                               causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kTensorCore) {
    if (!bf16 || out_f32 || D != tc::kD) return (int)cudaErrorInvalidValue;
    return (int)tc::launch_dq(p, s);
  }
  if (route != kCudaCore) return (int)cudaErrorInvalidValue;
  if (!bf16) return (int)launch_dq<float, float>(p, s);
  return (int)(out_f32 ? launch_dq<__nv_bfloat16, float>(p, s)
                       : launch_dq<__nv_bfloat16, __nv_bfloat16>(p, s));
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const int* mask,
                             const float* lse, const float* delta, void* dk,
                             void* dv, int B, int H, int Sq, int Sk, int D,
                             const long long* strides, float scale,
                             int causal, int bf16, int out_f32, int route,
                             void* stream) {
  const Params p = make_params(q, k, v, dout, mask, lse, delta, nullptr, dk,
                               dv, B, H, Sq, Sk, D, strides, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kTensorCore) {
    if (!bf16 || out_f32 || D != tc::kD) return (int)cudaErrorInvalidValue;
    return (int)tc::launch_dkv(p, s);
  }
  if (route != kCudaCore) return (int)cudaErrorInvalidValue;
  if (!bf16) return (int)launch_dkv<float, float>(p, s);
  return (int)(out_f32 ? launch_dkv<__nv_bfloat16, float>(p, s)
                       : launch_dkv<__nv_bfloat16, __nv_bfloat16>(p, s));
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
