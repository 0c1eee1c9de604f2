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
// D=64, causal) each kernel does O(S^2 D) flops on O(S D) bytes:
// operations. This first design runs them on fp32 CUDA cores out of shared
// memory (no tensor cores), so it sits far above that bound; TMA + wgmma
// tiles are later work.
//
// Design (simple and right first), mirroring csrc/flash_fwd.cu:
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

}  // namespace

// The C interface. Pointers are device pointers, except `strides`: a host
// array of 22 element strides — (batch, sequence, head) of q, k, v, dO, dQ,
// dK, dV in that order (dQ's slots are unused by flash_bwd_dkv and dK's and
// dV's by flash_bwd_dq), then the mask's batch stride. The caller (the
// Python wrapper) has checked shapes, dtypes (q, k, v and dO all fp32, or
// all bf16; the outputs in that dtype or, with `out_f32`, fp32), D % 8 == 0
// with D <= 128, B * H <= 65535, that the last dim of every view is
// contiguous, and that rows start on 16-byte boundaries. Launches on
// `stream`, allocates nothing, and returns cudaGetLastError() of the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const int* mask,
                            const float* lse, const float* delta, void* dq,
                            int B, int H, int Sq, int Sk, int D,
                            const long long* strides, float scale, int causal,
                            int bf16, int out_f32, void* stream) {
  const Params p = make_params(q, k, v, dout, mask, lse, delta, dq, nullptr,
                               nullptr, B, H, Sq, Sk, D, strides, scale,
                               causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return (int)launch_dq<float, float>(p, s);
  return (int)(out_f32 ? launch_dq<__nv_bfloat16, float>(p, s)
                       : launch_dq<__nv_bfloat16, __nv_bfloat16>(p, s));
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const int* mask,
                             const float* lse, const float* delta, void* dk,
                             void* dv, int B, int H, int Sq, int Sk, int D,
                             const long long* strides, float scale,
                             int causal, int bf16, int out_f32, void* stream) {
  const Params p = make_params(q, k, v, dout, mask, lse, delta, nullptr, dk,
                               dv, B, H, Sq, Sk, D, strides, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return (int)launch_dkv<float, float>(p, s);
  return (int)(out_f32 ? launch_dkv<__nv_bfloat16, float>(p, s)
                       : launch_dkv<__nv_bfloat16, __nv_bfloat16>(p, s));
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
