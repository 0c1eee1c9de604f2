// Flash-attention forward for Hopper (sm_90a): exact blockwise
// online-softmax attention with an int32 key-validity mask and optional
// top-left-aligned causal masking. Returns o and the fp32 log-sum-exp.
//
// Replaces the TPU kernel dear_pytorch_tpu/ops/flash_attention.py::_fwd_kernel
// (its function, not its block structure). Built by
// dear_pytorch_tpu_torch/ops/_build.py with nvcc into a shared library with
// a plain C interface; called through ctypes by
// dear_pytorch_tpu_torch/ops/flash_attention.py.
//
// What it computes, per query row i of head bh (b = bh / H, h = bh % H):
//   s_j   = (scale * q_i) . k_j                  (fp32)
//   key j counts iff mask[b, j] > 0 and, when causal, j <= i
//   m     = max(max_j s_j, -1e30)                (the -1e30 floor)
//   o_i   = sum_j exp(s_j - m) v_j / max(l, 1e-30),  l = sum_j exp(s_j - m)
//   lse_i = m + log(max(l, 1e-30))
// so a row with no valid key gives o = 0 and lse = -1e30, not NaN.
//
// What bounds it on this card: a decode tick (Sq = 1 over the L-slot cache)
// reads all of K and V once and does 4*D flops per key: bytes. A causal
// prefill at S = 1024 does O(S^2 D) flops on O(S D) bytes: operations.
//
// Design (simple and right first; no TMA or wgmma yet):
//   - one block of 4 warps per (tile of BQ query rows, bh); BQ = 1 for
//     Sq == 1 (decode), 16 otherwise;
//   - the scaled q tile is staged in shared memory as fp32;
//   - a loop over key tiles of 128 keys: the block stages K, V (as fp32,
//     rows padded to D + 1 floats so that lane j reading row j is free of
//     bank conflicts) and the per-key validity in shared memory, with
//     16-byte loads, several in flight per thread (a first version loaded
//     one element per iteration and exposed the memory latency ~64 times
//     per tile: 0.25 ms for a 4-slot GPT-2 decode tick's attention);
//   - within a tile, warp w owns keys 32w .. 32w + 31, one key per lane:
//     each lane computes its key's score for every row, the warp keeps an
//     online-softmax state (m, l, acc) per row in registers, and the PV
//     product broadcasts each key's p with a shuffle while each lane owns
//     the output dims lane, lane + 32, ...;
//   - so the 4 warps of a block split the keys of every row (a split-K
//     inside the block: a decode row is served by 128 threads, not one),
//     and the block merges the 4 partial states through shared memory at
//     the end;
//   - causal rows stop the key loop at the tile holding the diagonal (the
//     counterpart of the TPU kernel's _k_index_map clamp), and the ragged
//     edges of Sq and Sk are masked here, so any length is accepted.
// A decode tick still gives only slots * heads blocks (48 at 4 slots of
// GPT-2 small) for 132 SMs; spreading a row's keys over several blocks
// (flash-decoding) is the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = kWarps * 32;  // keys per tile: one per lane
constexpr int kUnroll = 4;            // 16-byte loads in flight per thread
constexpr float kNegBig = -1e30f;     // the TPU kernel's _NEG_BIG
constexpr float kTiny = 1e-30f;       // floor of the softmax denominator

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

// Shared memory: q tile [BQ][D], K and V tiles [kBlockK][D + 1], key
// validity [kBlockK]; the final merge reuses the front of the same buffer.
__host__ __device__ inline size_t smem_floats(int bq, int d) {
  size_t tiles = (size_t)bq * d + 2 * (size_t)kBlockK * (d + 1) + kBlockK;
  size_t merge = 2 * (size_t)kWarps * bq + (size_t)kWarps * bq * d;
  return tiles > merge ? tiles : merge;
}

// ND = output dims per lane (ceil(D / 32) rounded up to 2 or 4).
template <typename T, typename OutT, int BQ, int ND>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
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
  const int q0 = blockIdx.x * BQ;
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

  // causal: keys past the tile's last row count for no row of the tile
  const int k_end = p.causal ? min(p.Sk, q0 + nq) : p.Sk;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int vpr = D / kVec;             // 16-byte vectors per row
  const int nvec = kBlockK * vpr;
  for (int kt = 0; kt < k_end; kt += kBlockK) {
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
}

template <typename T, typename OutT, int BQ, int ND>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(BQ, p.D) * sizeof(float);
  auto kern = flash_fwd_kernel<T, OutT, BQ, ND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename OutT>
cudaError_t launch_shape(const Params& p, cudaStream_t stream) {
  if (p.Sq == 1)
    return p.D <= 64 ? launch<T, OutT, 1, 2>(p, stream)
                     : launch<T, OutT, 1, 4>(p, stream);
  return p.D <= 64 ? launch<T, OutT, 16, 2>(p, stream)
                   : launch<T, OutT, 16, 4>(p, stream);
}

}  // namespace

// The C interface. Pointers are device pointers; strides are in elements.
// The caller (the Python wrapper) has checked shapes, dtypes (q, k, v all
// fp32, or all bf16), D % 8 == 0 with D <= 128, B * H <= 65535, that the
// last dim of every view is contiguous, and that k and v rows start on
// 16-byte boundaries (base pointers and strides). Launches on `stream`,
// allocates nothing, and returns cudaGetLastError() of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const int* mask, void* o, float* lse, int B, int H,
                         int Sq, int Sk, int D, long long q_sb, long long q_ss,
                         long long q_sh, long long k_sb, long long k_ss,
                         long long k_sh, long long v_sb, long long v_ss,
                         long long v_sh, long long o_sb, long long o_ss,
                         long long o_sh, long long mask_sb, float scale,
                         int causal, int in_bf16, int out_f32, void* stream) {
  Params p{q,    k,    v,    mask, o,    lse,  B,    H,       Sq,
           Sk,   D,    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,    v_sb,
           v_ss, v_sh, o_sb, o_ss, o_sh, mask_sb, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!in_bf16)
    err = launch_shape<float, float>(p, s);
  else if (out_f32)
    err = launch_shape<__nv_bfloat16, float>(p, s);
  else
    err = launch_shape<__nv_bfloat16, __nv_bfloat16>(p, s);
  return (int)err;
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
