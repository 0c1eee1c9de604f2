// The shard update of the DeAR schedule for Hopper (sm_90a): one launch per
// fusion bucket over the shard this rank owns, right after the bucket's
// reduce-scatter. It scales the reduced gradient and applies the optimizer
// in place: fused SGD (momentum, dampening, nesterov, weight decay) or
// AdamW.
//
// Replaces the epilogue of the TPU kernel dear_pytorch_tpu/ops/
// collective_matmul.py::_rs_update_kernel (:361-393): `grad = (partial /
// mean_world)`, then `ShardOptimizer.update` on the owned shard. The ring
// reduce-scatter half of that kernel is not here: on this path NCCL's
// reduce-scatter produces the reduced bucket. Built by
// dear_pytorch_tpu_torch/ops/_build.py with nvcc into a shared library with
// a plain C interface; called through ctypes by
// dear_pytorch_tpu_torch/ops/fused_sgd.py.
//
// What it computes per element, in this order (the JAX package's order,
// dear_pytorch_tpu/ops/fused_sgd.py:98-110 and :148-166):
//   g = rs / mean_world; g = g * clip_scale        (clip_scale: optional,
//                                                   a device fp32 scalar)
//   SGD:   d = g + wd * p                          (only when wd != 0)
//          buf = initialized ? mom * buf + (1 - dampening) * d : d
//          d = nesterov ? d + mom * buf : buf
//          p = p - lr * d
//   AdamW: p = p * (1 - lr * wd)                   (only when wd != 0)
//          m = m + (1 - b1) * (g - m)
//          v = b2 * v + (1 - b2) * (g * g)
//          p = p - (lr / bc1) * m / (sqrt(v) / bc2_sqrt + eps)
// Every product, sum, quotient and root is one IEEE round-to-nearest
// operation (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: never contracted
// into an FMA), so the result is bitwise equal to the plain PyTorch version,
// which runs the same sequence as separate ops. The scalars (lr, bc1, ...)
// are computed once per step on the host and passed in as fp32.
//
// What bounds it on this card: bytes. Per element it reads the gradient
// (2 or 4 bytes), the parameter and 1 or 2 state words and writes them
// back, for a handful of flops. The design: one thread per 4 consecutive
// elements with 16-byte loads and stores of the fp32 arrays (8- or 16-byte
// loads of the gradient) where every pointer is aligned, scalar accesses
// otherwise and for the tail; a grid-stride loop.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kMaxBlocks = 4096;

enum Kind { kSgd = 0, kSgdMomentum = 1, kAdamW = 2 };

// The fp32 scalars, in the order of the host array (see the C interface).
struct Hyper {
  float mean_world, lr, wd, momentum, one_minus_dampening, decay;
  float one_minus_b1, b2, one_minus_b2, step_size, bc2_sqrt, eps;
};

struct Args {
  int kind;
  int initialized;
  int nesterov;
  Hyper h;
  const float* clip;  // device scalar or null
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One element: g is the raw reduced gradient, p/s1/s2 are updated in place.
__device__ __forceinline__ void update_one(const Args& a, float clip, float g,
                                           float& p, float& s1, float& s2) {
  const Hyper& h = a.h;
  g = __fdiv_rn(g, h.mean_world);
  if (a.clip) g = __fmul_rn(g, clip);
  if (a.kind == kAdamW) {
    if (h.wd != 0.f) p = __fmul_rn(p, h.decay);
    s1 = __fadd_rn(s1, __fmul_rn(h.one_minus_b1, __fsub_rn(g, s1)));
    s2 = __fadd_rn(__fmul_rn(h.b2, s2),
                   __fmul_rn(h.one_minus_b2, __fmul_rn(g, g)));
    const float denom =
        __fadd_rn(__fdiv_rn(__fsqrt_rn(s2), h.bc2_sqrt), h.eps);
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(h.step_size, s1), denom));
    return;
  }
  float d = g;
  if (h.wd != 0.f) d = __fadd_rn(d, __fmul_rn(h.wd, p));
  if (a.kind == kSgdMomentum) {
    s1 = a.initialized ? __fadd_rn(__fmul_rn(h.momentum, s1),
                                   __fmul_rn(h.one_minus_dampening, d))
                       : d;
    d = a.nesterov ? __fadd_rn(d, __fmul_rn(h.momentum, s1)) : s1;
  }
  p = __fsub_rn(p, __fmul_rn(h.lr, d));
}

template <typename G>
struct GradVec;
template <>
struct GradVec<float> {
  using type = float4;
};
template <>
struct GradVec<__nv_bfloat16> {
  using type = uint2;  // 4 bf16 values
};

template <typename G>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const Args a, const G* __restrict__ grad,
                    float* __restrict__ param, float* __restrict__ s1,
                    float* __restrict__ s2, long long n, int vec) {
  const float clip = a.clip ? *a.clip : 1.f;
  const bool two = a.kind == kAdamW;
  const bool one = a.kind != kSgd;
  const long long groups = (n + kVec - 1) / kVec;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       gi < groups; gi += stride) {
    const long long i0 = gi * kVec;
    if (vec && i0 + kVec <= n) {
      typename GradVec<G>::type graw =
          *reinterpret_cast<const typename GradVec<G>::type*>(grad + i0);
      const G* ge = reinterpret_cast<const G*>(&graw);
      float4 pv = *reinterpret_cast<const float4*>(param + i0);
      float4 av = one ? *reinterpret_cast<const float4*>(s1 + i0)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 bv = two ? *reinterpret_cast<const float4*>(s2 + i0)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      float* pe = reinterpret_cast<float*>(&pv);
      float* ae = reinterpret_cast<float*>(&av);
      float* be = reinterpret_cast<float*>(&bv);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        update_one(a, clip, to_f32(ge[e]), pe[e], ae[e], be[e]);
      *reinterpret_cast<float4*>(param + i0) = pv;
      if (one) *reinterpret_cast<float4*>(s1 + i0) = av;
      if (two) *reinterpret_cast<float4*>(s2 + i0) = bv;
    } else {
      for (long long i = i0; i < n && i < i0 + kVec; ++i) {
        float pe = param[i];
        float ae = one ? s1[i] : 0.f;
        float be = two ? s2[i] : 0.f;
        update_one(a, clip, to_f32(grad[i]), pe, ae, be);
        param[i] = pe;
        if (one) s1[i] = ae;
        if (two) s2[i] = be;
      }
    }
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename G>
cudaError_t launch(const Args& a, const void* grad, float* param, float* s1,
                   float* s2, long long n, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int vec = aligned(grad, kVec * sizeof(G)) && aligned(param, 16) &&
                  aligned(s1, 16) && aligned(s2, 16);
  const long long groups = (n + kVec - 1) / kVec;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_update_kernel<G><<<(int)blocks, kThreads, 0, stream>>>(
      a, static_cast<const G*>(grad), param, s1, s2, n, vec);
  return cudaGetLastError();
}

}  // namespace

// The C interface. `grad` (fp32, or bf16 when grad_bf16), `param`, `s1`
// (momentum buffer, or AdamW's exp_avg; null for plain SGD), `s2` (AdamW's
// exp_avg_sq; null otherwise) and `clip_scale` (null without clipping) are
// device pointers to `n` elements (one for clip_scale); `scalars` is a host
// array of the 12 fp32 values of `Hyper`, in its order. kind: 0 SGD, 1 SGD
// with momentum, 2 AdamW. Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() of the launch.
extern "C" int fused_update(int kind, int grad_bf16, const void* grad,
                            float* param, float* s1, float* s2, long long n,
                            const float* scalars, const float* clip_scale,
                            int initialized, int nesterov, void* stream) {
  if (kind < kSgd || kind > kAdamW) return (int)cudaErrorInvalidValue;
  Args a;
  a.kind = kind;
  a.initialized = initialized;
  a.nesterov = nesterov;
  a.h = Hyper{scalars[0], scalars[1], scalars[2],  scalars[3],
              scalars[4], scalars[5], scalars[6],  scalars[7],
              scalars[8], scalars[9], scalars[10], scalars[11]};
  a.clip = clip_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(grad_bf16
                   ? launch<__nv_bfloat16>(a, grad, param, s1, s2, n, s)
                   : launch<float>(a, grad, param, s1, s2, n, s));
}

extern "C" const char* fused_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
