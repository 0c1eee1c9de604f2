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
// The per-element update (`update_one`, the scalars `Hyper`) lives in
// csrc/shard_update.cuh, shared with the ring kernel of csrc/ring.cu; its
// operations are bitwise equal to the plain PyTorch version.
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

#include "shard_update.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kMaxBlocks = 4096;

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
