// The shard update of the DeAR schedule, per element: shared by the two
// kernels that end a bucket's reduce-scatter with it, csrc/fused_update.cu
// (after NCCL's reduce-scatter, mode "dear") and csrc/ring.cu (the last hop
// of the ring reduce-scatter, mode "dear-fused"), so that both run exactly
// the same IEEE operations in the same order.
//
// Replaces the epilogue of the TPU kernel dear_pytorch_tpu/ops/
// collective_matmul.py::_rs_update_kernel (:361-393): `grad = (partial /
// mean_world)`, then `ShardOptimizer.update` on the owned shard. What it
// computes per element, in this order (the JAX package's order,
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
// dear_pytorch_tpu_torch/ops/fused_sgd.py::fused_update_reference, which
// runs the same sequence as separate ops. The scalars (lr, bc1, ...) are
// computed once per step on the host and passed in as fp32.

#pragma once

#include <cuda_bf16.h>

namespace {

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


}  // namespace
