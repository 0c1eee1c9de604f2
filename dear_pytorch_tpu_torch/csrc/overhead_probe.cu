// The overhead probe's elementwise kernel for Hopper (sm_90a): o = x * 2 + 1
// over an fp32 (nblocks * rows_per_block, 512) tensor.
//
// Replaces the TPU kernel scripts/pallas_overhead_probe.py::kern (:33),
// launched there through pl.pallas_call (:39) over a grid of `nblocks`
// steps, each owning one (rows_per_block, 512) block. The probe runs the
// same bytes at two granularities (16 blocks of 1024 rows, 2048 blocks of 8
// rows) to separate the cost of one grid step from the cost of the bytes.
// To keep that meaning on the card, the grid is the Pallas grid: one CUDA
// block per grid step, owning its (rows_per_block, 512) tile and walking it
// in a loop. At 16 blocks only 16 of the card's 132 SMs work, so that
// granularity measures one SM's bandwidth, not the per-step cost. Built by
// dear_pytorch_tpu_torch/ops/_build.py with nvcc into a shared library with
// a plain C interface; called through ctypes by
// dear_pytorch_tpu_torch/ops/overhead_probe.py.
//
// What bounds it on this card: bytes. Per element it reads 4 bytes and
// writes 4 for two flops, so the bound is 8 bytes per element over the
// memory rate (67,108,864 bytes at the probe's size: about 0.020 ms at 3.35
// TB/s). The design: 256 threads, 16-byte (float4) loads and stores,
// neighbouring threads on neighbouring addresses, and each thread keeps 4
// float4 loads in flight before it stores (one pass of the loop covers
// 256 * 4 float4 = one (8, 512) tile, the finer granularity's whole block).
//
// Bitwise equal to the plain version `x * 2.0 + 1.0` (two PyTorch ops, each
// rounded): 2x is exact in fp32 (an exponent step; it overflows to inf in
// both), so round(round(2x) + 1) == round(2x + 1), and the result is
// rounded once whether or not nvcc contracts the two into one FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 512;               // the probe's row width
constexpr int kVecPerRow = kWidth / 4;    // float4 per row
constexpr int kThreads = 256;
constexpr int kUnroll = 4;                // float4 in flight per thread

__device__ __forceinline__ float4 affine(float4 v) {
  v.x = v.x * 2.0f + 1.0f;
  v.y = v.y * 2.0f + 1.0f;
  v.z = v.z * 2.0f + 1.0f;
  v.w = v.w * 2.0f + 1.0f;
  return v;
}

// Block b owns rows [b * rows_per_block, (b + 1) * rows_per_block): tile
// float4s [b * tile, (b + 1) * tile) with tile = rows_per_block * 128.
__global__ void __launch_bounds__(kThreads)
affine_probe_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                    long long tile) {
  const long long base = (long long)blockIdx.x * tile;
  const float4* xt = x + base;
  float4* ot = o + base;
  constexpr int kStep = kThreads * kUnroll;
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < tile; i += kStep) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = xt[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) ot[i + u * kThreads] = affine(v[u]);
  }
  for (; i < tile; i += kThreads) ot[i] = affine(xt[i]);
}

}  // namespace

// The C interface. `x` and `o` are device pointers to nblocks *
// rows_per_block rows of `width` fp32 values, 16-byte aligned; `width` must
// be 512. Launches nblocks blocks on `stream`, allocates nothing, and
// returns cudaErrorInvalidValue for arguments it does not take, otherwise
// cudaGetLastError() of the launch.
extern "C" int affine_probe(const float* x, float* o, long long nblocks,
                            long long rows_per_block, int width,
                            void* stream) {
  if (width != kWidth || nblocks <= 0 || nblocks > 0x7fffffffLL ||
      rows_per_block <= 0 || x == nullptr || o == nullptr ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(o) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  affine_probe_kernel<<<(unsigned)nblocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o),
      rows_per_block * kVecPerRow);
  return (int)cudaGetLastError();
}

extern "C" const char* affine_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
