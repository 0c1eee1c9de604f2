// The flag primitives of the ring transport, shared by csrc/ring.cu (K4 and
// the K5 ring) and csrc/ring_matmul.cu (K6, K7, K8): system-scope acquire
// loads and release stores of the arrival and credit flags that live in
// ring buffers mapped into a neighbour's process through CUDA IPC, and the
// wait that backs off with __nanosleep and traps past a wall-clock deadline.
//
// Ranks in two processes on one card run only because the GPU time-slices
// between their contexts, so the deadline is read from %globaltimer
// (wall-clock ns; clock64 would stop counting while the context is switched
// out): past kDeadlineNs the kernel prints what it waited for and traps, so
// a broken ring fails loudly instead of hanging.

#pragma once

#include <stdio.h>

namespace {

constexpr unsigned long long kDeadlineNs = 30ull * 1000000000ull;
// blocks per rank of a K4 / K5 ring launch (ring.cu); ring_matmul.cu sizes
// its grid so that one of its launches and one of these fit beside it
constexpr int kRingBlocks = 32;

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One thread: wait until *flag >= want (wrap-safe), or trap.
__device__ void spin_until(const unsigned* flag, unsigned want,
                           const char* what, int rank, int round) {
  unsigned long long t0 = 0;
  unsigned ns = 32;
  while ((int)(ld_acquire_sys(flag) - want) < 0) {
    const unsigned long long now = global_ns();
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > kDeadlineNs) {
      printf("ring: rank %d round %d block %d waited %llu s for %s >= %u "
             "(at %u); trapping\n", rank, round, (int)blockIdx.x,
             (now - t0) / 1000000000ull, what, want, ld_acquire_sys(flag));
      __trap();
    }
    __nanosleep(ns);
    if (ns < 2048) ns <<= 1;
  }
}

}  // namespace
