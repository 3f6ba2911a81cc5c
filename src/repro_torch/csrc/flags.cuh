// Flag words for the port's cooperative kernels (kv_shuttle.cu,
// gemm_allgather.cu, ring_attention.cu): each DMA semaphore of a Pallas
// kernel becomes a 32-bit word in device memory that counts what has
// landed.
//
// A sender finishes its stores, meets its CTA at __syncthreads, fences and
// adds to the word (cta_signal: a release). A receiver spins on an acquire
// load until the word reaches its target (spin_geq). Every spin gives up
// after timeout_ms with a trap, so a protocol fault fails the launch
// instead of hanging the card.
//
// group_signal / group_wait are the same for a group of threads that meet
// at a named barrier (bar.sync id, count) in place of __syncthreads: the
// consumer warpgroups of a warp-specialised kernel (gemm_allgather.cu),
// whose producer warp never reaches their barrier. They spin inline and
// trap without a message (spin_geq_inline): a kernel that runs wgmma must
// call no function, or ptxas serializes every wgmma in it.
#pragma once
#include <cuda_runtime.h>
#include <stdio.h>

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// one thread: spin until *p >= target; trap after timeout_ms. Kept out of
// line: inlined, its slow path (the clock, the printf) cost the ring kernel
// 64 more registers a thread and half its CTAs per SM.
__device__ __noinline__ void spin_geq(const unsigned* p, unsigned target, int timeout_ms,
                                      const char* kernel, const char* what, int a, int b) {
  if (ld_acquire(p) >= target) return;
  const unsigned long long t0 = globaltimer();
  const unsigned long long limit = (unsigned long long)timeout_ms * 1000000ull;
  while (ld_acquire(p) < target) {
    __nanosleep(64);
    if (globaltimer() - t0 > limit) {
      printf("%s: block %d timed out on %s (%d, %d: have %u, want %u)\n", kernel,
             (int)blockIdx.x, what, a, b, ld_acquire(p), target);
      asm volatile("trap;");
    }
  }
}

// spin_geq inline and without its message (printf is a call too)
__device__ __forceinline__ void spin_geq_inline(const unsigned* p, unsigned target,
                                                int timeout_ms) {
  if (ld_acquire(p) >= target) return;
  const unsigned long long t0 = globaltimer();
  const unsigned long long limit = (unsigned long long)timeout_ms * 1000000ull;
  while (ld_acquire(p) < target) {
    __nanosleep(64);
    if (globaltimer() - t0 > limit) asm volatile("trap;");
  }
}

// whole CTA: thread 0 spins, then the CTA goes on with what it waited for
__device__ __forceinline__ void cta_wait(const unsigned* p, unsigned target, int timeout_ms,
                                         const char* kernel, const char* what, int a, int b) {
  if (threadIdx.x == 0) {
    spin_geq(p, target, timeout_ms, kernel, what, a, b);
    __threadfence();
  }
  __syncthreads();
}

// whole CTA: publish this CTA's stores, then add `amount` to the flag
__device__ void cta_signal(unsigned* p, unsigned amount) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(p, amount);
  }
}

// threads 0 .. count - 1: meet at named barrier `bar` (not 0, which is
// __syncthreads')
__device__ __forceinline__ void group_sync(int bar, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// cta_signal for threads 0 .. count - 1
__device__ void group_signal(unsigned* p, unsigned amount, int bar, int count) {
  group_sync(bar, count);
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(p, amount);
  }
}

// cta_wait for threads 0 .. count - 1 (bar 0 with every thread: the CTA)
__device__ __forceinline__ void group_wait(const unsigned* p, unsigned target, int timeout_ms,
                                           int bar, int count) {
  if (threadIdx.x == 0) {
    spin_geq_inline(p, target, timeout_ms);
    __threadfence();
  }
  group_sync(bar, count);
}
