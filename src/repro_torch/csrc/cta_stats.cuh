// Cycle counters of a CTA, for moe_dispatch.cu and kv_shuttle.cu, in the
// counting build (-DCUCO_STATS, kernels/build.py::STATS_DEFINES): its whole
// run, the cycles it spends waiting (the slow path of a flag spin,
// window.cuh's bulk-group waits) and the cycles in tile products (gemm).
// Thread 0 counts them with clock64 in shared memory (`cta`) and, at its
// exit, adds them and a CTA count to its role's row of the launch's
// accumulator, u64 (roles, BUCKETS). The wrapper launches this
// build, with an accumulator, only on one launch in 17 while a profiler
// records (core/telemetry.py::kernel_counters).
//
// The production build compiles every helper here to the plain operation
// (stats::gemm to the products, stats::cta_wait to flags.cuh's cta_wait),
// so it is the kernel without counters, instruction for instruction: the
// kernels sit at their register cap, and even counting code that never
// runs moved their spills and cost moe_kernel 1.4% in the two-stream
// decode on an H100.
//
// clock64, not %globaltimer: the shares are ratios within one CTA on one
// SM, and %globaltimer's update step can be coarser than a wait.
#pragma once
#include <cuda_runtime.h>

#include "flags.cuh"

namespace stats {

// a role's row of the accumulator (core/telemetry.py::KERNEL_BUCKETS)
enum : int { CTAS, CYCLES, WAIT, GEMM, BUCKETS };

#ifdef CUCO_STATS

struct Cta {
  long long t0, mark;  // the CTA's start; the open bracket's start
  unsigned long long wait, gemm;
  int role;
};

__shared__ Cta cta;  // this CTA's counts (thread 0's)

// thread 0, first: the CTA counts for row `role` of the accumulator
__device__ __forceinline__ void open(int role) {
  cta.wait = cta.gemm = 0;
  cta.role = role;
  cta.t0 = clock64();
}

// thread 0, last: add the CTA's counts to its row of `acc`
__device__ __forceinline__ void close(unsigned long long* acc) {
  if (!acc) return;
  acc += cta.role * BUCKETS;
  atomicAdd(acc + CTAS, 1ull);
  atomicAdd(acc + CYCLES, (unsigned long long)(clock64() - cta.t0));
  atomicAdd(acc + WAIT, cta.wait);
  atomicAdd(acc + GEMM, cta.gemm);
}

// the wait bucket, for window.cuh's bulk-group waits
__device__ __forceinline__ unsigned long long* wait() { return &cta.wait; }

// thread 0's bracket around a wait
__device__ __forceinline__ void mark() { cta.mark = clock64(); }
__device__ __forceinline__ void add_wait() { cta.wait += clock64() - cta.mark; }

// flags.cuh's cta_wait, thread 0's cycles counted as waiting from the
// first acquire load that fails (the slow path) to the one that succeeds
__device__ __forceinline__ void cta_wait(const unsigned* p, unsigned target, int timeout_ms,
                                         const char* kernel, const char* what, int a, int b) {
  if (threadIdx.x == 0) {
    if (ld_acquire(p) < target) {
      mark();
      spin_geq(p, target, timeout_ms, kernel, what, a, b);
      add_wait();
    }
    __threadfence();
  }
  __syncthreads();
}

// thread 0's cycles in `ready()` counted as waiting; no other thread, and
// no production build, calls it (a unit's first stage on the wgmma core)
template <class F>
__device__ __forceinline__ void wait_for(F&& ready) {
  if (threadIdx.x == 0) {
    mark();
    ready();
    add_wait();
  }
}

// `products()` (every thread: tc_gemm.cuh's tile, which opens and closes on
// __syncthreads; a consumer of the wgmma core: its product loop), thread
// 0's cycles in it counted as gemm
template <class F>
__device__ __forceinline__ void gemm(F&& products) {
  if (threadIdx.x == 0) cta.mark = clock64();
  products();
  if (threadIdx.x == 0) cta.gemm += clock64() - cta.mark;
}

#else  // the production build: no counter

__device__ __forceinline__ void open(int) {}
__device__ __forceinline__ void close(unsigned long long*) {}
__device__ __forceinline__ unsigned long long* wait() { return nullptr; }
__device__ __forceinline__ void mark() {}
__device__ __forceinline__ void add_wait() {}

__device__ __forceinline__ void cta_wait(const unsigned* p, unsigned target, int timeout_ms,
                                         const char* kernel, const char* what, int a, int b) {
  ::cta_wait(p, target, timeout_ms, kernel, what, a, b);
}

template <class F>
__device__ __forceinline__ void wait_for(F&&) {}

template <class F>
__device__ __forceinline__ void gemm(F&& products) {
  products();
}

#endif

}  // namespace stats
