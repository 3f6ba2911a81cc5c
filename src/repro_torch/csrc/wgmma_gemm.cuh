// The split-once tensor-core GEMM core of gemm_allgather.cu: f32-accurate
// products as 3xTF32 `wgmma`, operands fed by TMA into an mbarrier ring.
//
// Operands: split into TF32 hi / lo once per call, before the product
// loop, into K-major scratch in device memory (split_tf32: hi rounds x to
// TF32, lo = x - hi), zero-padded to whole tiles. tf32 `wgmma` reads only
// K-major A and B, so B arrives as B^T (N, K). The loop then only loads
// and multiplies: no split, no transpose, no masking.
//
// Tile: BM x BN = 128 x 128 over BK = 32 deep stages. A stage holds A hi,
// A lo, B hi and B lo, 128 rows of 32 floats each (128 bytes: one
// 128-byte swizzle row), 64 KB; STAGES = 3 of them are 192 KB of the
// CTA's 227 KB. The epilogue stores from registers, so no result tile
// competes with the stages for shared memory.
//
// Warps: two consumer warpgroups (threads 0-255), 64 tile rows each, and
// one producer warp (threads 256-287) whose lane 0 keeps TMA loads in
// flight: four 16 KB boxes a stage, completing on the stage's `full`
// barrier; each consumer warp arrives on `empty` once its products have
// read the stage. 288 threads at one CTA an SM may hold 224 registers
// each, so the consumers' two 64 x 128 f32 sets (a partial and the sum)
// fit without setmaxnreg.
//
// Products: per 8-deep k step, wgmma m64n128k8 .tf32 three times:
// a_lo b_hi, then a_hi b_lo, then a_hi b_hi (small terms first). The
// tensor core truncates its f32 sum, so PART_STAGES stages of products go
// into a fresh partial (scale-d = 0 on the first) that is added into the
// sum on the f32 cores after wgmma.wait_group. PART_STAGES = 4 (128-deep
// partials) was set from chip_smoke.py's ga_core readings on an H100: the
// error at K = 4096 and K = 7168 stays far inside the 1e-4 gate at 1, 4
// and 8, and 4 runs the GEMM faster than 1 (a wait and 64 adds a stage)
// and as fast as 8 (PERF.md §6).
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flags.cuh"
#include "mma.cuh"

#ifndef GA_PART_STAGES
#define GA_PART_STAGES 4
#endif

namespace wg {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;
constexpr int PART_STAGES = GA_PART_STAGES;
constexpr int NCONS = 256;                  // two consumer warpgroups
constexpr int NTHREADS = NCONS + 32;        // + the producer warp
constexpr int BOX = 128 * BK * 4;           // one operand half of a stage: 16 KB
constexpr int STAGE = 4 * BOX;              // A hi, A lo, B hi, B lo
constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;  // + barriers, + 1 KB alignment
constexpr int CONS_BAR = 1;                 // the consumers' named barrier (0 is __syncthreads)

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait until the barrier's phase of parity `parity` has completed; trap
// after timeout_ms (a lost TMA load fails the launch, never hangs it).
// Inline and without printf: a kernel that runs wgmma calls no function,
// or ptxas serializes every wgmma in it.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity, int timeout_ms) {
  if (mbar_try(bar, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try(bar, parity))
    if (globaltimer() - t0 > (unsigned long long)timeout_ms * 1000000ull) asm volatile("trap;");
}

// one 2-D TMA box (c0: the inner, K coordinate; c1: the row) into `dst`;
// its bytes count down barrier `bar`'s transaction count
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, int c0, int c1,
                                         unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// generic-proxy writes (the split's stores) before async-proxy reads (TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// K-major operand of 128-byte rows, 128-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B): 8-row groups 1024 bytes apart (SBO), the
// leading offset unused; `addr` may step 32 bytes (one k8 slice) into a
// 1024-byte aligned atom
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pin the accumulators' order against the asynchronous wgmma
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B: m64n128k8, A and B tf32 from shared memory (K-major);
// scale_d = 0 starts a fresh sum
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ------------------------------------------------------------ the ring

struct Ring {
  unsigned smem;  // shared address of stage 0 (1024-byte aligned)
  unsigned full, empty;  // shared addresses of the STAGES barriers of each kind
  int stage;
  unsigned phase;

  __device__ __forceinline__ unsigned full_bar() const { return full + 8 * stage; }
  __device__ __forceinline__ unsigned empty_bar() const { return empty + 8 * stage; }
  __device__ __forceinline__ unsigned at() const { return smem + stage * STAGE; }
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// the ring over the dynamic shared memory `raw` (SMEM bytes); thread 0
// initialises the barriers, and the caller meets its CTA (__syncthreads)
// before any thread uses them
__device__ __forceinline__ Ring make_ring(char* raw) {
  Ring r;
  r.smem = (tc::smem_u32(raw) + 1023u) & ~1023u;
  r.full = r.smem + STAGES * STAGE;
  r.empty = r.full + 8 * STAGES;
  r.stage = 0;
  r.phase = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full + 8 * s, 1);                // the producer's expect_tx
      mbar_init(r.empty + 8 * s, NCONS / 32);      // every consumer warp
    }
    mbar_init_fence();
  }
  return r;
}

// Producer (one thread): the nk stages of one tile. A's hi rows start at
// row `a_hi` of map `ta` and its lo rows at `a_lo`; B^T's at `b_hi`,
// `b_lo` of `tb`.
__device__ __forceinline__ void produce_tile(Ring& r, const CUtensorMap* ta,
                                             const CUtensorMap* tb, int a_hi, int a_lo,
                                             int b_hi, int b_lo, int nk, int timeout_ms) {
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(r.empty_bar(), r.phase ^ 1u, timeout_ms);
    const unsigned bar = r.full_bar(), st = r.at();
    mbar_expect_tx(bar, STAGE);
    tma_load(st, ta, kt * BK, a_hi, bar);
    tma_load(st + BOX, ta, kt * BK, a_lo, bar);
    tma_load(st + 2 * BOX, tb, kt * BK, b_hi, bar);
    tma_load(st + 3 * BOX, tb, kt * BK, b_lo, bar);
    r.advance();
  }
}

// Consumers (threads 0-255): one tile's nk stages into acc, the f32 sum
// of this warpgroup's 64 rows x 128 columns in wgmma's accumulator
// layout: thread (warp w of the group, lane 4g + t) holds rows 16w + g
// (acc[4j], acc[4j + 1]) and 16w + g + 8 (acc[4j + 2], acc[4j + 3]) at
// columns 8j + 2t, 8j + 2t + 1.
__device__ __forceinline__ void consume_tile(Ring& r, int nk, float (&acc)[64], int timeout_ms) {
  const int grp = threadIdx.x / 128;
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(r.full_bar(), r.phase, timeout_ms);
    const unsigned a_hi = r.at() + grp * 64 * 128, a_lo = a_hi + BOX;
    const unsigned b_hi = r.at() + 2 * BOX, b_lo = b_hi + BOX;
    const int keep = kt % PART_STAGES != 0;
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const unsigned o = ks * 32;
      wgmma_tf32(part, sw128_desc(a_lo + o), sw128_desc(b_hi + o), ks == 0 ? keep : 1);
      wgmma_tf32(part, sw128_desc(a_hi + o), sw128_desc(b_lo + o), 1);
      wgmma_tf32(part, sw128_desc(a_hi + o), sw128_desc(b_hi + o), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty_bar());
    if (kt % PART_STAGES == PART_STAGES - 1 || kt == nk - 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    r.advance();
  }
}

}  // namespace wg
