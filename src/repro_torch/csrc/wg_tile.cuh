// The Hopper tile core of kv_shuttle.cu's aligned projections and of
// moe_dispatch.cu's expert GEMMs: f32-accurate products as 3xTF32 `wgmma`,
// the weight fed from registers and x by TMA, in a warp-specialised CTA,
// one an SM.
//
// Operands, swapped: tf32 `wgmma` reads only K-major operands from shared
// memory. x (rows, d) row-major is K-major, the weights (d, dk) row-major
// are not, so each tile is computed transposed, C^T = W^T x^T: `wgmma`'s
// A (M = 64 output columns a warpgroup) is the weight, gathered from
// shared memory into registers in any layout (no weight is transposed or
// copied), and its B (N = the tile's 128 token rows) is x, read by
// descriptor from the TMA box (128-byte swizzle, as wgmma_gemm.cuh reads
// its operands).
//
// Split: x = hi + lo (mma.cuh's split_tf32: hi rounds x to TF32, lo =
// x - hi) once a stage, in shared memory: hi in place, lo into the stage's
// lo box, by the converter warps, before `wgmma` reads either. The weight's
// split happens in the consumers' registers, as they gather a stage's
// fragments. Each element of either operand is split once per CTA.
//
// Tile: BM x BN = 128 token rows x 128 output columns over BK = 32 deep
// stages. A stage holds x (16 KB, one 128 x 32 box), x's lo half (16 KB)
// and the weight (16 KB: four 32 x 32 boxes, 128-byte swizzle, so the
// fragment gathers below hit every bank once); STAGES = 3 of them and a
// dedicated 128 x 128 result tile fit the CTA's 227 KB, so the next tile's
// loads start while the send window's bulk stores still read the last
// result. (A fourth stage, beside a 64-column result tile sent in two
// pieces, ran no faster on an H100: the split sets the pace there, not
// the loads' latency.) Rows past x's end, depth past d and weight columns
// past dk are zero-filled by TMA; weight boxes wholly past dk are not
// loaded (their products land in columns no epilogue stores).
//
// Warps: two consumer warpgroups (threads 0-255), 64 output columns each,
// and a loader warpgroup: warp 8's lane 0 keeps TMA loads in flight on
// the `full` barriers, warps 9-11 convert each landed stage and arrive on
// `ready`; each consumer warp arrives on `empty` once its products have
// read the stage. The consumers' sum and partial (two 64 x 128 f32 sets,
// 128 registers a thread) and a stage's weight fragments (32) sit at the
// 168 registers a thread that 384 threads at one CTA an SM launch with;
// setmaxnreg moves the loaders' spare registers to the consumers (without
// it ptxas spilled 120-144 bytes of each kernel's consumer state). The next
// stage's fragments are gathered after this stage's products, not during
// them: held beside them they spilled 756 bytes even so.
//
// Products: per 8-deep k step, wgmma m64n128k8 .tf32 three times, small
// terms first: w_lo x_hi, w_hi x_lo, w_hi x_hi. The tensor core truncates
// its f32 sum, so PART_STAGES stages go into a fresh partial (128 deep;
// a caller may ask for fewer) that is added into the sum on the f32
// cores, as both other cores do.
//
// moe_dispatch.cu's units (produce_unit, convert_unit's int8 path,
// consume_tile on 32 accumulators) add: a tile of 64 or 128 token rows
// (m64n64k8 or m64n128k8; x in 64-row boxes, one or two loads a stage),
// the weight's 128 columns as two 64-column halves at any two offsets
// (gate and up for SwiGLU), and x as int8 rows with a scale each (the int8
// wire): TMA lands them at the start of the stage's lo box, and the
// converters dequantize each row before the split, into the swizzled
// boxes the TMA would have written.
//
// The kernel that runs this core must call no function (ptxas then
// serializes every wgmma): every wait here and around it is inline.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flags.cuh"
#include "mma.cuh"
#include "wgmma_gemm.cuh"

namespace wt {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, PART_STAGES = 4;
constexpr int NCONS = 256;              // two consumer warpgroups
constexpr int NTHREADS = NCONS + 128;   // + the loader warpgroup
constexpr int NCONV = 96;               // its converter warps, 9-11
constexpr int XBOX = BM * BK * 4;       // x's box: 16 KB
constexpr int WBOX = BK * 32 * 4;       // a weight box, 32 x 32: 4 KB
constexpr int STAGE = 2 * XBOX + 4 * WBOX;  // x (hi in place), x lo, weight: 48 KB
constexpr int LDC = BN + 4;             // the result tile's row (floats)
constexpr int CTILE = BM * LDC * 4;
constexpr int BARS = 3 * STAGES * 8;
constexpr int SMEM = STAGES * STAGE + CTILE + BARS + 1024;  // + 1 KB alignment
constexpr int CONS_BAR = 1;             // the consumers' named barrier
constexpr int CONV_BAR = 2;             // the converters' (the int8 wire)
constexpr int REG_CONS = 232, REG_LOAD = 40;  // setmaxnreg, a thread
static_assert(NCONS * REG_CONS + (NTHREADS - NCONS) * REG_LOAD <= 65536, "registers");

// d (+)= A B: m64n128k8, A tf32 in registers (a0: row g, k t; a1: row
// g + 8, k t; a2: row g, k t + 4; a3: row g + 8, k t + 4 of the warp's 16
// rows), B tf32 from shared memory (K-major); scale_d = 0 starts a fresh sum
__device__ __forceinline__ void wgmma_ra(float (&d)[64], const unsigned (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, "
      "1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// wgmma_ra at N = 64 (the 64-row token tile): m64n64k8
__device__ __forceinline__ void wgmma_ra64(float (&d)[32], const unsigned (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "
      "%36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// pin the accumulators' order against the asynchronous wgmma (either width)
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the calling warpgroup's registers a thread: up (consumers) or down (loaders)
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------ the ring

struct Ring {
  char* gen;                     // stage 0, generic address (1024-byte aligned)
  unsigned smem;                 // stage 0, shared address
  unsigned full, ready, empty;   // the STAGES barriers of each kind
  int stage;
  unsigned phase;

  __device__ __forceinline__ unsigned at() const { return smem + stage * STAGE; }
  __device__ __forceinline__ char* gen_at() const { return gen + stage * STAGE; }
  __device__ __forceinline__ unsigned bar(unsigned kind) const { return kind + 8 * stage; }
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
  r.gen = raw + (r.smem - tc::smem_u32(raw));
  r.full = r.smem + STAGES * STAGE + CTILE;
  r.ready = r.full + 8 * STAGES;
  r.empty = r.ready + 8 * STAGES;
  r.stage = 0;
  r.phase = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(r.full + 8 * s, 1);             // the producer's expect_tx
      wg::mbar_init(r.ready + 8 * s, NCONV / 32);   // every converter warp
      wg::mbar_init(r.empty + 8 * s, NCONS / 32);   // every consumer warp
    }
    wg::mbar_init_fence();
  }
  return r;
}

// the dedicated result tile, C[token row][column], LDC floats a row
__device__ __forceinline__ float* result_tile(const Ring& r) {
  return reinterpret_cast<float*>(r.gen + STAGES * STAGE);
}

// shared memory past the ring's barriers, for the caller's state
__device__ __forceinline__ char* tail(const Ring& r) {
  return r.gen + STAGES * STAGE + CTILE + BARS;
}

// ------------------------------------------------------------ the roles

// Producer (one thread): the nk stages of one tile: x rows [row0, row0 +
// 128) of map tx ((d, rows) f32) and weight columns [col0, col0 + ncols)
// of map tw ((dk, d) f32), 32 columns a box.
__device__ __forceinline__ void produce_tile(Ring& r, const CUtensorMap* tx,
                                             const CUtensorMap* tw, int row0, int col0,
                                             int ncols, int nk, int timeout_ms) {
  const int nb = (ncols + 31) / 32;
  for (int kt = 0; kt < nk; ++kt) {
    wg::mbar_wait(r.bar(r.empty), r.phase ^ 1u, timeout_ms);
    const unsigned full = r.bar(r.full), st = r.at();
    wg::mbar_expect_tx(full, XBOX + nb * WBOX);
    wg::tma_load(st, tx, kt * BK, row0, full);
    for (int b = 0; b < nb; ++b)
      wg::tma_load(st + 2 * XBOX + b * WBOX, tw, col0 + 32 * b, kt * BK, full);
    r.advance();
  }
}

// Producer (one thread), a unit's entry: its nk stages, x rows [xrow,
// xrow + rows) of map tx (rows 64 or 128, in 64-row boxes: f32 into the hi
// box, int8 (I8) 32-byte rows to the start of the lo box) and, of map tw,
// weight rows [wrow, wrow + 32 nk) at columns col_lo + [0, 64) and col_hi +
// [0, 64), the 32-column boxes below ncols.
template <bool I8>
__device__ __forceinline__ void produce_unit(Ring& r, const CUtensorMap* tx, int xrow, int rows,
                                             const CUtensorMap* tw, int wrow, int col_lo,
                                             int col_hi, int ncols, int nk, int timeout_ms) {
  const int nb = (ncols + 31) / 32;
  const unsigned bytes = rows * BK * (I8 ? 1 : 4) + nb * WBOX;
  for (int kt = 0; kt < nk; ++kt) {
    wg::mbar_wait(r.bar(r.empty), r.phase ^ 1u, timeout_ms);
    const unsigned full = r.bar(r.full), st = r.at();
    wg::mbar_expect_tx(full, bytes);
    for (int b = 0; b < rows / 64; ++b)
      wg::tma_load(st + (I8 ? XBOX + b * 64 * BK : b * 64 * BK * 4), tx, kt * BK, xrow + 64 * b,
                   full);
    for (int b = 0; b < nb; ++b)
      wg::tma_load(st + 2 * XBOX + b * WBOX, tw, (b < 2 ? col_lo : col_hi - 64) + 32 * b,
                   wrow + kt * BK, full);
    r.advance();
  }
}

// x's first N float4s of a landed stage `st`: hi in place, lo into the lo
// box (the converter warps)
__device__ __forceinline__ void split_x(char* st, int N) {
  const int ct = threadIdx.x - (NTHREADS - NCONV);
  float4* hi = reinterpret_cast<float4*>(st);
  float4* lo = reinterpret_cast<float4*>(st + XBOX);
  for (int i0 = ct; i0 < N; i0 += 4 * NCONV) {
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i0 + j * NCONV < N) v[j] = hi[i0 + j * NCONV];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j * NCONV >= N) break;
      unsigned h[4], l[4];
      tc::split_tf32(v[j].x, h[0], l[0]);
      tc::split_tf32(v[j].y, h[1], l[1]);
      tc::split_tf32(v[j].z, h[2], l[2]);
      tc::split_tf32(v[j].w, h[3], l[3]);
      hi[i0 + j * NCONV] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                       __uint_as_float(h[2]), __uint_as_float(h[3]));
      lo[i0 + j * NCONV] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                       __uint_as_float(l[2]), __uint_as_float(l[3]));
    }
  }
}

// The int8 wire's chunks a converter thread takes (16 bytes: half a row)
constexpr int I8_CHUNKS = (2 * BM + NCONV - 1) / NCONV;

// A converter thread's row scales of a unit's int8 rows: chunk i is row
// (ct + i NCONV) / 2; rows at or past `valid` get 0 (their products are
// never stored). Read once the unit's first stage has landed: the
// producer's acquire of the rows' flags comes before it.
__device__ __forceinline__ void i8_scales(const float* scale, int rows, int valid,
                                          float (&sc)[I8_CHUNKS]) {
  const int ct = threadIdx.x - (NTHREADS - NCONV);
#pragma unroll
  for (int i = 0; i < I8_CHUNKS; ++i) {
    const int row = (ct + i * NCONV) >> 1;
    sc[i] = row < rows && row < valid ? __ldcg(scale + row) : 0.f;
  }
}

// The int8 rows of a landed stage `st` (rows x 32 bytes at the lo box's
// start): every converter loads its chunks, the three warps meet, then each
// writes its rows' dequantized hi and lo where TMA's 128-byte swizzle puts
// them (16-byte chunk c of row r at chunk c ^ r % 8)
__device__ __forceinline__ void split_x_i8(char* st, int rows, const float (&sc)[I8_CHUNKS]) {
  const int ct = threadIdx.x - (NTHREADS - NCONV);
  int4 q[I8_CHUNKS];
#pragma unroll
  for (int i = 0; i < I8_CHUNKS; ++i)
    if (ct + i * NCONV < 2 * rows) q[i] = reinterpret_cast<const int4*>(st + XBOX)[ct + i * NCONV];
  group_sync(CONV_BAR, NCONV);
#pragma unroll
  for (int i = 0; i < I8_CHUNKS; ++i) {
    const int c = ct + i * NCONV, row = c >> 1;
    if (c >= 2 * rows) break;
    const int w[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // float4 k of the half row: x[16 (c % 2) + 4 k ...]
      unsigned h[4], l[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        tc::split_tf32((float)(signed char)(w[k] >> (8 * b)) * sc[i], h[b], l[b]);
      const int off = row * 128 + ((((c & 1) * 4 + k) ^ (row & 7)) << 4);
      *reinterpret_cast<float4*>(st + off) =
          make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                      __uint_as_float(h[3]));
      *reinterpret_cast<float4*>(st + XBOX + off) =
          make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                      __uint_as_float(l[3]));
    }
  }
}

// Converters (warps 9-11): nk landed stages of `rows` x rows, in ring
// order: x's hi in place and its lo into the lo box (I8: int8 rows, row r
// dequantized with scale[r] first; scale: the unit's first row's), then
// the async proxy may read both
template <bool I8>
__device__ __forceinline__ void convert_unit(Ring& r, int nk, int rows, const float* scale,
                                             int valid, int timeout_ms) {
  float sc[I8_CHUNKS];
  for (int s = 0; s < nk; ++s) {
    wg::mbar_wait(r.bar(r.full), r.phase, timeout_ms);
    if constexpr (I8) {
      if (s == 0) i8_scales(scale, rows, valid, sc);
      split_x_i8(r.gen_at(), rows, sc);
    } else
      split_x(r.gen_at(), rows * (BK / 4));
    wg::fence_proxy_async();
    __syncwarp();
    if ((threadIdx.x & 31) == 0) wg::mbar_arrive(r.bar(r.ready));
    r.advance();
  }
}

// Which 4-column chunk of its 32-column weight box feeds D rows g, g + 8
// of a warp (g = lane / 4): the two warps of a box take chunks {0, 4, 1,
// 5} and {2, 6, 3, 7}, so that under the 128-byte swizzle (chunk ^ k % 8)
// a half-warp's eight-byte gathers at k = t (or t + 4), t = lane % 4, hit
// 16 distinct bank pairs. D rows g and g + 8 are columns 2 (g % 2) and
// + 1 of the chunk.
__device__ __forceinline__ int col_chunk(int warp, int g) {
  return 4 * ((g >> 1) & 1) + 2 * (warp & 1) + (g >> 2);
}

// The tile column of a consumer thread's D row g (its row g + 8: the next)
__device__ __forceinline__ int tile_col() {
  const int grp = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
  return 64 * grp + 32 * (warp >> 1) + 4 * col_chunk(warp, g) + 2 * (g & 1);
}

// A consumer thread's weight fragments of one stage (four k steps): the
// eight-byte gathers at byte offsets o0 (k = t of a k step) and o1 (k =
// t + 4), split into TF32 hi and lo
__device__ __forceinline__ void gather(const char* st, int o0, int o1,
                                       unsigned (&ah)[BK / 8][4], unsigned (&al)[BK / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {  // a k step is 8 swizzled 128-byte rows
    const float2 u = *reinterpret_cast<const float2*>(st + o0 + ks * 1024);
    const float2 v = *reinterpret_cast<const float2*>(st + o1 + ks * 1024);
    tc::split_tf32(u.x, ah[ks][0], al[ks][0]);
    tc::split_tf32(u.y, ah[ks][1], al[ks][1]);
    tc::split_tf32(v.x, ah[ks][2], al[ks][2]);
    tc::split_tf32(v.y, ah[ks][3], al[ks][3]);
  }
}

// Consumers (threads 0-255): one tile's nk stages into acc, warpgroup
// grp's 64 columns (D's rows) x the tile's 128 token rows (D's columns;
// 64 with N = 32 accumulators, m64n64k8) in wgmma's accumulator layout:
// thread (warp w of the group, lane 4g + t) holds D rows 16w + g (acc[4j],
// acc[4j + 1]) and 16w + g + 8 (acc[4j + 2], acc[4j + 3]) at token rows
// 8j + 2t, 8j + 2t + 1; D row g is tile column tile_col(), row g + 8 the
// next. PART: stages a partial sum takes (PART_STAGES, 128 deep, unless
// the caller asks for shorter ones).
template <int PART = PART_STAGES, int N>
__device__ __forceinline__ void consume_tile(Ring& r, int nk, float (&acc)[N], int timeout_ms) {
  static_assert(N == 64 || N == 32, "a tile of 128 or 64 token rows");
  const int grp = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int chunk = col_chunk(warp, g);
  const int box = 2 * XBOX + (2 * grp + (warp >> 1)) * WBOX + 8 * (g & 1);
  const int o0 = box + t * 128 + ((chunk ^ t) << 4);              // k = t of a k step
  const int o1 = box + (t + 4) * 128 + ((chunk ^ (t + 4)) << 4);  // k = t + 4
  float part[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) part[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    wg::mbar_wait(r.bar(r.full), r.phase, timeout_ms);
    wg::mbar_wait(r.bar(r.ready), r.phase, timeout_ms);
    unsigned ah[BK / 8][4], al[BK / 8][4];
    gather(r.gen_at(), o0, o1, ah, al);
    const unsigned xh = r.at(), xl = xh + XBOX;
    const int keep = kt % PART != 0;
    fence_acc(part);
    wg::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const unsigned o = ks * 32;
      if constexpr (N == 64) {
        wgmma_ra(part, al[ks], wg::sw128_desc(xh + o), ks == 0 ? keep : 1);
        wgmma_ra(part, ah[ks], wg::sw128_desc(xl + o), 1);
        wgmma_ra(part, ah[ks], wg::sw128_desc(xh + o), 1);
      } else {
        wgmma_ra64(part, al[ks], wg::sw128_desc(xh + o), ks == 0 ? keep : 1);
        wgmma_ra64(part, ah[ks], wg::sw128_desc(xl + o), 1);
        wgmma_ra64(part, ah[ks], wg::sw128_desc(xh + o), 1);
      }
    }
    wg::wgmma_commit();
    wg::wgmma_wait_all();
    fence_acc(part);
    if (lane == 0) wg::mbar_arrive(r.bar(r.empty));
    if (kt % PART == PART - 1 || kt == nk - 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += part[i];
    }
    r.advance();
  }
}

// acc (consume_tile's layout) into the result tile C[token row][column]
template <int N>
__device__ __forceinline__ void store_result(float* C, const float (&acc)[N]) {
  const int t = threadIdx.x & 3;
  const int col = tile_col();
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float2*>(C + (8 * j + 2 * t + e) * LDC + col) =
          make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
}

}  // namespace wt
