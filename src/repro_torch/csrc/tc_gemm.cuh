// The tensor-core tile GEMM of the port's unaligned operands (kv_shuttle.cu's
// projections and moe_dispatch.cu's gemm_core_kernel<false>, where K or N
// is off 4 or a base off 16 bytes: what TMA cannot map; the aligned ones
// run wg_tile.cuh's wgmma core): a CTA of NT = 256 threads computes one BM
// x BN = 64 x 128 output tile of A (rows x K) times B (K x N), both
// row-major, at f32 accuracy.
//
// Products: mma.sync m16n8k8 on TF32 with the error-compensated 3xTF32
// split (mma.cuh's split_tf32 and mma_tf32). Each f32 operand x becomes
// hi (x rounded to TF32) and lo = x - hi; every k step adds a_lo*b_hi,
// then a_hi*b_lo, then a_hi*b_hi (small terms first). At the TF32 rate
// (495 TFLOP/s dense) three products per multiply-add allow 165 TFLOP/s
// of f32-accurate work, against 67 on the SIMT cores. Not wgmma: for
// tf32 it takes only K-major A and B, and the weights here are (K, N)
// row-major (N-major); mma.sync fragments are gathered from shared memory
// in any layout, so no weight is transposed or copied.
// wgmma_gemm.cuh (gemm_allgather.cu) pays that copy once per call instead:
// its operands are split and transposed into K-major hi / lo scratch, then
// TMA + wgmma run with no split in the loop (chip_smoke.py's ga_core line),
// and wg_tile.cuh gathers the weight into registers as wgmma's A.
//
// Staging: A and B arrive through a ring of STAGES BK = 32 deep slices in
// dynamic shared memory, by cp.async (16 bytes a copy, one commit group a
// stage, one wait_group before each stage's products). .cg reads through
// L2 only: slabs other CTAs of the same launch wrote (the received rows,
// the SwiGLU intermediate) must never come from a stale L1 line; the
// caller issues the copy only after the acquire on that slab's flag. Rows
// at or past `valid`, columns at or past `ncols` and depth at or past K
// are zero-filled through cp.async's src-size operand. The unaligned path
// (VEC = false: a row length or a base that is not a multiple of 16 bytes)
// copies 4 bytes at a time (cp.async.ca: it reads inputs only). Three
// stages (80 KB a CTA, two CTAs an SM): on an H100 a fourth sped the tile
// alone and slowed the moe kernel.
//
// Operands: f32 A, or int8 A with per-row f32 scales (the int8 wire),
// dequantised while the fragments are gathered. B's 128 tile columns are
// two 64-column halves at any two column offsets: adjacent for a plain
// product, gate and up columns for SwiGLU's GEMM1.
//
// Warps: 2 x 4, each 32 rows x 32 columns: 2 x 4 m16n8 tiles, 32
// accumulators a thread (and 32 for a stage's partial sums). The result
// goes through shared memory, so the epilogues store whole rows; SwiGLU's
// pairs column c with column 64 + c.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma.cuh"

namespace tc {

constexpr int BM = 64, BN = 128, BK = 32, NT = 256, STAGES = 3;
constexpr int LDA = BK + 8;    // f32 A row (floats): 8-byte fragment loads, no bank conflict
constexpr int LDA8 = BK + 16;  // int8 A row (bytes): 16-byte rows, 8 rows on 8 banks
constexpr int LDB = BN + 4;    // B row (floats): 16-byte fragment loads, no bank conflict
constexpr int LDC = BN + 4;    // the result tile's row (floats), in smem after the products
constexpr int A_STAGE = BM * LDA * 4;
constexpr int B_STAGE = BK * LDB * 4;
constexpr int STAGE = A_STAGE + B_STAGE;
constexpr int SMEM = STAGES * STAGE + BM * 4;  // + an int8 tile's row scales
static_assert(BM * LDC * 4 <= STAGES * STAGE, "the result tile reuses the stages");

struct TileA {
  const void* p;       // (rows, lda) f32, or int8 with `scale`
  const float* scale;  // int8: a scale per row; f32: unused
  int lda;
  size_t row0;         // the tile's first row
  int valid;           // rows at or past this load as zeros
};

struct TileB {
  const float* p;      // (K, ldb) f32
  int ldb;
  int col_lo, col_hi;  // first global column of the low and high 64-column halves
  int ncols;           // tile columns (0..128) that load; the rest are zeros
};

// issue the copies of depth slice [k0, k0 + BK) into one stage
template <typename AT, bool VEC>
__device__ __forceinline__ void load_stage(const TileA& a, const TileB& b, int k0, int K,
                                           char* st) {
  const int tid = threadIdx.x;
  if constexpr (sizeof(AT) == 1) {  // int8: 64 rows x 32 bytes, 16 bytes a thread
    if (tid < BM * BK / 16) {
      const int r = tid >> 1, c = (tid & 1) * 16;
      const bool ok = r < a.valid && k0 + c < K;
      const int8_t* src =
          static_cast<const int8_t*>(a.p) + (ok ? (a.row0 + r) * a.lda + k0 + c : 0);
      cp16(st + r * LDA8 + c, src, ok);
    }
  } else if constexpr (VEC) {
    float* As = reinterpret_cast<float*>(st);
#pragma unroll
    for (int i = tid; i < BM * BK / 4; i += NT) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      const bool ok = r < a.valid && k0 + c < K;
      const float* src =
          static_cast<const float*>(a.p) + (ok ? (a.row0 + r) * a.lda + k0 + c : 0);
      cp16(As + r * LDA + c, src, ok);
    }
  } else {
    float* As = reinterpret_cast<float*>(st);
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const bool ok = r < a.valid && k0 + c < K;
      const float* src =
          static_cast<const float*>(a.p) + (ok ? (a.row0 + r) * a.lda + k0 + c : 0);
      cp4(As + r * LDA + c, src, ok);
    }
  }
  float* Bs = reinterpret_cast<float*>(st + A_STAGE);
  if constexpr (VEC) {
#pragma unroll
    for (int i = tid; i < BK * BN / 4; i += NT) {
      const int kr = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const bool ok = k0 + kr < K && c < b.ncols;
      const int col = (c < 64 ? b.col_lo : b.col_hi) + (c & 63);
      cp16(Bs + kr * LDB + c, b.p + (ok ? (size_t)(k0 + kr) * b.ldb + col : 0), ok);
    }
  } else {
    for (int i = tid; i < BK * BN; i += NT) {
      const int kr = i / BN, c = i % BN;
      const bool ok = k0 + kr < K && c < b.ncols;
      const int col = (c < 64 ? b.col_lo : b.col_hi) + (c & 63);
      cp4(Bs + kr * LDB + c, b.p + (ok ? (size_t)(k0 + kr) * b.ldb + col : 0), ok);
    }
  }
}

// The 3xTF32 products of one stage into the warp's 2 x 4 m16n8 tiles of
// `part` (zeroed by the caller; see tile() for why a stage sums apart).
// An m16n8k8 product only needs A's and B's k to agree, and its columns
// may be any 8 of the tile's: lane (g, t) takes k = kk + 2t and kk + 2t + 1
// (one 8-byte A load a row) and the warp's n8 tile j takes columns
// 32 wn + 4 g + j (one 16-byte B load a k row for all four tiles). The
// result is stored back through the same map.
template <typename AT>
__device__ __forceinline__ void mma_stage(const char* st, const float* sc,
                                          float (&part)[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const float* Bs = reinterpret_cast<const float*>(st + A_STAGE);
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    unsigned ah[2][4], al[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of m16 tile i
        const int r = wm + i * 16 + g + h * 8;
        float2 v;
        if constexpr (sizeof(AT) == 1) {
          const char2 q = *reinterpret_cast<const char2*>(st + r * LDA8 + kk + 2 * t);
          v = make_float2((float)q.x * sc[r], (float)q.y * sc[r]);
        } else {
          v = *reinterpret_cast<const float2*>(reinterpret_cast<const float*>(st) + r * LDA +
                                               kk + 2 * t);
        }
        split_tf32(v.x, ah[i][h], al[i][h]);          // a0 / a1: k = kk + 2t
        split_tf32(v.y, ah[i][h + 2], al[i][h + 2]);  // a2 / a3: k = kk + 2t + 1
      }
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + (kk + 2 * t) * LDB + wn + 4 * g);
    const float4 b1 = *reinterpret_cast<const float4*>(Bs + (kk + 2 * t + 1) * LDB + wn + 4 * g);
    const float bk0[4] = {b0.x, b0.y, b0.z, b0.w}, bk1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned bh[2], bl[2];
      split_tf32(bk0[j], bh[0], bl[0]);
      split_tf32(bk1[j], bh[1], bl[1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_tf32(part[i][j], al[i], bh);
        mma_tf32(part[i][j], ah[i], bl);
        mma_tf32(part[i][j], ah[i], bh);
      }
    }
  }
}

// One BM x BN tile over depth K. Every thread of the CTA calls it; smem
// holds SMEM bytes. The result lands in smem as C[BM][LDC] (f32) for the
// caller's epilogue, every copy retired, after a __syncthreads.
//
// Each stage's products sum apart in `part` and are added into `acc` on
// the f32 cores (round to nearest). The tensor core truncates its f32
// accumulation, so a sum carried through all of K in it drifts toward
// zero: on an H100 at K = 7168 that read 1.006e-4 of the output's max-abs
// against cuBLAS f32, over the 1e-4 gate. Summed per stage,
// the truncations are relative to a 32-deep partial sum and of either
// sign. Kept out of line: the caller's loop state stays out of the
// 128-register budget of the products.
template <typename AT, bool VEC>
__device__ __noinline__ void tile(const TileA a, const TileB b, int K, char* smem) {
  __syncthreads();  // the previous tile's epilogue has read smem
  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  float* sc = reinterpret_cast<float*>(smem + STAGES * STAGE);
  if (sizeof(AT) == 1 && threadIdx.x < BM)
    sc[threadIdx.x] = (int)threadIdx.x < a.valid ? __ldcg(a.scale + a.row0 + threadIdx.x) : 0.f;
  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage<AT, VEC>(a, b, s * BK, K, smem + s * STAGE);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 is free
    const int next = kt + STAGES - 1;
    if (next < nk) load_stage<AT, VEC>(a, b, next * BK, K, smem + (next % STAGES) * STAGE);
    cp_commit();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][j][c] = 0.f;
    mma_stage<AT>(smem + (kt % STAGES) * STAGE, sc, part);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
  }
  cp_wait<0>();
  __syncthreads();  // every stage read: smem takes the result
  float* C = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // D(row, 2t + e) of tile j is column wn + 4 (2t + e) + j
      float* row = C + (wm + i * 16 + g + h * 8) * LDC + wn + 8 * t;
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[i][0][2 * h], acc[i][1][2 * h], acc[i][2][2 * h], acc[i][3][2 * h]);
      *reinterpret_cast<float4*>(row + 4) = make_float4(
          acc[i][0][2 * h + 1], acc[i][1][2 * h + 1], acc[i][2][2 * h + 1], acc[i][3][2 * h + 1]);
    }
  __syncthreads();
}

// silu(g) * u, silu(g) = g * sigmoid(g)
__device__ __forceinline__ float swiglu(float g, float u) { return g / (1.f + expf(-g)) * u; }

// SwiGLU's epilogue of a paired tile: H[r, c] = silu(C[r, c]) * C[r, 64 + c]
// for the tile's 64 H columns and rows r < nrows (H 16-byte aligned, ldh
// a multiple of 4)
__device__ __forceinline__ void store_swiglu(const char* smem, float* H, int ldh, int nrows) {
  const float* C = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < BM * 16; i += NT) {
    const int r = i / 16, c = (i % 16) * 4;
    if (r >= nrows) break;
    const float4 g = *reinterpret_cast<const float4*>(C + r * LDC + c);
    const float4 u = *reinterpret_cast<const float4*>(C + r * LDC + 64 + c);
    *reinterpret_cast<float4*>(H + (size_t)r * ldh + c) =
        make_float4(swiglu(g.x, u.x), swiglu(g.y, u.y), swiglu(g.z, u.z), swiglu(g.w, u.w));
  }
}

// A plain tile's epilogue: out[r, c] = C[r, c] for rows r < nrows and
// columns c < ncols (the high half continuing the low one); rows at or
// past `valid` store zeros. VEC: float4 stores (ldo a multiple of 4, out
// 16-byte aligned).
template <bool VEC>
__device__ __forceinline__ void store_tile(const char* smem, float* out, int ldo, int nrows,
                                           int ncols, int valid) {
  const float* C = reinterpret_cast<const float*>(smem);
  if (VEC) {
    for (int i = threadIdx.x; i < BM * BN / 4; i += NT) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      if (r >= nrows) break;
      if (c >= ncols) continue;
      const float4 v = r < valid ? *reinterpret_cast<const float4*>(C + r * LDC + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(out + (size_t)r * ldo + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < BM * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      if (r >= nrows) break;
      if (c < ncols) out[(size_t)r * ldo + c] = r < valid ? C[r * LDC + c] : 0.f;
    }
  }
}

}  // namespace tc
