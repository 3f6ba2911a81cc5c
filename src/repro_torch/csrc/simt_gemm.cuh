// The SIMT f32 tile GEMM of gemm_allgather.cu: a CTA of NT = 256 threads
// computes one BM x BN = 64 x 64 output tile, 4 x 4 outputs a thread,
// staging BK = 16 deep slices of A (transposed) and B in shared memory. No
// tensor cores, no asynchronous copy: the first, simple version, kept until
// gemm_allgather.cu is redesigned (moe_dispatch.cu and kv_shuttle.cu run on
// tc_gemm.cuh).
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>

#define BM 64
#define BN 64
#define BK 16
#define NT 256

struct Smem {
  float As[BK][BM + 4];
  float Bs[BK][BN];
};

// One BM x BN tile of A (rows x K, row stride K) times B (K x N, row stride
// N): rows [row0, row0 + nrows), columns [col0, col0 + ncols). Out-of-range
// rows, columns and depth load as zeros; the K sum runs in ascending order.
__device__ void gemm_tile(const float* A, int row0, int nrows, int K, const float* B, int N,
                          int col0, int ncols, int vec, float (&acc)[4][4], Smem& sm) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lr = tid / 4, lk = (tid % 4) * 4;     // A tile load coordinates
  const int br = tid / 16, bc = (tid % 16) * 4;   // B tile load coordinates
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    float a[4] = {0.f, 0.f, 0.f, 0.f}, w[4] = {0.f, 0.f, 0.f, 0.f};
    if (lr < nrows) {
      const float* ap = A + (size_t)(row0 + lr) * K + k0 + lk;
      if (vec && k0 + lk + 3 < K) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(ap));
        a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
      } else {
        for (int q = 0; q < 4; ++q)
          if (k0 + lk + q < K) a[q] = __ldg(ap + q);
      }
    }
    if (k0 + br < K) {
      const float* bp = B + (size_t)(k0 + br) * N + col0 + bc;
      if (vec && bc + 3 < ncols) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(bp));
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      } else {
        for (int q = 0; q < 4; ++q)
          if (bc + q < ncols) w[q] = __ldg(bp + q);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sm.As[lk + q][lr] = a[q];
      sm.Bs[br][bc + q] = w[q];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br4[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ void store_tile(float* out, int row0, int nrows, int N, int col0, int ncols,
                           int vec, const float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nrows) continue;
    float* op = out + (size_t)(row0 + r) * N + col0 + tx * 4;
    if (vec && tx * 4 + 3 < ncols) {
      *reinterpret_cast<float4*>(op) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
      for (int j = 0; j < 4; ++j)
        if (tx * 4 + j < ncols) op[j] = acc[i][j];
    }
  }
}
