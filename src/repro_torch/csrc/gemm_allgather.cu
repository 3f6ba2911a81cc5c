// Fused GEMM + AllGather for Hopper (sm_90a): every rank computes
// C_r = A_r @ B and stores it into every rank's output at rows
// [r*M_l, (r+1)*M_l), so each rank ends with the whole gathered product.
//
// Replaces src/repro/kernels/gemm_allgather.py::_ga_kernel (the Pallas
// kernel behind gemm_allgather_sharded and gemm_allgather). It computes the
// same function in f32: the K sum runs in f32, every output element is
// written once into each of the n outputs.
//
// Layout: the n ranks are n partitions of ONE cooperative launch over one
// allocation (CTA b is rank b % n). A "remote copy" is a store into the
// receiving rank's output; a flag word per (receiver, source, chunk)
// stands in for each receive semaphore and counts the elements landed
// (flags.cuh: the sender's CTA stores, __syncthreads, __threadfence,
// atomicAdd; the receiver spins on an acquire load). Realizations:
//   TILE_FUSED  a 64x64 GEMM tile is stored into the own output and every
//               peer's (round order: offset 1, 2, ...) the moment its K loop
//               ends; its flag ticks go to every tile_m chunk it overlaps, so
//               a tile_m of 16 or 32 changes the flag granularity, not the
//               GEMM tile (no half-empty 64-row tiles).
//   DEFERRED    the rank's CTAs store their tiles into the own slab and meet
//               at a rank-wide counter (the GEMM is done); then each CTA ships
//               its share of the slab to every peer, reading it through L2
//               (__ldcg: other CTAs wrote it).
// Completion: COUNTER waits per (source, tile_m chunk) flag; SIGNAL and
// DEFERRED wait once per inbound edge (one flag per source). The waits come
// after the rank's own stores, spread over its CTAs (one warp each, a lane
// per flag), since nothing in the kernel consumes the gathered rows. The
// reference's `contexts` send window has no counterpart: a store and its
// flag retire as they issue (ROADMAP queue 3). The wrapper zeroes the flags
// and the rank counters on the launch stream before every launch.
//
// Bound: at GemmAllGather's defaults (n=4, M=K=N=4096, M_l=1024, f32) the
// call does 137.4 GFLOP of f32 against 403 MB of traffic, so the f32
// (non-tensor-core) rate bounds it (2.05 ms on an H100 SXM). This first
// version is a plain SIMT GEMM (64x64 tiles, 4x4 per thread, no wgmma, no
// TMA); the broadcast adds (n-1) stores of each tile.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "flags.cuh"
#include "simt_gemm.cuh"

struct GaParams {
  int n, M_l, K, N;
  int chunk_rows;   // rows per flag chunk: tile_m under fused COUNTER, else M_l
  int nchunks;      // M_l / chunk_rows
  int fused;        // TILE_FUSED (1) or DEFERRED (0)
  int vec;          // K, N multiples of 4 and 16-byte aligned bases
  int per_rank;     // CTAs per rank
  int timeout_ms;
  const float* a;   // (n, M_l, K)
  const float* b;   // (K, N)
  float* out;       // (n, n*M_l, N): rank r's gathered output at out[r]
  unsigned* flag;   // (n receiver, n source, nchunks): elements landed
  unsigned* done;   // (n): CTAs of the rank whose tiles are stored (DEFERRED)
};

// where source `src`'s slab lands in receiver `dst`'s output
__device__ __forceinline__ float* slab_of(const GaParams& P, int dst, int src) {
  return P.out + ((size_t)dst * P.n + src) * P.M_l * P.N;
}

__device__ __forceinline__ unsigned* flag_of(const GaParams& P, int dst, int src, int c) {
  return P.flag + ((size_t)dst * P.n + src) * P.nchunks + c;
}

// TILE_FUSED: GEMM tile -> own output and every peer's, then tick the
// flags of each chunk the tile overlaps, for every peer
__device__ void fused_tiles(const GaParams& P, int me, int pid, Smem& sm) {
  const float* A = P.a + (size_t)me * P.M_l * P.K;
  const int ctn = (P.N + BN - 1) / BN, rtn = (P.M_l + BM - 1) / BM;
  float acc[4][4];
  for (int u = pid; u < rtn * ctn; u += P.per_rank) {  // row-tile major
    const int row0 = (u / ctn) * BM, col0 = (u % ctn) * BN;
    const int nrows = min(BM, P.M_l - row0), ncols = min(BN, P.N - col0);
    gemm_tile(A, row0, nrows, P.K, P.b, P.N, col0, ncols, P.vec, acc, sm);
    for (int off = 0; off < P.n; ++off)
      store_tile(slab_of(P, (me + off) % P.n, me), row0, nrows, P.N, col0, ncols, P.vec, acc);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      const int c0 = row0 / P.chunk_rows, c1 = (row0 + nrows - 1) / P.chunk_rows;
      for (int off = 1; off < P.n; ++off)
        for (int c = c0; c <= c1; ++c) {
          const int lo = max(row0, c * P.chunk_rows);
          const int hi = min(row0 + nrows, (c + 1) * P.chunk_rows);
          atomicAdd(flag_of(P, (me + off) % P.n, me, c), (unsigned)((hi - lo) * ncols));
        }
    }
  }
}

// DEFERRED: the whole GEMM into the own slab, a rank-wide meeting, then
// this CTA's share of the slab to every peer (one flag per edge)
__device__ void deferred_slab(const GaParams& P, int me, int pid, Smem& sm) {
  const float* A = P.a + (size_t)me * P.M_l * P.K;
  float* own = slab_of(P, me, me);
  const int ctn = (P.N + BN - 1) / BN, rtn = (P.M_l + BM - 1) / BM;
  float acc[4][4];
  for (int u = pid; u < rtn * ctn; u += P.per_rank) {
    const int row0 = (u / ctn) * BM, col0 = (u % ctn) * BN;
    const int nrows = min(BM, P.M_l - row0), ncols = min(BN, P.N - col0);
    gemm_tile(A, row0, nrows, P.K, P.b, P.N, col0, ncols, P.vec, acc, sm);
    store_tile(own, row0, nrows, P.N, col0, ncols, P.vec, acc);
  }
  cta_signal(&P.done[me], 1u);
  cta_wait(&P.done[me], (unsigned)P.per_rank, P.timeout_ms, "gemm_allgather", "rank GEMM",
           me, 0);
  const size_t elems = (size_t)P.M_l * P.N;
  const size_t share = ((elems + P.per_rank - 1) / P.per_rank + 3) / 4 * 4;
  const size_t lo = (size_t)pid * share < elems ? (size_t)pid * share : elems;
  const size_t hi = lo + share < elems ? lo + share : elems;
  for (int off = 1; off < P.n; ++off) {
    const int dst = (me + off) % P.n;
    float* to = slab_of(P, dst, me);
    if (P.vec) {
      for (size_t i = lo + 4 * threadIdx.x; i < hi; i += 4 * NT)
        *reinterpret_cast<float4*>(to + i) = __ldcg(reinterpret_cast<const float4*>(own + i));
    } else {
      for (size_t i = lo + threadIdx.x; i < hi; i += NT) to[i] = __ldcg(own + i);
    }
    cta_signal(flag_of(P, dst, me, 0), (unsigned)(hi - lo));
  }
}

// the receive side: warp 0 of each CTA waits on its share of the rank's
// inbound flags, a lane per flag, in round order (offset 1 first)
__device__ void wait_inbound(const GaParams& P, int me, int pid) {
  if (threadIdx.x >= 32) return;
  const int total = (P.n - 1) * P.nchunks;
  const unsigned want = (unsigned)P.chunk_rows * P.N;
  for (int i = pid * 32 + threadIdx.x; i < total; i += P.per_rank * 32) {
    const int off = 1 + i / P.nchunks, c = i % P.nchunks;
    const int src = (me - off + P.n) % P.n;
    spin_geq(flag_of(P, me, src, c), want, P.timeout_ms, "gemm_allgather", "arrival", src, c);
  }
  __threadfence();
}

__global__ void __launch_bounds__(NT) gemm_allgather_kernel(GaParams P) {
  __shared__ Smem sm;
  const int me = blockIdx.x % P.n, pid = blockIdx.x / P.n;
  if (P.fused)
    fused_tiles(P, me, pid, sm);
  else
    deferred_slab(P, me, pid, sm);
  wait_inbound(P, me, pid);
}

// ------------------------------------------------------------ C interface

extern "C" {

// Largest co-resident grid that splits evenly over n ranks. Returns a
// cudaError_t, or -1 without cooperative launch, or -2 when a rank would
// get no CTA.
int gemm_allgather_grid(int n, int* grid, int* per_sm) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, gemm_allgather_kernel, NT, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return -1;
  const int per_rank = (*per_sm) * sms / n;
  *grid = per_rank * n;
  return per_rank < 1 ? -2 : 0;
}

// Cooperative launch: the runtime refuses a grid whose CTAs cannot all be
// resident at once, which the spin-waits require.
int gemm_allgather_launch(const GaParams* p, int grid, void* stream) {
  void* args[] = {const_cast<GaParams*>(p)};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)gemm_allgather_kernel, dim3(grid),
                                              dim3(NT), args, 0, (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

const char* gemm_allgather_error(int code) {
  if (code == -1) return "device does not support cooperative launch";
  if (code == -2) return "fewer co-resident CTAs than ranks";
  return cudaGetErrorString((cudaError_t)code);
}

int gemm_allgather_params_size() { return (int)sizeof(GaParams); }

}  // extern "C"
