// KV-cache shuttle for Hopper (sm_90a): the prefill rank computes K = x@Wk
// and V = x@Wv (or, in `pure` mode, takes finished [K; V] cache rows) and
// ships both to the decode rank, which waits on-device.
//
// Replaces src/repro/kernels/kv_shuttle.py::_shuttle_kernel (the Pallas
// kernel behind kv_shuttle_sharded, kv_shuttle and kv_cache_shuttle), the
// n = 2 degenerate ring of RingSchedule. It computes the same function:
// projections accumulate in f32 and are stored in x's dtype (f32 here);
// `pure` copies rows verbatim, so a bf16 cache arrives bit for bit.
//
// Layout: the two ranks are two partitions of ONE cooperative launch over
// one allocation. A "send" is the prefill partition's store into the
// decode rank's output slab; a flag word per (half, chunk) stands in for
// each krecv / vrecv DMA semaphore and counts the elements landed. The
// issue order is core/verify.py::lower_ring's for the n = 2 ring: a CTA
// writes a tile (GEMM epilogue or row copy), stores it into the decode
// slab (the send), then ticks the chunk's flag (__syncthreads,
// __threadfence, atomicAdd). A kv_chunk x dk chunk spans several tiles
// written by several CTAs, so its flag completes only after every
// contributing CTA's release. The decode rank waits with acquire loads:
//   fused + COUNTER  per chunk, K then V (32 chunks in flight at a time);
//   fused (SIGNAL)   every K chunk, then every V chunk;
//   whole tensor     K once, then V once.
// Work units (tiles) go round robin over the prefill CTAs in the round
// order: fused is chunk-major (chunk c's K tiles, then its V tiles);
// otherwise every K tile precedes every V tile. Chained and sequential
// differ only in when V may start: sequential CTAs wait until all of K
// has landed (the drain before the V GEMM), chained ones go straight on.
// The reference's `contexts` send window has no counterpart: a store and
// its flag retire as they issue (ROADMAP queue 3).
//
// The decode rank computes nothing, so it gets one CTA (one warp of it
// waits, 32 chunks at a time) and the prefill partition every other
// co-resident CTA. The wrapper zeroes the flags on
// the launch stream before every launch, so a stale flag never satisfies
// a wait. Every spin gives up after timeout_ms with a trap.
//
// Bound: at the workload's width (T = d = 4096, dk = 512, f32) the two
// projections are 34.4 GFLOP against 117 MB of traffic, so the f32
// (non-tensor-core) rate bounds it; this first version is a plain SIMT
// GEMM (64x64 tiles, 4x4 per thread, no wgmma, no TMA). `pure` mode is a
// copy: HBM bandwidth bounds it.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "flags.cuh"
#include "simt_gemm.cuh"

struct ShuttleParams {
  int rows;         // rows of each half: T, or N in pure mode
  int d;            // GEMM depth (unused in pure mode)
  int dk;           // columns of each half (the row width w in pure mode)
  int chunk_rows;   // rows per flag chunk: kv_chunk when fused, else rows
  int nchunks;      // flag chunks per half: rows / chunk_rows
  int fused, chained, counter, pure;
  int vec;          // 16-byte aligned rows and bases: vector loads/stores
  int esize;        // pure mode: bytes per element
  int unit_rows;    // pure mode: rows per copy unit
  int timeout_ms;
  const void* x;    // x[0] (rows, d) f32, or [K; V] (2*rows, w) in pure mode
  const float* wk;  // (d, dk)
  const float* wv;  // (d, dk)
  void* ko;         // the decode rank's K slab (rows, dk)
  void* vo;         // the decode rank's V slab (rows, dk)
  unsigned* flag;   // (2, nchunks): elements landed per (half, chunk)
};

// pure mode: copy nbytes verbatim, 16 bytes a thread where aligned, four
// loads in flight before their stores
__device__ void copy_bytes(const char* __restrict__ src, char* __restrict__ dst,
                           size_t nbytes, int vec) {
  if (vec) {
    const uint4* __restrict__ s = reinterpret_cast<const uint4*>(src);
    uint4* __restrict__ t = reinterpret_cast<uint4*>(dst);
    const size_t n = nbytes / 16;
    size_t i = threadIdx.x;
    for (; i + 3 * NT < n; i += 4 * NT) {
      const uint4 a = __ldcs(s + i), b = __ldcs(s + i + NT);
      const uint4 c = __ldcs(s + i + 2 * NT), d = __ldcs(s + i + 3 * NT);
      t[i] = a;
      t[i + NT] = b;
      t[i + 2 * NT] = c;
      t[i + 3 * NT] = d;
    }
    for (; i < n; i += NT) t[i] = __ldcs(s + i);
  } else {
    for (size_t i = threadIdx.x; i < nbytes; i += NT) dst[i] = src[i];
  }
}

// ------------------------------------------------------------------ roles

__device__ int units_per_chunk(const ShuttleParams& P) {
  if (P.pure) return (P.chunk_rows + P.unit_rows - 1) / P.unit_rows;
  return ((P.chunk_rows + BM - 1) / BM) * ((P.dk + BN - 1) / BN);
}

// one work unit: write the tile, send it, tick its (half, chunk) flag
__device__ void run_unit(const ShuttleParams& P, int half, int chunk, int sub, Smem& sm) {
  unsigned* flag = P.flag + (size_t)half * P.nchunks + chunk;
  void* out = half ? P.vo : P.ko;
  if (P.pure) {
    const int r0 = sub * P.unit_rows;
    const int nrows = min(P.unit_rows, P.chunk_rows - r0);
    const size_t row = (size_t)chunk * P.chunk_rows + r0;
    const size_t rb = (size_t)P.dk * P.esize;
    const char* src = reinterpret_cast<const char*>(P.x) + ((size_t)half * P.rows + row) * rb;
    copy_bytes(src, reinterpret_cast<char*>(out) + row * rb, nrows * rb, P.vec);
    cta_signal(flag, (unsigned)(nrows * P.dk));
    return;
  }
  const int ctn = (P.dk + BN - 1) / BN;
  const int rt = sub / ctn, col0 = (sub % ctn) * BN;
  const int r0 = rt * BM;
  const int nrows = min(BM, P.chunk_rows - r0), ncols = min(BN, P.dk - col0);
  const int row0 = chunk * P.chunk_rows + r0;
  float acc[4][4];
  gemm_tile(reinterpret_cast<const float*>(P.x), row0, nrows, P.d, half ? P.wv : P.wk, P.dk,
            col0, ncols, P.vec, acc, sm);
  store_tile(reinterpret_cast<float*>(out), row0, nrows, P.dk, col0, ncols, P.vec, acc);
  cta_signal(flag, (unsigned)(nrows * ncols));
}

__device__ void prefill(const ShuttleParams& P, int pid, int npre, Smem& sm) {
  const int upc = units_per_chunk(P);
  const int total = 2 * P.nchunks * upc;
  const unsigned all_k = (unsigned)P.chunk_rows * P.dk;  // one whole-tensor chunk
  bool drained = false;
  for (int u = pid; u < total; u += npre) {
    int half, chunk, sub;
    if (P.fused) {  // chunk-major: chunk c's K tiles, then its V tiles
      chunk = u / (2 * upc);
      half = (u % (2 * upc)) / upc;
      sub = u % upc;
    } else {        // every K tile, then every V tile
      half = u / upc;
      chunk = 0;
      sub = u % upc;
    }
    if (half == 1 && !P.fused && !P.chained && !drained) {
      // sequential: K's send drains before the V GEMM starts
      if (threadIdx.x == 0) {
        spin_geq(P.flag, all_k, P.timeout_ms, "kv_shuttle", "K drain", 0, 0);
        __threadfence();
      }
      __syncthreads();
      drained = true;
    }
    run_unit(P, half, chunk, sub, sm);
  }
}

// one warp; lane i waits on chunk c0 + i, 32 chunks at a time: the loads
// of a 32-chunk window are in flight together, where one thread walking
// the flags would pay an L2 round trip per chunk after the last arrival
__device__ void decode(const ShuttleParams& P) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const unsigned per = (unsigned)P.chunk_rows * P.dk;
  const unsigned* kf = P.flag;
  const unsigned* vf = P.flag + P.nchunks;
  for (int pass = 0; pass < (P.fused && P.counter ? 1 : 2); ++pass) {
    for (int c0 = 0; c0 < P.nchunks; c0 += 32) {
      const int c = c0 + lane;
      if (c < P.nchunks) {
        if (P.fused && P.counter) {  // COUNTER: per chunk, K then V
          spin_geq(kf + c, per, P.timeout_ms, "kv_shuttle", "K chunk", 0, c);
          spin_geq(vf + c, per, P.timeout_ms, "kv_shuttle", "V chunk", 1, c);
        } else {  // every K chunk, then every V chunk (one chunk unfused)
          spin_geq((pass ? vf : kf) + c, per, P.timeout_ms, "kv_shuttle", pass ? "V" : "K",
                   pass, c);
        }
      }
      __syncwarp();
    }
  }
  __threadfence();
}

__global__ void __launch_bounds__(NT) kv_shuttle_kernel(ShuttleParams P) {
  __shared__ Smem sm;
  const int npre = gridDim.x - 1;  // the last CTA is the decode rank
  if ((int)blockIdx.x < npre)
    prefill(P, blockIdx.x, npre, sm);
  else
    decode(P);
}

// ------------------------------------------------------------ C interface

extern "C" {

// Largest co-resident grid: (CTAs per SM) x SMs. Returns a cudaError_t,
// or -1 without cooperative launch, or -2 when fewer than two CTAs fit.
int kv_shuttle_grid(int* grid, int* per_sm) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kv_shuttle_kernel, NT, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return -1;
  *grid = (*per_sm) * sms;
  return *grid < 2 ? -2 : 0;
}

// Cooperative launch: the runtime refuses a grid whose CTAs cannot all be
// resident at once, which the spin-waits require.
int kv_shuttle_launch(const ShuttleParams* p, int grid, void* stream) {
  void* args[] = {const_cast<ShuttleParams*>(p)};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)kv_shuttle_kernel, dim3(grid),
                                              dim3(NT), args, 0, (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

const char* kv_shuttle_error(int code) {
  if (code == -1) return "device does not support cooperative launch";
  if (code == -2) return "fewer than two co-resident CTAs";
  return cudaGetErrorString((cudaError_t)code);
}

int kv_shuttle_params_size() { return (int)sizeof(ShuttleParams); }

}  // extern "C"
