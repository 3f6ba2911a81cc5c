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
// Work units (whole tiles, or row copies in `pure` mode) go round robin
// over the prefill CTAs in the round order. Fused is chunk-major: a row
// group (kv_chunk rows when that is a multiple of 64, else one 64-row
// m-tile) issues its K tiles, then its V tiles, so chunk c is complete no
// later than chunk c + 1; otherwise every K tile precedes every V tile.
// Chained and sequential differ only in when V may start: sequential
// CTAs wait until all of K has landed (the drain before the V GEMM),
// chained ones go straight on.
// The reference's `contexts` send window has no counterpart: a store and
// its flag retire as they issue (ROADMAP queue 3).
//
// The decode rank computes nothing, so it gets one CTA (one warp of it
// waits, 32 chunks at a time) and the prefill partition every other
// co-resident CTA. The wrapper zeroes the flags on
// the launch stream before every launch, so a stale flag never satisfies
// a wait. Every spin gives up after timeout_ms with a trap.
//
// GEMM variants: the projections run through tc_gemm.cuh's 64 x 128
// tensor-core tile (3xTF32 mma.sync, f32 accurate, cp.async ring). A unit
// is one whole tile (half, m-tile, column tile) whatever kv_chunk is; its
// epilogue ticks the (half, chunk) flag of every chunk it overlaps by the
// elements it wrote there, so kv_chunk sets only the flag granularity.
// The units walk the column tiles inside an m-tile: x (T x d, 64 MB at the
// workload's width) is the operand beyond L2, so CTAs that run together
// share its rows while both weights (8 MB each) stay in L2.
//
// Bound: at the workload's width (T = d = 4096, dk = 512, f32) the two
// projections are 34.4 GFLOP against 117 MB of traffic. 3xTF32 is three
// tensor products per multiply-add, so the operations bound it: 3 x 34.4
// GFLOP at 495 TFLOP/s, 0.21 ms on an H100 SXM. `pure` mode is a copy
// (its own kernel instantiation, without the GEMM's shared memory and
// registers): HBM bandwidth bounds it.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "flags.cuh"
#include "tc_gemm.cuh"

using tc::BM;
using tc::BN;
using tc::NT;

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

// pure mode: one unit copies unit_rows rows of one (half, chunk)
__device__ void copy_unit(const ShuttleParams& P, int half, int chunk, int sub) {
  unsigned* flag = P.flag + (size_t)half * P.nchunks + chunk;
  void* out = half ? P.vo : P.ko;
  const int r0 = sub * P.unit_rows;
  const int nrows = min(P.unit_rows, P.chunk_rows - r0);
  const size_t row = (size_t)chunk * P.chunk_rows + r0;
  const size_t rb = (size_t)P.dk * P.esize;
  const char* src = reinterpret_cast<const char*>(P.x) + ((size_t)half * P.rows + row) * rb;
  copy_bytes(src, reinterpret_cast<char*>(out) + row * rb, nrows * rb, P.vec);
  cta_signal(flag, (unsigned)(nrows * P.dk));
}

// one GEMM unit: the whole tile (m-tile mt, column tile ct) of one half,
// stored into the decode slab (the send); then a tick of every
// (half, chunk) flag the tile overlaps, by the elements it wrote there
template <bool VEC>
__device__ void gemm_unit(const ShuttleParams& P, int half, int mt, int ct, char* smem) {
  const int row0 = mt * BM, col0 = ct * BN;
  const int nrows = min(BM, P.rows - row0), ncols = min(BN, P.dk - col0);
  tc::tile<float, VEC>(tc::TileA{P.x, nullptr, P.d, (size_t)row0, nrows},
                       tc::TileB{half ? P.wv : P.wk, P.dk, col0, col0 + 64, ncols}, P.d, smem);
  float* out = reinterpret_cast<float*>(half ? P.vo : P.ko);
  tc::store_tile<VEC>(smem, out + (size_t)row0 * P.dk + col0, P.dk, nrows, ncols, nrows);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    unsigned* flag = P.flag + (size_t)half * P.nchunks;
    for (int c = row0 / P.chunk_rows; c <= (row0 + nrows - 1) / P.chunk_rows; ++c) {
      const int lo = max(row0, c * P.chunk_rows);
      const int hi = min(row0 + nrows, (c + 1) * P.chunk_rows);
      atomicAdd(flag + c, (unsigned)((hi - lo) * ncols));
    }
  }
}

// sequential: K's send drains before the V GEMM starts
__device__ void drain_k(const ShuttleParams& P) {
  cta_wait(P.flag, (unsigned)P.chunk_rows * P.dk, P.timeout_ms, "kv_shuttle", "K drain", 0, 0);
}

__device__ void prefill_copy(const ShuttleParams& P, int pid, int npre) {
  const int upc = (P.chunk_rows + P.unit_rows - 1) / P.unit_rows;
  const int total = 2 * P.nchunks * upc;
  bool drained = false;
  for (int u = pid; u < total; u += npre) {
    int half, chunk, sub;
    if (P.fused) {  // chunk-major: chunk c's K rows, then its V rows
      chunk = u / (2 * upc);
      half = (u % (2 * upc)) / upc;
      sub = u % upc;
    } else {        // all of K, then all of V
      half = u / upc;
      chunk = 0;
      sub = u % upc;
    }
    if (half == 1 && !P.fused && !P.chained && !drained) {
      drain_k(P);
      drained = true;
    }
    copy_unit(P, half, chunk, sub);
  }
}

template <bool VEC>
__device__ void prefill_gemm(const ShuttleParams& P, int pid, int npre, char* smem) {
  const int rt = (P.rows + BM - 1) / BM, ctn = (P.dk + BN - 1) / BN;
  // a row group of tpg m-tiles issues its K tiles, then its V tiles;
  // unfused, the group is the whole tensor
  const int tpg = !P.fused ? rt : (P.chunk_rows % BM == 0 ? P.chunk_rows / BM : 1);
  const int per_group = 2 * tpg * ctn;
  const int total = 2 * rt * ctn;
  bool drained = false;
  for (int u = pid; u < total; u += npre) {
    const int group = u / per_group, rem = u % per_group;
    const int half = rem / (tpg * ctn), sub = rem % (tpg * ctn);
    const int mt = group * tpg + sub / ctn, ct = sub % ctn;
    if (half == 1 && !P.fused && !P.chained && !drained) {
      drain_k(P);
      drained = true;
    }
    gemm_unit<VEC>(P, half, mt, ct, smem);
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

// PURE: the row copies (the engine's cache handoff), four CTAs per SM
// (64 registers). Otherwise the projections, two CTAs per SM: the 3-stage
// ring takes 80 KB of shared memory a CTA, and the launch bound holds
// ptxas at 128 registers.
template <bool PURE>
__global__ void __launch_bounds__(NT, PURE ? 4 : 2) kv_shuttle_kernel(ShuttleParams P) {
  extern __shared__ __align__(16) char smem[];
  const int npre = gridDim.x - 1;  // the last CTA is the decode rank
  if ((int)blockIdx.x >= npre) {
    decode(P);
  } else if constexpr (PURE) {
    prefill_copy(P, blockIdx.x, npre);
  } else {
    if (P.vec)
      prefill_gemm<true>(P, blockIdx.x, npre, smem);
    else
      prefill_gemm<false>(P, blockIdx.x, npre, smem);
  }
}

// ------------------------------------------------------------ C interface

static const void* kernel_for(int pure) {
  return pure ? (const void*)kv_shuttle_kernel<true> : (const void*)kv_shuttle_kernel<false>;
}

static int smem_for(int pure) { return pure ? 0 : tc::SMEM; }

// the GEMM ring's shared memory is above the 48 KB default: opt in before
// the occupancy query and the launch
static cudaError_t allow_smem(int pure) {
  return cudaFuncSetAttribute(kernel_for(pure), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_for(pure));
}

extern "C" {

// Largest co-resident grid of the pure or the GEMM kernel: (CTAs per SM)
// x SMs. Returns a cudaError_t, or -1 without cooperative launch, or -2
// when fewer than two CTAs fit.
int kv_shuttle_grid(int pure, int* grid, int* per_sm) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = allow_smem(pure);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel_for(pure), NT,
                                                      smem_for(pure));
  if (e != cudaSuccess) return (int)e;
  if (!coop) return -1;
  *grid = (*per_sm) * sms;
  return *grid < 2 ? -2 : 0;
}

// Cooperative launch: the runtime refuses a grid whose CTAs cannot all be
// resident at once, which the spin-waits require.
int kv_shuttle_launch(const ShuttleParams* p, int grid, void* stream) {
  void* args[] = {const_cast<ShuttleParams*>(p)};
  cudaError_t e = allow_smem(p->pure);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel_for(p->pure), dim3(grid), dim3(NT), args,
                                    smem_for(p->pure), (cudaStream_t)stream);
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
