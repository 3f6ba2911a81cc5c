// Fused GEMM + AllGather for Hopper (sm_90a): every rank computes
// C_r = A_r @ B and stores it into every rank's output at rows
// [r*M_l, (r+1)*M_l), so each rank ends with the whole gathered product.
//
// Replaces src/repro/kernels/gemm_allgather.py::_ga_kernel (the Pallas
// kernel behind gemm_allgather_sharded and gemm_allgather). It computes the
// same function at f32 accuracy; every output element is written once into
// each of the n outputs.
//
// Layout: the n ranks are n partitions of ONE cooperative launch over one
// allocation (CTA b is rank b % n). A "remote copy" is a store into the
// receiving rank's output; a flag word per (receiver, source, chunk)
// stands in for each receive semaphore and counts the elements landed
// (flags.cuh: the sender's threads store, meet, one fences and adds; the
// receiver spins on an acquire load, inline: the kernel calls no function,
// which would serialize its wgmma). Realizations:
//   TILE_FUSED  a 128 x 128 GEMM tile is stored into the own output and
//               every peer's (round order: offset 0, 1, 2, ...) from the
//               consumers' registers the moment its K loop ends; its flag
//               ticks go to every tile_m chunk it overlaps, so tile_m
//               changes the flag granularity, not the GEMM tile.
//   DEFERRED    the rank's CTAs store their tiles into the own slab and meet
//               at a rank-wide counter (the GEMM is done); then each CTA
//               reads its share of the slab once through L2 (__ldcg: other
//               CTAs wrote it) and stores it to every peer.
// Completion: COUNTER waits per (source, tile_m chunk) flag; SIGNAL and
// DEFERRED wait once per inbound edge (one flag per source). The waits come
// after the rank's own stores, spread over its CTAs (one warp each, a lane
// per flag), since nothing in the kernel consumes the gathered rows. The
// wrapper zeroes the flags and the rank counters on the launch stream
// before every launch.
//
// The send window (window.cuh, mechanism (a): TMA bulk stores). A round is
// (offset, tile u) of one CTA: its 128 x 128 tile into one peer's output
// (TILE_FUSED, tile-major: offsets 1, 2, ... of a tile, then the next
// tile), or its share of the slab to one peer (DEFERRED). The fused
// epilogue stores the own slab from registers as before; for each peer the
// two consumer warpgroups stage their 64 rows in turn into a 33 KB slot
// (what shared memory has left beside the 3-stage ring: the slot costs no
// stage, but it takes 33 KB from the SM's L1 cache, and the split, which
// reads A and B through L1, runs about 15% slower: chip_smoke.py's ga_core
// line, PERF.md §6) and thread 0 sends each half with a bulk store a row. DEFERRED
// stages its share through the ring itself, idle once the rank's GEMM is
// done. At most `contexts` rounds a CTA are unretired; retiring one waits
// for its bulk groups, fences and ticks its flags (a tile: every tile_m
// chunk it overlaps, for its peer). The window drains before the receive
// waits, which depend only on the other ranks' drains. Rows that are not
// 16-byte multiples (N not a multiple of 4) keep the plain stores and only
// defer the flag.
//
// Bound: at GemmAllGather's defaults (n=4, M=K=N=4096, M_l=1024, f32) the
// call does 137.4 GFLOP against 403 MB of traffic. f32 accuracy on the
// tensor cores is 3xTF32, three TF32 products per multiply-add, so the
// operations bound it: 0.833 ms at 495 / 3 TFLOP/s on an H100 SXM. What
// holds the kernel above it on the card is the split (device memory: it
// writes twice the operands' bytes, a replica of B^T per rank) and the
// GEMM's operand feed (hi and lo double what each tile reads through L2);
// chip_smoke.py's ga_core line times the split, the GEMM and the
// broadcast apart.
//
// Design (wgmma_gemm.cuh): one CTA an SM, persistent, warp-specialised.
// Phase 1, the split: each rank's CTAs write A_r and B^T as TF32 hi / lo,
// K-major and zero-padded to whole tiles, into scratch the wrapper
// allocates (each rank splits its own replica of B, as each card of a node
// holds its own), then meet at the rank's `split` counter. The split is
// done once per call, not once per tile: each B element feeds M_l / 128
// row tiles and each A element N / 128 column tiles, and the TPU kernel
// likewise stages B once (sync_copy into VMEM) for every tile. Phase 2,
// the GEMM: a producer warp keeps TMA loads of 128 x 32 hi / lo boxes in
// flight into a 3-stage mbarrier ring; two consumer warpgroups run wgmma
// m64n128k8 .tf32, three products a k step, each stage summed apart on the
// f32 cores. The rank's tiles go to its CTAs in groups of GROUP_M = 4
// row tiles, column by column inside a group: the CTAs that run together
// then share a few A row tiles and B column tiles through L2. Row by row
// (GROUP_M = 1), every wave of 33 CTAs reads all of the rank's B^T hi / lo
// (128 MB at the defaults) from HBM again; ga_core times 1, 4 and 8.
// Phase 3, the epilogue: thread stores from the accumulators into the own
// slab (float2 when N is even; any N works, so there is no separate
// unaligned kernel), then the tile's rounds to the peers through the send
// window below.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flags.cuh"
#include "tma_map.cuh"
#include "wgmma_gemm.cuh"
#include "window.cuh"

#ifndef GA_GROUP_M
#define GA_GROUP_M 4
#endif

using wg::BK;
using wg::BM;
using wg::BN;
using wg::NCONS;
using wg::NTHREADS;

constexpr int GROUP_M = GA_GROUP_M;
constexpr int NWARPS = NTHREADS / 32;

struct GaParams {
  int n, M_l, K, N;
  int M_p, K_p, N_p;  // M_l, K, N padded to whole tiles (BM, BK, BN)
  int chunk_rows;     // rows per flag chunk: tile_m under fused COUNTER, else M_l
  int nchunks;        // M_l / chunk_rows
  int fused;          // TILE_FUSED (1) or DEFERRED (0)
  int vec;            // K, N multiples of 4 and 16-byte aligned bases
  int per_rank;       // CTAs per rank
  int timeout_ms;
  int contexts;       // the send window's depth: 1, 2 or 4
  int log_cap;        // events a CTA's probe log holds (-DCUCO_PROBE builds)
  const float* a;     // (n, M_l, K)
  const float* b;     // (K, N)
  float* out;         // (n, n*M_l, N): rank r's gathered output at out[r]
  float* sa;          // (2, n, M_p, K_p): each rank's A, TF32 hi then lo
  float* sb;          // (2, n, N_p, K_p): each rank's B^T, TF32 hi then lo
  unsigned* flag;     // (n receiver, n source, nchunks): elements landed
  unsigned* done;     // (n): CTAs of the rank whose tiles are stored (DEFERRED)
  unsigned* split;    // (n): CTAs of the rank whose share of the split is stored
  int* log;           // (grid, log_cap, 4): window events (-DCUCO_PROBE builds)
  int* log_n;         // (grid): events each CTA appended
};

// a round: tile (row0, col0) to peer `off` (TILE_FUSED), or `amount`
// elements of the slab (DEFERRED)
struct GaRound {
  int off, row0, col0;
  unsigned amount;
};
using GaWindow = win::Window<GaRound>;
constexpr int GA_LDS = BN + 4;                 // a staged row (floats)
constexpr int GA_SLOT = 64 * GA_LDS * 4;       // one warpgroup's 64 rows
constexpr int GA_SHIP = 64 * 1024;             // DEFERRED's piece (in the ring)
constexpr int GA_SMEM = wg::SMEM + GA_SLOT + (int)sizeof(GaWindow);
static_assert(GA_SMEM <= 232448, "the send slot must fit beside the ring");

// where source `src`'s slab lands in receiver `dst`'s output
__device__ __forceinline__ float* slab_of(const GaParams& P, int dst, int src) {
  return P.out + ((size_t)dst * P.n + src) * P.M_l * P.N;
}

__device__ __forceinline__ unsigned* flag_of(const GaParams& P, int dst, int src, int c) {
  return P.flag + ((size_t)dst * P.n + src) * P.nchunks + c;
}

// ------------------------------------------------------------ phase 1: split

__device__ __forceinline__ void split_store(float* hi, float* lo, float x) {
  unsigned h, l;
  tc::split_tf32(x, h, l);
  *hi = __uint_as_float(h);
  *lo = __uint_as_float(l);
}

// This CTA's share of rank `me`'s split: A_r (M_l, K) -> (M_p, K_p) hi and
// lo, and B (K, N) -> B^T (N_p, K_p) hi and lo, 32 x 32 blocks a warp
// through `tr` (shared memory, a 32 x 33 block a warp)
__device__ void split_operands(const GaParams& P, int me, int pid, float* tr) {
  const size_t plane_a = (size_t)P.n * P.M_p * P.K_p, plane_b = (size_t)P.n * P.N_p * P.K_p;
  const float* A = P.a + (size_t)me * P.M_l * P.K;
  float* ahi = P.sa + (size_t)me * P.M_p * P.K_p;
  const size_t quads = (size_t)P.M_p * P.K_p / 4;
  for (size_t q = (size_t)pid * NTHREADS + threadIdx.x; q < quads;
       q += (size_t)P.per_rank * NTHREADS) {
    const size_t i = 4 * q;
    const int m = (int)(i / P.K_p), k = (int)(i % P.K_p);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (m < P.M_l) {
      const float* src = A + (size_t)m * P.K + k;
      if (P.vec) {
        if (k < P.K) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(src));
          v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < P.K) v[e] = __ldg(src + e);
      }
    }
    unsigned h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) tc::split_tf32(v[e], h[e], l[e]);
    *reinterpret_cast<uint4*>(ahi + i) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(ahi + plane_a + i) = make_uint4(l[0], l[1], l[2], l[3]);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* t = tr + warp * 32 * 33;
  float* bhi = P.sb + (size_t)me * P.N_p * P.K_p;
  const int kb = P.K_p / 32, blocks = kb * (P.N_p / 32);
  for (int blk = pid * NWARPS + warp; blk < blocks; blk += P.per_rank * NWARPS) {
    const int k0 = (blk % kb) * 32, n0 = (blk / kb) * 32, col = n0 + lane;
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {  // rows k0 + r of B, a lane a column
      const int k = k0 + r;
      t[r * 33 + lane] = k < P.K && col < P.N ? __ldg(P.b + (size_t)k * P.N + col) : 0.f;
    }
    __syncwarp();
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {  // row n0 + r of B^T, a lane a k
      const size_t o = (size_t)(n0 + r) * P.K_p + k0 + lane;
      split_store(bhi + o, bhi + plane_b + o, t[lane * 33 + r]);
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------ phase 2: GEMM

// tile u of a rank: groups of GROUP_M row tiles, column-major inside a group
__device__ __forceinline__ void tile_of(const GaParams& P, int u, int& row0, int& col0) {
  const int rtn = P.M_p / BM, ctn = P.N_p / BN;
  const int g = u / (GROUP_M * ctn), first = g * GROUP_M;
  const int rows = min(GROUP_M, rtn - first), local = u - g * GROUP_M * ctn;
  row0 = (first + local % rows) * BM;
  col0 = (local / rows) * BN;
}

// the consumers' stores of their accumulators into C (M_l, N) at tile
// (row0, col0): consumer warp w (0-7) holds rows 16w + g and 16w + g + 8
// (wg::consume_tile's layout); rows and columns past the edge are dropped
__device__ __forceinline__ void store_acc(float* C, const GaParams& P, int row0, int col0,
                                          const float (&acc)[64]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + (threadIdx.x >> 5) * 16 + g;
  const bool pairs = (P.N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= P.M_l) continue;
    float* row = C + (size_t)r * P.N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = col0 + 8 * j + 2 * t;
      const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      if (pairs) {
        if (c < P.N) *reinterpret_cast<float2*>(row + c) = make_float2(x, y);
      } else {
        if (c < P.N) row[c] = x;
        if (c + 1 < P.N) row[c + 1] = y;
      }
    }
  }
}

// a round's release (thread 0 of the consumers, once its stores landed):
// DEFERRED adds its share to the edge's flag; TILE_FUSED ticks the flag of
// each chunk the tile overlaps, for its peer
__device__ __forceinline__ void release_round(const GaParams& P, int me, const GaRound& r) {
  unsigned* f = flag_of(P, (me + r.off) % P.n, me, 0);
  if (!P.fused) {
    if (r.amount) atomicAdd(f, r.amount);
    return;
  }
  const int nrows = min(BM, P.M_l - r.row0), ncols = min(BN, P.N - r.col0);
  const int c0 = r.row0 / P.chunk_rows, c1 = (r.row0 + nrows - 1) / P.chunk_rows;
  for (int c = c0; c <= c1; ++c) {
    const int lo = max(r.row0, c * P.chunk_rows);
    const int hi = min(r.row0 + nrows, (c + 1) * P.chunk_rows);
    atomicAdd(f + c, (unsigned)((hi - lo) * ncols));
  }
}

// TILE_FUSED, the consumers: rounds (off, u) of tile u to every peer. Each
// warpgroup stages its 64 rows of the accumulators into the slot in turn
// and thread 0 sends them, a bulk store a row (rows past M_l and columns
// past N stay home)
template <class Release>
__device__ __forceinline__ void send_tile(const GaParams& P, GaWindow& w, float* slot, int me,
                                          int u, int row0, int col0, const float (&acc)[64],
                                          Release& release) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lr = ((threadIdx.x >> 5) & 3) * 16 + g;  // the thread's row in its half
  const int ncols = min(BN, P.N - col0);
  for (int off = 1; off < P.n; ++off) {
    if (threadIdx.x == 0) win::push(w, GaRound{off, row0, col0, 0u}, off, u, release);
    float* dst = slab_of(P, (me + off) % P.n, me);
    for (int h = 0; h < 2; ++h) {
      if (threadIdx.x == 0) win::wait_read_all();  // the slot's last bulk stores read it
      group_sync(wg::CONS_BAR, NCONS);
      if ((int)(threadIdx.x >> 7) == h) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<float2*>(slot + (lr + 8 * e) * GA_LDS + 8 * j + 2 * t) =
                make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
      }
      win::fence_to_async();
      group_sync(wg::CONS_BAR, NCONS);
      if (threadIdx.x == 0) {
        const int first = row0 + 64 * h, rows = min(64, P.M_l - first);
        for (int r = 0; r < rows; ++r)
          win::bulk_store(dst + (size_t)(first + r) * P.N + col0, slot + r * GA_LDS, ncols * 4);
        win::commit_piece(w);
      }
    }
  }
}

// DEFERRED (the consumers, after the rank's GEMM met): this CTA's share of
// the own slab to every peer, round (off, 0) each: staged through `stage`
// (the idle ring) and sent by bulk stores. Unaligned rows (N % 4) copy as
// before, COPY_U loads in flight a thread, stored to each peer in round
// order, and only the flags wait for the rounds' retirement.
constexpr int COPY_U = 4;

template <class Release>
__device__ __forceinline__ void ship_slab(const GaParams& P, GaWindow& w, char* stage, int me,
                                          int pid, Release& release) {
  const float* own = slab_of(P, me, me);
  const size_t elems = (size_t)P.M_l * P.N;
  const size_t share = ((elems + P.per_rank - 1) / P.per_rank + 3) / 4 * 4;
  const size_t lo = (size_t)pid * share < elems ? (size_t)pid * share : elems;
  const size_t hi = lo + share < elems ? lo + share : elems;
  if (P.vec) {
    for (int off = 1; off < P.n; ++off) {
      if (threadIdx.x == 0)
        win::push(w, GaRound{off, 0, 0, (unsigned)(hi - lo)}, off, 0, release);
      win::ship<NCONS, 8>(w, stage, GA_SHIP, own + lo, slab_of(P, (me + off) % P.n, me) + lo,
                          (hi - lo) * 4, [] { group_sync(wg::CONS_BAR, NCONS); });
    }
    return;
  }
  for (size_t i0 = lo + threadIdx.x; i0 < hi; i0 += COPY_U * NCONS) {
    float v[COPY_U];
#pragma unroll
    for (int u = 0; u < COPY_U; ++u) {
      const size_t i = i0 + (size_t)u * NCONS;
      if (i >= hi) break;
      v[u] = __ldcg(own + i);
    }
    for (int off = 1; off < P.n; ++off) {
      float* to = slab_of(P, (me + off) % P.n, me);
#pragma unroll
      for (int u = 0; u < COPY_U; ++u) {
        const size_t i = i0 + (size_t)u * NCONS;
        if (i >= hi) break;
        to[i] = v[u];
      }
    }
  }
  group_sync(wg::CONS_BAR, NCONS);
  if (threadIdx.x == 0)
    for (int off = 1; off < P.n; ++off)
      win::push(w, GaRound{off, 0, 0, (unsigned)(hi - lo)}, off, 0, release);
}

// the receive side: warp 0 of each CTA waits on its share of the rank's
// inbound flags, a lane per flag, in round order (offset 1 first)
__device__ __forceinline__ void wait_inbound(const GaParams& P, int me, int pid,
                                             const win::Log& lg) {
  if (threadIdx.x >= 32) return;
  const int total = (P.n - 1) * P.nchunks;
  const unsigned want = (unsigned)P.chunk_rows * P.N;
  for (int i = pid * 32 + threadIdx.x; i < total; i += P.per_rank * 32) {
    const int off = 1 + i / P.nchunks, c = i % P.nchunks;
    const int src = (me - off + P.n) % P.n;
    spin_geq_inline(flag_of(P, me, src, c), want, P.timeout_ms);
    win::note(lg, win::EV_RECV, off, c);
  }
  __threadfence();
}

__global__ void __launch_bounds__(NTHREADS, 1)
    gemm_allgather_kernel(const GaParams P, const int split_only,
                          const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb) {
  extern __shared__ __align__(1024) char smem[];
  const int me = blockIdx.x % P.n, pid = blockIdx.x / P.n;
  wg::Ring ring = wg::make_ring(smem);
  split_operands(P, me, pid, reinterpret_cast<float*>(smem + (ring.smem - tc::smem_u32(smem))));
  wg::fence_proxy_async();  // the split's stores, before any CTA's TMA reads them
  cta_signal(&P.split[me], 1u);
  group_wait(&P.split[me], (unsigned)P.per_rank, P.timeout_ms, 0, NTHREADS);
  if (split_only) return;
  const int tiles = (P.M_p / BM) * (P.N_p / BN), nk = P.K_p / BK;
  if (threadIdx.x >= NCONS) {  // the producer warp
    if (threadIdx.x == NCONS) {
      wg::fence_proxy_async();
      for (int u = pid; u < tiles; u += P.per_rank) {
        int row0, col0;
        tile_of(P, u, row0, col0);
        wg::produce_tile(ring, &ta, &tb, me * P.M_p + row0, (P.n + me) * P.M_p + row0,
                         me * P.N_p + col0, (P.n + me) * P.N_p + col0, nk, P.timeout_ms);
      }
    }
    return;
  }
  float acc[64];  // the consumers
  float* own = slab_of(P, me, me);
  GaWindow& w = *reinterpret_cast<GaWindow*>(smem + wg::SMEM + GA_SLOT);
  float* slot = reinterpret_cast<float*>(smem + wg::SMEM);
  const win::Log lg = win::cta_log(P.log, P.log_n, P.log_cap);
  if (threadIdx.x == 0) win::open(w, P.contexts, lg);
  auto release = [&](const GaRound& r) { release_round(P, me, r); };
  for (int u = pid; u < tiles; u += P.per_rank) {
    int row0, col0;
    tile_of(P, u, row0, col0);
    wg::consume_tile(ring, nk, acc, P.timeout_ms);
    store_acc(own, P, row0, col0, acc);
    if (!P.fused) continue;
    if (P.vec) {
      send_tile(P, w, slot, me, u, row0, col0, acc, release);
    } else {  // plain stores; the flags wait for the rounds' retirement
      for (int off = 1; off < P.n; ++off)
        store_acc(slab_of(P, (me + off) % P.n, me), P, row0, col0, acc);
      group_sync(wg::CONS_BAR, NCONS);
      if (threadIdx.x == 0)
        for (int off = 1; off < P.n; ++off)
          win::push(w, GaRound{off, row0, col0, 0u}, off, u, release);
    }
  }
  if (!P.fused) {
    group_signal(&P.done[me], 1u, wg::CONS_BAR, NCONS);
    group_wait(&P.done[me], (unsigned)P.per_rank, P.timeout_ms, wg::CONS_BAR, NCONS);
    ship_slab(P, w, smem + (ring.smem - tc::smem_u32(smem)), me, pid, release);
  }
  if (threadIdx.x == 0) win::drain(w, release, 0);
  wait_inbound(P, me, pid, lg);
}

// ------------------------------------------------------------ C interface

// the dynamic shared memory is above the 48 KB default: opt in before the
// occupancy query and the launch
static cudaError_t allow_smem() {
  return cudaFuncSetAttribute((const void*)gemm_allgather_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, GA_SMEM);
}

static int launch(const GaParams* p, int grid, int split_only, void* stream) {
  CUtensorMap ta, tb;
  // (rows, K_p) f32 scratch as 128 x 32 boxes in the 128-byte swizzle wgmma reads
  int rc = tma::encode(&ta, p->sa, p->K_p, 2 * p->n * p->M_p, 128);
  if (rc == 0) rc = tma::encode(&tb, p->sb, p->K_p, 2 * p->n * p->N_p, 128);
  if (rc != 0) return rc;
  void* args[] = {const_cast<GaParams*>(p), &split_only, &ta, &tb};
  cudaError_t e = allow_smem();
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel((const void*)gemm_allgather_kernel, dim3(grid),
                                    dim3(NTHREADS), args, GA_SMEM, (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

extern "C" {

// Largest co-resident grid that splits evenly over n ranks. Returns a
// cudaError_t, or -1 without cooperative launch, or -2 when a rank would
// get no CTA.
int gemm_allgather_grid(int n, int* grid, int* per_sm) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = allow_smem();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, gemm_allgather_kernel, NTHREADS,
                                                      GA_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return -1;
  const int per_rank = (*per_sm) * sms / n;
  *grid = per_rank * n;
  return per_rank < 1 ? -2 : 0;
}

// Cooperative launch: the runtime refuses a grid whose CTAs cannot all be
// resident at once, which the spin-waits require.
int gemm_allgather_launch(const GaParams* p, int grid, void* stream) {
  return launch(p, grid, 0, stream);
}

// The split phase alone (the same kernel, returning after the rank
// meeting), for the tests and chip_smoke.py's ga_core line: fills p->sa
// and p->sb; the flags and the output are not touched.
int gemm_allgather_split(const GaParams* p, int grid, void* stream) {
  return launch(p, grid, 1, stream);
}

const char* gemm_allgather_error(int code) {
  if (code == -1) return "device does not support cooperative launch";
  if (code == -2) return "fewer co-resident CTAs than ranks";
  if (code == -3) return "the driver has no cuTensorMapEncodeTiled";
  if (code == -4) return "cuTensorMapEncodeTiled refused a scratch layout";
  return cudaGetErrorString((cudaError_t)code);
}

int gemm_allgather_params_size() { return (int)sizeof(GaParams); }

int gemm_allgather_smem_bytes() { return GA_SMEM; }

}  // extern "C"
