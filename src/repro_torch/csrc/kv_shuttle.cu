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
// slab (the send), and the chunk's flag is ticked when that round
// retires from the send window (below). A kv_chunk x dk chunk spans several tiles
// written by several CTAs, so its flag completes only after every
// contributing CTA's release. The decode rank waits with acquire loads:
//   fused + COUNTER  per chunk, K then V (32 chunks in flight at a time);
//   fused (SIGNAL)   every K chunk, then every V chunk;
//   whole tensor     K once, then V once.
// Work units (whole tiles, or row copies in `pure` mode) go round robin
// over the prefill CTAs in the round order. Fused is chunk-major: a row
// group (kv_chunk rows when that is a multiple of the tile height, else
// one m-tile) issues its K tiles, then its V tiles, so chunk c is complete no
// later than chunk c + 1; otherwise every K tile precedes every V tile.
// Chained and sequential differ only in when V may start: sequential
// CTAs wait until all of K has landed (the drain before the V GEMM),
// chained ones go straight on.
//
// The send window (window.cuh, mechanism (a): TMA bulk stores). A round is
// one work unit of one prefill CTA: a GEMM tile, or a row copy in `pure`
// mode. The GEMM tile already sits in shared memory after its products
// (wg_tile.cuh's dedicated result tile), so thread 0 sends it row by row
// with bulk stores and the CTA starts the next tile's loads at once (the
// stores have only to have read the tile, not landed); a row copy goes
// through a 32 KB slot (loads through registers, then bulk stores). At most
// `contexts` units a CTA are unretired; retiring one waits for its bulk
// groups, fences, then ticks the flags of the chunks it covers. The window
// drains before a sequential CTA's K drain (its own K units must be
// released before it waits for all of K) and at the end. The decode rank
// waits on nothing the prefill CTAs hold, so no wait cycle forms.
// Unaligned projections (tc_gemm.cuh's core) and cache rows that are not
// 16-byte multiples keep plain stores and only defer the flag.
//
// Counters (cta_stats.cuh): in the counting build (-DCUCO_STATS, one traced
// launch in 17 takes it) each CTA counts its cycles, those its thread 0
// spends waiting on flags and bulk groups (the decode warp: its receive
// waits) and those in tile products, and adds them to the `stats`
// accumulator by role: prefill, decode. The production build compiles no
// counter.
//
// The decode rank computes nothing, so it gets one CTA (one warp of it
// waits, 32 chunks at a time) and the prefill partition every other
// co-resident CTA (131 and 1 on an H100 under the wgmma core). The
// wrapper zeroes the flags on the launch stream before every launch, so a
// stale flag never satisfies a wait. Every spin gives up after timeout_ms
// with a trap.
//
// GEMM variants, on one of two tile cores, chosen by what the inputs
// allow. Aligned inputs (d and dk multiples of 4, 16-byte bases: what TMA
// needs) take wg_tile.cuh's 128 x 128 Hopper core (3xTF32 `wgmma`, the
// weight from registers, x by TMA; one CTA an SM of a warp-specialised
// kernel, its own overload of kv_shuttle_kernel); the others keep
// tc_gemm.cuh's 64 x 128 tile (3xTF32 mma.sync, cp.async ring, two CTAs an
// SM: kv_shuttle_kernel<false>). A unit is one whole tile (half, m-tile,
// column tile) whatever kv_chunk is; its epilogue ticks the (half, chunk)
// flag of every chunk it overlaps by the elements it wrote there, so
// kv_chunk sets only the flag granularity, and a fused row group follows
// the core's tile height. The units walk the column tiles inside an
// m-tile: x (T x d, 64 MB at the workload's width) is the operand beyond
// L2, so CTAs that run together share its rows while both weights (8 MB
// each) stay in L2.
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

#include "cta_stats.cuh"
#include "flags.cuh"
#include "tc_gemm.cuh"
#include "tma_map.cuh"
#include "wg_tile.cuh"
#include "window.cuh"

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
  int vec;          // 16-byte aligned rows and bases: the wgmma core, bulk stores
  int esize;        // pure mode: bytes per element
  int unit_rows;    // pure mode: rows per copy unit
  int timeout_ms;
  int contexts;     // the send window's depth: 1, 2 or 4
  int log_cap;      // events a CTA's probe log holds (-DCUCO_PROBE builds)
  const void* x;    // x[0] (rows, d) f32, or [K; V] (2*rows, w) in pure mode
  const float* wk;  // (d, dk)
  const float* wv;  // (d, dk)
  void* ko;         // the decode rank's K slab (rows, dk)
  void* vo;         // the decode rank's V slab (rows, dk)
  unsigned* flag;   // (2, nchunks): elements landed per (half, chunk)
  // one slot, so the struct keeps the size and layout the production build
  // was tuned at (a field more moved its spills): no build takes both
  union {
    int* log;                   // -DCUCO_PROBE: (grid, log_cap, 4) window events
    unsigned long long* stats;  // -DCUCO_STATS: (2 roles: prefill, decode;
                                // cta_stats.cuh's buckets) cycle counters
  };                            // null in the production build (cta_log only
                                // offsets it, note compiles to nothing)
  int* log_n;       // (grid): events each CTA appended (-DCUCO_PROBE)
};

// a round: rows [row0, row0 + nrows) x ncols of one half, whose release
// ticks the flag of every chunk they overlap by the elements there
struct KvRound {
  unsigned* flag;  // the half's flags
  int row0, nrows, ncols;
};
using KvWindow = win::Window<KvRound>;
constexpr int KV_SLOT = 32 * 1024;  // pure mode's send slot

__device__ __forceinline__ void release_round(const ShuttleParams& P, const KvRound& r) {
  for (int c = r.row0 / P.chunk_rows; c <= (r.row0 + r.nrows - 1) / P.chunk_rows; ++c) {
    const int lo = max(r.row0, c * P.chunk_rows);
    const int hi = min(r.row0 + r.nrows, (c + 1) * P.chunk_rows);
    atomicAdd(r.flag + c, (unsigned)((hi - lo) * r.ncols));
  }
}

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

// pure mode: one unit copies unit_rows rows of one (half, chunk): round
// (half, unit u) of the window
__device__ void copy_unit(const ShuttleParams& P, KvWindow& w, char* slot, int half, int chunk,
                          int sub, int u) {
  const int r0 = sub * P.unit_rows;
  const int nrows = min(P.unit_rows, P.chunk_rows - r0);
  const size_t row = (size_t)chunk * P.chunk_rows + r0;
  const size_t rb = (size_t)P.dk * P.esize;
  const char* src = reinterpret_cast<const char*>(P.x) + ((size_t)half * P.rows + row) * rb;
  char* dst = reinterpret_cast<char*>(half ? P.vo : P.ko) + row * rb;
  auto release = [&](const KvRound& r) { release_round(P, r); };
  if (threadIdx.x == 0)
    win::push(w, KvRound{P.flag + (size_t)half * P.nchunks, (int)row, nrows, P.dk}, half, u,
              release);
  if (P.vec) {
    win::ship<NT, 8>(w, slot, KV_SLOT, src, dst, nrows * rb, [] { __syncthreads(); });
  } else {  // plain stores; the flag waits for the round's retirement
    copy_bytes(src, dst, nrows * rb, 0);
    __syncthreads();
  }
}

// The GEMM units' round order over tiles of bm rows and BN = 128 columns
// (both cores): a row group of tpg m-tiles issues its K tiles, then its V
// tiles; unfused, the group is the whole tensor
struct Units {
  int ctn, tpg, total;
  __device__ __forceinline__ Units(const ShuttleParams& P, int bm) {
    const int rt = (P.rows + bm - 1) / bm;
    ctn = (P.dk + BN - 1) / BN;
    tpg = !P.fused ? rt : (P.chunk_rows % bm == 0 ? P.chunk_rows / bm : 1);
    total = 2 * rt * ctn;
  }
  __device__ __forceinline__ void at(int u, int& half, int& mt, int& ct) const {
    const int per_group = 2 * tpg * ctn;
    const int group = u / per_group, rem = u % per_group;
    half = rem / (tpg * ctn);
    const int sub = rem % (tpg * ctn);
    mt = group * tpg + sub / ctn;
    ct = sub % ctn;
  }
};

// one GEMM unit on tc_gemm.cuh's core (unaligned inputs): the whole tile
// (m-tile mt, column tile ct) of one half, round (half, unit u) of the
// window, in plain stores; the flag waits for the round's retirement
__device__ void gemm_unit(const ShuttleParams& P, KvWindow& w, int half, int mt, int ct, int u,
                          char* smem) {
  const int row0 = mt * BM, col0 = ct * BN;
  const int nrows = min(BM, P.rows - row0), ncols = min(BN, P.dk - col0);
  stats::gemm([&] {
    tc::tile<float, false>(tc::TileA{P.x, nullptr, P.d, (size_t)row0, nrows},
                           tc::TileB{half ? P.wv : P.wk, P.dk, col0, col0 + 64, ncols}, P.d,
                           smem);
  });
  float* out = reinterpret_cast<float*>(half ? P.vo : P.ko) + (size_t)row0 * P.dk + col0;
  if (threadIdx.x == 0)
    win::push(w, KvRound{P.flag + (size_t)half * P.nchunks, row0, nrows, ncols}, half, u,
              [&](const KvRound& r) { release_round(P, r); });
  tc::store_tile<false>(smem, out, P.dk, nrows, ncols, nrows);
  __syncthreads();
}

// sequential: K's send drains before the V GEMM starts (this CTA's own
// window first: the wait covers its K units too)
__device__ void drain_k(const ShuttleParams& P, KvWindow& w) {
  if (threadIdx.x == 0) win::drain(w, [&](const KvRound& r) { release_round(P, r); }, 0);
  stats::cta_wait(P.flag, (unsigned)P.chunk_rows * P.dk, P.timeout_ms, "kv_shuttle", "K drain",
                  0, 0);
}

__device__ void prefill_copy(const ShuttleParams& P, KvWindow& w, char* slot, int pid, int npre) {
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
      drain_k(P, w);
      drained = true;
    }
    copy_unit(P, w, slot, half, chunk, sub, u);
  }
}

__device__ void prefill_gemm(const ShuttleParams& P, KvWindow& w, int pid, int npre, char* smem) {
  const Units un(P, BM);
  bool drained = false;
  for (int u = pid; u < un.total; u += npre) {
    int half, mt, ct;
    un.at(u, half, mt, ct);
    if (half == 1 && !P.fused && !P.chained && !drained) {
      drain_k(P, w);
      drained = true;
    }
    gemm_unit(P, w, half, mt, ct, u, smem);
  }
}

// one warp; lane i waits on chunk c0 + i, 32 chunks at a time: the loads
// of a 32-chunk window are in flight together, where one thread walking
// the flags would pay an L2 round trip per chunk after the last arrival
// Each chunk's K / V pair is one receive in the probe log. The warp's
// waits (cta_stats.cuh) are lane 0's cycles from a 32-chunk window's first
// load to the warp's join after its last arrival. INLINE: flags.cuh's
// inline spins, for the kernel that runs wgmma (it must call no function).
template <bool INLINE>
__device__ __forceinline__ void decode_body(const ShuttleParams& P) {
  if (threadIdx.x >= 32) return;
  const win::Log lg = win::cta_log(P.log, P.log_n, P.log_cap);
  const int lane = threadIdx.x;
  const unsigned per = (unsigned)P.chunk_rows * P.dk;
  const unsigned* kf = P.flag;
  const unsigned* vf = P.flag + P.nchunks;
  for (int pass = 0; pass < (P.fused && P.counter ? 1 : 2); ++pass) {
    for (int c0 = 0; c0 < P.nchunks; c0 += 32) {
      if (lane == 0) stats::mark();
      const int c = c0 + lane;
      if (c < P.nchunks) {
        if (P.fused && P.counter) {  // COUNTER: per chunk, K then V
          if constexpr (INLINE) {
            spin_geq_inline(kf + c, per, P.timeout_ms);
            spin_geq_inline(vf + c, per, P.timeout_ms);
          } else {
            spin_geq(kf + c, per, P.timeout_ms, "kv_shuttle", "K chunk", 0, c);
            spin_geq(vf + c, per, P.timeout_ms, "kv_shuttle", "V chunk", 1, c);
          }
          win::note(lg, win::EV_RECV, 0, c);
        } else {  // every K chunk, then every V chunk (one chunk unfused)
          if constexpr (INLINE)
            spin_geq_inline((pass ? vf : kf) + c, per, P.timeout_ms);
          else
            spin_geq((pass ? vf : kf) + c, per, P.timeout_ms, "kv_shuttle", pass ? "V" : "K",
                     pass, c);
          if (pass) win::note(lg, win::EV_RECV, 0, c);
        }
      }
      __syncwarp();
      if (lane == 0) stats::add_wait();
    }
  }
  __threadfence();
}

__device__ void decode(const ShuttleParams& P) { decode_body<false>(P); }

// PURE: the row copies (the engine's cache handoff), four CTAs per SM
// (64 registers). Otherwise the projections of unaligned inputs on
// tc_gemm.cuh's core, two CTAs per SM: the 3-stage ring takes 80 KB of
// shared memory a CTA, and the launch bound holds ptxas at 128 registers.
template <bool PURE>
__host__ __device__ constexpr int smem_of() {
  return (PURE ? KV_SLOT : tc::SMEM) + (int)sizeof(KvWindow);
}

template <bool PURE>
__global__ void __launch_bounds__(NT, PURE ? 4 : 2) kv_shuttle_kernel(ShuttleParams P) {
  extern __shared__ __align__(16) char smem[];
  const int npre = gridDim.x - 1;  // the last CTA is the decode rank
  if (threadIdx.x == 0) stats::open((int)blockIdx.x >= npre);  // role: prefill (0) or decode (1)
  if ((int)blockIdx.x >= npre) {
    decode(P);
    if (threadIdx.x == 0) stats::close(P.stats);
    return;
  }
  KvWindow& w = *reinterpret_cast<KvWindow*>(smem + smem_of<PURE>() - sizeof(KvWindow));
  if (threadIdx.x == 0)
    win::open(w, P.contexts, win::cta_log(P.log, P.log_n, P.log_cap), stats::wait());
  if constexpr (PURE)
    prefill_copy(P, w, smem, blockIdx.x, npre);
  else
    prefill_gemm(P, w, blockIdx.x, npre, smem);
  if (threadIdx.x == 0) win::drain(w, [&](const KvRound& r) { release_round(P, r); }, 1);
  if (threadIdx.x == 0) stats::close(P.stats);
}

// ------------------------------------------------------------ the wgmma core

// wg_tile.cuh's ring, its result tile, then the window
constexpr int WG_SMEM = wt::SMEM + (int)sizeof(KvWindow);

// sequential, on the wgmma core: drain_k for the consumers, inline
__device__ __forceinline__ void drain_k_wg(const ShuttleParams& P, KvWindow& w) {
  if (threadIdx.x == 0) {
    win::drain(w, [&](const KvRound& r) { release_round(P, r); }, 0);
    const unsigned want = (unsigned)P.chunk_rows * P.dk;
    if (ld_acquire(P.flag) < want) {
      stats::mark();
      spin_geq_inline(P.flag, want, P.timeout_ms);
      stats::add_wait();
    }
    __threadfence();
  }
  group_sync(wt::CONS_BAR, wt::NCONS);
}

// One GEMM unit on the wgmma core (the consumers): the tile's products,
// then its result tile, sent as round (half, unit u) of the window by
// thread 0's bulk stores, a row each. ALONE (the core alone): plain
// stores, no window.
template <bool ALONE>
__device__ __forceinline__ void wg_unit(const ShuttleParams& P, KvWindow& w, wt::Ring& r,
                                        float* C, int half, int mt, int ct, int u, int nk) {
  const int row0 = mt * wt::BM, col0 = ct * wt::BN;
  const int nrows = min(wt::BM, P.rows - row0), ncols = min(wt::BN, P.dk - col0);
  float* out = reinterpret_cast<float*>(half ? P.vo : P.ko) + (size_t)row0 * P.dk + col0;
  float acc[64];
  stats::gemm([&] { wt::consume_tile(r, nk, acc, P.timeout_ms); });
  // the last tile's stores have read C
  if (!ALONE && threadIdx.x == 0) win::wait_read_all(stats::wait());
  group_sync(wt::CONS_BAR, wt::NCONS);
  stats::gemm([&] { wt::store_result(C, acc); });
  if (!ALONE) win::fence_to_async();  // the tile's rows, written by every consumer
  group_sync(wt::CONS_BAR, wt::NCONS);
  if (ALONE) {
    for (int i = threadIdx.x; i < nrows * (wt::BN / 4); i += wt::NCONS) {
      const int rr = i / (wt::BN / 4), c = (i % (wt::BN / 4)) * 4;
      if (c < ncols)
        *reinterpret_cast<float4*>(out + (size_t)rr * P.dk + c) =
            *reinterpret_cast<const float4*>(C + rr * wt::LDC + c);
    }
  } else if (threadIdx.x == 0) {
    win::push(w, KvRound{P.flag + (size_t)half * P.nchunks, row0, nrows, ncols}, half, u,
              [&](const KvRound& rd) { release_round(P, rd); });
    for (int rr = 0; rr < nrows; ++rr)
      win::bulk_store(out + (size_t)rr * P.dk, C + rr * wt::LDC, ncols * 4);
    win::commit_piece(w);
  }
}

// The prefill CTAs on the wgmma core: the loader warpgroup streams every
// unit's stages (warp 8's lane 0 by TMA, warps 9-11 split them); the
// consumers run each unit's products and epilogue, in the round order.
template <bool ALONE>
__device__ __forceinline__ void prefill_wg(const ShuttleParams& P, const CUtensorMap* tx,
                                           const CUtensorMap* twk, const CUtensorMap* twv,
                                           int pid, int npre, char* smem) {
  wt::Ring ring = wt::make_ring(smem);
  KvWindow& w = *reinterpret_cast<KvWindow*>(wt::tail(ring));
  if (!ALONE && threadIdx.x == 0)
    win::open(w, P.contexts, win::cta_log(P.log, P.log_n, P.log_cap), stats::wait());
  __syncthreads();  // the barriers are initialised
  const Units un(P, wt::BM);
  const int nk = (P.d + wt::BK - 1) / wt::BK;
  if (threadIdx.x >= wt::NCONS) {  // the loader warpgroup
    wt::reg_dealloc<wt::REG_LOAD>();
    if (threadIdx.x == wt::NCONS) {
      for (int u = pid; u < un.total; u += npre) {
        int half, mt, ct;
        un.at(u, half, mt, ct);
        wt::produce_tile(ring, tx, half ? twv : twk, mt * wt::BM, ct * wt::BN,
                         min(wt::BN, P.dk - ct * wt::BN), nk, P.timeout_ms);
      }
    } else if (threadIdx.x >= wt::NTHREADS - wt::NCONV) {
      const int mine = pid < un.total ? (un.total - pid + npre - 1) / npre : 0;
      wt::convert_unit<false>(ring, mine * nk, wt::BM, nullptr, 0, P.timeout_ms);
    }
    return;
  }
  wt::reg_alloc<wt::REG_CONS>();
  float* C = wt::result_tile(ring);
  bool drained = false;
  for (int u = pid; u < un.total; u += npre) {
    int half, mt, ct;
    un.at(u, half, mt, ct);
    if (!ALONE && half == 1 && !P.fused && !P.chained && !drained) {
      drain_k_wg(P, w);
      drained = true;
    }
    wg_unit<ALONE>(P, w, ring, C, half, mt, ct, u, nk);
  }
  if (!ALONE && threadIdx.x == 0)
    win::drain(w, [&](const KvRound& r) { release_round(P, r); }, 1);
}

// The projections of aligned inputs (d and dk multiples of 4, 16-byte
// bases) on the wgmma core: one CTA an SM (wg_tile.cuh), the last the
// decode rank. tx maps x[0] (d, rows), twk / twv the weights (dk, d).
__global__ void __launch_bounds__(wt::NTHREADS, 1)
    kv_shuttle_kernel(const ShuttleParams P, const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap twk,
                      const __grid_constant__ CUtensorMap twv) {
  extern __shared__ __align__(16) char wsmem[];
  const int npre = gridDim.x - 1;  // the last CTA is the decode rank
  if (threadIdx.x == 0) stats::open((int)blockIdx.x >= npre);
  if ((int)blockIdx.x >= npre) {
    decode_body<true>(P);
    if (threadIdx.x == 0) stats::close(P.stats);
    return;
  }
  prefill_wg<false>(P, &tx, &twk, &twv, blockIdx.x, npre, wsmem);
  if (threadIdx.x == 0) stats::close(P.stats);
}

// The wgmma core alone (kv_shuttle_gemm): K and V of the chained units,
// every CTA a prefill CTA, no flags
__global__ void __launch_bounds__(wt::NTHREADS, 1)
    kv_gemm_kernel(const ShuttleParams P, const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap twk,
                   const __grid_constant__ CUtensorMap twv) {
  extern __shared__ __align__(16) char wsmem[];
  prefill_wg<true>(P, &tx, &twk, &twv, blockIdx.x, gridDim.x, wsmem);
}

// ------------------------------------------------------------ C interface

// the three kernels, by core (kernels/kv_shuttle.py::CORE_IDS)
enum : int { CORE_WGMMA = 0, CORE_COPY = 1, CORE_MMA = 2 };
using WgKernel = void (*)(ShuttleParams, CUtensorMap, CUtensorMap, CUtensorMap);

static const void* kernel_for(int core) {
  if (core == CORE_WGMMA) return (const void*)static_cast<WgKernel>(kv_shuttle_kernel);
  return core == CORE_COPY ? (const void*)kv_shuttle_kernel<true>
                           : (const void*)kv_shuttle_kernel<false>;
}

static int smem_for(int core) {
  return core == CORE_WGMMA ? WG_SMEM : core == CORE_COPY ? smem_of<true>() : smem_of<false>();
}

static int threads_for(int core) { return core == CORE_WGMMA ? wt::NTHREADS : NT; }

static int core_of(const ShuttleParams* p) {
  return p->pure ? CORE_COPY : p->vec ? CORE_WGMMA : CORE_MMA;
}

// every kernel's shared memory is above the 48 KB default: opt in before
// the occupancy query and the launch
static cudaError_t allow_smem(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the wgmma core's maps: x[0] (rows, d) in 128 x 32 boxes, each weight
// (d, dk) in 32 x 32 boxes
static int encode_maps(const ShuttleParams* p, CUtensorMap (&m)[3]) {
  int rc = tma::encode(&m[0], p->x, p->d, p->rows, wt::BM);
  if (rc == 0) rc = tma::encode(&m[1], p->wk, p->dk, p->d, wt::BK);
  if (rc == 0) rc = tma::encode(&m[2], p->wv, p->dk, p->d, wt::BK);
  return rc;
}

static int launch(const void* kernel, int core, int smem, bool coop, const ShuttleParams* p,
                  int grid, void* stream) {
  CUtensorMap maps[3];
  if (core == CORE_WGMMA) {
    const int rc = encode_maps(p, maps);
    if (rc != 0) return rc;
  }
  // the kernels with fewer parameters read only the first
  void* args[] = {const_cast<ShuttleParams*>(p), &maps[0], &maps[1], &maps[2]};
  const dim3 threads(threads_for(core));
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = coop ? cudaLaunchCooperativeKernel(kernel, dim3(grid), threads, args, smem,
                                           (cudaStream_t)stream)
             : cudaLaunchKernel(kernel, dim3(grid), threads, args, smem, (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

extern "C" {

// Largest co-resident grid of a core's kernel (CORE_WGMMA: the aligned
// projections; CORE_COPY: pure mode; CORE_MMA: unaligned projections):
// (CTAs per SM) x SMs. Returns a cudaError_t, or -1 without cooperative
// launch, or -2 when fewer than two CTAs fit.
int kv_shuttle_grid(int core, int* grid, int* per_sm) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = allow_smem(kernel_for(core), smem_for(core));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel_for(core), threads_for(core),
                                                      smem_for(core));
  if (e != cudaSuccess) return (int)e;
  if (!coop) return -1;
  *grid = (*per_sm) * sms;
  return *grid < 2 ? -2 : 0;
}

// Cooperative launch of the kernel of p's core (pure; else vec: wgmma):
// the runtime refuses a grid whose CTAs cannot all be resident at once,
// which the spin-waits require.
int kv_shuttle_launch(const ShuttleParams* p, int grid, void* stream) {
  const int core = core_of(p);
  return launch(kernel_for(core), core, smem_for(core), true, p, grid, stream);
}

// The wgmma core alone, for the tests and chip_smoke.py's gemm_core line:
// p->ko = x wk and p->vo = x wv (x (rows, d); aligned as the core needs),
// `grid` CTAs of one an SM; no flag, no window, no decode CTA.
int kv_shuttle_gemm(const ShuttleParams* p, int grid, void* stream) {
  return launch((const void*)kv_gemm_kernel, CORE_WGMMA, WG_SMEM, false, p, grid, stream);
}

const char* kv_shuttle_error(int code) {
  if (code == -1) return "device does not support cooperative launch";
  if (code == -2) return "fewer than two co-resident CTAs";
  if (code == -3) return "the driver has no cuTensorMapEncodeTiled";
  if (code == -4) return "cuTensorMapEncodeTiled refused an operand's layout";
  return cudaGetErrorString((cudaError_t)code);
}

int kv_shuttle_params_size() { return (int)sizeof(ShuttleParams); }

}  // extern "C"
