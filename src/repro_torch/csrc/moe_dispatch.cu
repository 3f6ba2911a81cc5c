// Fused MoE dispatch -> expert SwiGLU FFN -> combine for Hopper (sm_90a).
//
// Replaces src/repro/kernels/moe_dispatch.py::_moe_kernel (the Pallas
// kernel behind moe_dispatch_combine_sharded). It computes the same
// function in f32: every rank stages its tokens into block_tokens-row
// microblocks per expert, stores each real microblock into the owning
// expert's receive slab in the (off, j) round order of DispatchSchedule
// (dummy rounds elided: a GPU has no lockstep rule), runs the expert
// SwiGLU FFN over what arrived, and returns the rows along the reverse
// permutation (combine). Completion is BARRIER / DEFERRED (wait every
// edge, then compute), SIGNAL pipelined (per source: wait, then that
// source's FFN) or COUNTER tile-fused (per microblock arrival, whole
// 64-row GEMM tiles whose epilogue stores straight into the source's
// combine slab and ticks the combine flag once for every combine_tile-row
// chunk it covers: combine_tile sets the flag granularity, never the GEMM
// tile). Options: an int8 wire with per-row f32 scales (max|x|/127 +
// 1e-12, round half to even), and a second stream that runs the
// shared-expert FFN (or any SwiGLU FFN over the rank's own Ts rows).
//
// Routing is a table of (source, expert) pairs: source s sends
// counts[s][e] rows to expert e, sorted into runs from offsets[s][e] of
// its T rows, in blocks[s][e] microblocks (a router's sizes differ by
// pair; the skew law gives every source the same row). Rows past a
// source's last run are routed nowhere and come back zero.
//
// Packed (tile-fused only): expert e's arrivals are one run, every
// source's rows back to back in arrival order (e, e + 1, ... mod n), cut
// into microblocks of B rows that may span sources; only the last is
// short, and its flag counts the padding, which no source sends. A pair
// table's tiles then cover ceil(rows / B) microblocks an expert, not one
// short microblock a source.
//
// Layout: the n ranks are partitions of ONE cooperative launch over one
// allocation (a symmetric heap on one card). A "remote copy" is a store
// into the receiving rank's slab. Each DMA semaphore becomes a flag word
// (flags.cuh): the sender's round retires from the send window (below)
// once its stores have landed, and its flag is added to then; the
// receiver spins on an acquire load.
// Dispatch flags are per (receiver, source, microblock) and count rows;
// combine flags are per (receiver, expert) and count elements. The wrapper
// splits the CTAs over the streams (each rank's routed stream, and its
// second stream) in proportion to their work and passes the prefix table
// (cta0). It zeroes every flag and counter before each launch on the
// launch stream, so a stale count never satisfies a wait. Every spin gives
// up after timeout_ms with a trap, so a protocol fault fails the launch
// instead of hanging.
//
// No barrier inside a stream. The SwiGLU intermediate H lives in a global
// scratch (64 rows x 2f f32 is far beyond shared memory) with rows of its
// own per segment; each GEMM1 unit bumps its segment's "H ready" counter,
// and a GEMM2 unit of the segment waits until the counter reaches the
// segment's GEMM1 unit count. The non-fused combine of a source waits the
// same way on that source's "out ready" counter. Deadlock freedom: the
// CTAs of a stream take their units (GEMM1, GEMM2 and combine work) round
// robin from ONE global order, each CTA in increasing order, and a unit
// only waits on dispatch flags (their stores wait on nothing) or on units
// of its own stream that come earlier in that order (all GEMM1 units of a
// segment precede its GEMM2 units, which precede its combine). Every CTA
// is resident (cooperative launch), so the earliest unfinished unit always
// has its inputs and its CTA at hand. The final assembly waits on other
// ranks' combine stores, which never wait on an assembly.
//
// The send window (window.cuh, mechanism (a): TMA bulk stores), as the
// reference windows its dispatch and combine rounds. A round is one CTA's
// share of a dispatch round (off, j) (its rows of the microblock; an int8
// row and its scale are one entry: the data goes by bulk store, the scale
// by the owner's plain store, landed by its fence at retirement), of a
// non-fused combine round (off, j), or one tile-fused GEMM2 tile (its
// combine store). A dispatch row is staged (and quantized) into a slot at
// the start of shared memory, which the GEMM ring does not use until the
// dispatch ends, then thread 0 sends it with one bulk store and the CTA
// stages the next row while it flies; a GEMM2 tile goes straight from the
// tile in shared memory, a row a bulk store, and the next tile's loads
// start once the stores have read it. At most `contexts` rounds a CTA are
// unretired. The dispatch window drains when the CTA's dispatch rounds
// end (marks dispatch_issued / dispatch_drained around it; the second
// stream's CTAs mark shared_ffn as they start, so the shared FFN runs
// while dispatch sends are in flight, as the reference's overlap slot);
// the combine window drains before the assembly. Deadlock: the dispatch
// drain waits only on the CTA's own stores, before any wait; a unit with
// combine rounds in flight waits only on dispatch flags (released at the
// senders' dispatch drains) and on units of its stream that come earlier
// in the global order, never on a combine flag, so the argument above
// stands. A row is at most 64 KB (d <= 16384 in f32).
//
// Counters (cta_stats.cuh): in the counting build (-DCUCO_STATS, one traced
// launch in 17 takes it) each CTA counts its cycles, those its thread 0
// spends waiting on flags and bulk groups, and those in tile products, and
// adds them to the `stats` accumulator by role: routed stream, second
// stream. The production build compiles no counter.
//
// GEMMs: tc_gemm.cuh's 64 x 128 tensor-core tile (3xTF32 mma.sync, f32
// accurate, cp.async ring). A unit is one tile; the units of one GEMM walk
// the m-tiles inside a column slab, so the CTAs that run together share
// one weight slab through L2 instead of each m-tile reading it from HBM.
//
// Bound: at serving width (4 ranks x 256 tokens, d=7168, f=fs=2048) the
// call does 180.4 GFLOP against ~1 GB of weights. 3xTF32 is three tensor
// products per multiply-add, so the operations bound it: 3 x 180.4 GFLOP
// at 495 TFLOP/s, 1.09 ms on an H100 SXM. chip_smoke.py's gemm_core line
// times the tile GEMM alone at this GEMM's shapes, which splits a
// variant's time between GEMM and dispatch / combine / waiting.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "cta_stats.cuh"
#include "flags.cuh"
#include "tc_gemm.cuh"
#include "window.cuh"

#define MOE_MAXN 8

using tc::BM;
using tc::BN;
using tc::NT;

struct MoeParams {
  int n, T, Ts, d, f, fs, B, b_max, stride, ct;
  // [source][expert]: rows, microblocks and the first row of each run
  int counts[MOE_MAXN][MOE_MAXN], blocks[MOE_MAXN][MOE_MAXN], offsets[MOE_MAXN][MOE_MAXN];
  int cta0[2 * MOE_MAXN + 1];  // stream 2r (rank r routed) / 2r+1 (its second stream):
                               // CTAs [cta0[s], cta0[s + 1])
  int barrier, pipelined, tile_fused, shared, wire_i8, timeout_ms;
  int contexts;        // the send window's depth: 1, 2 or 4
  int log_cap;         // events a CTA's probe log holds (-DCUCO_PROBE builds)
  int packed;          // expert e's arrivals packed into one run (tile-fused)
  const float *x, *w1, *w2, *xs, *s1, *s2;
  float *y, *ys;
  void* recv;          // (n, n*stride, d) float or int8: receive slabs
  float* recv_s;       // (n, n*stride) per-row scales of the int8 wire
  float* ffn_out;      // (n, n*stride, d) expert output (non-fused paths)
  float* comb;         // (n, n*stride, d) combine slabs
  float* h;            // (n, n*stride, f) SwiGLU intermediate
  float* hs;           // (n, Ts, fs) shared-expert SwiGLU intermediate
  unsigned* disp_flag; // (n recv, n src, b_max) rows landed
  unsigned* comb_flag; // (n recv, n expert) elements landed
  unsigned* h_ready;   // (n rank, n src, b_max) GEMM1 units done per segment
  unsigned* o_ready;   // (n rank, n src) GEMM2 units done per segment (non-fused)
  unsigned* hs_ready;  // (n) second-stream GEMM1 units done
  // one slot, so the struct keeps the size and layout the production build
  // was tuned at: no build takes both
  union {
    int* log;                   // -DCUCO_PROBE: (grid, log_cap, 4) window events
    unsigned long long* stats;  // -DCUCO_STATS: (2 roles: routed, second stream;
                                // cta_stats.cuh's buckets) cycle counters
  };                            // null in the production build (cta_log only
                                // offsets it, note compiles to nothing)
  int* log_n;          // (grid): events each CTA appended (-DCUCO_PROBE)
};

#define KNAME "moe_dispatch"

// a round: `amount` added to `flag` in ticks of `step` at its retirement
struct MoeRound {
  unsigned* flag;
  unsigned amount, step;
};
using MoeWindow = win::Window<MoeRound>;
constexpr unsigned MOE_SLOT = 64 * 1024;  // the send slot: the ring's first 64 KB

__device__ __forceinline__ void release_round(const MoeRound& r) {
  for (unsigned a = 0; a < r.amount; a += r.step) atomicAdd(r.flag, min(r.step, r.amount - a));
}

// packed: the first row of source s's run in expert e's arrivals
__device__ __forceinline__ int packed_start(const MoeParams& P, int s, int e) {
  int r = 0;
  for (int q = e; q != s; q = (q + 1) % P.n) r += P.counts[q][e];
  return r;
}

// packed: the rows of expert e's arrivals
__device__ __forceinline__ int packed_rows(const MoeParams& P, int e) {
  int r = 0;
  for (int s = 0; s < P.n; ++s) r += P.counts[s][e];
  return r;
}

// ------------------------------------------------------------ row staging

__device__ float block_max(float v) {
  __shared__ float red[NT / 32];
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < NT / 32; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

__device__ __forceinline__ signed char quant(float v, float s) {
  float r = rintf(v / s);  // round half to even, like jnp.round
  return (signed char)fminf(fmaxf(r, -127.f), 127.f);
}

// stage one token row onto the wire (src == nullptr: a zero padding row)
__device__ void stage_row(const float* src, float* dst, float*, int d) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < d / 4; i += NT)
    d4[i] = src ? __ldg(s4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ void stage_row(const float* src, int8_t* dst, float* scale, int d) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float m = 0.f;
  if (src)
    for (int i = threadIdx.x; i < d / 4; i += NT) {
      float4 v = __ldg(s4 + i);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  m = block_max(m);
  const float s = m / 127.0f + 1e-12f;
  char4* d4 = reinterpret_cast<char4*>(dst);
  for (int i = threadIdx.x; i < d / 4; i += NT) {
    char4 q = make_char4(0, 0, 0, 0);
    if (src) {
      float4 v = __ldg(s4 + i);
      q = make_char4(quant(v.x, s), quant(v.y, s), quant(v.z, s), quant(v.w, s));
    }
    d4[i] = q;
  }
  if (threadIdx.x == 0) *scale = s;
}

// -------------------------------------------------------------- work units

// A stream's CTAs take its units round robin from one global order: unit
// u belongs to CTA u % size. `next` is the index of the stream's next unit.
struct Stream {
  int me, gid, size, next;
  __device__ bool take() { return next++ % size == gid; }
};

// A run of rows one GEMM covers: slab rows [a_row0, a_row0 + rows), of
// which the first `valid` are tokens. GEMM1 writes H rows a_row0 + r and
// bumps h_ready; GEMM2 waits until h_ready reaches h_units, writes row r
// to out + r*N (zero for valid <= r < rows) and then bumps o_ready or, in
// the tile-fused path, ticks comb_flag per combine chunk. `src` >= 0: the
// GEMM1 units of a pipelined path wait for the microblocks (src, j0 + ...)
// their rows cover.
struct Seg {
  size_t a_row0;
  int rows, valid;
  float* out;
  unsigned* h_ready;
  unsigned h_units;
  unsigned* o_ready;
  unsigned* comb_flag;
  int src, j0;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

__device__ __forceinline__ int mtiles(int rows) { return (rows + BM - 1) / BM; }

// GEMM1 units of segments `segs`: F/64 H column slabs (each a paired
// 128-column B tile: 64 gate and 64 up columns) x the m-tiles, m-tiles
// inside a column slab.
template <typename AT>
__device__ void gemm1(const MoeParams& P, const AT* A, const float* S, const Seg* segs, int nseg,
                      int K, const float* W, int F, float* H, Stream& st, char* smem) {
  for (int c0 = 0; c0 < F; c0 += 64)
    for (int s = 0; s < nseg; ++s)
      for (int m0 = 0; m0 < segs[s].rows; m0 += BM) {
        if (!st.take()) continue;
        const Seg& sg = segs[s];
        if (sg.src >= 0) {  // pipelined: the microblocks this tile reads have landed
          const int j1 = sg.j0 + (min(m0 + BM, sg.rows) - 1) / P.B;
          for (int j = sg.j0 + m0 / P.B; j <= j1; ++j)
            stats::cta_wait(&P.disp_flag[((size_t)st.me * P.n + sg.src) * P.b_max + j],
                            (unsigned)P.B, P.timeout_ms, KNAME, "dispatch", sg.src, j);
        }
        // a combine tile's stores read smem
        if (threadIdx.x == 0) win::wait_read_all(stats::wait());
        stats::gemm([&] {
          tc::tile<AT, true>(tc::TileA{A, S, K, sg.a_row0 + m0, clampi(sg.valid - m0, 0, BM)},
                             tc::TileB{W, 2 * F, c0, F + c0, BN}, K, smem);
        });
        tc::store_swiglu(smem, H + (sg.a_row0 + m0) * F + c0, F, min(BM, sg.rows - m0));
        cta_signal(sg.h_ready, 1u);
      }
}

// GEMM2 units: ceil(N/128) output column slabs x the m-tiles, m-tiles
// inside a column slab; each waits for its segment's H.
template <bool PACKED = false>
__device__ void gemm2(const MoeParams& P, const float* H, const Seg* segs, int nseg, int K,
                      const float* W, int N, Stream& st, char* smem, MoeWindow* w = nullptr) {
  for (int c0 = 0; c0 < N; c0 += BN)
    for (int s = 0; s < nseg; ++s)
      for (int m0 = 0; m0 < segs[s].rows; m0 += BM) {
        if (!st.take()) continue;
        const Seg& sg = segs[s];
        stats::cta_wait(sg.h_ready, sg.h_units, P.timeout_ms, KNAME, "H ready", st.me, s);
        const int rows = min(BM, sg.rows - m0), valid = clampi(sg.valid - m0, 0, BM);
        const int ncols = min(BN, N - c0);
        // a combine tile's stores read smem
        if (threadIdx.x == 0) win::wait_read_all(stats::wait());
        stats::gemm([&] {
          tc::tile<float, true>(tc::TileA{H, nullptr, K, sg.a_row0 + m0, valid},
                                tc::TileB{W, N, c0, c0 + 64, ncols}, K, smem);
        });
        if (PACKED) {
          // the packed combine: the tile's token rows, a round for each
          // source they came from, sent into that source's slab
          float* C = reinterpret_cast<float*>(smem);
          win::fence_to_async();
          __syncthreads();
          if (threadIdx.x == 0) {
            const int p0 = sg.j0 * P.B + m0;  // the tile's first arrival row
            const int tile = (sg.j0 * ((N + BN - 1) / BN) + c0 / BN) * mtiles(sg.rows) + m0 / BM;
            for (int off = 0, a = 0; off < P.n && a < p0 + valid; ++off) {
              const int s = (st.me + off) % P.n, c = P.counts[s][st.me];
              const int lo = max(a, p0), hi = min(a + c, p0 + valid);
              if (lo < hi) {
                win::push(*w, MoeRound{&P.comb_flag[s * P.n + st.me], (unsigned)((hi - lo) * ncols),
                                       (unsigned)(P.ct * ncols)},
                          (s - st.me + P.n) % P.n, tile, release_round);
                float* out = P.comb + ((size_t)s * P.n * P.stride + (size_t)st.me * P.stride) * N;
                for (int r = lo; r < hi; ++r)
                  win::bulk_store(out + (size_t)(r - a) * N + c0, C + (r - p0) * tc::LDC, ncols * 4);
                win::commit_piece(*w);
              }
              a += c;
            }
          }
          continue;
        }
        if (sg.comb_flag) {
          // the tile-fused combine: round (off, tile) of the window, sent
          // from the tile in shared memory (padding rows zeroed first);
          // one tick per combine_tile chunk at its retirement
          float* C = reinterpret_cast<float*>(smem);
          for (int i = threadIdx.x; i < (rows - valid) * BN; i += NT)
            C[(valid + i / BN) * tc::LDC + i % BN] = 0.f;
          win::fence_to_async();
          __syncthreads();
          if (threadIdx.x == 0) {
            const int off = (sg.src - st.me + P.n) % P.n;
            const int tile = (sg.j0 * ((N + BN - 1) / BN) + c0 / BN) * mtiles(sg.rows) + m0 / BM;
            win::push(*w, MoeRound{sg.comb_flag, (unsigned)(rows * ncols), (unsigned)(P.ct * ncols)},
                      off, tile, release_round);
            for (int r = 0; r < rows; ++r)
              win::bulk_store(sg.out + (size_t)(m0 + r) * N + c0, C + r * tc::LDC, ncols * 4);
            win::commit_piece(*w);
          }
          continue;
        }
        tc::store_tile<true>(smem, sg.out + (size_t)m0 * N + c0, N, rows, ncols, valid);
        __syncthreads();
        if (threadIdx.x == 0 && sg.o_ready) {
          __threadfence();
          atomicAdd(sg.o_ready, 1u);
        }
      }
}

// ------------------------------------------------------------------ streams

// the second stream: ys = swiglu(xs, s1, s2) for this rank's tokens
__device__ void shared_stream(const MoeParams& P, Stream& st, char* smem) {
  if (threadIdx.x == 0)
    win::note(win::cta_log(P.log, P.log_n, P.log_cap), win::EV_MARK, win::MARK_SHARED_FFN, 0);
  const float* xs = P.xs + (size_t)st.me * P.Ts * P.d;
  float* hs = P.hs + (size_t)st.me * P.Ts * P.fs;
  const Seg sg{0, P.Ts, P.Ts, P.ys + (size_t)st.me * P.Ts * P.d, P.hs_ready + st.me,
               (unsigned)(P.fs / 64 * mtiles(P.Ts)), nullptr, nullptr, -1, 0};
  gemm1<float>(P, xs, nullptr, &sg, 1, P.d, P.s1, P.fs, hs, st, smem);
  gemm2(P, hs, &sg, 1, P.fs, P.s2, P.d, st, smem);
}

// The rows of a round of B this CTA takes (the stream's next B units, u
// % size == gid): i = first, first + size, ... below B. take_round moves
// the stream past them.
__device__ __forceinline__ int first_row(const Stream& st) {
  return ((st.gid - st.next) % st.size + st.size) % st.size;
}

__device__ __forceinline__ unsigned rows_of(const Stream& st, int B) {
  const int first = first_row(st);
  return first < B ? (unsigned)((B - 1 - first) / st.size + 1) : 0u;
}

// copy one f32 row written by other CTAs (the assembly)
__device__ void copy_row(const float* src, float* dst, int d) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < d / 4; i += NT) d4[i] = __ldcg(s4 + i);
}

// dispatch -> expert FFN -> combine -> assemble, for rank `me`
// PACKED: the tile-fused path on packed arrivals (its own instance, so
// the other paths compile as they did without it)
template <typename WT, bool PACKED>
__device__ void routed(const MoeParams& P, Stream& st, char* smem, MoeWindow& w) {
  const int n = P.n, B = P.B, d = P.d, f = P.f, stride = P.stride, bmax = P.b_max;
  const int me = st.me;
  const size_t slab = (size_t)n * stride;

  // ---- dispatch: rounds (off, j) of DispatchSchedule, dummies elided.
  // Rows of successive rounds go round robin over the stream; each CTA
  // stages (and quantizes) its rows into the slot and sends them, its
  // share of a round one window entry.
  for (int off = 0; off < n; ++off) {
    const int e = (me - off + n) % n;
    WT* dst = reinterpret_cast<WT*>(P.recv) + (size_t)e * slab * d;
    float* dsc = P.recv_s + (size_t)e * slab;
    if (PACKED) {
      // my run into e's arrivals from row p0, in chunks that end at e's
      // microblock edges: a round each; the chunk that ends e's rows also
      // lands the padding of its microblock
      const int c = P.counts[me][e], p0 = packed_start(P, me, e), R = packed_rows(P, e);
      for (int k0 = 0; k0 < c;) {
        const int J = (p0 + k0) / B, k1 = min(c, (J + 1) * B - p0), L = k1 - k0;
        const unsigned mine = rows_of(st, L);
        const unsigned pad = p0 + k1 == R && first_row(st) == 0 ? (unsigned)((J + 1) * B - R) : 0u;
        if (mine && threadIdx.x == 0)
          win::push(w, MoeRound{&P.disp_flag[(size_t)e * n * bmax + J], mine + pad, mine + pad},
                    off, J, release_round);
        for (int i = first_row(st); i < L; i += st.size) {
          const int k = k0 + i;
          const float* src = P.x + ((size_t)me * P.T + P.offsets[me][e] + k) * d;
          const size_t row = (size_t)p0 + k;
          if (threadIdx.x == 0) win::wait_read_all(stats::wait());  // the slot's last row was read
          __syncthreads();
          stage_row(src, reinterpret_cast<WT*>(smem), dsc + row, d);
          win::fence_to_async();
          __syncthreads();
          if (threadIdx.x == 0) {
            win::bulk_store(dst + row * d, smem, (unsigned)(d * sizeof(WT)));
            win::commit_piece(w);
          }
        }
        st.next += L;
        k0 = k1;
      }
      continue;
    }
    for (int j = 0; j < P.blocks[me][e]; ++j) {
      const unsigned mine = rows_of(st, B);
      if (mine && threadIdx.x == 0)
        win::push(w, MoeRound{&P.disp_flag[((size_t)e * n + me) * bmax + j], mine, mine}, off,
                  j, release_round);
      for (int i = first_row(st); i < B; i += st.size) {
        const int k = j * B + i;
        const float* src =
            k < P.counts[me][e] ? P.x + ((size_t)me * P.T + P.offsets[me][e] + k) * d : nullptr;
        const size_t row = (size_t)me * stride + k;
        if (threadIdx.x == 0) win::wait_read_all(stats::wait());  // the slot's last row was read
        __syncthreads();
        stage_row(src, reinterpret_cast<WT*>(smem), dsc + row, d);
        win::fence_to_async();
        __syncthreads();
        if (threadIdx.x == 0) {
          win::bulk_store(dst + row * d, smem, (unsigned)(d * sizeof(WT)));
          win::commit_piece(w);
        }
      }
      st.next += B;
    }
  }
  if (threadIdx.x == 0) {
    win::note(w.log, win::EV_MARK, win::MARK_DISPATCH_ISSUED, 0);
    win::drain(w, release_round, 0);
    win::note(w.log, win::EV_MARK, win::MARK_DISPATCH_DRAINED, 0);
  }

  // ---- expert FFN over the arrivals: source src's rows are its
  // blocks[src][me] microblocks, the first counts[src][me] of them tokens
  const WT* recv = reinterpret_cast<const WT*>(P.recv) + (size_t)me * slab * d;
  const float* rs = P.recv_s + (size_t)me * slab;
  const float* w1 = P.w1 + (size_t)me * d * 2 * f;
  const float* w2 = P.w2 + (size_t)me * f * d;
  float* h = P.h + (size_t)me * slab * f;
  float* ffo = P.ffn_out + (size_t)me * slab * d;
  unsigned* h_ready = P.h_ready + (size_t)me * n * bmax;
  unsigned* o_ready = P.o_ready + (size_t)me * n;
  const unsigned g1 = (unsigned)(f / 64);  // GEMM1 units per m-tile

  if (PACKED) {
    // COUNTER over the packed arrivals: microblock J of every source's
    // rows, GEMM1 then GEMM2; GEMM2's epilogue sends each source its rows
    const int R = packed_rows(P, me);
    for (int J = 0; J * B < R; ++J) {
      const Seg sg{(size_t)J * B, B, min(R - J * B, B), nullptr, &h_ready[J], g1 * mtiles(B),
                   nullptr, P.comb_flag, 0, J};
      gemm1<WT>(P, recv, rs, &sg, 1, d, w1, f, h, st, smem);
      gemm2<true>(P, h, &sg, 1, f, w2, d, st, smem, &w);
    }
  } else if (P.tile_fused) {
    // COUNTER: per microblock arrival, GEMM1 then GEMM2 of its 64-row
    // tiles; GEMM2's epilogue is the combine store into the source's slab
    for (int off = 0; off < n; ++off) {
      const int src = (me + off) % n;
      const int mb = P.blocks[src][me], cme = P.counts[src][me];
      for (int j = 0; j < mb; ++j) {
        const int rel = j * B;
        const Seg sg{(size_t)src * stride + rel, B, clampi(cme - rel, 0, B),
                     P.comb + ((size_t)src * slab + (size_t)me * stride + rel) * d,
                     &h_ready[src * bmax + j], g1 * mtiles(B), nullptr,
                     &P.comb_flag[src * n + me], src, j};
        gemm1<WT>(P, recv, rs, &sg, 1, d, w1, f, h, st, smem);
        gemm2(P, h, &sg, 1, f, w2, d, st, smem, &w);
      }
    }
  } else {
    const bool pipelined = !P.barrier && P.pipelined;
    const int cols = (d + BN - 1) / BN;  // GEMM2 units per m-tile
    unsigned all_units = 0, all_out = 0;  // GEMM1 / GEMM2 units of every source's rows
    for (int s = 0; s < n; ++s) {
      const int mt = mtiles(P.blocks[s][me] * B);
      all_units += g1 * mt;
      all_out += cols * mt;
    }
    Seg segs[MOE_MAXN];
    for (int s = 0; s < n; ++s) {
      const int src = (me + s) % n, rows = P.blocks[src][me] * B;
      // pipelined: a counter per source; otherwise one for the whole GEMM
      segs[s] = Seg{(size_t)src * stride, rows, min(P.counts[src][me], rows),
                    ffo + (size_t)src * stride * d,
                    pipelined ? &h_ready[src * bmax] : h_ready,
                    pipelined ? g1 * mtiles(rows) : all_units,
                    pipelined ? &o_ready[s] : o_ready, nullptr, pipelined ? src : -1, 0};
    }
    if (pipelined) {
      // SIGNAL pipelined: sources in arrival order, self edge first
      for (int s = 0; s < n; ++s) {
        gemm1<WT>(P, recv, rs, &segs[s], 1, d, w1, f, h, st, smem);
        gemm2(P, h, &segs[s], 1, f, w2, d, st, smem);
      }
    } else {
      // BARRIER / DEFERRED: every edge lands before any expert compute
      for (int s = 0; s < n; ++s)
        for (int j = 0; j < P.blocks[(me + s) % n][me]; ++j)
          stats::cta_wait(&P.disp_flag[((size_t)me * n + (me + s) % n) * bmax + j], (unsigned)B,
                          P.timeout_ms, KNAME, "dispatch", (me + s) % n, j);
      gemm1<WT>(P, recv, rs, segs, n, d, w1, f, h, st, smem);
      gemm2(P, h, segs, n, f, w2, d, st, smem);
    }
    // ---- combine: reverse shift, expert me -> source (me + off) % n, once
    // that source's expert rows are in ffn_out
    for (int off = 0; off < n; ++off) {
      const int q = (me + off) % n, mb = P.blocks[q][me];
      const unsigned o_units = pipelined ? (unsigned)(cols * mtiles(mb * B)) : all_out;
      for (int j = 0; j < mb; ++j) {
        const unsigned mine = rows_of(st, B);
        if (mine) {
          stats::cta_wait(segs[off].o_ready, o_units, P.timeout_ms, KNAME, "out ready", me, off);
          if (threadIdx.x == 0)
            win::push(w, MoeRound{&P.comb_flag[q * n + me], mine * d, mine * d}, off, j,
                      release_round);
        }
        for (int i = first_row(st); i < B; i += st.size) {
          const int k = j * B + i;
          win::ship<NT, 8>(w, smem, MOE_SLOT, ffo + ((size_t)q * stride + k) * d,
                           P.comb + ((size_t)q * slab + (size_t)me * stride + k) * d,
                           (size_t)d * 4, [] { __syncthreads(); });
        }
        st.next += B;
      }
    }
  }
  if (threadIdx.x == 0) win::drain(w, release_round, 1);

  // ---- assemble: region e of my combine slab holds my tokens for expert
  // e; rows past my last run were routed nowhere and come back zero
  for (int e = 0; e < n; ++e)
    stats::cta_wait(&P.comb_flag[me * n + e],
                    (unsigned)(PACKED ? P.counts[me][e] : P.blocks[me][e] * B) * d,
                    P.timeout_ms, KNAME, "combine", me, e);
  const float* comb = P.comb + (size_t)me * slab * d;
  const int routed_rows = P.offsets[me][n - 1] + P.counts[me][n - 1];
  for (int k = 0; k < P.T; ++k) {
    if (!st.take()) continue;
    float* dst = P.y + ((size_t)me * P.T + k) * d;
    if (k >= routed_rows) {
      stage_row(static_cast<const float*>(nullptr), dst, nullptr, d);
      continue;
    }
    int e = 0;
    while (e + 1 < n && k >= P.offsets[me][e + 1]) ++e;
    copy_row(comb + ((size_t)e * stride + k - P.offsets[me][e]) * d, dst, d);
  }
}

// Two CTAs per SM: the 3-stage ring takes 80 KB of shared memory a CTA and
// the launch bound holds ptxas at 128 registers a thread.
constexpr int MOE_SMEM = tc::SMEM + (int)sizeof(MoeWindow);

template <typename WT>
__global__ void __launch_bounds__(NT, 2) moe_kernel(MoeParams P) {
  extern __shared__ __align__(16) char smem[];
  int s = 0;
  while (s + 1 < 2 * P.n && (int)blockIdx.x >= P.cta0[s + 1]) ++s;
  if ((int)blockIdx.x >= P.cta0[2 * P.n]) return;
  if (threadIdx.x == 0) stats::open(s & 1);  // role: routed (0) or second stream (1)
  Stream st{s / 2, (int)blockIdx.x - P.cta0[s], P.cta0[s + 1] - P.cta0[s], 0};
  if (s & 1) {
    shared_stream(P, st, smem);
  } else {
    MoeWindow& w = *reinterpret_cast<MoeWindow*>(smem + tc::SMEM);
    if (threadIdx.x == 0)
      win::open(w, P.contexts, win::cta_log(P.log, P.log_n, P.log_cap), stats::wait());
    if (P.packed)
      routed<WT, true>(P, st, smem, w);
    else
      routed<WT, false>(P, st, smem, w);
  }
  if (threadIdx.x == 0) stats::close(P.stats);
}

// The tile GEMM alone, one CTA a tile (m-tiles inside a column slab), for
// the tests and chip_smoke.py's gemm_core line: C = A B, or with `swiglu`
// C = silu(A B[:, :N/2]) * (A B[:, N/2:]), C (M, N/2).
template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
    gemm_core_kernel(const float* A, const float* Bw, float* C, int M, int K, int N, int swiglu) {
  extern __shared__ __align__(16) char smem[];
  const int mt = (M + BM - 1) / BM;
  const int m0 = (blockIdx.x % mt) * BM;
  const int rows = min(BM, M - m0);
  if (swiglu) {
    const int F = N / 2, c0 = (blockIdx.x / mt) * 64;
    tc::tile<float, VEC>(tc::TileA{A, nullptr, K, (size_t)m0, rows},
                         tc::TileB{Bw, N, c0, F + c0, BN}, K, smem);
    tc::store_swiglu(smem, C + (size_t)m0 * F + c0, F, rows);
  } else {
    const int c0 = (blockIdx.x / mt) * BN, ncols = min(BN, N - c0);
    tc::tile<float, VEC>(tc::TileA{A, nullptr, K, (size_t)m0, rows},
                         tc::TileB{Bw, N, c0, c0 + 64, ncols}, K, smem);
    tc::store_tile<VEC>(smem, C + (size_t)m0 * N + c0, N, rows, ncols, rows);
  }
}

// ------------------------------------------------------------ C interface

static const void* kernel_for(int wire_i8) {
  return wire_i8 ? (const void*)moe_kernel<int8_t> : (const void*)moe_kernel<float>;
}

// the ring's shared memory is above the 48 KB default: opt in before the
// occupancy query and the launch
static cudaError_t allow_smem(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

extern "C" {

// Largest co-resident grid: (CTAs per SM) x SMs. Returns a cudaError_t,
// or -1 without cooperative launch, or -2 when the grid cannot give every
// rank one routed CTA (and one second-stream CTA when `shared`).
int moe_dispatch_grid(int n, int shared, int wire_i8, int* grid, int* per_sm) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = allow_smem(kernel_for(wire_i8), MOE_SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel_for(wire_i8), NT, MOE_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return -1;
  *grid = (*per_sm) * sms;
  return *grid < n * (shared ? 2 : 1) ? -2 : 0;
}

// Cooperative launch: the runtime refuses a grid whose CTAs cannot all be
// resident at once, which the spin-waits require.
int moe_dispatch_launch(const MoeParams* p, int grid, void* stream) {
  void* args[] = {const_cast<MoeParams*>(p)};
  cudaError_t e = allow_smem(kernel_for(p->wire_i8), MOE_SMEM);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel_for(p->wire_i8), dim3(grid), dim3(NT), args,
                                    MOE_SMEM, (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

// The tile GEMM alone (see gemm_core_kernel): `vec` when K and N are
// multiples of 4 and the bases 16-byte aligned; `swiglu` wants N/2 a
// multiple of 64.
int moe_dispatch_gemm(const float* a, const float* b, float* c, int M, int K, int N, int swiglu,
                      int vec, void* stream) {
  const void* kernel = vec ? (const void*)gemm_core_kernel<true> : (const void*)gemm_core_kernel<false>;
  cudaError_t e = allow_smem(kernel, tc::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int mt = (M + BM - 1) / BM, nt = swiglu ? N / 2 / 64 : (N + BN - 1) / BN;
  if (vec)
    gemm_core_kernel<true><<<mt * nt, NT, tc::SMEM, (cudaStream_t)stream>>>(a, b, c, M, K, N, swiglu);
  else
    gemm_core_kernel<false><<<mt * nt, NT, tc::SMEM, (cudaStream_t)stream>>>(a, b, c, M, K, N, swiglu);
  return (int)cudaGetLastError();
}

const char* moe_dispatch_error(int code) {
  if (code == -1) return "device does not support cooperative launch";
  if (code == -2) return "too few co-resident CTAs for the ranks";
  return cudaGetErrorString((cudaError_t)code);
}

int moe_dispatch_params_size() { return (int)sizeof(MoeParams); }

}  // extern "C"
