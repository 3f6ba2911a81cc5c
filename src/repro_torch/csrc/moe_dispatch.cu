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
// GEMM tiles of its rows whose epilogue stores straight into the source's
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
// scratch (a tile's rows x 2f f32 is far beyond shared memory) with rows
// of its own per segment; each GEMM1 unit bumps its segment's "H ready"
// counter, and a GEMM2 unit of the segment waits until the counter reaches
// the segment's GEMM1 unit count. The non-fused combine of a source waits the
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
// the start of the GEMM ring, which loads nothing until the dispatch
// drains, then thread 0 sends it with one bulk store and the CTA stages
// the next row while it flies; a GEMM2 tile goes straight from the result
// tile in shared memory, a row a bulk store, while the next tile's loads
// go on, and the next result waits until the stores have read the tile.
// The non-fused combine ships rows through the same slot once the CTA's
// last unit is done. At most `contexts` rounds a CTA are
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
// launch in 17 takes it) each CTA counts its cycles, those its thread 0 (a
// consumer, the window's owner) spends waiting (flags, bulk groups, and
// each unit's first stage: the loads the producer could not issue ahead,
// its flag waits among them) and those in its units' product loops (gemm),
// and adds them to the `stats` accumulator by role: routed stream, second
// stream. The production build compiles no counter.
//
// GEMMs: wg_tile.cuh's Hopper core (3xTF32 wgmma, f32 accurate, 64-deep
// partial sums added on the f32 cores; the weight gathered into registers
// as wgmma's A, the token rows by TMA as its B). A CTA is warp-specialised,
// one an SM: all 384 threads stage the dispatch; then the loader warpgroup
// (warp 8's lane 0 the producer, warps 9-11 the converters) streams every
// GEMM unit of the CTA's share, and the two consumer warpgroups run each
// unit's products and epilogue, then the combine and the assembly. A unit
// is one tile of 64 or 128 token rows x 128 columns (GEMM1: 64 gate and 64
// up columns, one warpgroup each, paired for SwiGLU through the result tile
// in shared memory). A segment is cut into tiles of 128 rows, and a tile
// with at most 64 rows left takes 64 (m64n64k8): a 64-row microblock of
// the tile-fused and packed paths is one 64-row tile. The units of one GEMM
// walk the m-tiles inside a column slab, so the CTAs that run together
// share one weight slab through L2. The int8 wire's rows land by TMA as
// int8 and the converters dequantize them with their row's scale before
// the split.
//
// The producer makes a unit's waits (dispatch flags, H ready) before it
// loads the unit's stages, and only once every stage of the unit before is
// issued, so the consumers wait on no other CTA, and the deadlock argument
// above holds: each CTA's units complete in the global order. After a wait
// it fences the proxies (fence.proxy.async): the rows it acquired were
// written by other CTAs' stores, and TMA reads them. Rows past a tile's
// `valid` read whatever the slabs hold there (padding, the next segment's
// rows): a product row reads only its own token row, and no epilogue
// stores such a row but as zeros.
//
// Bound: at serving width (4 ranks x 256 tokens, d=7168, f=fs=2048) the
// call does 180.4 GFLOP against ~1 GB of weights. 3xTF32 is three tensor
// products per multiply-add, so the operations bound it: 3 x 180.4 GFLOP
// at 495 TFLOP/s, 1.09 ms on an H100 SXM. chip_smoke.py's gemm_core line
// times the core alone at this GEMM's shapes, which splits a variant's
// time between GEMM and dispatch / combine / waiting.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cta_stats.cuh"
#include "flags.cuh"
#include "tc_gemm.cuh"
#include "tma_map.cuh"
#include "wg_tile.cuh"
#include "window.cuh"

#define MOE_MAXN 8

constexpr int NTH = wt::NTHREADS;  // a CTA: the dispatch's staging threads
constexpr int NCONS = wt::NCONS;   // the consumers: epilogues, combine, assembly
constexpr int TM = wt::BM;         // the widest token tile: 128 rows
constexpr int BN = wt::BN;         // a tile's 128 columns
constexpr int BK = wt::BK;
// setmaxnreg, a thread: the loader warpgroup keeps 104 (the producer walks
// the stream's units, the int8 converters hold a unit's chunks and
// scales), the consumers take the rest of the 168 x 384 a CTA launches
// with. With wg_tile.cuh's 40 / 232 ptxas spilled 1196 bytes of
// moe_kernel<float> and 2284 of <int8>, most of them in the loader's
// walk (CUDA 12.8).
constexpr int REG_LOAD = 104, REG_CONS = 200;
static_assert(NCONS * REG_CONS + (NTH - NCONS) * REG_LOAD <= 168 * NTH, "registers");
// A partial sum takes two 32-deep stages: at 128 deep (wg_tile.cuh's
// PART_STAGES) decode_shared's worst row read 3.18e-6 of the plain
// version, against 2.05e-6 at 64 deep and 1.65e-6 at 32, and 64 deep ran
// as fast in decode_shared and 0.6-1.0% slower in prefill_skew (an H100)
constexpr int PART = 2;

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

// The TMA maps of the operands, as the wrapper's stacked tensors: token
// rows in 64-row boxes (recv: int8 rows on the int8 wire), weights in
// 32-row boxes, 32 columns a box. xs, hs, s1, s2 only with a second stream.
struct MoeMaps {
  CUtensorMap recv, h, w1, w2, xs, hs, s1, s2;
};

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

// ------------------------------------------------------------ waits

// The consumers: thread 0 spins until *p >= target (its cycles counted as
// waiting), then all go on with what it waited for. Inline, without a
// message: the kernel that runs wgmma calls no function.
__device__ __forceinline__ void cons_wait(const unsigned* p, unsigned target, int timeout_ms) {
  if (threadIdx.x == 0) {
    if (ld_acquire(p) < target) {
      stats::mark();
      spin_geq_inline(p, target, timeout_ms);
      stats::add_wait();
    }
    __threadfence();
  }
  group_sync(wt::CONS_BAR, NCONS);
}

// the generic-proxy writes acquired (other CTAs' stores) before the async
// proxy's reads (TMA)
__device__ __forceinline__ void fence_to_tma() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// ------------------------------------------------------------ row staging

__device__ __forceinline__ float block_max(float v) {
  __shared__ float red[NTH / 32];
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < NTH / 32; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

__device__ __forceinline__ signed char quant(float v, float s) {
  float r = rintf(v / s);  // round half to even, like jnp.round
  return (signed char)fminf(fmaxf(r, -127.f), 127.f);
}

// threads 0 .. NT - 1 stage one token row onto the wire (src == nullptr: a
// zero padding row)
template <int NT>
__device__ __forceinline__ void stage_row(const float* src, float* dst, float*, int d) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < d / 4; i += NT)
    d4[i] = src ? __ldg(s4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// the int8 wire: every thread of the CTA (block_max)
template <int NT>
__device__ __forceinline__ void stage_row(const float* src, int8_t* dst, float* scale, int d) {
  static_assert(NT == NTH, "the whole CTA quantizes a row");
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

// the consumers copy one f32 row written by other CTAs (the assembly)
__device__ __forceinline__ void copy_row(const float* src, float* dst, int d) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < d / 4; i += NCONS) d4[i] = __ldcg(s4 + i);
}

// -------------------------------------------------------------- work units

// A stream's CTAs take its units round robin from one global order: unit
// u belongs to CTA u % size. `next` is the index of the stream's next unit.
struct Stream {
  int me, gid, size, next;
  __device__ __forceinline__ bool take() { return next++ % size == gid; }
};

// A run of rows one GEMM covers: rows [a_row0, a_row0 + rows) of the
// stacked slabs (every rank's; the second stream's: every rank's Ts rows),
// of which the first `valid` are tokens. GEMM1 writes H rows a_row0 + r
// and bumps h_ready; GEMM2 waits until h_ready reaches h_units, writes row
// r to out + r*N (zero for valid <= r < rows) and then bumps o_ready or,
// in the tile-fused path, ticks comb_flag per combine chunk. `src` >= 0:
// the GEMM1 units of a pipelined or tile-fused path wait for the
// microblocks (src, j0 + ...) their rows cover.
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

__device__ __forceinline__ int mtiles(int rows) { return (rows + TM - 1) / TM; }

// the token tile of a segment's m-tile with `left` rows from its start on:
// 128 rows, or 64 where at most 64 are left (kernels/moe_dispatch.py::tile_rows)
__device__ __forceinline__ int tile_rows(int left) { return left > 64 ? TM : 64; }

// one GEMM unit: GEMM1 (SwiGLU into H) or GEMM2 of segment sg's m-tile
// at m0, tn token rows, and column slab c0
struct Unit {
  const Seg* sg;
  int gemm2, m0, c0, tn;
};

// A stream's operands: maps of the A operands (GEMM1's token rows, H) and
// weights, the expert's first weight rows in its maps, GEMM1's depth k1
// and H's width F (GEMM2's depth), GEMM2's width N, H itself and the int8
// wire's row scales (rows of the stacked slabs)
struct Ops {
  const CUtensorMap *a1, *w1, *a2, *w2;
  int w1row, w2row, k1, F, N;
  float* H;
  const float* scale;
};

// The units of one GEMM over segments `segs`: GEMM1 (gemm2 == 0), F/64 H
// column slabs of `cols` = F (each a paired 128-column weight tile: 64
// gate and 64 up columns), or GEMM2, ceil(N/128) output column slabs of
// `cols` = N, each waiting for its segment's H; x the m-tiles, m-tiles
// inside a column slab. Every role hands its units to v from this one
// site, so each role's code for a unit is inlined once.
template <class V>
__device__ __forceinline__ void gemm_units(const Seg* segs, int nseg, int gemm2, int cols,
                                           Stream& st, V&& v) {
  for (int c0 = 0; c0 < cols; c0 += gemm2 ? BN : 64)
    for (int s = 0; s < nseg; ++s)
      for (int m0 = 0; m0 < segs[s].rows; m0 += TM)
        if (st.take()) v(Unit{&segs[s], gemm2, m0, c0, tile_rows(segs[s].rows - m0)});
}

// ------------------------------------------------------------ the roles

// The producer: the unit's waits, then its stages by TMA
template <bool I8>
__device__ __forceinline__ void produce(const MoeParams& P, const Ops& o, wt::Ring& ring, int me,
                                        const Unit& u) {
  const Seg& sg = *u.sg;
  const int row = (int)(sg.a_row0 + u.m0);
  if (!u.gemm2) {
    if (sg.src >= 0) {  // the microblocks this tile reads have landed
      const int j1 = sg.j0 + (min(u.m0 + u.tn, sg.rows) - 1) / P.B;
      for (int j = sg.j0 + u.m0 / P.B; j <= j1; ++j)
        spin_geq_inline(&P.disp_flag[((size_t)me * P.n + sg.src) * P.b_max + j], (unsigned)P.B,
                        P.timeout_ms);
      fence_to_tma();
    }
    wt::produce_unit<I8>(ring, o.a1, row, u.tn, o.w1, o.w1row, u.c0, o.F + u.c0, BN,
                         (o.k1 + BK - 1) / BK, P.timeout_ms);
  } else {
    if (sg.h_ready) {  // H's rows of the segment are written
      spin_geq_inline(sg.h_ready, sg.h_units, P.timeout_ms);
      fence_to_tma();
    }
    wt::produce_unit<false>(ring, o.a2, row, u.tn, o.w2, o.w2row, u.c0, u.c0 + 64,
                            min(BN, o.N - u.c0), (o.F + BK - 1) / BK, P.timeout_ms);
  }
}

// The converters: the unit's stages, split (dequantized first on the int8
// wire)
template <bool I8>
__device__ __forceinline__ void convert(const MoeParams& P, const Ops& o, wt::Ring& ring,
                                        const Unit& u) {
  const Seg& sg = *u.sg;
  if (!u.gemm2)
    wt::convert_unit<I8>(ring, (o.k1 + BK - 1) / BK, u.tn, o.scale + sg.a_row0 + u.m0,
                         clampi(sg.valid - u.m0, 0, u.tn), P.timeout_ms);
  else
    wt::convert_unit<false>(ring, (o.F + BK - 1) / BK, u.tn, nullptr, 0, P.timeout_ms);
}

// The consumers' products of one unit of N / 2 token rows into the result
// tile C; thread 0's wait for the unit's first stage counts as waiting
template <int N>
__device__ __forceinline__ void products(wt::Ring& ring, int nk, float* C, int timeout_ms) {
  float acc[N];
  stats::wait_for([&] {
    wg::mbar_wait(ring.bar(ring.full), ring.phase, timeout_ms);
    wg::mbar_wait(ring.bar(ring.ready), ring.phase, timeout_ms);
  });
  stats::gemm([&] { wt::consume_tile<PART>(ring, nk, acc, timeout_ms); });
  // the last tile's bulk stores have read C
  if (threadIdx.x == 0) win::wait_read_all(stats::wait());
  group_sync(wt::CONS_BAR, NCONS);
  wt::store_result(C, acc);
  group_sync(wt::CONS_BAR, NCONS);
}

// The consumers: one unit's products, then its epilogue from the result
// tile. GEMM1: SwiGLU into H's token rows, then h_ready. GEMM2: the
// packed combine (PACKED), the tile-fused combine (comb_flag), or plain
// stores into `out` and o_ready.
template <bool PACKED>
__device__ __forceinline__ void consume(const MoeParams& P, const Ops& o, wt::Ring& ring, int me,
                                        const Unit& u, MoeWindow& w) {
  const Seg& sg = *u.sg;
  float* C = wt::result_tile(ring);
  const int nk = ((u.gemm2 ? o.F : o.k1) + BK - 1) / BK;
  if (u.tn == TM)
    products<TM / 2>(ring, nk, C, P.timeout_ms);
  else
    products<32>(ring, nk, C, P.timeout_ms);
  const int m0 = u.m0, c0 = u.c0;
  const int rows = min(u.tn, sg.rows - m0), valid = clampi(sg.valid - m0, 0, u.tn);
  if (!u.gemm2) {
    // H[r, c] = silu(C[r, c]) * C[r, 64 + c], the token rows
    float* H = o.H + (sg.a_row0 + m0) * o.F + c0;
    for (int i = threadIdx.x; i < valid * 16; i += NCONS) {
      const int r = i >> 4, c = (i & 15) * 4;
      const float4 g = *reinterpret_cast<const float4*>(C + r * wt::LDC + c);
      const float4 v = *reinterpret_cast<const float4*>(C + r * wt::LDC + 64 + c);
      *reinterpret_cast<float4*>(H + (size_t)r * o.F + c) =
          make_float4(tc::swiglu(g.x, v.x), tc::swiglu(g.y, v.y), tc::swiglu(g.z, v.z),
                      tc::swiglu(g.w, v.w));
    }
    if (sg.h_ready) {
      fence_to_tma();  // the GEMM2 units read H by TMA
      group_sync(wt::CONS_BAR, NCONS);
      if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(sg.h_ready, 1u);
      }
    }
    return;
  }
  const int N = o.N, ncols = min(BN, N - c0);
  if constexpr (PACKED) {
    // the packed combine: the tile's token rows, a round for each source
    // they came from, sent into that source's slab
    win::fence_to_async();
    group_sync(wt::CONS_BAR, NCONS);
    if (threadIdx.x == 0) {
      const int p0 = sg.j0 * P.B + m0;  // the tile's first arrival row
      const int tile = (sg.j0 * ((N + BN - 1) / BN) + c0 / BN) * mtiles(sg.rows) + m0 / TM;
      for (int off = 0, a = 0; off < P.n && a < p0 + valid; ++off) {
        const int s = (me + off) % P.n, c = P.counts[s][me];
        const int lo = max(a, p0), hi = min(a + c, p0 + valid);
        if (lo < hi) {
          win::push(w, MoeRound{&P.comb_flag[s * P.n + me], (unsigned)((hi - lo) * ncols),
                                (unsigned)(P.ct * ncols)},
                    (s - me + P.n) % P.n, tile, release_round);
          float* out = P.comb + ((size_t)s * P.n * P.stride + (size_t)me * P.stride) * N;
          for (int r = lo; r < hi; ++r)
            win::bulk_store(out + (size_t)(r - a) * N + c0, C + (r - p0) * wt::LDC, ncols * 4);
          win::commit_piece(w);
        }
        a += c;
      }
    }
    return;
  }
  if (sg.comb_flag) {
    // the tile-fused combine: round (off, tile) of the window, sent from
    // the result tile (padding rows zeroed first); one tick per
    // combine_tile chunk at its retirement
    for (int i = threadIdx.x; i < (rows - valid) * BN; i += NCONS)
      C[(valid + i / BN) * wt::LDC + i % BN] = 0.f;
    win::fence_to_async();
    group_sync(wt::CONS_BAR, NCONS);
    if (threadIdx.x == 0) {
      const int off = (sg.src - me + P.n) % P.n;
      const int tile = (sg.j0 * ((N + BN - 1) / BN) + c0 / BN) * mtiles(sg.rows) + m0 / TM;
      win::push(w, MoeRound{sg.comb_flag, (unsigned)(rows * ncols), (unsigned)(P.ct * ncols)}, off,
                tile, release_round);
      for (int r = 0; r < rows; ++r)
        win::bulk_store(sg.out + (size_t)(m0 + r) * N + c0, C + r * wt::LDC, ncols * 4);
      win::commit_piece(w);
    }
    return;
  }
  // plain stores, rows at or past `valid` as zeros (ncols and N multiples of 4)
  float* out = sg.out + (size_t)m0 * N + c0;
  for (int i = threadIdx.x; i < rows * (BN / 4); i += NCONS) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    if (c < ncols)
      *reinterpret_cast<float4*>(out + (size_t)r * N + c) =
          r < valid ? *reinterpret_cast<const float4*>(C + r * wt::LDC + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (sg.o_ready) {
    group_sync(wt::CONS_BAR, NCONS);
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(sg.o_ready, 1u);
    }
  }
}

// The GEMM units `walk` hands out, on the core: the loader warpgroup
// streams them (the producer first waits for every dispatch edge when
// `all_edges`: BARRIER / DEFERRED) and returns false; the consumers run
// them and return true to go on with the stream.
template <bool I8, bool PACKED, class Walk>
__device__ __forceinline__ bool on_core(const MoeParams& P, const Ops& o, wt::Ring& ring, int me,
                                        MoeWindow& w, bool all_edges, Walk&& walk) {
  if (threadIdx.x >= NCONS) {
    wt::reg_dealloc<REG_LOAD>();
    if (threadIdx.x == NCONS) {
      if (all_edges) {
        for (int s = 0; s < P.n; ++s)
          for (int j = 0; j < P.blocks[s][me]; ++j)
            spin_geq_inline(&P.disp_flag[((size_t)me * P.n + s) * P.b_max + j], (unsigned)P.B,
                            P.timeout_ms);
        fence_to_tma();
      }
      walk([&](const Unit& u) { produce<I8>(P, o, ring, me, u); });
    } else if (threadIdx.x >= NTH - wt::NCONV) {
      walk([&](const Unit& u) { convert<I8>(P, o, ring, u); });
    }
    return false;
  }
  wt::reg_alloc<REG_CONS>();
  walk([&](const Unit& u) { consume<PACKED>(P, o, ring, me, u, w); });
  return true;
}

// ------------------------------------------------------------------ streams

// the second stream: ys = swiglu(xs, s1, s2) for this rank's tokens
__device__ __forceinline__ void shared_stream(const MoeParams& P, const MoeMaps& M, Stream& st,
                                              wt::Ring& ring, MoeWindow& w) {
  if (threadIdx.x == 0)
    win::note(win::cta_log(P.log, P.log_n, P.log_cap), win::EV_MARK, win::MARK_SHARED_FFN, 0);
  const Seg sg{(size_t)st.me * P.Ts, P.Ts, P.Ts, P.ys + (size_t)st.me * P.Ts * P.d,
               P.hs_ready + st.me, (unsigned)(P.fs / 64 * mtiles(P.Ts)), nullptr, nullptr, -1, 0};
  const Ops o{&M.xs, &M.s1, &M.hs, &M.s2, 0, 0, P.d, P.fs, P.d, P.hs, nullptr};
  on_core<false, false>(P, o, ring, st.me, w, false, [&](auto&& v) {
    for (int g2 = 0; g2 < 2; ++g2) gemm_units(&sg, 1, g2, g2 ? P.d : P.fs, st, v);
  });
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

// The routed stream's GEMM units in the global order, handed to v: a
// group's GEMM1 units, then its GEMM2 units, group after group. A group
// is one microblock of the packed arrivals (PACKED) or of a source's
// arrivals (tile-fused COUNTER), one source's rows (SIGNAL pipelined, in
// arrival order, self edge first) or every source's (BARRIER / DEFERRED:
// every edge lands before any expert compute).
template <bool PACKED, class V>
__device__ __forceinline__ void routed_units(const MoeParams& P, Stream& st, V&& v) {
  const int n = P.n, B = P.B, me = st.me, bmax = P.b_max, stride = P.stride;
  const size_t slab = (size_t)n * stride, base = (size_t)me * slab;  // my slab's first row
  unsigned* h_ready = P.h_ready + (size_t)me * n * bmax;
  unsigned* o_ready = P.o_ready + (size_t)me * n;
  const unsigned g1 = (unsigned)(P.f / 64);  // GEMM1 units per m-tile
  const bool pipelined = !P.barrier && P.pipelined;
  int groups, nseg = 1, off = 0, j = 0;  // tile-fused: the next group's (off, j)
  if constexpr (PACKED) {
    groups = (packed_rows(P, me) + B - 1) / B;
  } else if (P.tile_fused) {
    groups = 0;
    for (int s = 0; s < n; ++s) groups += P.blocks[s][me];
  } else {
    groups = pipelined ? n : 1;
  }
  unsigned all_units = 0;  // BARRIER / DEFERRED: GEMM1 units of every source's rows
  for (int s = 0; s < n; ++s) all_units += g1 * mtiles(P.blocks[s][me] * B);
  Seg segs[MOE_MAXN];
  for (int k = 0; k < 2 * groups; ++k) {
    const int g2 = k & 1, i = k >> 1;
    if (!g2) {
      if constexpr (PACKED) {
        // every source's rows of microblock i; GEMM2's epilogue sends each
        // source its rows
        segs[0] = Seg{base + (size_t)i * B, B, min(packed_rows(P, me) - i * B, B), nullptr,
                      &h_ready[i], g1 * mtiles(B), nullptr, P.comb_flag, 0, i};
      } else if (P.tile_fused) {
        // microblock j of source src; GEMM2's epilogue is the combine store
        // into the source's slab
        while (j >= P.blocks[(me + off) % n][me]) ++off, j = 0;
        const int src = (me + off) % n, rel = j * B;
        segs[0] = Seg{base + (size_t)src * stride + rel, B, clampi(P.counts[src][me] - rel, 0, B),
                      P.comb + ((size_t)src * slab + (size_t)me * stride + rel) * P.d,
                      &h_ready[src * bmax + j], g1 * mtiles(B), nullptr,
                      &P.comb_flag[src * n + me], src, j};
        ++j;
      } else {
        // one source's rows (pipelined: a counter per source), or all of
        // them (one counter for the whole GEMM)
        nseg = pipelined ? 1 : n;
        for (int q = 0; q < nseg; ++q) {
          const int s = pipelined ? i : q, src = (me + s) % n, rows = P.blocks[src][me] * B;
          segs[q] = Seg{base + (size_t)src * stride, rows, min(P.counts[src][me], rows),
                        P.ffn_out + (base + (size_t)src * stride) * P.d,
                        pipelined ? &h_ready[src * bmax] : h_ready,
                        pipelined ? g1 * mtiles(rows) : all_units,
                        pipelined ? &o_ready[s] : o_ready, nullptr, pipelined ? src : -1, 0};
        }
      }
    }
    gemm_units(segs, nseg, g2, g2 ? P.d : P.f, st, v);
  }
}

// dispatch -> expert FFN -> combine -> assemble, for rank `me`
// PACKED: the tile-fused path on packed arrivals (its own instance, so
// the other paths compile as they did without it)
template <typename WT, bool PACKED>
__device__ __forceinline__ void routed(const MoeParams& P, const MoeMaps& M, Stream& st,
                                       wt::Ring& ring, MoeWindow& w) {
  const int n = P.n, B = P.B, d = P.d, stride = P.stride, bmax = P.b_max;
  const int me = st.me;
  const size_t slab = (size_t)n * stride;
  char* slot = ring.gen;  // the send slot: the ring is idle until the dispatch drains

  // ---- dispatch: rounds (off, j) of DispatchSchedule, dummies elided.
  // Rows of successive rounds go round robin over the stream; each CTA
  // stages (and quantizes) its rows into the slot and sends them, its
  // share of a round one window entry.
  for (int off = 0; off < n; ++off) {
    const int e = (me - off + n) % n;
    WT* dst = reinterpret_cast<WT*>(P.recv) + (size_t)e * slab * d;
    float* dsc = P.recv_s + (size_t)e * slab;
    if constexpr (PACKED) {
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
          stage_row<NTH>(src, reinterpret_cast<WT*>(slot), dsc + row, d);
          win::fence_to_async();
          __syncthreads();
          if (threadIdx.x == 0) {
            win::bulk_store(dst + row * d, slot, (unsigned)(d * sizeof(WT)));
            win::commit_piece(w);
          }
        }
        st.next += L;
        k0 = k1;
      }
    } else {
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
          stage_row<NTH>(src, reinterpret_cast<WT*>(slot), dsc + row, d);
          win::fence_to_async();
          __syncthreads();
          if (threadIdx.x == 0) {
            win::bulk_store(dst + row * d, slot, (unsigned)(d * sizeof(WT)));
            win::commit_piece(w);
          }
        }
        st.next += B;
      }
    }
  }
  if (threadIdx.x == 0) {
    win::note(w.log, win::EV_MARK, win::MARK_DISPATCH_ISSUED, 0);
    win::drain(w, release_round, 0);
    win::note(w.log, win::EV_MARK, win::MARK_DISPATCH_DRAINED, 0);
  }
  __syncthreads();  // the slot's stores have landed: the ring may load over it

  // ---- expert FFN over the arrivals, on the core: source src's rows are
  // its blocks[src][me] microblocks, the first counts[src][me] of them tokens
  const Ops o{&M.recv, &M.w1, &M.h, &M.w2, me * d, me * P.f, d, P.f, d, P.h, P.recv_s};
  const bool pipelined = !P.barrier && P.pipelined;
  if (!on_core<sizeof(WT) == 1, PACKED>(P, o, ring, me, w, !PACKED && !P.tile_fused && !pipelined,
                                          [&](auto&& v) { routed_units<PACKED>(P, st, v); }))
    return;  // the loader warpgroup is done

  if (!PACKED && !P.tile_fused) {
    // ---- combine: reverse shift, expert me -> source (me + off) % n, once
    // that source's expert rows are in ffn_out
    const int cols = (d + BN - 1) / BN;  // GEMM2 units per m-tile
    unsigned all_out = 0;                // GEMM2 units of every source's rows
    for (int s = 0; s < n; ++s) all_out += cols * mtiles(P.blocks[s][me] * B);
    const float* ffo = P.ffn_out + (size_t)me * slab * d;
    unsigned* o_ready = P.o_ready + (size_t)me * n;
    for (int off = 0; off < n; ++off) {
      const int q = (me + off) % n, mb = P.blocks[q][me];
      const unsigned o_units = pipelined ? (unsigned)(cols * mtiles(mb * B)) : all_out;
      for (int j = 0; j < mb; ++j) {
        const unsigned mine = rows_of(st, B);
        if (mine) {
          cons_wait(pipelined ? &o_ready[off] : o_ready, o_units, P.timeout_ms);
          if (threadIdx.x == 0)
            win::push(w, MoeRound{&P.comb_flag[q * n + me], mine * d, mine * d}, off, j,
                      release_round);
        }
        for (int i = first_row(st); i < B; i += st.size) {
          const int k = j * B + i;
          win::ship<NCONS, 8>(w, slot, MOE_SLOT, ffo + ((size_t)q * stride + k) * d,
                              P.comb + ((size_t)q * slab + (size_t)me * stride + k) * d,
                              (size_t)d * 4, [] { group_sync(wt::CONS_BAR, NCONS); });
        }
        st.next += B;
      }
    }
  }
  if (threadIdx.x == 0) win::drain(w, release_round, 1);

  // ---- assemble: region e of my combine slab holds my tokens for expert
  // e; rows past my last run were routed nowhere and come back zero
  for (int e = 0; e < n; ++e)
    cons_wait(&P.comb_flag[me * n + e],
              (unsigned)(PACKED ? P.counts[me][e] : P.blocks[me][e] * B) * d, P.timeout_ms);
  const float* comb = P.comb + (size_t)me * slab * d;
  const int routed_rows = P.offsets[me][n - 1] + P.counts[me][n - 1];
  for (int k = 0; k < P.T; ++k) {
    if (!st.take()) continue;
    float* dst = P.y + ((size_t)me * P.T + k) * d;
    if (k >= routed_rows) {
      stage_row<NCONS>(static_cast<const float*>(nullptr), dst, nullptr, d);
      continue;
    }
    int e = 0;
    while (e + 1 < n && k >= P.offsets[me][e + 1]) ++e;
    copy_row(comb + ((size_t)e * stride + k - P.offsets[me][e]) * d, dst, d);
  }
}

// wg_tile.cuh's ring, its result tile, then the window
constexpr int MOE_SMEM = wt::SMEM + (int)sizeof(MoeWindow);

// One CTA an SM: the ring's three 48 KB stages and the 128-row result tile
// take 211 KB of shared memory, and 384 threads hold 168 registers each
// (setmaxnreg moves the loaders' spare to the consumers: REG_LOAD).
template <typename WT>
__global__ void __launch_bounds__(NTH, 1)
    moe_kernel(const __grid_constant__ MoeParams P, const __grid_constant__ MoeMaps M) {
  extern __shared__ __align__(16) char smem[];
  int s = 0;
  while (s + 1 < 2 * P.n && (int)blockIdx.x >= P.cta0[s + 1]) ++s;
  if ((int)blockIdx.x >= P.cta0[2 * P.n]) return;
  wt::Ring ring = wt::make_ring(smem);
  MoeWindow& w = *reinterpret_cast<MoeWindow*>(wt::tail(ring));
  if (threadIdx.x == 0) {
    stats::open(s & 1);  // role: routed (0) or second stream (1)
    win::open(w, P.contexts, win::cta_log(P.log, P.log_n, P.log_cap), stats::wait());
  }
  __syncthreads();  // the ring's barriers are initialised
  Stream st{s / 2, (int)blockIdx.x - P.cta0[s], P.cta0[s + 1] - P.cta0[s], 0};
  if (s & 1)
    shared_stream(P, M, st, ring, w);
  else if (P.packed)
    routed<WT, true>(P, M, st, ring, w);
  else
    routed<WT, false>(P, M, st, ring, w);
  if (threadIdx.x == 0) stats::close(P.stats);
}

// The core alone, for workloads/scmoe.py's router and FFN2, the tests and
// chip_smoke.py's gemm_core line: C = A B, or with `swiglu` C = silu(A
// B[:, :N/2]) * (A B[:, N/2:]), C (M, N/2); ta maps A (M, K), tb B (K, N).
// The CTAs take the tiles round robin, m-tiles inside a column slab.
__global__ void __launch_bounds__(NTH, 1)
    gemm_core_kernel(const int M, const int K, const int N, const int swiglu, float* C,
                     const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb) {
  extern __shared__ __align__(16) char smem[];
  wt::Ring ring = wt::make_ring(smem);
  MoeWindow& w = *reinterpret_cast<MoeWindow*>(wt::tail(ring));  // never opened: no stores
  MoeParams P{};
  P.timeout_ms = 20000;  // kernels/moe_dispatch.py::TIMEOUT_MS
  __syncthreads();  // the ring's barriers are initialised
  const int F = swiglu ? N / 2 : N;
  const Seg sg{0, M, M, C, nullptr, 0, nullptr, nullptr, -1, 0};
  const Ops o{&ta, &tb, &ta, &tb, 0, 0, K, swiglu ? F : K, N, C, nullptr};
  Stream st{0, (int)blockIdx.x, (int)gridDim.x, 0};
  on_core<false, false>(P, o, ring, 0, w, false,
                        [&](auto&& v) { gemm_units(&sg, 1, !swiglu, F, st, v); });
}

// The unaligned inputs' tile GEMM (K or N off 4, or a base off 16 bytes:
// what TMA cannot map), on tc_gemm.cuh's core, one CTA a tile: the same
// products as gemm_core_kernel, plain.
template <bool VEC>
__global__ void __launch_bounds__(tc::NT, 2)
    gemm_core_kernel(const float* A, const float* Bw, float* C, int M, int K, int N, int swiglu) {
  extern __shared__ __align__(16) char smem[];
  const int mt = (M + tc::BM - 1) / tc::BM;
  const int m0 = (blockIdx.x % mt) * tc::BM;
  const int rows = min(tc::BM, M - m0);
  if (swiglu) {
    const int F = N / 2, c0 = (blockIdx.x / mt) * 64;
    tc::tile<float, VEC>(tc::TileA{A, nullptr, K, (size_t)m0, rows},
                         tc::TileB{Bw, N, c0, F + c0, tc::BN}, K, smem);
    tc::store_swiglu(smem, C + (size_t)m0 * F + c0, F, rows);
  } else {
    const int c0 = (blockIdx.x / mt) * tc::BN, ncols = min(tc::BN, N - c0);
    tc::tile<float, VEC>(tc::TileA{A, nullptr, K, (size_t)m0, rows},
                         tc::TileB{Bw, N, c0, c0 + 64, ncols}, K, smem);
    tc::store_tile<VEC>(smem, C + (size_t)m0 * N + c0, N, rows, ncols, rows);
  }
}

// ------------------------------------------------------------ C interface

static const void* kernel_for(int wire_i8) {
  return wire_i8 ? (const void*)moe_kernel<int8_t> : (const void*)moe_kernel<float>;
}

// the kernels' shared memory is above the 48 KB default: opt in before the
// occupancy query and the launch
static cudaError_t allow_smem(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the maps of p's operands (MoeMaps)
static int encode_maps(const MoeParams* p, MoeMaps* m) {
  // every rank's slab (one row at least: a launch that routes no row
  // reads none, but the encoder takes no empty tensor)
  const long long rows = max((long long)p->n * p->n * p->stride, 1ll);
  int rc = tma::encode(&m->recv, p->recv, p->d, rows, 64, p->wire_i8 != 0);
  if (rc == 0) rc = tma::encode(&m->h, p->h, p->f, rows, 64);
  if (rc == 0) rc = tma::encode(&m->w1, p->w1, 2 * p->f, (long long)p->n * p->d, BK);
  if (rc == 0) rc = tma::encode(&m->w2, p->w2, p->d, (long long)p->n * p->f, BK);
  if (rc == 0 && p->shared) {
    rc = tma::encode(&m->xs, p->xs, p->d, (long long)p->n * p->Ts, 64);
    if (rc == 0) rc = tma::encode(&m->hs, p->hs, p->fs, (long long)p->n * p->Ts, 64);
    if (rc == 0) rc = tma::encode(&m->s1, p->s1, 2 * p->fs, p->d, BK);
    if (rc == 0) rc = tma::encode(&m->s2, p->s2, p->d, p->fs, BK);
  }
  return rc;
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
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel_for(wire_i8), NTH, MOE_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return -1;
  *grid = (*per_sm) * sms;
  return *grid < n * (shared ? 2 : 1) ? -2 : 0;
}

// Cooperative launch: the runtime refuses a grid whose CTAs cannot all be
// resident at once, which the spin-waits require.
int moe_dispatch_launch(const MoeParams* p, int grid, void* stream) {
  MoeMaps maps = {};
  const int rc = encode_maps(p, &maps);
  if (rc != 0) return rc;
  void* args[] = {const_cast<MoeParams*>(p), &maps};
  cudaError_t e = allow_smem(kernel_for(p->wire_i8), MOE_SMEM);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel_for(p->wire_i8), dim3(grid), dim3(NTH), args,
                                    MOE_SMEM, (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

// The GEMM alone (see gemm_core_kernel): `vec` when K and N are multiples
// of 4 and the bases 16-byte aligned (the wgmma core, one CTA an SM over
// the tiles), else tc_gemm.cuh's tile; `swiglu` wants N/2 a multiple of 64.
int moe_dispatch_gemm(const float* a, const float* b, float* c, int M, int K, int N, int swiglu,
                      int vec, void* stream) {
  if (!vec) {
    const void* kernel = (const void*)gemm_core_kernel<false>;
    cudaError_t e = allow_smem(kernel, tc::SMEM);
    if (e != cudaSuccess) return (int)e;
    const int mt = (M + tc::BM - 1) / tc::BM, nt = swiglu ? N / 2 / 64 : (N + tc::BN - 1) / tc::BN;
    gemm_core_kernel<false><<<mt * nt, tc::NT, tc::SMEM, (cudaStream_t)stream>>>(a, b, c, M, K, N,
                                                                                 swiglu);
    return (int)cudaGetLastError();
  }
  CUtensorMap ta, tb;
  int rc = tma::encode(&ta, a, K, M, 64);
  if (rc == 0) rc = tma::encode(&tb, b, N, K, BK);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const void* kernel = (const void*)static_cast<void (*)(int, int, int, int, float*, CUtensorMap,
                                                         CUtensorMap)>(gemm_core_kernel);
  if (e == cudaSuccess) e = allow_smem(kernel, MOE_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (M + TM - 1) / TM * (swiglu ? N / 2 / 64 : (N + BN - 1) / BN);
  void* args[] = {&M, &K, &N, &swiglu, &c, &ta, &tb};
  e = cudaLaunchKernel(kernel, dim3(tiles < sms ? tiles : sms), dim3(NTH), args, MOE_SMEM,
                       (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

const char* moe_dispatch_error(int code) {
  if (code == -1) return "device does not support cooperative launch";
  if (code == -2) return "too few co-resident CTAs for the ranks";
  if (code == -3) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (code == -4) return "cuTensorMapEncodeTiled refused an operand's layout";
  return cudaGetErrorString((cudaError_t)code);
}

int moe_dispatch_params_size() { return (int)sizeof(MoeParams); }

}  // extern "C"
