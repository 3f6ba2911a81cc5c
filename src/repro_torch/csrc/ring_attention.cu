// Context-parallel ring attention for Hopper (sm_90a): rank r holds the
// query, key and value shards of rows [r*Sl, (r+1)*Sl) of one sequence;
// the key/value shards rotate one hop per step (r -> r+1) and every rank
// folds each shard it holds into its queries' online softmax.
//
// Replaces src/repro/kernels/ring_attention.py::_ring_kernel (the Pallas
// kernel behind ring_attention_sharded and ring_attention). It computes
// the same function in q's dtype (f32 or bf16 in, buffers and output the
// same) with the math in f32: the attend step is _fa_kernel's
// (attend.cuh's tensor-core step), masked scores -1e30, the output
// acc / max(l, 1e-30).
//
// Layout: the n ranks are n partitions of ONE cooperative launch over one
// allocation: rank r's CTAs are [cta0[r], cta0[r + 1]), a split the
// wrapper makes by each rank's causal work (kernels/ring_attention.py::
// ring_ctas: rank r attends to r full shards and its own diagonal, so an
// even split left rank n - 1 with (2n - 1) / n^2 of the work on 1 / n of
// the CTAs; the split also weighs whole pieces and the waits between
// ranks). Each rank's CTAs own (bh, 64-row query tile) pieces of its Q
// shard, dealt in snake order (piece_of). In step s a rank attends to the shard that started on rank
// (r - s) % n: at step 0 its own k / v, after that slot s % 2 of its
// double buffer (kbuf / vbuf, (n, 2, BH, Sl, hd)). In step s it also
// forwards what it holds into the next rank's slot (s + 1) % 2: each CTA
// stores its share of each chunk (rows [c*kv_chunk, (c+1)*kv_chunk) of
// every bh), and a flag word per (receiving rank, step, chunk) is ticked
// by the elements landed when that round retires from the send window
// (below; flags.cuh).
// Realizations, as _ring_kernel orders them:
//   fused COUNTER  chunk by chunk: wait chunk c's arrival just before the
//                  first key tile that needs it is copied, forward it,
//                  attend;
//   fused SIGNAL   wait all of the step's chunks first, then the same;
//   pipelined      one whole-shard round per step: forward, attend, then
//                  wait for the next step's shard (the lazy fence);
//   deferred/eager forward, wait for the next step's shard, then attend.
// The free-slot credit is required on the card, not a window: before it
// forwards in step s >= 2 a CTA waits until every CTA of the next rank has
// finished step s - 1 (a per-rank counter the CTAs bump after steps
// s <= n - 3, awaited at the next rank's CTA count times s), since the
// slot it writes is the one that rank read then (step 1 writes slot 0,
// which nothing has read: step 0 reads k / v themselves). A key tile fully masked
// for a piece's queries is skipped, as _fa_kernel skips masked kv blocks;
// that is exact, since every query row meets an unmasked key in step 0's
// first tile (its own shard), so its running max is finite before any
// masked tile comes. A CTA holding one piece keeps its softmax state in
// registers across steps; one holding several parks it between steps in
// `acc` (the f32 accumulator; `out` itself for f32) and `ml` (max and
// sum). The wrapper zeroes the flags and counters on the launch stream
// before every launch.
//
// The send window (window.cuh, mechanism (a): TMA bulk stores). A round is
// this CTA's share of one (step, chunk) K / V pair, one window entry:
// DEPTH loads a thread of K and of V go through registers into a 16 KB
// slot of shared memory beside the attention tiles, and thread 0 sends the
// slot with bulk stores (one per bh run of K and of V), then goes back to
// the attention step without waiting for them to land. At most `contexts`
// rounds are unretired; retiring one waits for its bulk groups, fences and
// ticks the chunk's flag. The window drains once a step, as soon as the
// step's last round is pushed (fused: when the last chunk is forwarded;
// otherwise right after the forward), so no flag waits for the step's
// attention, and always before the free-slot credit and any wait on the
// next step's shard: rank r's chunk then waits only on r - 1's
// retirement, which depends on r - 1's own earlier pushes and earlier
// steps, never on r. (Released only at the step's end, the flags would
// hold each rank's next step behind its upstream rank's whole step.) Bulk
// stores fit the ring: its units are 16 bytes already, and the
// slot costs no CTA an SM (f32 at hd 64: 104 KB of the SM's 228 a CTA, 2
// an SM as before).
//
// Bound: at RingAttention's defaults (n=4, BH=8, seq=4096, hd=64, causal)
// the call does the work of causal flash attention at S=4096, 17.2 GFLOP,
// so the operations bound it: f32-accurate on the tensor cores (3xTF32,
// 165 TFLOP/s) 0.104 ms on an H100 SXM (5.0 ms at BH=96, seq=8192); bf16
// at 989 TFLOP/s, 0.017 ms. Forwarding moves each K / V shard n - 1 hops
// (4 MB a rank and step at the defaults in f32): each thread keeps four
// 16-byte loads in flight, so the few CTAs of rank 0 keep their share
// moving.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attend.cuh"
#include "flags.cuh"
#include "window.cuh"

#define RING_MAXN 16

struct RingParams {
  int n, BH, Sl, hd;
  int chunk_rows;   // rows per flag chunk: kv_chunk when fused, else Sl
  int nc;           // chunks per shard: Sl / chunk_rows
  int fused, counter, pipelined, eager;
  int causal;
  int bf16;         // q, k, v, out and the buffers are bf16 (else f32)
  int cta0[RING_MAXN + 1];  // rank r's CTAs: [cta0[r], cta0[r + 1])
  int timeout_ms;
  int stall_rank;   // read only by the -DRING_TEST_STALL build (the tests'
  int stall_us;     // slowed rank): this rank's CTAs idle stall_us before
                    // each step's attention
  int contexts;     // the send window's depth: 1, 2 or 4
  int log_cap;      // events a CTA's probe log holds (-DCUCO_PROBE builds)
  float scale;
  const void* q;    // (n, BH, Sl, hd)
  const void* k;
  const void* v;
  void* out;        // (n, BH, Sl, hd)
  float* acc;       // (n, BH, Sl, hd) f32: parks accumulators between steps
  void* kbuf;       // (n, 2, BH, Sl, hd): the double buffer
  void* vbuf;
  float* ml;        // (2, n, BH, Sl): parked running max and sum
  unsigned* flag;   // (n, n, nc): elements landed per (rank, step, chunk)
  unsigned* done;   // (n): CTA-steps each rank finished (the credit)
  int* log;         // (grid, log_cap, 4): window events (-DCUCO_PROBE builds)
  int* log_n;       // (grid): events each CTA appended
};

// the send slot beside the attention tiles: PIECE 16-byte units of K, then
// of V; the window's state after it
constexpr int RING_DEPTH = 4;
constexpr int RING_PIECE = RING_DEPTH * ATT_NT;
constexpr int RING_SLOT = 2 * RING_PIECE * 16;
using RingWindow = win::Window<win::Tick>;

template <typename T, int HDP>
constexpr int ring_smem() {
  return Attn<T, HDP>::SMEM + RING_SLOT + (int)sizeof(RingWindow);
}

#define HDP_MAX 128

__device__ __forceinline__ size_t shard_elems(const RingParams& P) {
  return (size_t)P.BH * P.Sl * P.hd;
}

__device__ __forceinline__ unsigned* flag_of(const RingParams& P, int rank, int step, int c) {
  return P.flag + ((size_t)rank * P.n + step) * P.nc + c;
}

// this CTA's share (pid of cnt) of chunk c of (k, v) into (kn, vn): round
// (step, c) of the window, whose retirement ticks the receiver's flag by
// the elements it landed. Pieces of RING_PIECE units a tensor: four
// 16-byte loads of K and of V in flight a thread, staged in the slot, then
// thread 0's bulk stores, one per bh run. Index math in 32 bits (the
// wrapper bounds a chunk's elements below 2^32): a 64-bit divide a unit
// held rank 0's few CTAs to about 1 GB/s each.
template <typename T>
__device__ void forward_chunk(const RingParams& P, RingWindow& w, char* slot, int cnt,
                              const T* k, const T* v, T* kn, T* vn, int step, int c, int pid,
                              unsigned* flag) {
  constexpr int PER = 16 / sizeof(T);
  const unsigned per_bh = (unsigned)(P.chunk_rows * P.hd / PER);  // units of a bh's chunk
  const unsigned units = (unsigned)P.BH * per_bh;
  const unsigned lo = (unsigned)((unsigned long long)units * pid / cnt);
  const unsigned hi = (unsigned)((unsigned long long)units * (pid + 1) / cnt);
  const size_t bh_stride = (size_t)P.Sl * P.hd, base = (size_t)c * P.chunk_rows * P.hd;
  if (threadIdx.x == 0)
    win::push(w, win::Tick{flag, 2 * PER * (hi - lo)}, step, c, win::release_tick);
  uint4* ks = reinterpret_cast<uint4*>(slot);
  uint4* vs = ks + RING_PIECE;
  for (unsigned p0 = lo; p0 < hi; p0 += RING_PIECE) {
    const unsigned p1 = min(hi, p0 + RING_PIECE);
    uint4 kx[RING_DEPTH], vx[RING_DEPTH];
#pragma unroll
    for (int i = 0; i < RING_DEPTH; ++i) {
      const unsigned u = p0 + threadIdx.x + i * ATT_NT;
      if (u >= p1) break;
      const unsigned bh = u / per_bh;
      const size_t at = bh * bh_stride + base + (size_t)(u - bh * per_bh) * PER;
      kx[i] = __ldcg(reinterpret_cast<const uint4*>(k + at));
      vx[i] = __ldcg(reinterpret_cast<const uint4*>(v + at));
    }
    if (threadIdx.x == 0) win::wait_read_all();  // the slot's last bulk stores read it
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RING_DEPTH; ++i) {
      const unsigned u = threadIdx.x + i * ATT_NT;
      if (p0 + u >= p1) break;
      ks[u] = kx[i];
      vs[u] = vx[i];
    }
    win::fence_to_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      for (unsigned u = p0; u < p1;) {  // runs of one bh each
        const unsigned bh = u / per_bh, end = min(p1, (bh + 1) * per_bh);
        const size_t at = bh * bh_stride + base + (size_t)(u - bh * per_bh) * PER;
        win::bulk_store(kn + at, ks + (u - p0), (end - u) * 16);
        win::bulk_store(vn + at, vs + (u - p0), (end - u) * 16);
        u = end;
      }
      win::commit_piece(w);
    }
  }
}

// cta_wait, then (thread 0) the probe log's receive event (step, chunk)
__device__ __forceinline__ void recv_wait(const RingParams& P, const win::Log& lg,
                                          const unsigned* flag, unsigned target, const char* what,
                                          int step, int c) {
  cta_wait(flag, target, P.timeout_ms, "ring_attention", what, step, c);
  if (threadIdx.x == 0) win::note(lg, win::EV_RECV, step, c);
}

// Piece i of this CTA (pid of cnt), or -1: the rounds of cnt pieces go
// out in snake order (round i to pid, round i + 1 to cnt - 1 - pid), so a
// CTA holding a long causal row in one round holds a short one in the
// next (pieces run in query-tile order).
__device__ __forceinline__ int piece_of(int i, int pid, int cnt, int npieces) {
  const int p = i * cnt + (i & 1 ? cnt - 1 - pid : pid);
  return p < npieces ? p : -1;
}

// The slots of step s for rank me: the shard it reads (its own k / v in
// step 0, then slot s % 2 of its double buffer) and the next rank's slot
// it forwards into, (s + 1) % 2
template <typename T>
struct Slots {
  const T *kd, *vd;
  T *kn, *vn;
  __device__ __forceinline__ Slots(const RingParams& P, int me, int s) {
    const int nxt = (me + 1) % P.n;
    const size_t shard = shard_elems(P);
    kd = s ? reinterpret_cast<const T*>(P.kbuf) + ((size_t)me * 2 + s % 2) * shard
           : reinterpret_cast<const T*>(P.k) + me * shard;
    vd = s ? reinterpret_cast<const T*>(P.vbuf) + ((size_t)me * 2 + s % 2) * shard
           : reinterpret_cast<const T*>(P.v) + me * shard;
    kn = reinterpret_cast<T*>(P.kbuf) + ((size_t)nxt * 2 + (s + 1) % 2) * shard;
    vn = reinterpret_cast<T*>(P.vbuf) + ((size_t)nxt * 2 + (s + 1) % 2) * shard;
  }
};

// Where piece p of rank me sits: its bh, first query row q0 and rows nq
// of its shard, and its first row in the (n, BH, Sl) rows of q and out
struct PieceRows {
  size_t bh, row0, rows;
  int q0, nq;
  __device__ __forceinline__ PieceRows(const RingParams& P, int me, int p) {
    bh = p % P.BH;
    q0 = (p / P.BH) * ATT_BQ;
    nq = min(ATT_BQ, P.Sl - q0);
    row0 = ((size_t)me * P.BH + bh) * P.Sl + q0;
    rows = (size_t)P.n * P.BH * P.Sl;
  }
};

template <typename T, int HDP>
__global__ void __launch_bounds__(ATT_NT, Attn<T, HDP>::MIN_CTAS)
    ring_attention_kernel(RingParams P) {
  extern __shared__ float4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  char* slot = smem + Attn<T, HDP>::SMEM;
  RingWindow& w = *reinterpret_cast<RingWindow*>(slot + RING_SLOT);
  const win::Log lg = win::cta_log(P.log, P.log_n, P.log_cap);
  if (threadIdx.x == 0) win::open(w, P.contexts, lg);
  const int n = P.n;
  int me = 0;
  while (me + 1 < n && (int)blockIdx.x >= P.cta0[me + 1]) ++me;
  const int nxt = (me + 1) % n;
  const int pid = blockIdx.x - P.cta0[me], cnt = P.cta0[me + 1] - P.cta0[me];
  const int cnt_nxt = P.cta0[nxt + 1] - P.cta0[nxt];
  const int nqt = (P.Sl + ATT_BQ - 1) / ATT_BQ, npieces = P.BH * nqt;
  int mine = 0;
  for (int i = 0; i * cnt < npieces; ++i) mine += piece_of(i, pid, cnt, npieces) >= 0;
  const bool resident = mine == 1;  // its one piece's state stays in registers
  const unsigned chunk_flag = (unsigned)(2 * P.BH * P.chunk_rows * P.hd);
  AttnState<HDP> st;
  for (int s = 0; s < n; ++s) {
    const bool rotate = s <= n - 2;
    const int src = (me - s + n) % n;
    // the free-slot credit: the next rank is done reading the slot this
    // step writes, (s + 1) % 2, in step s - 1. Not in step 1: slot 0 is
    // first read in step 2 (step 0 reads k / v themselves), and waiting
    // there held the last rank until rank 0 had run its whole diagonal.
    if (rotate && s >= 2)
      cta_wait(&P.done[nxt], (unsigned)(cnt_nxt * s), P.timeout_ms, "ring_attention",
               "credit", nxt, s);
    // the step's drain, once its last round is pushed: then every flag of
    // the step is released as soon as its stores land, before the
    // attention goes on, any wait on the next step's shard and the credit
    bool drained = false;
    auto drain = [&]() {
      if (threadIdx.x == 0) win::drain(w, win::release_tick, s);
      drained = true;
    };
    int ticked = 0;  // fused: chunks of this step waited for and forwarded
    auto tick = [&](int upto) {
      const int step = opaque_int(s);
      const Slots<T> sl(P, me, step);
      for (; ticked <= upto; ++ticked) {
        if (step >= 1 && P.counter)
          recv_wait(P, lg, flag_of(P, me, step, ticked), chunk_flag, "chunk", step, ticked);
        if (step <= n - 2)
          forward_chunk(P, w, slot, cnt, sl.kd, sl.vd, sl.kn, sl.vn, step, ticked, pid,
                        flag_of(P, nxt, step + 1, ticked));
      }
      if (ticked == P.nc && !drained) drain();
    };
    if (P.fused) {
      if (s >= 1 && !P.counter)  // SIGNAL: drain the step's arrivals up front
        for (int c = 0; c < P.nc; ++c)
          recv_wait(P, lg, flag_of(P, me, s, c), chunk_flag, "chunk", s, c);
    } else if (rotate) {
      const Slots<T> sl(P, me, s);
      forward_chunk(P, w, slot, cnt, sl.kd, sl.vd, sl.kn, sl.vn, s, 0, pid,
                    flag_of(P, nxt, s + 1, 0));
      drain();
      if (P.eager || !P.pipelined)  // DEFERRED / eager: fenced before the compute
        recv_wait(P, lg, flag_of(P, me, s + 1, 0), chunk_flag, "shard", s + 1, 0);
    }
#ifdef RING_TEST_STALL
    if (me == P.stall_rank && threadIdx.x == 0) {
      const unsigned long long t0 = globaltimer();
      while (globaltimer() - t0 < (unsigned long long)P.stall_us * 1000ull) __nanosleep(1000);
    }
#endif
    for (int i = 0; i * cnt < npieces; ++i) {
      const int piece = piece_of(i, pid, cnt, npieces);
      if (piece < 0) continue;
      const PieceRows pr(P, me, piece);
      const int qpos0 = me * P.Sl + pr.q0, kbase = src * P.Sl;
      // keys of this shard at or before the piece's last query
      const int kend = P.causal ? max(0, min(P.Sl, qpos0 + pr.nq - kbase)) : P.Sl;
      // a parked state the step leaves as it is stays parked
      const bool parked = s > 0 && !resident && (kend > 0 || s == n - 1);
      if (s == 0)
        attn_init(st);
      else if (parked)
        attn_unpark<T, HDP>(st, smem, P.acc + pr.row0 * P.hd, P.ml + pr.row0,
                            P.ml + pr.rows + pr.row0, pr.nq, P.hd);
      const Slots<T> sl(P, me, s);
      const size_t at = pr.bh * P.Sl * P.hd;
      attn_piece<T, HDP>(st, smem, reinterpret_cast<const T*>(P.q) + pr.row0 * P.hd, pr.nq,
                         sl.kd + at, sl.vd + at, P.Sl, kend, P.hd, true, qpos0, kbase, P.causal,
                         P.scale, [&](int i) {
                           // a tile's chunks arrive (and go on) before its copy
                           const int last = i * ATT_BKV + min(ATT_BKV, P.Sl - i * ATT_BKV) - 1;
                           if (P.fused) tick(last / P.chunk_rows);
                         });
      if (P.fused) tick(P.nc - 1);  // chunks past the piece's keys
      const PieceRows po(P, me, opaque_int(piece));  // found anew: not held across the tiles
      if (s == n - 1)
        attn_store<T, HDP>(st, smem, reinterpret_cast<T*>(P.out) + po.row0 * P.hd, po.nq, P.hd,
                           true);
      else if (!resident && (s == 0 || parked))
        attn_park<T, HDP>(st, smem, P.acc + po.row0 * P.hd, P.ml + po.row0,
                          P.ml + po.rows + po.row0, po.nq, P.hd);
    }
    if (P.fused) tick(P.nc - 1);  // a CTA without a piece
    if (!drained) drain();  // a step that forwards nothing
    if (!P.fused && rotate && P.pipelined && !P.eager)  // the lazy fence
      recv_wait(P, lg, flag_of(P, me, s + 1, 0), chunk_flag, "shard", s + 1, 0);
    if (s <= n - 3) cta_signal(&P.done[me], 1u);  // slot s % 2 is free again
  }
}

template <typename T, int HDP>
static cudaError_t grid_of(int* grid, int* per_sm) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ring_attention_kernel<T, HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, ring_smem<T, HDP>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, ring_attention_kernel<T, HDP>,
                                                      ATT_NT, ring_smem<T, HDP>());
  if (e == cudaSuccess) *grid = (*per_sm) * sms;
  return e;
}

template <typename T, int HDP>
static cudaError_t launch(const RingParams* p, int grid, cudaStream_t stream) {
  void* args[] = {const_cast<RingParams*>(p)};
  const void* fn = (const void*)ring_attention_kernel<T, HDP>;
  cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, ring_smem<T, HDP>());
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(ATT_NT), args, ring_smem<T, HDP>(),
                                    stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return e;
}

extern "C" {

// Largest co-resident grid for n ranks at head dimension hd, in bf16 or
// f32 (CTAs per SM x SMs; the wrapper splits it over the ranks). Returns a
// cudaError_t, or -1 without cooperative launch, -2 when a rank would get
// no CTA, -3 for hd outside 1..128, -4 for n outside 1..RING_MAXN.
int ring_attention_grid(int n, int hd, int bf16, int* grid, int* per_sm) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return -1;
  if (hd < 1 || hd > HDP_MAX) return -3;
  if (n < 1 || n > RING_MAXN) return -4;
  if (bf16)
    e = hd <= 64 ? grid_of<__nv_bfloat16, 64>(grid, per_sm)
                 : grid_of<__nv_bfloat16, 128>(grid, per_sm);
  else
    e = hd <= 64 ? grid_of<float, 64>(grid, per_sm) : grid_of<float, 128>(grid, per_sm);
  if (e != cudaSuccess) return (int)e;
  return *grid < n ? -2 : 0;
}

// Cooperative launch: the runtime refuses a grid whose CTAs cannot all be
// resident at once, which the spin-waits require.
int ring_attention_launch(const RingParams* p, int grid, void* stream) {
  if (p->hd < 1 || p->hd > HDP_MAX) return -3;
  if (p->n < 1 || p->n > RING_MAXN || p->cta0[p->n] != grid) return -4;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (p->bf16)
    e = p->hd <= 64 ? launch<__nv_bfloat16, 64>(p, grid, s)
                    : launch<__nv_bfloat16, 128>(p, grid, s);
  else
    e = p->hd <= 64 ? launch<float, 64>(p, grid, s) : launch<float, 128>(p, grid, s);
  return (int)e;
}

const char* ring_attention_error(int code) {
  if (code == -1) return "device does not support cooperative launch";
  if (code == -2) return "fewer co-resident CTAs than ranks";
  if (code == -3) return "head dimension outside 1..128";
  if (code == -4) return "rank count outside 1..16, or a CTA table that does not cover the grid";
  return cudaGetErrorString((cudaError_t)code);
}

int ring_attention_params_size() { return (int)sizeof(RingParams); }

}  // extern "C"
