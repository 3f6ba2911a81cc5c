// Context-parallel ring attention for Hopper (sm_90a): rank r holds the
// query, key and value shards of rows [r*Sl, (r+1)*Sl) of one sequence;
// the key/value shards rotate one hop per step (r -> r+1) and every rank
// folds each shard it holds into its queries' online softmax.
//
// Replaces src/repro/kernels/ring_attention.py::_ring_kernel (the Pallas
// kernel behind ring_attention_sharded and ring_attention). It computes
// the same function in f32: the attend step is _fa_kernel's (attend.cuh),
// masked scores -1e30, the output acc / max(l, 1e-30).
//
// Layout: the n ranks are n partitions of ONE cooperative launch over one
// allocation (CTA b is rank b % n). Each rank's CTAs own (bh, 64-row
// query tile) pieces of its Q shard. In step s a rank attends to the
// shard that started on rank (r - s) % n: at step 0 its own k / v, after
// that slot s % 2 of its double buffer (kbuf / vbuf, (n, 2, BH, Sl, hd)).
// In step s it also forwards what it holds into the next rank's slot
// (s + 1) % 2: each CTA stores its share of each chunk (rows
// [c*kv_chunk, (c+1)*kv_chunk) of every bh), then ticks a flag word per
// (receiving rank, step, chunk) by the elements landed (flags.cuh).
// Realizations, as _ring_kernel orders them:
//   fused COUNTER  chunk by chunk: wait chunk c's arrival just before the
//                  first key tile that needs it, forward it, attend;
//   fused SIGNAL   wait all of the step's chunks first, then the same;
//   pipelined      one whole-shard round per step: forward, attend, then
//                  wait for the next step's shard (the lazy fence);
//   deferred/eager forward, wait for the next step's shard, then attend.
// The free-slot credit is required on the card, not a window: before it
// forwards in step s >= 1 a CTA waits until every CTA of the next rank has
// finished step s - 1 (a per-rank counter the CTAs bump after steps s <=
// n - 3), since the slot it writes is the one that rank read then. A key
// tile fully masked for a piece's queries is skipped, as _fa_kernel skips
// masked kv blocks; that is exact, since every query row meets an
// unmasked key in step 0's first tile (its own shard), so its running max
// is finite before any masked tile comes. A CTA holding one piece keeps
// its softmax state in registers across steps; one holding several parks
// it between steps in `out` (the accumulator) and `ml` (max and sum). The
// reference's `contexts` send window has no counterpart: a store and its
// flag retire as they issue (ROADMAP queue 3). The wrapper zeroes the
// flags and counters on the launch stream before every launch.
//
// Bound: at RingAttention's defaults (n=4, BH=8, seq=4096, hd=64, causal)
// the call does the work of causal flash attention at S=4096, 17.2 GFLOP
// of f32, so the f32 (non-tensor-core) rate bounds it: 0.256 ms on an H100
// SXM (12.3 ms at BH=96, seq=8192). Causal work is uneven across ranks
// (rank r attends to r + 1/2 shards' worth) while the CTAs split evenly.
// This first version runs on the SIMT cores (no wgmma, no TMA).
#include <cuda_runtime.h>
#include <stdint.h>

#include "attend.cuh"
#include "flags.cuh"

struct RingParams {
  int n, BH, Sl, hd;
  int chunk_rows;   // rows per flag chunk: kv_chunk when fused, else Sl
  int nc;           // chunks per shard: Sl / chunk_rows
  int fused, counter, pipelined, eager;
  int causal, vec;
  int per_rank;     // CTAs per rank
  int timeout_ms;
  int stall_rank;   // read only by the -DRING_TEST_STALL build (the tests'
  int stall_us;     // slowed rank): this rank's CTAs idle stall_us before
                    // each step's attention
  float scale;
  const float* q;   // (n, BH, Sl, hd)
  const float* k;
  const float* v;
  float* out;       // (n, BH, Sl, hd); parks accumulators between steps
  float* kbuf;      // (n, 2, BH, Sl, hd): the double buffer
  float* vbuf;
  float* ml;        // (2, n, BH, Sl): parked running max and sum
  unsigned* flag;   // (n, n, nc): elements landed per (rank, step, chunk)
  unsigned* done;   // (n): CTA-steps each rank finished (the credit)
};

#define HDP_MAX 128

__device__ __forceinline__ size_t shard_elems(const RingParams& P) {
  return (size_t)P.BH * P.Sl * P.hd;
}

__device__ __forceinline__ unsigned* flag_of(const RingParams& P, int rank, int step, int c) {
  return P.flag + ((size_t)rank * P.n + step) * P.nc + c;
}

// this CTA's share of chunk c of (k, v) into (kn, vn), then its tick of
// the receiver's flag for `step`
__device__ void forward_chunk(const RingParams& P, const float* k, const float* v, float* kn,
                              float* vn, int c, int pid, unsigned* flag) {
  const size_t per_bh = (size_t)P.chunk_rows * P.hd;
  const size_t units = P.BH * per_bh / 4;  // hd % 4 == 0 (the wrapper checks)
  const size_t lo = units * pid / P.per_rank, hi = units * (pid + 1) / P.per_rank;
  for (size_t u = lo + threadIdx.x; u < hi; u += ATT_NT) {
    const size_t e = 4 * u, bh = e / per_bh;
    const size_t at = (bh * P.Sl + (size_t)c * P.chunk_rows) * P.hd + e % per_bh;
    *reinterpret_cast<float4*>(kn + at) = __ldcg(reinterpret_cast<const float4*>(k + at));
    *reinterpret_cast<float4*>(vn + at) = __ldcg(reinterpret_cast<const float4*>(v + at));
  }
  cta_signal(flag, (unsigned)(8 * (hi - lo)));
}

template <int HDP>
__device__ void park(const RingParams& P, const AttnState<HDP>& st, size_t row0, int nq) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t rows = (size_t)P.n * P.BH * P.Sl;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    if (tx == 0) {
      P.ml[row0 + r] = st.m[i];
      P.ml[rows + row0 + r] = st.l[i];
    }
#pragma unroll
    for (int e = 0; e < HDP / 16; ++e)
      if (attn_col(e) < P.hd) P.out[(row0 + r) * P.hd + attn_col(e)] = st.o[i][e];
  }
}

template <int HDP>
__device__ void unpark(const RingParams& P, AttnState<HDP>& st, size_t row0, int nq) {
  const int ty = threadIdx.x / 16;
  const size_t rows = (size_t)P.n * P.BH * P.Sl;
  attn_init(st);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    st.m[i] = P.ml[row0 + r];
    st.l[i] = P.ml[rows + row0 + r];
#pragma unroll
    for (int e = 0; e < HDP / 16; ++e)
      if (attn_col(e) < P.hd) st.o[i][e] = P.out[(row0 + r) * P.hd + attn_col(e)];
  }
}

// Two CTAs per SM at hd <= 64 (at most 128 registers a thread): left to
// itself ptxas takes up to 182, one CTA a SM, and the ring runs 35% slower.
template <int HDP>
__global__ void __launch_bounds__(ATT_NT, HDP <= 64 ? 2 : 1)
    ring_attention_kernel(RingParams P) {
  extern __shared__ float4 smem_raw[];
  AttnSmem<HDP>& sm = *reinterpret_cast<AttnSmem<HDP>*>(smem_raw);
  const int n = P.n, me = blockIdx.x % n, pid = blockIdx.x / n, nxt = (me + 1) % n;
  const size_t shard = shard_elems(P);
  const int nqt = (P.Sl + ATT_BQ - 1) / ATT_BQ, npieces = P.BH * nqt;
  const bool resident = npieces - pid > 0 && npieces - pid <= P.per_rank;  // one piece
  const unsigned chunk_flag = (unsigned)(2 * P.BH * P.chunk_rows * P.hd);
  AttnState<HDP> st;
  for (int s = 0; s < n; ++s) {
    const bool rotate = s <= n - 2;
    const int src = (me - s + n) % n;
    const float* kd = s ? P.kbuf + ((size_t)me * 2 + s % 2) * shard : P.k + me * shard;
    const float* vd = s ? P.vbuf + ((size_t)me * 2 + s % 2) * shard : P.v + me * shard;
    float* kn = P.kbuf + ((size_t)nxt * 2 + (s + 1) % 2) * shard;
    float* vn = P.vbuf + ((size_t)nxt * 2 + (s + 1) % 2) * shard;
    if (rotate && s >= 1)  // the free-slot credit: the next rank is done reading
      cta_wait(&P.done[nxt], (unsigned)(P.per_rank * s), P.timeout_ms, "ring_attention",
               "credit", nxt, s);
    int ticked = 0;  // fused: chunks of this step waited for and forwarded
    auto tick = [&](int upto) {
      for (; ticked <= upto; ++ticked) {
        if (s >= 1 && P.counter)
          cta_wait(flag_of(P, me, s, ticked), chunk_flag, P.timeout_ms, "ring_attention",
                   "chunk", s, ticked);
        if (rotate)
          forward_chunk(P, kd, vd, kn, vn, ticked, pid, flag_of(P, nxt, s + 1, ticked));
      }
    };
    if (P.fused) {
      if (s >= 1 && !P.counter)  // SIGNAL: drain the step's arrivals up front
        for (int c = 0; c < P.nc; ++c)
          cta_wait(flag_of(P, me, s, c), chunk_flag, P.timeout_ms, "ring_attention", "chunk",
                   s, c);
    } else if (rotate) {
      forward_chunk(P, kd, vd, kn, vn, 0, pid, flag_of(P, nxt, s + 1, 0));
      if (P.eager || !P.pipelined)  // DEFERRED / eager: fenced before the compute
        cta_wait(flag_of(P, me, s + 1, 0), chunk_flag, P.timeout_ms, "ring_attention",
                 "shard", s + 1, 0);
    }
#ifdef RING_TEST_STALL
    if (me == P.stall_rank && threadIdx.x == 0) {
      const unsigned long long t0 = globaltimer();
      while (globaltimer() - t0 < (unsigned long long)P.stall_us * 1000ull) __nanosleep(1000);
    }
#endif
    for (int piece = pid; piece < npieces; piece += P.per_rank) {
      const int bh = piece % P.BH, q0 = (piece / P.BH) * ATT_BQ;
      const int nq = min(ATT_BQ, P.Sl - q0);
      const size_t row0 = ((size_t)me * P.BH + bh) * P.Sl + q0;
      if (s == 0)
        attn_init(st);
      else if (!resident)
        unpark(P, st, row0, nq);
      load_rows<HDP>(sm.q, P.q + row0 * P.hd, nq, P.hd, P.vec);
      const long long qpos0 = (long long)me * P.Sl + q0, kbase = (long long)src * P.Sl;
      // keys of this shard at or before the piece's last query
      const int kend = P.causal ? (int)max(0LL, min((long long)P.Sl, qpos0 + nq - kbase))
                                : P.Sl;
      for (int k0 = 0; k0 < P.Sl; k0 += ATT_BKV) {
        const int nk = min(ATT_BKV, P.Sl - k0);
        if (P.fused) tick((k0 + nk - 1) / P.chunk_rows);
        if (k0 >= kend) continue;
        const size_t at = ((size_t)bh * P.Sl + k0) * P.hd;
        attn_tile(st, sm, kd + at, vd + at, nk, P.hd, P.vec, kbase + k0, qpos0, P.causal,
                  P.scale);
      }
      if (s == n - 1)
        attn_store(st, P.out + row0 * P.hd, nq, P.hd);
      else if (!resident)
        park(P, st, row0, nq);
    }
    if (P.fused) tick(P.nc - 1);  // chunks no piece of this CTA reached
    if (!P.fused && rotate && P.pipelined && !P.eager)  // the lazy fence
      cta_wait(flag_of(P, me, s + 1, 0), chunk_flag, P.timeout_ms, "ring_attention", "shard",
               s + 1, 0);
    if (s <= n - 3) cta_signal(&P.done[me], 1u);  // slot s % 2 is free again
  }
}

template <int HDP>
static int smem_bytes() { return (int)sizeof(AttnSmem<HDP>); }

template <int HDP>
static cudaError_t grid_of(int n, int* grid, int* per_sm) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ring_attention_kernel<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<HDP>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, ring_attention_kernel<HDP>, ATT_NT,
                                                      smem_bytes<HDP>());
  if (e == cudaSuccess) *grid = (*per_sm) * sms / n * n;
  return e;
}

extern "C" {

// Largest co-resident grid for n ranks at head dimension hd (a multiple of
// n). Returns a cudaError_t, or -1 without cooperative launch, -2 when a
// rank would get no CTA, -3 for hd outside 1..128.
int ring_attention_grid(int n, int hd, int* grid, int* per_sm) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return -1;
  if (hd < 1 || hd > HDP_MAX) return -3;
  e = hd <= 64 ? grid_of<64>(n, grid, per_sm) : grid_of<128>(n, grid, per_sm);
  if (e != cudaSuccess) return (int)e;
  return *grid < n ? -2 : 0;
}

// Cooperative launch: the runtime refuses a grid whose CTAs cannot all be
// resident at once, which the spin-waits require.
int ring_attention_launch(const RingParams* p, int grid, void* stream) {
  if (p->hd < 1 || p->hd > HDP_MAX) return -3;
  void* args[] = {const_cast<RingParams*>(p)};
  const void* fn = p->hd <= 64 ? (const void*)ring_attention_kernel<64>
                               : (const void*)ring_attention_kernel<128>;
  const int smem = p->hd <= 64 ? smem_bytes<64>() : smem_bytes<128>();
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(ATT_NT), args, smem,
                                    (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

const char* ring_attention_error(int code) {
  if (code == -1) return "device does not support cooperative launch";
  if (code == -2) return "fewer co-resident CTAs than ranks";
  if (code == -3) return "head dimension outside 1..128";
  return cudaGetErrorString((cudaError_t)code);
}

int ring_attention_params_size() { return (int)sizeof(RingParams); }

}  // extern "C"
