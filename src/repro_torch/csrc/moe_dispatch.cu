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
// source's FFN) or COUNTER tile-fused (per microblock arrival, combine_tile
// row GEMM tiles whose epilogue stores straight into the source's combine
// slab). Options: an int8 wire with per-row f32 scales (max|x|/127 + 1e-12,
// round half to even), and a second stream that runs the shared-expert FFN.
//
// Layout: the n ranks are n partitions of ONE cooperative launch over one
// allocation (a symmetric heap on one card). A "remote copy" is a store
// into the receiving rank's slab. Each DMA semaphore becomes a flag word:
// the sender's CTA finishes its stores, __syncthreads, __threadfence,
// atomicAdd; the receiver spins on an acquire load. Dispatch flags are per
// (receiver, source, microblock) and count rows; combine flags are per
// (receiver, expert) and count elements. The wrapper zeroes them before
// every launch on the launch stream, so a stale flag never satisfies a
// wait. Within a rank, CTAs meet at a counter barrier between GEMM1 and
// GEMM2 (the SwiGLU intermediate lives in a global scratch: 64 rows x 2f
// f32 is far beyond shared memory). Every spin gives up after timeout_ms
// with a trap, so a protocol fault fails the launch instead of hanging.
//
// Bound: at serving width (4 ranks x 256 tokens, d=7168, f=fs=2048) the
// call does ~180 GFLOP of f32 GEMM and moves ~1 GB of weights, so the f32
// (non-tensor-core) rate bounds it. This first version is a plain SIMT
// GEMM (64x64 tiles, 4x4 per thread, no wgmma, no TMA). How its time
// splits between the GEMM and the dispatch/combine stores is not measured.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#define MOE_MAXN 8
#define BM 64
#define BN 64
#define BK 16
#define NT 256

struct MoeParams {
  int n, T, Ts, d, f, fs, B, b_max, stride, ct;
  int counts[MOE_MAXN], blocks[MOE_MAXN], offsets[MOE_MAXN];
  int barrier, pipelined, tile_fused, shared, wire_i8, timeout_ms;
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
  unsigned* bar;       // (n, 2) group barrier counters
};

struct Smem {
  float As[BK][BM + 4];
  float Bg[BK][BN];
  float Bu[BK][BN];
  float red[NT / 32];
};

// ------------------------------------------------------- flags and barriers

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// one thread: spin until *p >= target; trap after the timeout
__device__ void spin_geq(const unsigned* p, unsigned target, const MoeParams& P,
                         const char* what) {
  if (ld_acquire(p) >= target) return;
  const unsigned long long t0 = globaltimer();
  const unsigned long long limit = (unsigned long long)P.timeout_ms * 1000000ull;
  while (ld_acquire(p) < target) {
    __nanosleep(64);
    if (globaltimer() - t0 > limit) {
      printf("moe_dispatch: block %d timed out on %s (have %u, want %u)\n",
             (int)blockIdx.x, what, ld_acquire(p), target);
      asm volatile("trap;");
    }
  }
}

// whole CTA: wait for a flag, then every thread may read what it covers
__device__ void cta_wait(const unsigned* p, unsigned target, const MoeParams& P,
                         const char* what) {
  if (threadIdx.x == 0) {
    spin_geq(p, target, P, what);
    __threadfence();
  }
  __syncthreads();
}

// whole CTA: publish this CTA's stores, then bump the flag (release)
__device__ void cta_signal(unsigned* p, unsigned amount) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(p, amount);
  }
}

struct Group {
  unsigned* ctr;
  int size;
  unsigned gen;
};

// every CTA of the group meets here (counter barrier, monotone generations)
__device__ void group_sync(Group& g, const MoeParams& P) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(g.ctr, 1u);
    spin_geq(g.ctr, (g.gen + 1) * (unsigned)g.size, P, "group barrier");
    __threadfence();
  }
  __syncthreads();
  g.gen++;
}

// ------------------------------------------------------------ row staging

__device__ float block_max(float v, Smem& sm) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) sm.red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = sm.red[0];
  for (int w = 1; w < NT / 32; ++w) m = fmaxf(m, sm.red[w]);
  __syncthreads();
  return m;
}

__device__ __forceinline__ signed char quant(float v, float s) {
  float r = rintf(v / s);  // round half to even, like jnp.round
  return (signed char)fminf(fmaxf(r, -127.f), 127.f);
}

// stage one token row onto the wire (src == nullptr: a zero padding row)
__device__ void stage_row(const float* src, float* dst, float*, int d, Smem&) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < d / 4; i += NT)
    d4[i] = src ? __ldg(s4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ void stage_row(const float* src, int8_t* dst, float* scale, int d, Smem& sm) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float m = 0.f;
  if (src)
    for (int i = threadIdx.x; i < d / 4; i += NT) {
      float4 v = __ldg(s4 + i);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  m = block_max(m, sm);
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

// -------------------------------------------------------------------- GEMM

// four consecutive A values of one row; slabs written by other CTAs are
// read through L2 (__ldcg), never a possibly stale L1 line
__device__ __forceinline__ float4 load_a4(const float* A, const float*, size_t row,
                                          int lda, int k) {
  return __ldcg(reinterpret_cast<const float4*>(A + row * lda + k));
}

__device__ __forceinline__ float4 load_a4(const int8_t* A, const float* S, size_t row,
                                          int lda, int k) {
  const char4 q = __ldcg(reinterpret_cast<const char4*>(A + row * lda + k));
  const float s = __ldcg(S + row);
  return make_float4(q.x * s, q.y * s, q.z * s, q.w * s);
}

// One BM x BN output tile over K. PAIRED: W holds gate columns at n0 and
// up columns at n0 + up_off (GEMM1 of SwiGLU); acc_u is then meaningful.
// A rows at or past `valid` load as zeros (the kernel's `valid` mask).
template <bool PAIRED, typename AT>
__device__ void tile_mma(const AT* A, const float* S, int lda, size_t a_row0, int valid,
                         int K, const float* W, int ldw, int n0, int up_off,
                         float (&acc_g)[4][4], float (&acc_u)[4][4], Smem& sm) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lr = tid / 4, lk = (tid % 4) * 4;     // A tile load coordinates
  const int br = tid / 16, bc = (tid % 16) * 4;   // W tile load coordinates
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_g[i][j] = acc_u[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    float4 a = lr < valid ? load_a4(A, S, a_row0 + lr, lda, k0 + lk)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    const float* wrow = W + (size_t)(k0 + br) * ldw + n0 + bc;
    sm.As[lk + 0][lr] = a.x;
    sm.As[lk + 1][lr] = a.y;
    sm.As[lk + 2][lr] = a.z;
    sm.As[lk + 3][lr] = a.w;
    *reinterpret_cast<float4*>(&sm.Bg[br][bc]) = __ldg(reinterpret_cast<const float4*>(wrow));
    if (PAIRED)
      *reinterpret_cast<float4*>(&sm.Bu[br][bc]) =
          __ldg(reinterpret_cast<const float4*>(wrow + up_off));
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.As[kk][ty * 4]);
      const float4 gv = *reinterpret_cast<const float4*>(&sm.Bg[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_g[i][j] = fmaf(ar[i], gr[j], acc_g[i][j]);
      if (PAIRED) {
        const float4 uv = *reinterpret_cast<const float4*>(&sm.Bu[kk][tx * 4]);
        const float ur[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc_u[i][j] = fmaf(ar[i], ur[j], acc_u[i][j]);
      }
    }
    __syncthreads();
  }
}

// A run of rows one GEMM covers: slab rows [a_row0, a_row0 + rows), of
// which the first `valid` are tokens; GEMM2 writes row r to out + r*N and
// (if flag) bumps flag by the elements each CTA stored.
struct Seg {
  size_t a_row0;
  int rows, valid;
  float* out;
  unsigned* flag;
};

// silu(g) * u, silu(g) = g * sigmoid(g)
__device__ __forceinline__ float swiglu(float g, float u) { return g / (1.f + expf(-g)) * u; }

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// GEMM1 + SwiGLU: H[row, c] = silu(A W[:, c]) * (A W[:, F + c]), c < F.
// Units (m tile, n tile) go round robin over the group, starting at `rot`
// so that consecutive small phases land on different CTAs.
template <typename AT>
__device__ void gemm1(const AT* A, const float* S, int lda, const Seg* segs, int nseg, int K,
                      const float* W, int F, float* H, int gid, int gsize, int& rot, Smem& sm) {
  const int ntn = F / BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float g[4][4], u[4][4];
  int unit = rot;
  for (int s = 0; s < nseg; ++s) {
    const int mt = (segs[s].rows + BM - 1) / BM;
    for (int q = 0; q < mt * ntn; ++q, ++unit) {
      if (unit % gsize != gid) continue;
      const int m0 = (q / ntn) * BM, n0 = (q % ntn) * BN;
      const int rows = min(BM, segs[s].rows - m0);
      tile_mma<true>(A, S, lda, segs[s].a_row0 + m0, clampi(segs[s].valid - m0, 0, BM), K,
                     W, 2 * F, n0, F, g, u, sm);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= rows) continue;
        const float4 o = make_float4(swiglu(g[i][0], u[i][0]), swiglu(g[i][1], u[i][1]),
                                     swiglu(g[i][2], u[i][2]), swiglu(g[i][3], u[i][3]));
        *reinterpret_cast<float4*>(H + (segs[s].a_row0 + m0 + r) * F + n0 + tx * 4) = o;
      }
    }
  }
  rot = unit;
}

// GEMM2: out[r, :] = H[row, :] W2 for r < valid, zero for valid <= r < rows
__device__ void gemm2(const float* H, const Seg* segs, int nseg, int K, const float* W, int N,
                      int gid, int gsize, int& rot, Smem& sm) {
  const int ntn = N / BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4], unused[4][4];
  int unit = rot;
  for (int s = 0; s < nseg; ++s) {
    const int mt = (segs[s].rows + BM - 1) / BM;
    for (int q = 0; q < mt * ntn; ++q, ++unit) {
      if (unit % gsize != gid) continue;
      const int m0 = (q / ntn) * BM, n0 = (q % ntn) * BN;
      const int rows = min(BM, segs[s].rows - m0);
      const int valid = clampi(segs[s].valid - m0, 0, BM);
      tile_mma<false>(H, nullptr, K, segs[s].a_row0 + m0, valid, K, W, N, n0, 0, acc,
                      unused, sm);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= rows) continue;
        const bool ok = r < valid;
        const float4 o = make_float4(ok ? acc[i][0] : 0.f, ok ? acc[i][1] : 0.f,
                                     ok ? acc[i][2] : 0.f, ok ? acc[i][3] : 0.f);
        *reinterpret_cast<float4*>(segs[s].out + (size_t)(m0 + r) * N + n0 + tx * 4) = o;
      }
      if (segs[s].flag) cta_signal(segs[s].flag, (unsigned)(rows * BN));
    }
  }
  rot = unit;
}

// ------------------------------------------------------------------ streams

// the second stream: ys = swiglu(xs, s1, s2) for this rank's tokens
__device__ void shared_stream(const MoeParams& P, int me, int gid, Group& grp, Smem& sm) {
  int rot = 0;
  const float* xs = P.xs + (size_t)me * P.Ts * P.d;
  float* hs = P.hs + (size_t)me * P.Ts * P.fs;
  const Seg sg{0, P.Ts, P.Ts, P.ys + (size_t)me * P.Ts * P.d, nullptr};
  gemm1<float>(xs, nullptr, P.d, &sg, 1, P.d, P.s1, P.fs, hs, gid, grp.size, rot, sm);
  group_sync(grp, P);
  gemm2(hs, &sg, 1, P.fs, P.s2, P.d, gid, grp.size, rot, sm);
}

// copy one f32 row written by other CTAs (combine / assembly)
__device__ void copy_row(const float* src, float* dst, int d) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < d / 4; i += NT) d4[i] = __ldcg(s4 + i);
}

// dispatch -> expert FFN -> combine -> assemble, for rank `me`
template <typename WT>
__device__ void routed(const MoeParams& P, int me, int gid, Group& grp, Smem& sm) {
  const int n = P.n, B = P.B, d = P.d, f = P.f, stride = P.stride, bmax = P.b_max;
  const size_t slab = (size_t)n * stride;
  const int gsize = grp.size;
  int rot = 0;

  // ---- dispatch: rounds (off, j) of DispatchSchedule, dummies elided.
  // Rows of successive rounds go round robin over the group; each CTA
  // stages (and quantizes) its rows straight into the expert's slab.
  int base = 0;
  for (int off = 0; off < n; ++off) {
    const int e = (me - off + n) % n;
    WT* dst = reinterpret_cast<WT*>(P.recv) + (size_t)e * slab * d;
    float* dsc = P.recv_s + (size_t)e * slab;
    for (int j = 0; j < P.blocks[e]; ++j, base += B) {
      unsigned mine = 0;
      for (int i = 0; i < B; ++i) {
        if ((base + i) % gsize != gid) continue;
        const int k = j * B + i;
        const float* src =
            k < P.counts[e] ? P.x + ((size_t)me * P.T + P.offsets[e] + k) * d : nullptr;
        const size_t row = (size_t)me * stride + k;
        stage_row(src, dst + row * d, dsc + row, d, sm);
        ++mine;
      }
      if (mine) cta_signal(&P.disp_flag[((size_t)e * n + me) * bmax + j], mine);
    }
  }

  // ---- expert FFN over the arrivals
  const int mb = P.blocks[me], cme = P.counts[me];
  const WT* recv = reinterpret_cast<const WT*>(P.recv) + (size_t)me * slab * d;
  const float* rs = P.recv_s + (size_t)me * slab;
  const float* w1 = P.w1 + (size_t)me * d * 2 * f;
  const float* w2 = P.w2 + (size_t)me * f * d;
  float* h = P.h + (size_t)me * slab * f;
  float* ffo = P.ffn_out + (size_t)me * slab * d;
  auto arrived = [&](int src, int j) {
    cta_wait(&P.disp_flag[((size_t)me * n + src) * bmax + j], (unsigned)B, P, "dispatch");
  };

  if (P.tile_fused) {
    // COUNTER: per microblock arrival, combine_tile-row tiles; GEMM2's
    // epilogue is the combine store into the source's slab
    const int ct = P.ct;
    for (int off = 0; off < n; ++off) {
      const int src = (me + off) % n;
      for (int j = 0; j < mb; ++j) {
        arrived(src, j);
        for (int t = 0; t < B / ct; ++t) {
          const int rel = j * B + t * ct;
          const Seg sg{(size_t)src * stride + rel, ct, clampi(cme - rel, 0, ct),
                       P.comb + ((size_t)src * slab + (size_t)me * stride + rel) * d,
                       &P.comb_flag[src * n + me]};
          gemm1<WT>(recv, rs, d, &sg, 1, d, w1, f, h, gid, gsize, rot, sm);
          group_sync(grp, P);
          gemm2(h, &sg, 1, f, w2, d, gid, gsize, rot, sm);
        }
      }
    }
  } else {
    Seg segs[MOE_MAXN];
    for (int s = 0; s < n; ++s) {
      const int src = (me + s) % n;
      segs[s] = Seg{(size_t)src * stride, mb * B, min(cme, mb * B),
                    ffo + (size_t)src * stride * d, nullptr};
    }
    if (P.barrier || !P.pipelined) {
      // BARRIER / DEFERRED: every edge lands before any expert compute
      for (int s = 0; s < n; ++s)
        for (int j = 0; j < mb; ++j) arrived((me + s) % n, j);
      gemm1<WT>(recv, rs, d, segs, n, d, w1, f, h, gid, gsize, rot, sm);
      group_sync(grp, P);
      gemm2(h, segs, n, f, w2, d, gid, gsize, rot, sm);
    } else {
      // SIGNAL pipelined: sources in arrival order, self edge first
      for (int s = 0; s < n; ++s) {
        for (int j = 0; j < mb; ++j) arrived((me + s) % n, j);
        gemm1<WT>(recv, rs, d, &segs[s], 1, d, w1, f, h, gid, gsize, rot, sm);
        group_sync(grp, P);
        gemm2(h, &segs[s], 1, f, w2, d, gid, gsize, rot, sm);
      }
    }
    group_sync(grp, P);  // every expert row is in ffn_out before combine reads it
    // ---- combine: reverse shift, expert me -> source (me + off) % n
    base = 0;
    for (int off = 0; off < n; ++off) {
      const int q = (me + off) % n;
      for (int j = 0; j < mb; ++j, base += B) {
        unsigned mine = 0;
        for (int i = 0; i < B; ++i) {
          if ((base + i) % gsize != gid) continue;
          const int k = j * B + i;
          copy_row(ffo + ((size_t)q * stride + k) * d,
                   P.comb + ((size_t)q * slab + (size_t)me * stride + k) * d, d);
          ++mine;
        }
        if (mine) cta_signal(&P.comb_flag[q * n + me], mine * (unsigned)d);
      }
    }
  }

  // ---- assemble: region e of my combine slab holds my tokens for expert e
  for (int e = 0; e < n; ++e)
    cta_wait(&P.comb_flag[me * n + e], (unsigned)P.blocks[e] * B * d, P, "combine");
  const float* comb = P.comb + (size_t)me * slab * d;
  for (int k = (gid + rot) % gsize; k < P.T; k += gsize) {
    int e = 0;
    while (e + 1 < n && k >= P.offsets[e + 1]) ++e;
    copy_row(comb + ((size_t)e * stride + k - P.offsets[e]) * d,
             P.y + ((size_t)me * P.T + k) * d, d);
  }
}

template <typename WT>
__global__ void __launch_bounds__(NT) moe_kernel(MoeParams P) {
  __shared__ Smem sm;
  const int per = gridDim.x / P.n;
  const int me = blockIdx.x / per, local = blockIdx.x % per;
  if (me >= P.n) return;
  const int ps = P.shared ? per / 2 : 0, pa = per - ps;
  const bool second = local >= pa;
  Group grp{P.bar + 2 * me + (second ? 1 : 0), second ? ps : pa, 0u};
  if (second)
    shared_stream(P, me, local - pa, grp, sm);
  else
    routed<WT>(P, me, local, grp, sm);
}

// ------------------------------------------------------------ C interface

static const void* kernel_for(int wire_i8) {
  return wire_i8 ? (const void*)moe_kernel<int8_t> : (const void*)moe_kernel<float>;
}

extern "C" {

// Largest co-resident grid for n ranks: (CTAs per SM) x SMs, rounded down
// to a multiple of n. Returns a cudaError_t, or -1 without cooperative
// launch, or -2 when a rank would get too few CTAs.
int moe_dispatch_grid(int n, int shared, int wire_i8, int* grid, int* per_sm) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel_for(wire_i8), NT, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return -1;
  const int per_rank = (*per_sm) * sms / n;
  *grid = per_rank * n;
  return per_rank < (shared ? 2 : 1) ? -2 : 0;
}

// Cooperative launch: the runtime refuses a grid whose CTAs cannot all be
// resident at once, which the spin-waits require.
int moe_dispatch_launch(const MoeParams* p, int grid, void* stream) {
  void* args[] = {const_cast<MoeParams*>(p)};
  cudaError_t e = cudaLaunchCooperativeKernel(kernel_for(p->wire_i8), dim3(grid), dim3(NT),
                                              args, 0, (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

const char* moe_dispatch_error(int code) {
  if (code == -1) return "device does not support cooperative launch";
  if (code == -2) return "too few co-resident CTAs for the ranks";
  return cudaGetErrorString((cudaError_t)code);
}

int moe_dispatch_params_size() { return (int)sizeof(MoeParams); }

}  // extern "C"
