// The online-softmax attention step both attention kernels run
// (flash_attention.cu, ring_attention.cu), on the tensor cores: one CTA
// of 4 warps owns a piece of up to 64 query rows and folds key tiles of up
// to 64 rows into its running max, sum and f32 accumulator, the step of
// src/repro/kernels/flash_attention.py::_fa_kernel (and of `attend` in
// src/repro/kernels/ring_attention.py::_ring_kernel).
//
// Arithmetic as in the reference: s = (q . k) * scale; a causally masked
// score is -1e30 (the reference's NEG_INF, not -inf), so a row whose keys
// are all masked so far sums exp(0) terms that the first real key wipes
// (alpha = 0). A key row past the tile's end scores -inf and adds exactly
// 0. The output is acc / max(l, 1e-30).
//
// Warps: warp w owns query rows 16w .. 16w + 15 across all HDP columns
// (hd padded with zeros to HDP, 64 or 128). S = Q K^T (16 x 64 a warp)
// and O += P V are mma.sync products with f32 accumulators in registers;
// lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of every n8
// tile, so the softmax runs on the accumulator fragments and a row's max
// and sum are two shuffles over the 4 lanes that hold it.
//
//   bf16 (m16n8k16, f32 accumulation): Q, K and V stay bf16 in shared
//   memory; Q's and K's fragments come by ldmatrix, V's by
//   ldmatrix.trans. The C layout of two adjacent n8 tiles of S is
//   the A layout of one k16 step of P, so P never touches shared memory.
//   P goes in as a bf16 hi + lo pair (two products, lo first): P rounded
//   once to bf16 is off by 2^-9 of each term, which moves an output near
//   0 over a few keys by more than one bf16 step of the plain version
//   (an f32 P). Q K^T is exact in the products (bf16 inputs).
//   f32 (3xTF32, m16n8k8, mma.cuh's split): a product only needs A's and
//   B's k to agree, so lane (g, t) takes k = 2t and 2t + 1 (tc_gemm.cuh's
//   trick). Q K^T: one 8-byte shared load of Q a row and of K a key. P V:
//   S's accumulator fragment (c0..c3 at keys 2t, 2t + 1) is P's A fragment
//   as it stands (a0 = c0, a1 = c2, a2 = c1, a3 = c3) with V's rows read in
//   the same order (b0 = V[2t], b1 = V[2t + 1]); n8 tile j of O takes the
//   columns 32 (j / 4) + 4 n + j % 4, so one 16-byte load of a V row feeds
//   four tiles. Each key tile's P V sums apart (64 keys deep, 32 columns
//   at a time) and is added to O on the f32 cores: the tensor core
//   truncates its f32 sums.
//
// Staging: K and V tiles arrive by cp.async (16 bytes a copy, through L2:
// the ring's buffers are written by other CTAs of the launch) into a
// double buffer; tile i + 1's copy is in flight while tile i computes, and
// each tile costs one __syncthreads. Rows past the tile's end and columns
// past hd are zero-filled. Without 16-byte rows (hd not a multiple of 16
// bytes, or an unaligned base) the rows load synchronously.
//
// Shared memory a CTA (rows padded for conflict-free fragment loads:
// ldmatrix rows 16 bytes apart mod 128; f32 8-byte loads of K and Q
// 8 words apart mod 32, 16-byte loads of V 4 words apart), and the CTAs
// an SM that it and __launch_bounds__ allow (bf16 at HDP 64: 3, not the
// 4 its shared memory allows, whose 128 registers spill):
//   bf16 HDP  64:  45 KB, 3 CTAs      f32 HDP  64:  88 KB, 2 CTAs
//   bf16 HDP 128:  85 KB, 2 CTAs      f32 HDP 128: 168 KB, 1 CTA
// Q stays in shared memory, its fragments loaded (and in f32 split) anew
// each tile: held in registers beside O, S and P V's partial sums they
// made ptxas spill at HDP 128 (f32) and in the ring.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

#define ATT_BQ 64       // query rows per piece
#define ATT_BKV 64      // key rows per tile
#define ATT_NT 128      // threads per CTA: 4 warps of 16 query rows
#define ATT_MASKED -1e30f
#define ATT_NEG_INF __int_as_float(0xff800000)

typedef __nv_bfloat16 bf16;

template <typename T, int HDP>
struct Attn {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int LDQ = HDP + 8, LDK = HDP + 8;  // row strides (elements)
  static constexpr int LDV = BF16 ? HDP + 8 : HDP + 4;
  static constexpr int LDO = HDP + 4;                 // staging rows (floats)
  static constexpr int Q_BYTES = ATT_BQ * LDQ * (int)sizeof(T);
  static constexpr int K_BYTES = ATT_BKV * LDK * (int)sizeof(T);
  static constexpr int V_BYTES = ATT_BKV * LDV * (int)sizeof(T);
  static constexpr int SMEM = Q_BYTES + 2 * (K_BYTES + V_BYTES);
  static constexpr int MIN_CTAS = BF16 ? (HDP <= 64 ? 3 : 2) : (HDP <= 64 ? 2 : 1);
  static_assert(ATT_BQ * LDO * 4 <= SMEM, "the output staging reuses the tiles");
  static_assert(HDP % 64 == 0, "HDP is 64 or 128");

  static __device__ __forceinline__ T* q(char* s) { return reinterpret_cast<T*>(s); }
  static __device__ __forceinline__ T* k(char* s, int b) {
    return reinterpret_cast<T*>(s + Q_BYTES + b * K_BYTES);
  }
  static __device__ __forceinline__ T* v(char* s, int b) {
    return reinterpret_cast<T*>(s + Q_BYTES + 2 * K_BYTES + b * V_BYTES);
  }
};

template <int HDP>
struct AttnState {
  float o[HDP / 8][4];  // n8 tile j; rows g (e < 2) and g + 8, columns attn_col
  float m[2], l[2];     // rows g and g + 8 (l: the whole row's sum)
};

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float ld_elem(const float* p) { return __ldcg(p); }
__device__ __forceinline__ bf16 ld_elem(const bf16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

template <typename T>
__device__ __forceinline__ T zero_elem() {
  T z;
  from_f32(&z, 0.f);
  return z;
}

// row in the CTA's 64 and column of the lane's accumulator element e of
// n8 tile j (the f32 path permutes O's columns; see the header)
__device__ __forceinline__ int attn_row(int e) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}

template <typename T>
__device__ __forceinline__ int attn_col(int j, int e) {
  const int n = 2 * (threadIdx.x & 3) + (e & 1);
  return sizeof(T) == 2 ? 8 * j + n : 32 * (j >> 2) + 4 * n + (j & 3);
}

// rows [0, nrows) of src (row stride hd) into dst (row stride LD, HDP
// columns); zeros past nrows and past hd. vec: cp.async 16 bytes a copy
// (hd a multiple of 16 bytes, src 16-byte aligned); else synchronous.
template <typename T, int HDP, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int nrows, int hd, bool vec) {
  constexpr int PER = 16 / sizeof(T);
  if (vec) {
#pragma unroll 4
    for (int i = threadIdx.x; i < 64 * (HDP / PER); i += ATT_NT) {
      const int r = i / (HDP / PER), c = (i % (HDP / PER)) * PER;
      const bool ok = r < nrows && c < hd;
      tc::cp16(dst + r * LD + c, ok ? src + (size_t)r * hd + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * HDP; i += ATT_NT) {
      const int r = i / HDP, c = i % HDP;
      dst[r * LD + c] = r < nrows && c < hd ? ld_elem(src + (size_t)r * hd + c) : zero_elem<T>();
    }
  }
}

template <int HDP>
__device__ __forceinline__ void attn_init(AttnState<HDP>& st) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.m[i] = ATT_MASKED;
    st.l[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] = 0.f;
}

// x as a value the compiler cannot see through: what a kernel derives
// from it after the tile loop is derived there, not held in registers
// beside the accumulators (ptxas spilled them)
__device__ __forceinline__ int opaque_int(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The online softmax on S's fragments (keys 8j + 2t + (e & 1) of the
// tile): scale and mask them, move the running max and sum, rescale O,
// and leave P = exp(s - m) in s. qpos: the position of the warp's row g;
// key c of the tile sits at kpos0 + c.
template <int HDP>
__device__ __forceinline__ void softmax_step(AttnState<HDP>& st, float (&s)[8][4], int nk,
                                             int kpos0, int qpos, bool causal, float scale) {
  const int t = threadIdx.x & 3;
  float mx[2] = {ATT_NEG_INF, ATT_NEG_INF};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      float x = s[j][e] * scale;
      if (c >= nk)
        x = ATT_NEG_INF;
      else if (causal && qpos + 8 * (e >> 1) < kpos0 + c)
        x = ATT_MASKED;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(st.m[h], quad_max(mx[h]));
    alpha[h] = __expf(st.m[h] - m_new);
    st.m[h] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = __expf(s[j][e] - st.m[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * alpha[h] + quad_sum(sum[h]);
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] *= alpha[e >> 1];
}

// ------------------------------------------------------------------ bf16

template <int HDP>
__device__ __forceinline__ void attn_tile(AttnState<HDP>& st, const bf16* sq, const bf16* sk,
                                          const bf16* sv, int nk, int kpos0, int qpos,
                                          bool causal, float scale) {
  constexpr int LD = Attn<bf16, HDP>::LDK;  // = LDQ = LDV
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // S = Q K^T. Q's x4 load: matrix mi is the warp's rows 8 (mi % 2), dims
  // 16 kk + 8 (mi / 2), so r[i] is a_i. K's: matrix mi is keys 16 jp +
  // 8 (mi / 2), dims 16 kk + 8 (mi % 2): b0, b1 of n8 tile 2 jp, then of
  // 2 jp + 1.
  const bf16* qp = sq + (16 * (threadIdx.x >> 5) + r + 8 * (mi & 1)) * LD + 8 * (mi >> 1);
  const bf16* kp = sk + (r + 8 * (mi >> 1)) * LD + 8 * (mi & 1);
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    unsigned a[4];
    tc::ldmatrix_x4(a, qp + 16 * kk);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      unsigned b[4];
      tc::ldmatrix_x4(b, kp + 16 * jp * LD + 16 * kk);
      tc::mma_bf16(s[2 * jp], a, b[0], b[1]);
      tc::mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
    }
  }
  softmax_step(st, s, nk, kpos0, qpos, causal, scale);
  // O += P V: matrix mi of a transposed x4 load is keys 16 kk + 8 (mi %
  // 2), dims 16 jp + 8 (mi / 2)
  const bf16* vp = sv + (r + 8 * (mi & 1)) * LD + 8 * (mi >> 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a0..a3: (tile 2kk, rows g), (2kk, g + 8), (2kk + 1, g), ...
      const float* c = &s[2 * kk + (i >> 1)][2 * (i & 1)];
      hi[i] = tc::pack_bf16(c[0], c[1]);
      const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi[i]));
      lo[i] = tc::pack_bf16(c[0] - h.x, c[1] - h.y);
    }
#pragma unroll
    for (int jp = 0; jp < HDP / 16; ++jp) {
      unsigned b[4];
      tc::ldmatrix_x4_trans(b, vp + 16 * kk * LD + 16 * jp);
      tc::mma_bf16(st.o[2 * jp], lo, b[0], b[1]);
      tc::mma_bf16(st.o[2 * jp], hi, b[0], b[1]);
      tc::mma_bf16(st.o[2 * jp + 1], lo, b[2], b[3]);
      tc::mma_bf16(st.o[2 * jp + 1], hi, b[2], b[3]);
    }
  }
}

// ------------------------------------------------------------------- f32

template <int HDP>
__device__ __forceinline__ void attn_tile(AttnState<HDP>& st, const float* sq, const float* sk,
                                          const float* sv, int nk, int kpos0, int qpos,
                                          bool causal, float scale) {
  using L = Attn<float, HDP>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // S = Q K^T, k = 2t and 2t + 1 of each 8-deep step
  const float* qa = sq + (16 * (threadIdx.x >> 5) + g) * L::LDQ + 2 * t;
  const float* kb = sk + g * L::LDK + 2 * t;
#pragma unroll 1
  for (int kk = 0; kk < HDP; kk += 8) {
    const float2 x0 = *reinterpret_cast<const float2*>(qa + kk);
    const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * L::LDQ + kk);
    unsigned ah[4], al[4];
    tc::split_tf32(x0.x, ah[0], al[0]);
    tc::split_tf32(x1.x, ah[1], al[1]);
    tc::split_tf32(x0.y, ah[2], al[2]);
    tc::split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 y = *reinterpret_cast<const float2*>(kb + 8 * j * L::LDK + kk);
      unsigned bh[2], bl[2];
      tc::split_tf32(y.x, bh[0], bl[0]);
      tc::split_tf32(y.y, bh[1], bl[1]);
      tc::mma_tf32(s[j], al, bh);
      tc::mma_tf32(s[j], ah, bl);
      tc::mma_tf32(s[j], ah, bh);
    }
  }
  softmax_step(st, s, nk, kpos0, qpos, causal, scale);
  // O += P V, 32 columns of O at a time (n8 tiles 4h .. 4h + 3; their
  // partial sums in part)
  const float* vb = sv + 2 * t * L::LDV + 4 * g;
#pragma unroll
  for (int h = 0; h < HDP / 32; ++h) {
    float part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // keys 8j .. 8j + 7
      unsigned ah[4], al[4];
      tc::split_tf32(s[j][0], ah[0], al[0]);
      tc::split_tf32(s[j][2], ah[1], al[1]);
      tc::split_tf32(s[j][1], ah[2], al[2]);
      tc::split_tf32(s[j][3], ah[3], al[3]);
      const float* v0 = vb + 8 * j * L::LDV + 32 * h;
      const float4 b0 = *reinterpret_cast<const float4*>(v0);
      const float4 b1 = *reinterpret_cast<const float4*>(v0 + L::LDV);
      const float r0[4] = {b0.x, b0.y, b0.z, b0.w}, r1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        unsigned bh[2], bl[2];
        tc::split_tf32(r0[jj], bh[0], bl[0]);
        tc::split_tf32(r1[jj], bh[1], bl[1]);
        tc::mma_tf32(part[jj], al, bh);
        tc::mma_tf32(part[jj], ah, bl);
        tc::mma_tf32(part[jj], ah, bh);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.o[4 * h + j][e] += part[j][e];
  }
}

// --------------------------------------------------------------- a piece

// Fold key rows [0, kend) of k / v (row stride hd; krows rows in all, key
// c at position kpos0 + c) into the state of the CTA's queries: rows
// [0, nq) of q, row r at position qpos0 + r. before_issue(i) runs, on
// every thread, before tile i's copy is issued (the ring waits for the
// tile's chunk there). Every thread of the CTA calls it.
template <typename T, int HDP, typename Hook>
__device__ void attn_piece(AttnState<HDP>& st, char* smem, const T* q, int nq, const T* k,
                           const T* v, int krows, int kend, int hd, bool vec, int qpos0,
                           int kpos0, bool causal, float scale, Hook before_issue) {
  using L = Attn<T, HDP>;
  const int ntiles = (kend + ATT_BKV - 1) / ATT_BKV;
  if (ntiles == 0) return;
  __syncthreads();  // the previous piece (or staging) is done with smem
  stage_rows<T, HDP, L::LDQ>(L::q(smem), q, nq, hd, vec);
  const auto issue = [&](int i) {
    before_issue(i);
    const int nk = min(ATT_BKV, krows - i * ATT_BKV);
    const size_t at = (size_t)i * ATT_BKV * hd;
    stage_rows<T, HDP, L::LDK>(L::k(smem, i & 1), k + at, nk, hd, vec);
    stage_rows<T, HDP, L::LDV>(L::v(smem, i & 1), v + at, nk, hd, vec);
    tc::cp_commit();
  };
  issue(0);
  const int qpos = qpos0 + attn_row(0);
  for (int i = 0; i < ntiles; ++i) {
    tc::cp_wait<0>();
    __syncthreads();  // tile i landed for every thread; tile i - 1's buffer is free
    if (i + 1 < ntiles) issue(i + 1);
    attn_tile(st, L::q(smem), L::k(smem, i & 1), L::v(smem, i & 1),
              min(ATT_BKV, krows - i * ATT_BKV), kpos0 + i * ATT_BKV, qpos, causal, scale);
  }
}

// ------------------------------------------------------- out of the CTA

// the state's O (divided by max(l, 1e-30) when `normalize`) into the
// staging rows at the start of smem, after every warp is done with it
template <typename T, int HDP>
__device__ __forceinline__ float* stage_out(const AttnState<HDP>& st, char* smem, bool normalize) {
  float* so = reinterpret_cast<float*>(smem);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      so[attn_row(e) * Attn<T, HDP>::LDO + attn_col<T>(j, e)] =
          normalize ? st.o[j][e] / fmaxf(st.l[e >> 1], 1e-30f) : st.o[j][e];
  __syncthreads();
  return so;
}

// rows [0, nq) of the staged rows into out (row stride hd) as U; vec: four
// elements a store (hd a multiple of 4, out aligned to four elements)
template <int HDP, typename U>
__device__ __forceinline__ void copy_out(const float* so, U* out, int nq, int hd, bool vec) {
  constexpr int LDO = HDP + 4;
  if (vec) {
    for (int i = threadIdx.x; i < nq * (HDP / 4); i += ATT_NT) {
      const int r = i / (HDP / 4), c = 4 * (i % (HDP / 4));
      if (c >= hd) continue;
      const float4 x = *reinterpret_cast<const float4*>(so + r * LDO + c);
      if constexpr (sizeof(U) == 4) {
        *reinterpret_cast<float4*>(out + (size_t)r * hd + c) = x;
      } else {
        uint2 u;
        u.x = tc::pack_bf16(x.x, x.y);
        u.y = tc::pack_bf16(x.z, x.w);
        *reinterpret_cast<uint2*>(out + (size_t)r * hd + c) = u;
      }
    }
  } else {
    for (int i = threadIdx.x; i < nq * hd; i += ATT_NT)
      from_f32(out + i, so[(i / hd) * LDO + i % hd]);
  }
}

// rows [0, nq) of the normalized output, acc / max(l, 1e-30), into out
// (row stride hd) in T
template <typename T, int HDP>
__device__ void attn_store(const AttnState<HDP>& st, char* smem, T* out, int nq, int hd,
                           bool vec) {
  copy_out<HDP>(stage_out<T, HDP>(st, smem, true), out, nq, hd, vec);
}

// Park the state of rows [0, nq) between ring steps: the accumulator into
// acc (row stride hd, a multiple of 4), the max and sum into m and l.
template <typename T, int HDP>
__device__ void attn_park(const AttnState<HDP>& st, char* smem, float* acc, float* m, float* l,
                          int nq, int hd) {
  if ((threadIdx.x & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = attn_row(2 * h);
      if (r < nq) {
        m[r] = st.m[h];
        l[r] = st.l[h];
      }
    }
  copy_out<HDP>(stage_out<T, HDP>(st, smem, false), acc, nq, hd, true);
}

// The state attn_park left (rows past nq start fresh)
template <typename T, int HDP>
__device__ void attn_unpark(AttnState<HDP>& st, char* smem, const float* acc, const float* m,
                            const float* l, int nq, int hd) {
  constexpr int LDO = HDP + 4;
  float* so = reinterpret_cast<float*>(smem);
  __syncthreads();  // every warp is done with smem
  for (int i = threadIdx.x; i < nq * (HDP / 4); i += ATT_NT) {
    const int r = i / (HDP / 4), c = 4 * (i % (HDP / 4));
    *reinterpret_cast<float4*>(so + r * LDO + c) =
        c < hd ? __ldcg(reinterpret_cast<const float4*>(acc + (size_t)r * hd + c))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  attn_init(st);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = attn_row(2 * h);
    if (r < nq) {
      st.m[h] = __ldcg(m + r);
      st.l[h] = __ldcg(l + r);
    }
  }
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (attn_row(e) < nq) st.o[j][e] = so[attn_row(e) * LDO + attn_col<T>(j, e)];
}
