// The online-softmax attention step both attention kernels run
// (flash_attention.cu, ring_attention.cu): one CTA of 256 threads owns a
// tile of up to 64 query rows and folds key tiles of up to 64 rows into
// its running max, sum and f32 accumulator, the step of
// src/repro/kernels/flash_attention.py::_fa_kernel (and of `attend` in
// src/repro/kernels/ring_attention.py::_ring_kernel).
//
// Arithmetic as in the reference: s = (q . k) * scale; a causally masked
// score is -1e30 (the reference's NEG_INF, not -inf), so a row whose keys
// are all masked so far sums exp(0) terms that the first real key wipes
// (alpha = 0). A key row past the tile's end scores -inf and adds exactly
// 0. The row max and sum are shuffles over the 16 threads of a row group.
//
// Thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16 i and key
// columns tx + 16 j (i, j < 4) of the 64 x 64 score tile, and output
// columns 64 c + 4 tx .. + 3 (c < HDP / 64). Rows of q, k and v sit in
// shared memory padded to HDP + 4 floats, so the 16-byte loads of a
// quarter warp fall in distinct banks; P reuses k's rows once the scores
// are formed. hd is padded with zeros to HDP (64 or 128).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define ATT_BQ 64       // query rows per tile
#define ATT_BKV 64      // key rows per tile
#define ATT_NT 256      // threads per CTA
#define ATT_MASKED -1e30f
#define ATT_NEG_INF __int_as_float(0xff800000)

template <int HDP>
struct AttnSmem {
  float q[ATT_BQ][HDP + 4];
  float k[ATT_BKV][HDP + 4];  // the tile's P (64 x 68 floats) once S is formed
  float v[ATT_BKV][HDP + 4];
};

template <int HDP>
struct AttnState {
  float o[4][HDP / 16];  // rows ty + 16 i; columns 64 (e / 4) + 4 tx + e % 4
  float m[4], l[4];
};

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// four elements p[0..4) as floats, read through L2 (the ring's buffers are
// written by other CTAs during the launch); `avail` elements are in range
__device__ __forceinline__ float4 load4(const float* p, int avail, bool vec) {
  if (vec && avail >= 4) return __ldcg(reinterpret_cast<const float4*>(p));
  float e[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < 4 && i < avail; ++i) e[i] = __ldcg(p + i);
  return make_float4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int avail, bool vec) {
  if (vec && avail >= 4) {
    const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  float e[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < 4 && i < avail; ++i)
    e[i] = __bfloat162float(__ushort_as_bfloat16(__ldcg(s + i)));
  return make_float4(e[0], e[1], e[2], e[3]);
}

// rows [0, nrows) of src (row stride hd) into dst[64][HDP + 4]; zeros past
// nrows and past hd
template <int HDP, typename T>
__device__ void load_rows(float (*dst)[HDP + 4], const T* src, int nrows, int hd, bool vec) {
  for (int idx = threadIdx.x; idx < 64 * (HDP / 4); idx += ATT_NT) {
    const int r = idx / (HDP / 4), c = 4 * (idx % (HDP / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows && c < hd) x = load4(src + (size_t)r * hd + c, hd - c, vec);
    *reinterpret_cast<float4*>(&dst[r][c]) = x;
  }
}

template <int HDP>
__device__ __forceinline__ void attn_init(AttnState<HDP>& st) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.m[i] = ATT_MASKED;
    st.l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < HDP / 16; ++e) st.o[i][e] = 0.f;
  }
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Fold key rows [0, nk) of kp / vp (row stride hd; nk <= 64) into the
// state. Query row r sits at position qpos0 + r, key row c at kpos0 + c;
// under `causal` a key after the query is masked. sm.q holds the queries.
template <int HDP, typename T>
__device__ void attn_tile(AttnState<HDP>& st, AttnSmem<HDP>& sm, const T* kp, const T* vp,
                          int nk, int hd, bool vec, long long kpos0, long long qpos0,
                          bool causal, float scale) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  __syncthreads();  // the previous tile's P and v are consumed
  load_rows<HDP>(sm.k, kp, nk, hd, vec);
  load_rows<HDP>(sm.v, vp, nk, hd, vec);
  __syncthreads();
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&sm.q[ty + 16 * i][d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(&sm.k[tx + 16 * j][d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long qpos = qpos0 + ty + 16 * i;
    float mx = ATT_NEG_INF;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float x = s[i][j] * scale;
      if (c >= nk)
        x = ATT_NEG_INF;
      else if (causal && qpos < kpos0 + c)
        x = ATT_MASKED;
      s[i][j] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(st.m[i], row_max(mx));
    const float alpha = __expf(st.m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = __expf(s[i][j] - m_new);
      sum += s[i][j];
    }
    st.l[i] = st.l[i] * alpha + row_sum(sum);
    st.m[i] = m_new;
#pragma unroll
    for (int e = 0; e < HDP / 16; ++e) st.o[i][e] *= alpha;
  }
  __syncthreads();  // every thread has read k: its rows become P
  float (*p)[ATT_BKV + 4] = reinterpret_cast<float (*)[ATT_BKV + 4]>(&sm.k[0][0]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[ty + 16 * i][tx + 16 * j] = s[i][j];
  __syncthreads();
  const int nk4 = (nk + 3) & ~3;  // P and v are zero past nk
  for (int j = 0; j < nk4; j += 4) {
    float4 pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(&p[ty + 16 * i][j]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int c = 0; c < HDP / 64; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&sm.v[j + jj][64 * c + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = jj == 0 ? pr[i].x : jj == 1 ? pr[i].y : jj == 2 ? pr[i].z : pr[i].w;
          st.o[i][4 * c + 0] = fmaf(w, vv.x, st.o[i][4 * c + 0]);
          st.o[i][4 * c + 1] = fmaf(w, vv.y, st.o[i][4 * c + 1]);
          st.o[i][4 * c + 2] = fmaf(w, vv.z, st.o[i][4 * c + 2]);
          st.o[i][4 * c + 3] = fmaf(w, vv.w, st.o[i][4 * c + 3]);
        }
      }
    }
  }
}

// output column of the state's element e for this thread
__device__ __forceinline__ int attn_col(int e) {
  return 64 * (e / 4) + 4 * (threadIdx.x % 16) + e % 4;
}

// rows [0, nq) of the normalized output, acc / max(l, 1e-30), into out
// (row stride hd) in T
template <int HDP, typename T>
__device__ void attn_store(const AttnState<HDP>& st, T* out, int nq, int hd) {
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const float l = fmaxf(st.l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < HDP / 16; ++e) {
      const int c = attn_col(e);
      if (c < hd) from_f32(out + (size_t)r * hd + c, st.o[i][e] / l);
    }
  }
}
