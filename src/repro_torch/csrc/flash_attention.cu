// Blockwise flash attention for Hopper (sm_90a): out = softmax(q k^T *
// scale [+ causal mask]) v per (batch*head), with an online softmax.
//
// Replaces src/repro/kernels/flash_attention.py::_fa_kernel (the Pallas
// kernel behind flash_attention). It computes the same function: scores,
// running max, sum and accumulator in f32, masked scores -1e30, the output
// acc / max(l, 1e-30) stored in q's dtype (f32 or bf16 in, same out).
//
// Design: one CTA per (bh, 64-row query tile), where the Pallas grid ran
// its kv axis in order on one core: here a loop inside the CTA walks the
// key tiles (attend.cuh) and, under `causal`, stops at the tile holding
// the tile's last query, as _fa_kernel skips fully masked kv blocks (a
// fully masked tile after the first would add exactly 0). The longest
// causal rows are scheduled first, so the short ones fill the tail. The
// q_block / kv_block of the reference shape only its grid; the wrapper
// keeps its divisibility checks and the kernel always tiles 64 x 64.
//
// Bound: at (BH 8, S 4096, hd 64) the call does 17.2 GFLOP causal (34.4
// non-causal) of f32 against 33.6 MB of traffic (f32), so the f32
// (non-tensor-core) rate bounds it: 0.256 ms causal on an H100 SXM. This
// first version runs on the SIMT cores (no wgmma, no TMA).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attend.cuh"

struct FlashParams {
  int BH, S, Skv, hd;
  int causal;
  int bf16;       // q, k, v and out are bf16 (else f32)
  int vec;        // hd a multiple of 4 and aligned bases: vector loads
  float scale;
  const void* q;  // (BH, S, hd)
  const void* k;  // (BH, Skv, hd)
  const void* v;  // (BH, Skv, hd)
  void* out;      // (BH, S, hd)
};

template <int HDP, typename T>
__global__ void __launch_bounds__(ATT_NT) flash_attention_kernel(FlashParams P) {
  extern __shared__ float4 smem_raw[];
  AttnSmem<HDP>& sm = *reinterpret_cast<AttnSmem<HDP>*>(smem_raw);
  const int nqt = (P.S + ATT_BQ - 1) / ATT_BQ;
  const int bh = blockIdx.x % P.BH;
  const int q0 = (nqt - 1 - (int)blockIdx.x / P.BH) * ATT_BQ;  // longest rows first
  const int nq = min(ATT_BQ, P.S - q0);
  const T* q = reinterpret_cast<const T*>(P.q) + ((size_t)bh * P.S + q0) * P.hd;
  const T* k = reinterpret_cast<const T*>(P.k) + (size_t)bh * P.Skv * P.hd;
  const T* v = reinterpret_cast<const T*>(P.v) + (size_t)bh * P.Skv * P.hd;
  load_rows<HDP>(sm.q, q, nq, P.hd, P.vec);
  AttnState<HDP> st;
  attn_init(st);
  const int kend = P.causal ? min(P.Skv, q0 + nq) : P.Skv;
  for (int k0 = 0; k0 < kend; k0 += ATT_BKV)
    attn_tile(st, sm, k + (size_t)k0 * P.hd, v + (size_t)k0 * P.hd, min(ATT_BKV, P.Skv - k0),
              P.hd, P.vec, k0, q0, P.causal, P.scale);
  attn_store(st, reinterpret_cast<T*>(P.out) + ((size_t)bh * P.S + q0) * P.hd, nq, P.hd);
}

template <int HDP, typename T>
static cudaError_t launch(const FlashParams* p, cudaStream_t stream) {
  const int smem = (int)sizeof(AttnSmem<HDP>);
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<HDP, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int nqt = (p->S + ATT_BQ - 1) / ATT_BQ;
  flash_attention_kernel<HDP, T><<<p->BH * nqt, ATT_NT, smem, stream>>>(*p);
  return cudaGetLastError();
}

extern "C" {

// Launch on `stream`; hd <= 128. Returns a cudaError_t, or -1 for an hd
// the kernel does not take.
int flash_attention_launch(const FlashParams* p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (p->hd < 1 || p->hd > 128) return -1;
  if (p->hd <= 64)
    return (int)(p->bf16 ? launch<64, __nv_bfloat16>(p, s) : launch<64, float>(p, s));
  return (int)(p->bf16 ? launch<128, __nv_bfloat16>(p, s) : launch<128, float>(p, s));
}

const char* flash_attention_error(int code) {
  if (code == -1) return "head dimension outside 1..128";
  return cudaGetErrorString((cudaError_t)code);
}

int flash_attention_params_size() { return (int)sizeof(FlashParams); }

}  // extern "C"
