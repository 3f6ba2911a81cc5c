// Blockwise flash attention for Hopper (sm_90a): out = softmax(q k^T *
// scale [+ causal mask]) v per (batch*head), with an online softmax.
//
// Replaces src/repro/kernels/flash_attention.py::_fa_kernel (the Pallas
// kernel behind flash_attention). It computes the same function: scores,
// running max, sum and accumulator in f32, masked scores -1e30, the output
// acc / max(l, 1e-30) stored in q's dtype (f32 or bf16 in, same out).
//
// Design: one CTA of 4 warps per (bh, 64-row query tile), where the
// Pallas grid ran its kv axis in order on one core: here a loop inside
// the CTA walks the key tiles through attend.cuh's tensor-core step (bf16
// m16n8k16 for bf16 inputs, 3xTF32 m16n8k8 for f32; K and V double
// buffered by cp.async) and, under `causal`, stops at the tile holding the
// tile's last query, as _fa_kernel skips fully masked kv blocks (a fully
// masked tile after the first would add exactly 0). The longest causal
// rows are scheduled first, so the short ones fill the tail. The q_block /
// kv_block of the reference shape only its grid; the wrapper keeps its
// divisibility checks and the kernel always tiles 64 x 64.
//
// Bound: at (BH 8, S 4096, hd 64) the call does 17.2 GFLOP causal (34.4
// non-causal) against 33.6 MB of traffic (f32), so the operations bound
// it: f32-accurate on the tensor cores (3xTF32, 495 / 3 = 165 TFLOP/s)
// 0.104 ms causal on an H100 SXM; bf16 at 989 TFLOP/s, 0.017 ms. The
// step spends four MMA a multiply-add in bf16 (P as hi + lo) and three in
// f32, plus the split of every f32 operand on the integer and f32 pipes
// and the softmax on the SFU; attend.cuh's header has the layout.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attend.cuh"

struct FlashParams {
  int BH, S, Skv, hd;
  int causal;
  int bf16;       // q, k, v and out are bf16 (else f32)
  int vec;        // rows of 16-byte multiples, 16-byte aligned bases: cp.async
  float scale;
  const void* q;  // (BH, S, hd)
  const void* k;  // (BH, Skv, hd)
  const void* v;  // (BH, Skv, hd)
  void* out;      // (BH, S, hd)
};

template <typename T, int HDP>
__global__ void __launch_bounds__(ATT_NT, Attn<T, HDP>::MIN_CTAS)
    flash_attention_kernel(FlashParams P) {
  extern __shared__ float4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const int nqt = (P.S + ATT_BQ - 1) / ATT_BQ;
  const int bh = blockIdx.x % P.BH;
  const int q0 = (nqt - 1 - (int)blockIdx.x / P.BH) * ATT_BQ;  // longest rows first
  const int nq = min(ATT_BQ, P.S - q0);
  const T* q = reinterpret_cast<const T*>(P.q) + ((size_t)bh * P.S + q0) * P.hd;
  const T* k = reinterpret_cast<const T*>(P.k) + (size_t)bh * P.Skv * P.hd;
  const T* v = reinterpret_cast<const T*>(P.v) + (size_t)bh * P.Skv * P.hd;
  AttnState<HDP> st;
  attn_init(st);
  const int kend = P.causal ? min(P.Skv, q0 + nq) : P.Skv;
  attn_piece<T, HDP>(st, smem, q, nq, k, v, P.Skv, kend, P.hd, P.vec, q0, 0, P.causal, P.scale,
                     [](int) {});
  const int b = opaque_int(blockIdx.x);  // the tile found anew after the loop
  const int q1 = (nqt - 1 - b / P.BH) * ATT_BQ;
  attn_store<T, HDP>(st, smem, reinterpret_cast<T*>(P.out) + ((size_t)(b % P.BH) * P.S + q1) * P.hd,
                     min(ATT_BQ, P.S - q1), P.hd, P.vec);
}

template <typename T, int HDP>
static cudaError_t launch(const FlashParams* p, cudaStream_t stream) {
  const int smem = Attn<T, HDP>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, HDP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int nqt = (p->S + ATT_BQ - 1) / ATT_BQ;
  flash_attention_kernel<T, HDP><<<p->BH * nqt, ATT_NT, smem, stream>>>(*p);
  return cudaGetLastError();
}

extern "C" {

// Launch on `stream`; hd <= 128. Returns a cudaError_t, or -1 for an hd
// the kernel does not take.
int flash_attention_launch(const FlashParams* p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (p->hd < 1 || p->hd > 128) return -1;
  if (p->hd <= 64)
    return (int)(p->bf16 ? launch<__nv_bfloat16, 64>(p, s) : launch<float, 64>(p, s));
  return (int)(p->bf16 ? launch<__nv_bfloat16, 128>(p, s) : launch<float, 128>(p, s));
}

const char* flash_attention_error(int code) {
  if (code == -1) return "head dimension outside 1..128";
  return cudaGetErrorString((cudaError_t)code);
}

int flash_attention_params_size() { return (int)sizeof(FlashParams); }

}  // extern "C"
