// TMA tensor maps for the port's Hopper kernels (gemm_allgather.cu,
// kv_shuttle.cu, moe_dispatch.cu): host code only. The CUDA driver's
// cuTensorMapEncodeTiled is looked up at run time (the builds link no
// libcuda), and a map describes a row-major 2-D tensor cut into boxes.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>

namespace tma {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (outer, inner) tensor as boxes of box_outer rows of 32
// elements, zeros past its edges: f32 (`i8` false) box rows of 128 bytes
// in the 128-byte swizzle that wgmma's K-major descriptors read, int8 box
// rows of 32 bytes unswizzled. Returns 0, -3 (the CUDA driver has no encoder)
// or -4 (the encoder refused the layout: a base or a row pitch off 16
// bytes).
static int encode(CUtensorMap* map, const void* base, long long inner, long long outer,
                  int box_outer, bool i8 = false) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -3;
  const size_t esize = i8 ? 1 : sizeof(float);
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * esize};
  const cuuint32_t box[2] = {32u, (cuuint32_t)box_outer};
  const cuuint32_t step[2] = {1u, 1u};
  const CUresult r =
      fn(map, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
         const_cast<void*>(base), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
         i8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -4;
}

}  // namespace tma
