"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core
GPU data sheet, SXM column: dense rates, without sparsity, at the full
700 W power limit). Every roofline share and ``mfu`` of the benchmark
divides by these, and by nothing measured.

float32 work is held to the TF32 tensor rate: the fastest any
float32-accurate implementation on this card can go (a 3xTF32 GEMM does
three TF32 products for each; plain float32 outside the tensor cores runs
at 67 TFLOP/s), so no share of it can read over 100%.
"""

TF32_FLOPS = 495e12          # TF32 tensor core, dense
BF16_FLOPS = 989e12          # BF16 / FP16 tensor core, dense
FP8_FLOPS = 1979e12          # FP8 tensor core, dense
FP32_FLOPS = 67e12           # FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3, 80 GB

# the peak a configuration's stated compute precision is held to
FLOPS = {"float32": TF32_FLOPS, "bfloat16": BF16_FLOPS,
         "float16": BF16_FLOPS, "float8": FP8_FLOPS}


def bound_s(flops, nbytes, dtype):
    """The least time the card could take: the larger of the operations
    over the peak of ``dtype`` and the bytes over the HBM rate."""
    return max(flops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
