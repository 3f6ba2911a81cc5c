"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent : 1 attn
(arXiv:2402.19427). 38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.
Local attention window 2048.

38 layers is not divisible by the 3-block pattern; the released model runs the
(rglru, rglru, local_attn) cycle and truncates — we keep 38 layers with the
cycle truncated on the last repeat expressed as pattern repeats of the
divisible prefix (36) plus 2 extra recurrent layers folded into the pattern by
using a 19-layer half-cycle: (rglru, rglru, local_attn) * 12 + (rglru, rglru).
For scan-compatibility we express this as block_pattern of length 19 repeated
twice.
"""
from repro_torch.configs.base import ModelConfig

_HALF = ("rglru", "rglru", "local_attn") * 6 + ("rglru",)   # 19 blocks

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    block_pattern=_HALF,
    window=2048,
    rope_theta=10000.0,
    norm="rmsnorm",
    act="gelu",                      # GeGLU: gated gelu (mlp uses gate*up like swiglu)
    tie_embeddings=True,
)
