"""llava-next-mistral-7b [vlm] — mistral backbone + anyres tiling STUB.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000. The vision tower /
anyres tiling is a stub: ``input_specs()`` provides precomputed patch
embeddings (B, 576, d_model) prepended to the token sequence.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    block_pattern=("attn",),
    rope_theta=1_000_000.0,
    num_patch_tokens=576,
)
