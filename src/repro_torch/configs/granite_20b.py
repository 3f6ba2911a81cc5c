"""granite-20b [dense] — llama-arch code model, MQA (arXiv:2405.04324).

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152. GPT-BigCode style:
learned positions, LayerNorm, GeLU MLP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    block_pattern=("attn",),
    use_rope=False,
    learned_pos=True,
    norm="layernorm",
    act="gelu",
)
