"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517).

24L d_model=1024 4H (kv=4) d_ff=0 (xLSTM blocks carry their own up-projection)
vocab=50304. Alternating mLSTM/sLSTM (1:1).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    block_pattern=("mlstm", "slstm"),
    use_rope=False,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
)
