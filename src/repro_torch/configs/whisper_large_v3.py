"""whisper-large-v3 [audio] — encoder-decoder, conv frontend STUB (arXiv:2212.04356).

32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866. The conv1d/mel frontend is a
stub: ``input_specs()`` provides precomputed frame embeddings (B, 1500, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,                 # decoder layers
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    block_pattern=("attn",),
    use_rope=False,
    learned_pos=True,
    norm="layernorm",
    act="gelu",
    is_encoder_decoder=True,
    enc_layers=32,
    enc_seq=1500,
)
