"""granite-moe-3b-a800m [moe] — 40 experts top-8
(hf:ibm-granite/granite-3.0-3b-a800m family).

32L d_model=1536 24H (GQA kv=8) expert d_ff=512 vocab=49155, MoE 40e top-8 on
every layer. Expert count padded to 48 for mesh divisibility (dummy experts
receive -inf router logits and no tokens).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    block_pattern=("attn",),
    num_experts=40,
    experts_per_token=8,
    moe_every=1,
    moe_d_ff=512,
    capacity_factor=1.5,
)
