"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, early fusion
(hf:meta-llama/Llama-4-Maverick family).

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048, MoE on every
second layer (128 experts top-1 + shared expert), dense layers d_ff=16384.
iRoPE-style attention: chunked local attention (chunk 8192, RoPE) on 3 of 4
layers, NoPE full attention on the 4th — at decode the NoPE layers read a
sequence-sharded KV cache (O(S)/token), so long_500k runs for this arch.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=16384,                    # dense (non-MoE) layers
    vocab_size=202048,
    head_dim=128,
    block_pattern=("chunked_attn", "chunked_attn", "chunked_attn", "global_attn"),
    chunk=8192,
    rope_theta=500000.0,
    num_experts=128,
    experts_per_token=1,
    moe_every=2,
    moe_d_ff=8192,
    shared_expert=True,
    capacity_factor=1.25,
    ep_mode="alltoall",            # experts sharded over (pod, data); paper-style A2A dispatch
)
