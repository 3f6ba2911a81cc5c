"""Model / shape configuration dataclasses for all assigned architectures.

Every architecture in the assigned pool is expressed as a ``ModelConfig``.
Param dims that must be sharded as jit *inputs* have to be divisible by the
mesh axis size, so vocab and expert counts are internally padded (``*_padded``
properties); logical sizes stay exact and padded slots are masked out.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Block kinds understood by the model builder.
ATTN_KINDS = ("attn", "local_attn", "chunked_attn", "global_attn")
RECURRENT_KINDS = ("mlstm", "slstm", "rglru")
BLOCK_KINDS = ATTN_KINDS + RECURRENT_KINDS


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # block structure: cycled over layers
    block_pattern: tuple = ("attn",)
    window: int = 0                  # local attention window
    chunk: int = 0                   # chunked attention chunk size
    rope_theta: float = 10000.0
    use_rope: bool = True
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = False
    learned_pos: bool = False        # learned absolute position embeddings
    max_position: int = 0            # rows of learned pos table (0 -> from shape)
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1               # MoE replaces MLP on layers with (idx % moe_every == moe_every-1)
    moe_d_ff: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    ep_mode: str = "replicated"      # replicated (psum over TP) | alltoall (EP over data)
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    enc_seq: int = 0                 # stub conv-frontend output frames
    # vlm stub
    num_patch_tokens: int = 0        # precomputed patch embeddings prepended
    # recurrence
    conv_width: int = 4              # temporal conv width (rglru branch)
    mlstm_chunk: int = 128           # chunkwise-parallel chunk for mLSTM
    # numerics
    dtype: str = "bfloat16"
    # sharding pad granularity (model-axis size the padded dims must divide by)
    pad_to: int = 16

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab_size, max(256, self.pad_to))

    @property
    def num_experts_padded(self) -> int:
        if self.num_experts == 0:
            return 0
        return _round_up(self.num_experts, self.pad_to)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_recurrent(self) -> bool:
        return any(k in RECURRENT_KINDS for k in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no block does unbounded full attention (long_500k eligible)."""
        return all(k not in ("attn",) for k in self.block_pattern)

    @property
    def supports_long_context(self) -> bool:
        """long_500k cell eligibility: recurrent/local/chunked archs.

        ``global_attn`` (NoPE full-attention layers in llama4's iRoPE pattern)
        is allowed because at *decode* it is O(S) per token over a
        sequence-sharded KV cache; pure full-attention archs are skipped.
        """
        return all(k not in ("attn",) for k in self.block_pattern) and not self.is_encoder_decoder

    def block_kind(self, layer_idx: int) -> str:
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    def layer_is_moe(self, layer_idx: int) -> bool:
        return self.is_moe and (layer_idx % self.moe_every == self.moe_every - 1)

    @property
    def repeat_unit(self) -> int:
        """Layers per scan step: lcm of the block pattern and MoE interleave."""
        unit = len(self.block_pattern)
        if self.is_moe:
            unit = math.lcm(unit, self.moe_every)
        assert self.num_layers % unit == 0, (self.name, self.num_layers, unit)
        return unit

    @property
    def num_repeats(self) -> int:
        return self.num_layers // self.repeat_unit

    def param_count(self) -> int:
        """Analytic parameter count (logical, unpadded)."""
        d, hd = self.d_model, self.hd
        n = self.vocab_size * d          # token embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d     # lm head
        if self.learned_pos:
            n += (self.max_position or 4096) * d
        mlp_mult = 3 if self.act == "swiglu" else 2
        for i in range(self.num_layers):
            kind = self.block_kind(i)
            if kind in ATTN_KINDS:
                n += d * self.num_heads * hd * 2          # q, o
                n += d * self.num_kv_heads * hd * 2       # k, v
                n += d                                    # pre-norm
                if self.layer_is_moe(i):
                    n += d * self.num_experts             # router
                    n += self.num_experts * d * self.moe_d_ff * mlp_mult
                    if self.shared_expert:
                        n += d * self.moe_d_ff * mlp_mult
                else:
                    n += d * self.d_ff * mlp_mult
                n += d                                    # mlp pre-norm
            elif kind == "rglru":
                # griffin recurrent block: 2 in-proj, conv, gates, out-proj + mlp
                n += d * d * 3 + d * self.conv_width + 2 * d * d + 2 * d
                n += d * self.d_ff * mlp_mult + d
            elif kind == "mlstm":
                du = 2 * d
                n += d * du * 2 + du * (3 * (du // max(1, self.num_heads))) + du * d + 2 * d
            elif kind == "slstm":
                n += d * 4 * d + 4 * d * (d // max(1, self.num_heads)) + d * int(4 / 3 * d) * 2 + 2 * d
        if self.is_encoder_decoder:
            # encoder layers (self-attn + mlp) and decoder cross-attn
            enc = self.enc_layers * (d * self.num_heads * hd * 2 + d * self.num_kv_heads * hd * 2
                                     + d * self.d_ff * mlp_mult + 2 * d)
            cross = self.num_layers * (d * self.num_heads * hd * 2 + d * self.num_kv_heads * hd * 2 + d)
            n += enc + cross + self.enc_seq * d  # enc pos table
        n += d                                    # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        mlp_mult = 3 if self.act == "swiglu" else 2
        expert_p = self.num_experts * self.d_model * self.moe_d_ff * mlp_mult
        active_p = self.experts_per_token * self.d_model * self.moe_d_ff * mlp_mult
        n_moe_layers = sum(1 for i in range(self.num_layers) if self.layer_is_moe(i))
        return full - n_moe_layers * (expert_p - active_p)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized config of the same family/pattern as ``cfg``."""
    unit = cfg.repeat_unit
    small = dict(
        num_layers=unit,             # one repeat unit keeps the pattern intact
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        window=min(cfg.window, 16) if cfg.window else 0,
        chunk=min(cfg.chunk, 32) if cfg.chunk else 0,
        enc_layers=min(cfg.enc_layers, 2),
        enc_seq=min(cfg.enc_seq, 8),
        num_patch_tokens=min(cfg.num_patch_tokens, 4),
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.experts_per_token else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        mlstm_chunk=8,
        conv_width=cfg.conv_width,
        pad_to=2,
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
