"""Architecture config schema for the assigned LM-family models."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention options ---
    rope_theta: float = 1e6
    qkv_bias: bool = False          # qwen2
    qk_norm: bool = False           # qwen3
    m_rope: bool = False            # qwen2-vl multimodal RoPE
    m_rope_sections: tuple[int, ...] = (16, 24, 24)
    window: int | None = None       # local attention width
    logits_soft_cap: float | None = None

    # --- layer pattern ---
    # cycled across layers: "attn" (global), "local" (windowed attn),
    # "rglru" (recurrent), "ssm" (mamba2)
    block_pattern: tuple[str, ...] = ("attn",)

    # --- mlp ---
    mlp_gated: bool = True          # SwiGLU (False -> plain GELU MLP, whisper)
    act: str = "silu"

    # --- moe ---
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    ep_shard: bool = True  # shard experts on `model` (False: TP inside experts)

    # --- ssm (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- rglru (recurrentgemma) ---
    rnn_width: int = 0              # 0 -> d_model
    rglru_c: float = 8.0

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0         # >0 -> encoder-decoder
    encoder_seq: int = 1500         # audio frame positions (stub frontend)

    # --- embeddings / precision / memory ---
    tie_embeddings: bool = True
    embed_scale: bool = False       # multiply embeddings by sqrt(d_model)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"    # stored parameter dtype
    fsdp: bool = False              # shard params/opt-state over the data axis
    remat: str = "none"             # none | full | dots
    subquadratic: bool = False      # supports long_500k decode
    frontend: str | None = None     # "audio" | "vision" stub frontends

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def pattern_for_layer(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for 6ND roofline."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        per_layer = {}
        qkv = d * (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
        o = self.num_heads * self.head_dim * d
        per_layer["attn"] = qkv + o
        per_layer["local"] = qkv + o
        mlp = d * ff * (3 if self.mlp_gated else 2)
        if self.is_moe:
            mlp = self.num_experts * d * ff * 3 + d * self.num_experts
        di = self.d_inner
        per_layer["ssm"] = d * (2 * di + 2 * self.ssm_state + self.ssm_heads) + di * d + di * self.ssm_conv_width
        rw = self.rnn_width or d
        per_layer["rglru"] = d * rw * 3 + rw * d + 2 * rw * rw + rw * self.ssm_conv_width
        total_layers = 0
        for i in range(self.num_layers):
            pat = self.pattern_for_layer(i)
            blk = per_layer.get(pat, per_layer["attn"])
            if pat in ("attn", "local", "rglru"):  # these blocks carry an MLP
                blk += mlp
            total_layers += blk
        n += total_layers
        if self.is_encoder_decoder:
            enc = self.encoder_layers * (per_layer["attn"] + d * ff * 2)
            xattn = self.num_layers * (qkv + o)
            n += enc + xattn
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts) for 6·N_act·D."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_moe = self.num_experts * d * ff * 3
        active_moe = self.experts_per_tok * d * ff * 3
        return self.param_count() - self.num_layers * (dense_moe - active_moe)
