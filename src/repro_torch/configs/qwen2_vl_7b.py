"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only per the brief: the vision frontend is a stub; input_specs
provides precomputed patch embeddings merged into the leading slots."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    m_rope=True,
    m_rope_sections=(16, 24, 24),
    rope_theta=1e6,
    tie_embeddings=False,
    fsdp=True,
    remat="full",
    param_dtype="bfloat16",
    frontend="vision",
)
