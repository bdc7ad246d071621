"""qwen3-8b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=False,
    fsdp=True,
    remat="full",
    param_dtype="bfloat16",
)
