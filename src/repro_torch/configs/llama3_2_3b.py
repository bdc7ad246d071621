"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2-3B; unverified]."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=5e5,
    tie_embeddings=True,
    fsdp=True,
    remat="full",
)
