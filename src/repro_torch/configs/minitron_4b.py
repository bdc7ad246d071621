"""minitron-4b [dense] — pruned nemotron [arXiv:2407.14679; hf].

Nemotron uses squared-ReLU non-gated MLP; reproduced via act="relu2"."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    rope_theta=1e4,
    mlp_gated=False,
    act="relu2",
    tie_embeddings=False,
    fsdp=True,
    remat="full",
)
