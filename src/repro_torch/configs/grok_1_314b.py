"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified].

8 experts do not divide the 16-way model axis; experts are replicated and
each expert's FFN is tensor-parallel over `model` while parameters are
additionally FSDP-sharded over `data` (DESIGN.md §5).  bf16 params +
sharded optimizer state to fit 16 GB/chip (DESIGN.md §7)."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    experts_per_tok=2,
    ep_shard=False,
    logits_soft_cap=30.0,
    rope_theta=1e4,
    tie_embeddings=True,
    fsdp=True,
    remat="full",
    param_dtype="bfloat16",
)
