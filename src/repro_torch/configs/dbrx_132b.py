"""dbrx-132b [moe] — 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified].  Experts shard exactly onto the
16-way model axis: full expert parallelism (DESIGN.md §5 — the HiHGNN
multi-lane analogue)."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_tok=4,
    rope_theta=5e5,
    tie_embeddings=False,
    fsdp=True,
    remat="full",
    param_dtype="bfloat16",
)
