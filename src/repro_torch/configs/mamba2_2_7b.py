"""mamba2-2.7b [ssm] — SSD state-space duality [arXiv:2405.21060; unverified].

Attention-free: 64 mamba2 blocks, d_inner = 2*d_model = 5120, 80 SSD heads
of dim 64, state N=128.  Sub-quadratic: runs long_500k decode (O(1) state)."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("ssm",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    tie_embeddings=True,
    fsdp=True,
    remat="full",
    subquadratic=True,
)
