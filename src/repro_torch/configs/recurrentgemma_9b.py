"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 pattern
[arXiv:2402.19427; unverified].  38 layers = 12×(rglru,rglru,local)+2,
MQA local attention (window 2048), GeGLU MLP, embeddings scaled by
sqrt(d).  Sub-quadratic: long_500k decode state is O(window)."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    rnn_width=4096,
    act="gelu",
    rope_theta=1e4,
    embed_scale=True,
    tie_embeddings=True,
    fsdp=True,
    remat="full",
    subquadratic=True,
)
