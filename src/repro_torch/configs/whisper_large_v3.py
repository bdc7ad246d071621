"""whisper-large-v3 [audio] — enc-dec, conv frontend stubbed
[arXiv:2212.04356; unverified].  32 encoder + 32 decoder layers, MHA
(kv == heads == 20), GELU MLP, 1500 encoder frame positions."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    mlp_gated=False,
    act="gelu",
    tie_embeddings=True,
    fsdp=True,
    remat="full",
    frontend="audio",
)
