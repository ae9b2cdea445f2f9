"""phi3-mini-3.8b — RoPE SwiGLU GQA [arXiv:2404.14219; unverified].

32L d_model=3072 32H (GQA kv=32 == MHA) d_ff=8192 vocab=32064.
"""
from repro_torch.core.config import ArchConfig, AttentionConfig, DMSConfig, MLPConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    num_layers=32,
    d_model=3072,
    vocab_size=32064,
    attn=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=96, rope="full"),
    mlp=MLPConfig(d_ff=8192, kind="swiglu"),
    layer_pattern=("attn",),
    dms=DMSConfig(enabled=True, window=256, target_cr=8.0),
    family="dense",
    sub_quadratic=False,
)

SMOKE = CONFIG.scaled_down(num_layers=2, d_model=64)
