"""chatglm3-6b — RoPE 2d (half-rotary), GQA [arXiv:2406.12793; hf].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""
from repro_torch.core.config import ArchConfig, AttentionConfig, DMSConfig, MLPConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    num_layers=28,
    d_model=4096,
    vocab_size=65024,
    attn=AttentionConfig(num_heads=32, num_kv_heads=2, head_dim=128, rope="half"),
    mlp=MLPConfig(d_ff=13696, kind="swiglu"),
    layer_pattern=("attn",),
    norm="rmsnorm",
    dms=DMSConfig(enabled=True, window=256, target_cr=8.0),
    family="dense",
    sub_quadratic=False,
)

SMOKE = CONFIG.scaled_down(num_layers=2, d_model=64)
