"""Qwen-R1 7B (paper §4). 28L d_model=3584 28H (GQA kv=4) d_ff=18944."""
from repro_torch.core.config import ArchConfig, AttentionConfig, DMSConfig, MLPConfig

CONFIG = ArchConfig(
    name="qwen-r1-7b",
    num_layers=28,
    d_model=3584,
    vocab_size=152064,
    attn=AttentionConfig(num_heads=28, num_kv_heads=4, head_dim=128,
                         rope="full", rope_theta=1e6),
    mlp=MLPConfig(d_ff=18944, kind="swiglu"),
    layer_pattern=("attn",),
    dms=DMSConfig(enabled=True, window=256, target_cr=8.0),
    family="dense",
    sub_quadratic=False,
)

SMOKE = CONFIG.scaled_down(num_layers=2, d_model=64)
