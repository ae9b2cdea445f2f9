"""Qwen-R1 32B (paper §4, headline +9.1 AIME24 result).

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from repro_torch.core.config import ArchConfig, AttentionConfig, DMSConfig, MLPConfig

CONFIG = ArchConfig(
    name="qwen-r1-32b",
    num_layers=64,
    d_model=5120,
    vocab_size=152064,
    attn=AttentionConfig(num_heads=40, num_kv_heads=8, head_dim=128,
                         rope="full", rope_theta=1e6),
    mlp=MLPConfig(d_ff=27648, kind="swiglu"),
    layer_pattern=("attn",),
    dms=DMSConfig(enabled=True, window=256, target_cr=8.0),
    family="dense",
    sub_quadratic=False,
)

SMOKE = CONFIG.scaled_down(num_layers=2, d_model=64)
