"""Qwen-R1 1.5B (DeepSeek-R1 distilled Qwen 2.5 1.5B) — the paper's smallest
reasoning model (§4).  28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
"""
from repro_torch.core.config import ArchConfig, AttentionConfig, DMSConfig, MLPConfig

CONFIG = ArchConfig(
    name="qwen-r1-1.5b",
    num_layers=28,
    d_model=1536,
    vocab_size=151936,
    attn=AttentionConfig(num_heads=12, num_kv_heads=2, head_dim=128,
                         rope="full", rope_theta=1e6),
    mlp=MLPConfig(d_ff=8960, kind="swiglu"),
    layer_pattern=("attn",),
    tie_embeddings=True,
    dms=DMSConfig(enabled=True, window=256, target_cr=8.0),
    family="dense",
    sub_quadratic=False,
)

SMOKE = CONFIG.scaled_down(num_layers=2, d_model=64)
