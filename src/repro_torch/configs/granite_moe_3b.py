"""granite-moe-3b-a800m — 40 experts top-8 [hf:ibm-granite/granite-3.0; hf].

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 40e top-8.
"""
from repro_torch.core.config import (ArchConfig, AttentionConfig, DMSConfig,
                               MLPConfig, MoEConfig)

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    num_layers=32,
    d_model=1536,
    vocab_size=49155,
    attn=AttentionConfig(num_heads=24, num_kv_heads=8, head_dim=64, rope="full"),
    mlp=MLPConfig(d_ff=512, kind="swiglu", moe=MoEConfig(num_experts=40, top_k=8)),
    layer_pattern=("attn",),
    tie_embeddings=True,
    dms=DMSConfig(enabled=True, window=256, target_cr=8.0),
    family="moe",
    sub_quadratic=False,
)

SMOKE = CONFIG.scaled_down(num_layers=2, d_model=64, num_experts=8)
