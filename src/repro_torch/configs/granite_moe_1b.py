"""granite-moe-1b-a400m — 32 experts top-8 [hf:ibm-granite/granite-3.0; hf].

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 32e top-8.
"""
from repro_torch.core.config import (ArchConfig, AttentionConfig, DMSConfig,
                               MLPConfig, MoEConfig)

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    num_layers=24,
    d_model=1024,
    vocab_size=49155,
    attn=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=64, rope="full"),
    mlp=MLPConfig(d_ff=512, kind="swiglu", moe=MoEConfig(num_experts=32, top_k=8)),
    layer_pattern=("attn",),
    tie_embeddings=True,
    dms=DMSConfig(enabled=True, window=256, target_cr=8.0),
    family="moe",
    sub_quadratic=False,
)

SMOKE = CONFIG.scaled_down(num_layers=2, d_model=64, num_experts=8)
