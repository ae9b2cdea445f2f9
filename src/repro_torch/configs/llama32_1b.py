"""Llama 3.2 1B Instruct — the paper's ablation model (§5.2, §5.3, Table 1).

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.  The Table-1 DMS
variant uses a 16-token window.
"""
from repro_torch.core.config import ArchConfig, AttentionConfig, DMSConfig, MLPConfig

CONFIG = ArchConfig(
    name="llama32-1b",
    num_layers=16,
    d_model=2048,
    vocab_size=128256,
    attn=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=64,
                         rope="full", rope_theta=5e5),
    mlp=MLPConfig(d_ff=8192, kind="swiglu"),
    layer_pattern=("attn",),
    tie_embeddings=True,
    dms=DMSConfig(enabled=True, window=16, target_cr=4.0),
    family="dense",
    sub_quadratic=False,
)

SMOKE = CONFIG.scaled_down(num_layers=2, d_model=64)
