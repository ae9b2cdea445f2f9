"""minitron-4b — pruned nemotron [arXiv:2407.14679; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""
from repro_torch.core.config import ArchConfig, AttentionConfig, DMSConfig, MLPConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    num_layers=32,
    d_model=3072,
    vocab_size=256000,
    attn=AttentionConfig(num_heads=24, num_kv_heads=8, head_dim=128, rope="full"),
    mlp=MLPConfig(d_ff=9216, kind="swiglu"),
    layer_pattern=("attn",),
    dms=DMSConfig(enabled=True, window=256, target_cr=8.0),
    family="dense",
    sub_quadratic=False,
)

SMOKE = CONFIG.scaled_down(num_layers=2, d_model=64)
