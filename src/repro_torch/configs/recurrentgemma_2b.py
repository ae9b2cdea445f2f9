"""recurrentgemma-2b — RG-LRU + local attention [arXiv:2402.19427; hf].

26L d_model=2560 10H (GQA kv=1, i.e. MQA) d_ff=7680 vocab=256000, a
2048-token local window.  The published temporal pattern is (rglru, rglru,
attn_local) with the last block cut short; the reference keeps the layer
count with 13 repetitions of (rglru, attn_local), and so does the port.
DMS applies to the local-attention layers.
"""
from repro_torch.core.config import (ArchConfig, AttentionConfig, DMSConfig,
                                     MLPConfig, RGLRUConfig)

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    num_layers=26,
    d_model=2560,
    vocab_size=256000,
    attn=AttentionConfig(num_heads=10, num_kv_heads=1, head_dim=256,
                         rope="full", window=2048),
    mlp=MLPConfig(d_ff=7680, kind="geglu"),
    layer_pattern=("rglru", "attn_local"),
    rglru=RGLRUConfig(lru_width=2560, conv_kernel=4),
    tie_embeddings=True,
    embedding_multiplier=2560 ** 0.5,
    dms=DMSConfig(enabled=True, window=256, target_cr=8.0),
    family="hybrid",
    sub_quadratic=True,
)

SMOKE = CONFIG.scaled_down(num_layers=2, d_model=64)
