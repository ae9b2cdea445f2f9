"""gemma2-2b — local+global alternating, logit softcap [arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000; local window 4096,
attention softcap 50, final-logit softcap 30, pre+post block norms.
"""
from repro_torch.core.config import ArchConfig, AttentionConfig, DMSConfig, MLPConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    num_layers=26,
    d_model=2304,
    vocab_size=256000,
    attn=AttentionConfig(num_heads=8, num_kv_heads=4, head_dim=256,
                         rope="full", window=4096, logit_softcap=50.0),
    mlp=MLPConfig(d_ff=9216, kind="geglu"),
    layer_pattern=("attn_local", "attn"),
    post_norm=True,
    logit_softcap=30.0,
    tie_embeddings=True,
    embedding_multiplier=2304 ** 0.5,
    dms=DMSConfig(enabled=True, window=256, target_cr=8.0),
    family="dense",
    # local+global hybrid: half the layers are windowed -> long_500k decodes
    # with bounded local caches + DMS-compressed global caches
    sub_quadratic=True,
)

SMOKE = CONFIG.scaled_down(num_layers=2, d_model=64)
