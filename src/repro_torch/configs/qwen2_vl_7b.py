"""qwen2-vl-7b — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  Vision frontend is
a STUB: precomputed patch embeddings (B, F, D) (``frontend_embeds``) are
prepended to the text tokens.  M-RoPE: head_dim/2 = 64 freq slots split into
(temporal=16, height=24, width=24) sections.
"""
from repro_torch.core.config import ArchConfig, AttentionConfig, DMSConfig, MLPConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    num_layers=28,
    d_model=3584,
    vocab_size=152064,
    attn=AttentionConfig(num_heads=28, num_kv_heads=4, head_dim=128,
                         rope="mrope", mrope_sections=(16, 24, 24),
                         rope_theta=1e6),
    mlp=MLPConfig(d_ff=18944, kind="swiglu"),
    layer_pattern=("attn",),
    frontend="vision_patches",
    frontend_tokens=1024,
    dms=DMSConfig(enabled=True, window=256, target_cr=8.0),
    family="vlm",
    sub_quadratic=False,
)

SMOKE = CONFIG.scaled_down(num_layers=2, d_model=64)
