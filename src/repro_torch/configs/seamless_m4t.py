"""seamless-m4t-large-v2 — enc-dec, multimodal [arXiv:2308.11596; hf].

24L (encoder) + 24L (decoder) d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
The speech frontend is a STUB: precomputed frame embeddings (B, S_enc, D)
(``enc_embeds``) feed the bidirectional encoder; the decoder generates text
with causal self-attention (DMS-compressible) + cross-attention over the
encoder memory (static, DMS off).
"""
from repro_torch.core.config import ArchConfig, AttentionConfig, DMSConfig, MLPConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    num_layers=24,
    d_model=1024,
    vocab_size=256206,
    attn=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=64, rope="full"),
    mlp=MLPConfig(d_ff=8192, kind="gelu"),
    layer_pattern=("attn",),
    norm="layernorm",
    encoder_layers=24,
    encoder_bidirectional=True,
    cross_attention=True,
    frontend="audio_frames",
    frontend_tokens=0,          # frontend feeds the encoder, not the decoder
    dms=DMSConfig(enabled=True, window=256, target_cr=8.0),
    family="audio",
    sub_quadratic=False,
)

SMOKE = CONFIG.scaled_down(num_layers=2, d_model=64)
