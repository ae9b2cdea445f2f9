"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060].

64L d_model=2560, attention-free, vocab=50280, ssm_state=128.  No KV cache,
so no KV policy applies.
"""
from repro_torch.core.config import ArchConfig, DMSConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    num_layers=64,
    d_model=2560,
    vocab_size=50280,
    attn=None,
    mlp=None,
    layer_pattern=("ssd",),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                  conv_kernel=4, chunk_size=256),
    norm="rmsnorm",
    tie_embeddings=True,
    dms=DMSConfig(enabled=False),
    family="ssm",
    sub_quadratic=True,
)

SMOKE = CONFIG.scaled_down(num_layers=2, d_model=64)
