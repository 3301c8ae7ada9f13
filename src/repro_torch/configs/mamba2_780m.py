"""Mamba2-780M: attention-free SSD (state-space duality). [arXiv:2405.21060]
48L, d_model=1536, expand=2 (d_inner=3072), ssm_state=128, head_dim=64,
vocab=50280. Sub-quadratic: runs the long_500k shape."""
from repro_torch.configs.base import ModelConfig, SSDConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    n_layers=48,
    d_model=1536,
    n_heads=48,                  # d_inner / head_dim (bookkeeping only)
    n_kv_heads=48,
    d_head=64,
    d_ff=0,
    vocab=50280,
    pattern=("ssd",),
    mlp_type="none",
    ssd=SSDConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk=128, n_groups=1),
    tie_embeddings=True,
)
