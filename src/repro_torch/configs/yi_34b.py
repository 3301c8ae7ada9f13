"""Yi-34B: llama-architecture GQA decoder. [arXiv:2403.04652]
60L, d_model=7168, 56 heads / 8 KV, d_ff=20480, vocab=64000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    vocab=64000,
    pattern=("attn",),
    mlp_type="swiglu",
    rope_theta=5000000.0,
    tie_embeddings=False,
)
