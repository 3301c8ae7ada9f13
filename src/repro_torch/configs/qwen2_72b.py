"""Qwen2-72B: GQA with QKV bias. [arXiv:2407.10671]
80L, d_model=8192, 64 heads / 8 KV, d_ff=29568, vocab=152064."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab=152064,
    pattern=("attn",),
    mlp_type="swiglu",
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
)
