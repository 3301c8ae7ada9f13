"""Phi-3-mini-3.8B: RoPE + SwiGLU decoder (kv=32 -> MHA). [arXiv:2404.14219]
32L, d_model=3072, 32 heads / 32 KV, d_ff=8192, vocab=32064."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_head=96,
    d_ff=8192,
    vocab=32064,
    pattern=("attn",),
    mlp_type="swiglu",
    rope_theta=10000.0,
    tie_embeddings=False,
)
