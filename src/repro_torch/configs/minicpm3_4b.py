"""MiniCPM3-4B: 62L dense decoder with MLA attention.
[hf:openbmb/MiniCPM3-4B] d_model=2560, 40 heads, d_ff=6400, vocab=73448,
q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64."""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=64,
    d_ff=6400,
    vocab=73448,
    pattern=("attn",),
    mlp_type="swiglu",
    attn_impl="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
    rope_theta=10000.0,
    embed_scale=12.0,          # mup-style scale_emb
    tie_embeddings=True,
)
