"""DeepSeek-V2-Lite (16B total / 2.4B active): MLA + fine-grained MoE.
[arXiv:2405.04434] 27L, d_model=2048, 16 heads, kv_lora=512, qk_nope=128,
qk_rope=64, v_head=128 (no q_lora); MoE: 64 routed experts top-6 +
2 shared, expert d_ff=1408, first layer dense (d_ff=10944); vocab=102400."""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,                  # dense (first-layer) MLP width
    vocab=102400,
    pattern=("attn",),
    mlp_type="moe",
    attn_impl="mla",
    mla=MLAConfig(q_lora_rank=0, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                  first_k_dense=1, capacity_factor=1.25),
    rope_theta=10000.0,
    tie_embeddings=False,
)
