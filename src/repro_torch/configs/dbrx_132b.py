"""DBRX-132B: fine-grained MoE, 16 experts top-4. [hf:databricks/dbrx-base]
40L, d_model=6144, 48 heads / 8 KV, expert d_ff=10752, vocab=100352."""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=10752,
    vocab=100352,
    pattern=("attn",),
    mlp_type="moe",
    moe=MoEConfig(n_experts=16, top_k=4, n_shared=0, d_expert=10752,
                  first_k_dense=0, capacity_factor=1.25),
    rope_theta=500000.0,
    tie_embeddings=False,
)
