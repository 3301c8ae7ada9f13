"""RecurrentGemma-9B (Griffin): RG-LRU recurrent blocks + local attention in
a 2:1 pattern (recurrent, recurrent, local). [arXiv:2402.19427]
38L = 12 x (rglru, rglru, local) + 2 trailing rglru, d_model=4096,
16 heads / 1 KV (MQA) local attention with window 2048, d_ff=12288 (GeGLU),
vocab=256000."""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    n_layers=38,                 # 12 x (rglru, rglru, local) + 2 rglru
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab=256000,
    pattern=("rglru", "rglru", "local"),
    mlp_type="geglu",
    rglru=RGLRUConfig(d_rnn=4096, conv_width=4, c=8.0),
    window=2048,
    rope_theta=10000.0,
    embed_scale=4096 ** 0.5,
    tie_embeddings=True,
)
