"""PaliGemma-3B: SigLIP vision frontend (STUB: `input_specs` supplies 256
precomputed patch embeddings) + gemma-2B decoder, prefix-LM attention.
[arXiv:2407.07726] 18L, d_model=2048, 8 heads / 1 KV (MQA), d_ff=16384
(GeGLU), vocab=257216."""
from repro_torch.configs.base import ModelConfig

N_PATCHES = 256  # 224x224 / 14x14 SigLIP patches

CONFIG = ModelConfig(
    name="paligemma-3b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab=257216,
    pattern=("attn",),
    mlp_type="geglu",
    rope_theta=10000.0,
    prefix_lm=True,
    embed_scale=2048 ** 0.5,   # gemma embedding scale
    tie_embeddings=True,
    n_prefix_embeds=N_PATCHES,
)
