"""MusicGen-medium: decoder-only transformer over EnCodec tokens (STUB
frontend: `input_specs` supplies 4 parallel codebook token streams in the
delay pattern; the EnCodec encoder/decoder itself is out of scope).
[arXiv:2306.05284] 48L, d_model=1536, 24 heads (MHA), d_ff=6144, vocab=2048
per codebook, 4 codebooks with summed embeddings and parallel heads."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_head=64,
    d_ff=6144,
    vocab=2048,
    pattern=("attn",),
    mlp_type="gelu",
    rope_theta=10000.0,
    n_codebooks=4,
    tie_embeddings=False,
)
