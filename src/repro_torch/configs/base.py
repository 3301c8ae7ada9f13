"""Model configuration, a copy of the JAX package's `configs/base.py`.

The fields are the reference's, less its layer-scan and kernel knobs
(`scan_layers`, `use_pallas`): the port runs its layers in a Python loop
and picks a kernel by the device of the tensors and by whether autograd
records, not by a flag. `remat` is the reference's: the blocks a
training step recomputes in its backward (`models/transformer.py`).
`shard_strategy` is the reference's too: `parallel/sharding.py` reads it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3)."""
    q_lora_rank: int = 0          # 0 = direct q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0             # always-on shared experts
    d_expert: int = 0             # expert FFN hidden size
    first_k_dense: int = 0        # leading layers use a dense MLP
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_coef: float = 0.01
    # >0: dispatch sort/pack runs independently within this many token
    # shards (aligned with the DP sharding) so no global sort collectives
    # are emitted — §Perf iteration for the MoE cells.
    n_dispatch_shards: int = 0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """Griffin / RecurrentGemma recurrent block."""
    d_rnn: int = 0                # recurrent width (0 -> d_model)
    conv_width: int = 4
    c: float = 8.0                # RG-LRU gate sharpness


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    """Mamba-2 state-space duality block."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    n_groups: int = 1             # B/C groups (GVA-style)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # block pattern, repeated to cover n_layers. entries:
    #   "attn"   full (GQA/MLA) attention + MLP
    #   "local"  sliding-window attention + MLP
    #   "rglru"  RG-LRU recurrent block + MLP
    #   "ssd"    mamba-2 SSD block (no separate MLP)
    pattern: Tuple[str, ...] = ("attn",)
    mlp_type: str = "swiglu"      # swiglu | geglu | gelu | moe | none
    attn_impl: str = "gqa"        # gqa | mla
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    rglru: Optional[RGLRUConfig] = None
    ssd: Optional[SSDConfig] = None
    # attention details
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    qkv_bias: bool = False
    window: int = 0               # sliding window size for "local" blocks
    prefix_lm: bool = False       # bidirectional attention over the prefix
    logit_softcap: float = 0.0
    # embedding / head
    n_codebooks: int = 1          # musicgen: parallel codebook streams
    tie_embeddings: bool = True
    embed_scale: float = 0.0      # 0 -> 1.0; gemma uses sqrt(d_model)
    # norms / dtypes
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"       # compute dtype
    param_dtype: str = "float32"
    # training
    remat: str = "full"           # none | full | dots
    # sharding strategy: "tp" (FSDP x tensor-parallel, default) or
    # "ep_dp" (batch shards over ALL mesh axes incl. "model"; non-expert
    # params replicate over "model"; experts shard over "model" = pure
    # data-parallel attention + expert parallelism)
    shard_strategy: str = "tp"
    # decode-path optimization: MLA weight absorption (attention runs in the
    # compressed latent space; no per-step K/V expansion) — §Perf iteration.
    mla_absorb: bool = False
    # modality frontend stub: number of precomputed prefix embeddings
    n_prefix_embeds: int = 0      # e.g. paligemma image patches

    @property
    def pattern_full(self) -> Tuple[str, ...]:
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    @property
    def vocab_padded(self) -> int:
        """Embedding/head rows padded to a multiple of 16 so the vocab dim
        shards across the model axis (Megatron-style padding; padded logits
        are masked to -inf in the head)."""
        return -(-self.vocab // 16) * 16

    @property
    def is_ssm_only(self) -> bool:
        return all(p == "ssd" for p in self.pattern)

    @property
    def supports_long_context(self) -> bool:
        """sub-quadratic archs: no full-attention block in the pattern."""
        return all(p in ("ssd", "rglru", "local") for p in self.pattern)

    def validate(self) -> None:
        assert self.n_layers > 0 and self.d_model > 0
        for p in self.pattern:
            assert p in ("attn", "local", "rglru", "ssd"), p
        if "local" in self.pattern:
            assert self.window > 0, "local blocks need a window"
        if self.mlp_type == "moe":
            assert self.moe is not None
        if self.attn_impl == "mla":
            assert self.mla is not None
        if "ssd" in self.pattern:
            assert self.ssd is not None
        if "rglru" in self.pattern:
            assert self.rglru is not None


def scaled_down(cfg: ModelConfig, n_layers: int = 2, d_model: int = 64,
                n_heads: int = 4, vocab: int = 512, **kw) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    n_kv = max(1, min(cfg.n_kv_heads * n_heads // max(cfg.n_heads, 1), n_heads))
    if cfg.n_kv_heads == cfg.n_heads:
        n_kv = n_heads
    if cfg.n_kv_heads == 1:
        n_kv = 1
    upd = dict(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=n_kv, d_head=d_model // n_heads, d_ff=d_model * 3,
        vocab=vocab, window=min(cfg.window, 32) if cfg.window else 0,
        n_prefix_embeds=min(cfg.n_prefix_embeds, 4),
    )
    if cfg.mla is not None:
        upd["mla"] = MLAConfig(
            q_lora_rank=d_model // 2 if cfg.mla.q_lora_rank else 0,
            kv_lora_rank=d_model // 2, qk_nope_head_dim=d_model // n_heads,
            qk_rope_head_dim=max(4, d_model // n_heads // 2),
            v_head_dim=d_model // n_heads,
        )
    if cfg.moe is not None:
        upd["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, n_shared=min(cfg.moe.n_shared, 1),
            d_expert=d_model * 2,
            first_k_dense=min(cfg.moe.first_k_dense, 1),
        )
    if cfg.ssd is not None:
        upd["ssd"] = dataclasses.replace(
            cfg.ssd, d_state=16, head_dim=16, chunk=16)
    if cfg.rglru is not None:
        upd["rglru"] = dataclasses.replace(cfg.rglru, d_rnn=d_model)
    upd.update(kw)
    out = dataclasses.replace(cfg, **upd)
    out.validate()
    return out
