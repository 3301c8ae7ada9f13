"""The yardstick of the kernels: the H100's peaks, the operations and
bytes a decision kernel's call needs, from its shapes, and a language
model's operations a batch, from its configuration file alone.

Peaks: NVIDIA's H100 SXM data sheet (dense, at the 700 W limit).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989.4e12

# the ETF search's rows: the ready queue it scans (the engine's R_MAX)
ETF_ROWS = 16


def etf_search_bytes(S: int, R: int, P: int, alive: bool = False) -> int:
    """Bytes one call of the masked ETF search must move for S lanes of
    R ready slots x P PEs: the availability and execution-time tables
    [S, R, P] f32, the PEs' free times [S, P] f32, `now` [S] f32 and the
    slot mask [S, R] u8 read once; the PE mask [S, P] u8 when given; the
    minimum f32, slot i32, PE i32 and feasibility u8 a lane written
    once."""
    return S * (2 * R * P * 4 + P * 4 + 4 + R + (P if alive else 0)
                + 4 + 4 + 4 + 1)


def etf_search_ops(S: int, R: int, P: int) -> int:
    """Operations of one call: a finish time (a max of three and an add),
    a finiteness test and a compare a cell."""
    return 6 * S * R * P


def etf_search_bound_us(S: int, R: int, P: int, alive: bool = False) -> float:
    """The least time the H100 could take for the call: the larger of
    its bytes over HBM bandwidth and its operations over the fp32 rate."""
    return max(etf_search_bytes(S, R, P, alive) / HBM_BYTES_PER_S,
               etf_search_ops(S, R, P) / F32_OPS_PER_S) * 1e6


def lm_layer_flops(c: dict, layer: int) -> int:
    """Operations of one token in one layer of a DeepSeek-V2 model (the
    configuration file's published keys), outside attention over its
    context: the MLA projections (q; the latent and the RoPE key; keys
    and values up from the latent; the output), and
    the layer's MLP: the dense SwiGLU, or the router and the routed and
    shared experts' SwiGLUs. Two a multiply-add; norms, RoPE, softmax and
    activations not counted."""
    D, H = c["hidden_size"], c["num_attention_heads"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    R = c["kv_lora_rank"]
    attn = (2 * D * H * (dn + dr) + 2 * D * (R + dr) + 2 * R * H * (dn + dv)
            + 2 * H * dv * D)
    if layer < c["first_k_dense_replace"]:
        return attn + 6 * D * c["intermediate_size"]
    experts = c["num_experts_per_tok"] + (c["n_shared_experts"] or 0)
    return (attn + 2 * D * c["n_routed_experts"]
            + experts * 6 * D * c["moe_intermediate_size"])


def lm_attention_flops(c: dict) -> int:
    """Operations of one token's attention to one key in one layer, in
    the expanded form: the score over the nope and RoPE parts and the
    weighted value."""
    return 2 * c["num_attention_heads"] * (
        c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"])


def lm_flops(c: dict, prompt_len: int, new_tokens: int, batch: int) -> int:
    """Model operations of one served batch, in the published
    formulation whatever path the program takes: `batch` prompts of
    `prompt_len` tokens prefilled, each token attending to itself and
    those before it, then `new_tokens` - 1 decode steps (the token at
    position prompt_len + i - 1 attending to prompt_len + i keys), and
    the head for each token whose logits are served (the prompt's last
    and each decode step's)."""
    n_layers = c["num_hidden_layers"]
    per_token = sum(lm_layer_flops(c, i) for i in range(n_layers))
    head = 2 * c["hidden_size"] * c["vocab_size"]
    steps = new_tokens - 1
    P = prompt_len
    keys = P * (P + 1) // 2 + steps * P + steps * (steps + 1) // 2
    return batch * ((P + steps) * per_token + new_tokens * head
                    + keys * n_layers * lm_attention_flops(c))
