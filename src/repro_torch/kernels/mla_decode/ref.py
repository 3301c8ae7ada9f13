"""Plain PyTorch version of the MLA decode kernel (`kernel.py`): the
weight-absorbed attention over the latent cache, as `models/mla.py` runs it
on every route the kernel does not take (prefill, fp32 caches, training,
the CPU).

`latent_attention` is the model's absorbed attention after the cache's
`rms_norm`: fp32 scores from the exactly upcast bf16 (or fp32) operands,
`-inf` where masked, fp32 softmax, the weights cast to the cache's dtype
for the weighted sum. `mla_decode_reference` is the kernel's function:
that attention for one query position a row, from the raw cache, the
valid lengths and the query positions. The CPU path of
`ops.mla_decode` runs it, and `chip_smoke.py` holds the CUDA kernel to it
on the card.
"""
from __future__ import annotations

import torch

from repro_torch.models import modules as nn


def scores(s_nope, q_rope, k_rope, q_pos, kv_pos, scale: float):
    """fp32 (s_nope + s_rope) * scale, -inf where masked; in place in
    s_nope (the same values as the reference's additive mask on finite
    scores, without three more [B, H, Sq, Skv] buffers), out of place
    while autograd records (s_nope is a product's output, which the
    "dots" remat policy keeps for the backward)."""
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float())
    ok = (kv_pos[:, None, :] <= q_pos[:, :, None]) & (kv_pos[:, None, :] >= 0)
    if nn.records_grad(s_nope, s_rope):
        return ((s_nope + s_rope) * scale).masked_fill(~ok[:, None],
                                                       float("-inf"))
    s = s_nope.add_(s_rope).mul_(scale)
    return s.masked_fill_(~ok[:, None], float("-inf"))


def kv_positions(kv_valid, S_max: int):
    """[B, S_max] int32: each cache row's position, -1 from the row's valid
    length `kv_valid` [B] on (masked whatever the query's position)."""
    kv_pos = torch.arange(S_max, dtype=torch.int32,
                          device=kv_valid.device)[None].expand(
                              kv_valid.shape[0], S_max)
    return torch.where(kv_pos < kv_valid[:, None], kv_pos, -1)


def latent_attention(q_lat, q_rope, ckn, k_rope, q_pos, kv_pos,
                     scale: float):
    """q_lat [B,Sq,H,R], q_rope [B,Sq,H,Dr] over the normalised latents
    ckn [B,Skv,R] and k_rope [B,Skv,Dr] -> [B,Sq,H,R] in ckn's dtype."""
    s_nope = torch.einsum("bqhr,bkr->bhqk", q_lat.float(), ckn.float())
    s = scores(s_nope, q_rope, k_rope, q_pos, kv_pos, scale)
    w = torch.softmax(s, dim=-1).to(ckn.dtype)
    return torch.einsum("bhqk,bkr->bqhr", w, ckn)


def mla_decode_reference(q_lat, q_rope, c_kv, k_rope, kv_norm, q_pos,
                         kv_valid, *, eps: float, scale: float):
    """q_lat [B,1,H,R], q_rope [B,1,H,Dr], c_kv [B,S_max,R], k_rope
    [B,S_max,Dr], kv_norm [R], q_pos and kv_valid [B] -> o_lat [B,1,H,R]:
    position j of row b is attended where j < kv_valid[b] and
    j <= q_pos[b]."""
    ckn = nn.rms_norm(c_kv, kv_norm, eps)
    return latent_attention(q_lat, q_rope, ckn, k_rope, q_pos[:, None],
                            kv_positions(kv_valid, c_kv.shape[1]), scale)
