"""Plain PyTorch version of the flash attention kernel (`kernel.py`).

The same function as `repro/kernels/flash_attention/ref.py`: causal GQA
attention with an optional sliding window and tanh logit softcap, fp32
scores and softmax with `-inf` masks, output in `q.dtype`. The CPU path
of `ops.flash_attention` runs it, and `chip_smoke.py` holds the CUDA
kernel to it on the card.
"""
from __future__ import annotations

import math

import torch


def band_mask(S: int, causal: bool, window: int, device=None):
    """[S, S] bool: query row i may attend to key column j."""
    pos = torch.arange(S, device=device)
    ok = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window:
        ok &= pos[None, :] > pos[:, None] - window
    return ok


def mha_reference(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q [B,S,H,Dh], k/v [B,S,K,Dh] -> [B,S,H,Dh] (fp32 softmax)."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                     k.float()) / math.sqrt(Dh)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    ok = band_mask(S, causal, window, q.device)
    s = s.masked_fill(~ok, float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)
