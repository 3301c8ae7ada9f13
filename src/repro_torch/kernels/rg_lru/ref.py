"""Plain PyTorch version of the RG-LRU scan kernel (`kernel.py`).

The defining sequential recurrence of `repro/kernels/rg_lru/ref.py`:
h_t = a_t * h_{t-1} + b_t per channel, h_{-1} = 0, in fp32, output in
`a.dtype`. The multiply and the add are two torch operations, each
rounded, so the CUDA kernel (`__fmul_rn` then `__fadd_rn`) equals it bit
for bit.
"""
from __future__ import annotations

import torch


def rg_lru_reference(a, b):
    """a, b [B, S, C] -> h [B, S, C]."""
    a32, b32 = a.float(), b.float()
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                    device=a.device)
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = a32[:, t] * h
        h = h + b32[:, t]
        out[:, t] = h
    return out.to(a.dtype)
