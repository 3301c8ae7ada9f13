"""Dispatch for flash attention, by the device of the inputs.

A CUDA tensor launches the hand-written kernel (`kernel.py`) or raises;
a CPU tensor takes the plain PyTorch version (`ref.py`). There is no
switch and no fall back, and unlike the JAX reference's wrapper
(`repro/kernels/flash_attention/ops.py`) no sequence length has to be a
multiple of a block.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel, ref

LAUNCHES = kernel.LAUNCHES
reset_launches = kernel.reset_launches


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q [B,S,H,Dh], k [B,S,K,Dh], v [B,S,K,Dv] -> [B,S,H,Dv] in q's
    dtype."""
    if q.device.type == "cuda":
        return kernel.flash_attention_fwd(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, softcap=softcap)
    if q.device.type == "cpu":
        return ref.mha_reference(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
