"""Dispatch for the RG-LRU scan, by the device of the inputs.

A CUDA tensor launches the hand-written kernel (`kernel.py`) or raises;
a CPU tensor takes the plain sequential recurrence (`ref.py`). There is
no switch and no fall back.
"""
from __future__ import annotations

from repro_torch.kernels.rg_lru import kernel, ref

LAUNCHES = kernel.LAUNCHES
reset_launches = kernel.reset_launches


def rg_lru_scan(a, b):
    """a, b [B, S, C] -> h [B, S, C] in a's dtype (fp32 math)."""
    if a.device.type == "cuda":
        return kernel.rg_lru_fwd(a.contiguous(), b.contiguous())
    if a.device.type == "cpu":
        return ref.rg_lru_reference(a, b)
    raise ValueError(f"rg_lru: unsupported device {a.device}")
