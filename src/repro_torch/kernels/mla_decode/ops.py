"""Dispatch for the MLA decode attention, by the device of the inputs.

A CUDA tensor launches the hand-written kernel (`kernel.py`) or raises;
a CPU tensor takes the plain PyTorch version (`ref.py`). There is no
switch and no fall back. The JAX package has no kernel here: XLA runs its
absorbed attention (`repro/models/mla.py`).
"""
from __future__ import annotations

from repro_torch.kernels.mla_decode import kernel, ref

LAUNCHES = kernel.LAUNCHES
reset_launches = kernel.reset_launches


def mla_decode(q_lat, q_rope, c_kv, k_rope, kv_norm, q_pos, kv_valid, *,
               eps: float, scale: float):
    """q_lat [B,1,H,R], q_rope [B,1,H,Dr], c_kv [B,S_max,R], k_rope
    [B,S_max,Dr], kv_norm [R], q_pos and kv_valid [B] (int) -> o_lat
    [B,1,H,R]."""
    if q_lat.device.type == "cuda":
        return kernel.mla_decode_fwd(
            q_lat.contiguous(), q_rope.contiguous(), c_kv.contiguous(),
            k_rope.contiguous(), kv_norm.contiguous(), q_pos.int(),
            kv_valid.int(), eps=eps, scale=scale)
    if q_lat.device.type == "cpu":
        return ref.mla_decode_reference(q_lat, q_rope, c_kv, k_rope, kv_norm,
                                        q_pos, kv_valid, eps=eps, scale=scale)
    raise ValueError(f"mla_decode: unsupported device {q_lat.device}")
