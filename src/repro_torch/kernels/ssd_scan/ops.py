"""Dispatch for the SSD chunked scan, by the device of the inputs.

A CUDA tensor launches the hand-written kernel (`kernel.py`), which reads
B and C per group, or raises; a CPU tensor expands groups to heads, as
the reference's `repro/kernels/ssd_scan/ops.py` does, and takes the
plain sequential recurrence (`ref.py`). There is no switch and no fall
back.
"""
from __future__ import annotations

from repro_torch.kernels.ssd_scan import kernel, ref

LAUNCHES = kernel.LAUNCHES
reset_launches = kernel.reset_launches


def ssd(xh, dth, A, Bg, Cg, *, chunk=128):
    """xh [B,S,H,P], dth [B,S,H], A [H], Bg/Cg [B,S,G,N] with H % G == 0.
    Returns (y [B,S,H,P] in xh's dtype, h_last [B,H,N,P] fp32). On the
    GPU, x, B and C of mixed dtypes all take the fp32 route (the
    reference casts each to fp32; none is rounded to bf16)."""
    if xh.device.type == "cuda":
        if not xh.dtype == Bg.dtype == Cg.dtype:
            y, h = ssd(xh.float(), dth, A, Bg.float(), Cg.float(),
                       chunk=chunk)
            return y.to(xh.dtype), h
        return kernel.ssd_fwd(xh.contiguous(), dth.float().contiguous(),
                              A.float().contiguous(), Bg.contiguous(),
                              Cg.contiguous(), chunk=chunk)
    if xh.device.type == "cpu":
        kernel.check_chunk(xh.shape[1], chunk)
        return ssd_plain(xh, dth, A, Bg, Cg)
    raise ValueError(f"ssd_scan: unsupported device {xh.device}")


def ssd_plain(xh, dth, A, Bg, Cg):
    """The plain version on any device: B and C repeated to heads (group
    g serves heads g * H/G .. (g + 1) * H/G - 1, as `jnp.repeat` in the
    reference), then the sequential recurrence of `ref.py`. The repeat is
    a broadcast, which a CUDA graph can capture."""
    B, S, H, _ = xh.shape
    G, N = Bg.shape[2], Bg.shape[3]

    def heads(t):
        return t[:, :, :, None].expand(B, S, G, H // G, N).reshape(B, S, H, N)

    return ref.ssd_reference(xh, dth, A, heads(Bg), heads(Cg))
