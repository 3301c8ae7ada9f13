"""Plain PyTorch version of the SSD chunked-scan kernel (`kernel.py`).

The defining sequential recurrence of `repro/kernels/ssd_scan/ref.py`,
per (batch, head), from a zero state:
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T ;  y_t = C_t h_t
in fp32, y in `x.dtype` and h_last in fp32. B and C are per head, as in
the reference; `ops.ssd` expands groups to heads before it calls this.
The CPU path of `ops.ssd` runs it, and `chip_smoke.py` holds the CUDA
kernel to it on the card.
"""
from __future__ import annotations

import torch


def ssd_reference(x, dt, A, Bh, Ch):
    """x [B,S,H,P], dt [B,S,H], A [H], Bh/Ch [B,S,H,N] ->
    (y [B,S,H,P], h_last [B,H,N,P])."""
    B, S, H, P = x.shape
    N = Bh.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = Bh.float(), Ch.float(), A.float()
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    for t in range(S):
        a = torch.exp(dtf[:, t] * Af[None, :])                  # [B,H]
        upd = torch.einsum("bhn,bhp->bhnp", Bf[:, t],
                           xf[:, t] * dtf[:, t, :, None])
        h = a[..., None, None] * h + upd
        ys[:, t] = torch.einsum("bhn,bhnp->bhp", Cf[:, t], h)
    return ys.to(x.dtype), h
