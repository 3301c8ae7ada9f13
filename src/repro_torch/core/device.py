"""Device selection shared by every entry point of the port.

Entry points take `device=` and default to `"cuda"`. Asking for the GPU
on a machine without one is an error, never a quiet fall back to the
CPU: a CPU run reports no device metric, so it must be asked for.
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} asked for a GPU but torch sees none; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
