"""Hardware constants of the card the port runs on.

The port of `repro/launch/mesh.py`'s constants, for the NVIDIA H100 SXM5
80GB (NVIDIA's data sheet): dense bf16 tensor-core peak, HBM3
bandwidth, device memory, and NVLink bandwidth where the reference has
its ICI link rate. The serving cost model (`serve/costmodel.py`) divides
by the first two. `ICI_BW` and `CHIP_HBM_BYTES` are read by nothing yet:
they are kept for the mesh functions and the roofline section of the
launch and analysis slice (ROADMAP queue 1 item 9), which read them in
the reference.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12        # per card, dense bf16
HBM_BW = 3.35e12                # bytes/s per card
ICI_BW = 900e9                  # bytes/s per card, NVLink 4 (all links)
CHIP_HBM_BYTES = 80e9           # H100 80GB HBM3
