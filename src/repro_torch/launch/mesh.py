"""Device meshes and the hardware constants of the card the port runs on,
on the JAX package's `launch/mesh.py`.

`make_production_mesh(multi_pod=...)` and `make_local_mesh(data, model)`
build torch `DeviceMesh`es with the reference's shapes and axis names:
(16, 16) over ("data", "model"), (2, 16, 16) over ("pod", "data",
"model"), and a local (data, model) mesh clamped to the process group's
size, as the reference clamps to `len(jax.devices())`. Both need a
process group of the right size (the dry-run opens a fake one) and take
the device type, `cuda` by default.

The constants are the NVIDIA H100 SXM5 80GB's (NVIDIA's data sheet):
dense bf16 tensor-core peak, HBM3 bandwidth and device memory. `ICI_BW`
keeps the reference's one-constant form for the collective term of the
roofline (`launch/roofline.py`): the link a production mesh's
collectives cross. A 16 x 16 mesh spans 32 nodes of 8 cards, so every
axis of it (the 16-wide "model" axis too) leaves the node's NVLink
domain (900 GB/s a card) for the inter-node fabric: in NVIDIA's DGX H100
reference design each card has its own ConnectX-7 port at 400 Gb/s
(InfiniBand NDR), 50 GB/s a card in each direction. That is the value.
The serving cost model (`serve/costmodel.py`) reads the first two
constants.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12        # per card, dense bf16
HBM_BW = 3.35e12                # bytes/s per card
ICI_BW = 50e9                   # bytes/s per card, one 400 Gb/s NDR port
CHIP_HBM_BYTES = 80e9           # H100 80GB HBM3


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """A (data, model) mesh over the first data * model ranks of the
    process group, each clamped so the mesh fits in it."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, n // data)
    return DeviceMesh(device, torch.arange(data * model).view(data, model),
                      mesh_dim_names=("data", "model"))
