"""CUDA RG-LRU scan (`csrc/rg_lru.cu`) and its ctypes wrapper.

The source is built at first use by `kernels/_build.py` (nvcc for
`sm_90a`, `-fmad=false`, `include/ptx.cuh` for the mbarrier wrappers).
The wrapper checks device, dtype, shape and contiguity, chooses the
route with `route`, allocates the output with `torch.empty`, launches on
the current stream and raises on a nonzero `cudaGetLastError()`. The TMA
ring kernel counts under `LAUNCHES["rg_lru"]`, the generic kernel (inputs
TMA cannot take) under `LAUNCHES["rg_lru_generic"]`, so a path that
leaves the ring shows in the counts. It records nothing for autograd,
so it raises first on an input that requires grad while autograd
records (`_build.refuse_grad`). Nothing here runs on the CPU;
`ops.py` routes CPU tensors to the plain version in `ref.py`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

_SRC = Path(__file__).resolve().parent / "csrc" / "rg_lru.cu"
NVCC_FLAGS = _build.BASE_FLAGS + ("-fmad=false",) + _build.LINK_FLAGS

#: launches since the last reset (the plain version never counts)
LAUNCHES = {"rg_lru": 0, "rg_lru_generic": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rg_lru_launch.argtypes = [P] * 3 + [I] * 5 + [P]
    lib.rg_lru_launch.restype = ctypes.c_int


LIBRARY = _build.Library("rg_lru", _SRC, NVCC_FLAGS, _bind,
                         include_dirs=(_build.INCLUDE_DIR,))


def route(B: int, C: int, dtype: torch.dtype, *ptrs: int) -> str:
    """The kernel that takes a, b [B, S, C] of `dtype` at the data pointers
    `ptrs`, named as it counts: "rg_lru", the TMA ring, when every pointer
    is 16-byte aligned and a row of C elements a multiple of 16 bytes
    (TMA's rules), else "rg_lru_generic", whose grid holds at most 65535
    batch rows (a ValueError beyond)."""
    row = C * (2 if dtype == torch.bfloat16 else 4)
    if row % 16 == 0 and all(p % 16 == 0 for p in ptrs):
        return "rg_lru"
    if B > 65535:
        raise ValueError(f"rg_lru: batch {B} > 65535 on the generic route "
                         "(unaligned inputs)")
    return "rg_lru_generic"


def rg_lru_fwd(a, b):
    """a, b [B, S, C] on the GPU, each fp32 or bf16 -> h [B, S, C] in a's
    dtype, h_t = a_t h_{t-1} + b_t from h = 0 in fp32, bit-equal to
    `ref.rg_lru_reference`. When a and b differ in dtype both are taken
    to fp32 (as the reference casts each) and h is rounded to a's dtype."""
    _build.refuse_grad("rg_lru", a, b)
    B, S, C = a.shape
    dev = a.device
    dts = (torch.float32, torch.bfloat16)
    _build.check("a", a, dts, (B, S, C), dev)
    _build.check("b", b, dts, (B, S, C), dev)
    if b.dtype != a.dtype:
        return rg_lru_fwd(a.float(), b.float()).to(a.dtype)
    name = route(B, C, a.dtype, a.data_ptr(), b.data_ptr())
    y = torch.empty_like(a)
    if B * S * C:
        _build.launch(LAUNCHES, name, LIBRARY.load().rg_lru_launch,
                      _build.ptr(a), _build.ptr(b), _build.ptr(y), B, S, C,
                      int(a.dtype == torch.bfloat16), int(name == "rg_lru"),
                      _build.stream(dev))
    return y
