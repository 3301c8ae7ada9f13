"""CUDA SSD chunked scan (`csrc/ssd_scan.cu`) and its ctypes wrapper.

bf16 inputs run on the tensor cores (wgmma fed by TMA, the shared
`kernels/include/ptx.cuh`), fp32 inputs on the CUDA cores. The
source is built at first use by `kernels/_build.py` (nvcc for `sm_90a`,
with `-Xptxas -v`, whose register and spill lines the build log keeps).
The wrapper checks device, dtype, shape and contiguity,
allocates the outputs with `torch.empty`, launches on the current
stream, raises on a nonzero `cudaGetLastError()`, and adds one to
`LAUNCHES["ssd_scan"]`. It records nothing for autograd, so it raises
first on an input that requires grad while autograd records
(`_build.refuse_grad`). Unlike the TPU kernel it takes B and C per group,
[B, S, G, N], and never expands them to heads. Nothing here runs on the
CPU; `ops.py` routes CPU tensors to the plain version in `ref.py`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

_SRC = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
# -Xptxas -v: the registers and spills of each kernel, kept in the build log
NVCC_FLAGS = _build.BASE_FLAGS + ("-Xptxas", "-v") + _build.LINK_FLAGS
MAX_CHUNK = 128
MAX_STATE = 128

#: launches since the last reset (the plain version never counts)
LAUNCHES = {"ssd_scan": 0}


def reset_launches() -> None:
    LAUNCHES["ssd_scan"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [P] * 7 + [I] * 8 + [P]
    lib.ssd_scan_launch.restype = ctypes.c_int


LIBRARY = _build.Library("ssd_scan", _SRC, NVCC_FLAGS, _bind,
                         include_dirs=(_build.INCLUDE_DIR,))


def check_chunk(S: int, chunk: int) -> None:
    """The reference asserts `S % chunk == 0` (its kernel.py:70)."""
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} does not divide S = {S}")


def ssd_fwd(x, dt, A, Bg, Cg, *, chunk=128):
    """x [B,S,H,P] fp32 or bf16, dt [B,S,H] fp32, A [H] fp32, Bg/Cg
    [B,S,G,N] in x's dtype (one projection makes all three in the model;
    `ops.ssd` takes mixed dtypes to the fp32 route)
    with G dividing H, on the GPU; 1 <= chunk <= 128
    divides S, N <= 128. Returns (y [B,S,H,P] in x's dtype, h_last
    [B,H,N,P] fp32), as `ref.ssd_reference` with B and C repeated to
    heads. bf16 runs on the tensor cores, fp32 on the CUDA cores."""
    _build.refuse_grad("ssd_scan", x, dt, A, Bg, Cg)
    B, S, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    dev = x.device
    dts = (torch.float32, torch.bfloat16)
    _build.check("x", x, dts, (B, S, H, P), dev)
    _build.check("dt", dt, torch.float32, (B, S, H), dev)
    _build.check("A", A, torch.float32, (H,), dev)
    _build.check("Bg", Bg, x.dtype, (B, S, G, N), dev)
    _build.check("Cg", Cg, x.dtype, (B, S, G, N), dev)
    check_chunk(S, chunk)
    if chunk > MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} > {MAX_CHUNK}")
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan: {H} heads over {G} groups")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssd_scan: state size {N} not in [1, "
                         f"{MAX_STATE}]")
    if B > 65535 or H > 65535:
        raise ValueError(f"ssd_scan: batch {B} or heads {H} > 65535")
    y = torch.empty_like(x)
    h_last = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    if B * S * H * P:
        _build.launch(
            LAUNCHES, "ssd_scan", LIBRARY.load().ssd_scan_launch,
            _build.ptr(x), _build.ptr(dt), _build.ptr(A), _build.ptr(Bg),
            _build.ptr(Cg), _build.ptr(y), _build.ptr(h_last),
            B, S, H, P, G, N, chunk, int(x.dtype == torch.bfloat16),
            _build.stream(dev))
    return y, h_last
