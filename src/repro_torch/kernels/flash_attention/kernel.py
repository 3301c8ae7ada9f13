"""CUDA flash attention (`csrc/flash_attention.cu`) and its ctypes wrapper.

bf16 inputs run on the tensor cores (wgmma fed by TMA, the shared
`kernels/include/ptx.cuh`), fp32
inputs on the CUDA cores. The source is built at first use by
`kernels/_build.py` (nvcc for `sm_90a`, with `-Xptxas -v`, whose
register and spill lines the build log keeps). The wrapper checks
device, dtype, shape and contiguity,
allocates the output with `torch.empty`, launches on the current stream,
raises on a nonzero `cudaGetLastError()`, and adds one to
`LAUNCHES["flash_attention"]`. It records nothing for autograd, so it
raises first on an input that requires grad while autograd records
(`_build.refuse_grad`). Nothing here runs on the CPU; `ops.py`
routes CPU tensors to the plain version in `ref.py`.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# -Xptxas -v: the registers and spills of each kernel, kept in the build log
NVCC_FLAGS = _build.BASE_FLAGS + ("-Xptxas", "-v") + _build.LINK_FLAGS
MAX_DH = 256

#: launches since the last reset (the plain version never counts)
LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = ([P] * 4 + [I] * 7 + [Fl, Fl]
                                           + [I, P])
    lib.flash_attention_launch.restype = ctypes.c_int


LIBRARY = _build.Library("flash_attention", _SRC, NVCC_FLAGS, _bind,
                         include_dirs=(_build.INCLUDE_DIR,))


def common_width(q, k, v):
    """q/k of width Dh and v of width Dv padded with zero columns to
    max(Dh, Dv), the one head width the kernel takes: zero columns of q
    and k add nothing to a score, zero columns of v give zero output
    columns, which the caller slices off."""
    D = max(q.shape[-1], v.shape[-1])

    def pad(t):
        return t if t.shape[-1] == D else torch.nn.functional.pad(
            t, (0, D - t.shape[-1]))

    return pad(q), pad(k), pad(v)


def flash_attention_fwd(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q [B,S,H,Dh], k [B,S,K,Dh], v [B,S,K,Dv] on the GPU, fp32 or bf16,
    H % K == 0, Dh and Dv <= 256, any S >= 1 -> [B,S,H,Dv] in q's dtype,
    as `ref.mha_reference` (scores scaled by 1 / sqrt(Dh)). bf16 runs on
    the tensor cores, fp32 on the CUDA cores. When Dv differs from Dh the
    narrower operands are padded to the wider width (`common_width`) and
    the output is sliced back to Dv."""
    _build.refuse_grad("flash_attention", q, k, v)
    B, S, H, Dh = q.shape
    K, Dv = k.shape[2], v.shape[3]
    dev = q.device
    dts = (torch.float32, torch.bfloat16)
    _build.check("q", q, dts, (B, S, H, Dh), dev)
    _build.check("k", k, q.dtype, (B, S, K, Dh), dev)
    _build.check("v", v, q.dtype, (B, S, K, Dv), dev)
    if K < 1 or H % K:
        raise ValueError(f"flash_attention: {H} query heads over {K} KV "
                         "heads")
    for name, d in (("head", Dh), ("value", Dv)):
        if not 1 <= d <= MAX_DH:
            raise ValueError(f"flash_attention: {name} dim {d} not in "
                             f"[1, {MAX_DH}]")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    qp, kp, vp = common_width(q, k, v)
    o = torch.empty_like(qp)
    if B * S:
        _build.launch(
            LAUNCHES, "flash_attention", LIBRARY.load().flash_attention_launch,
            _build.ptr(qp), _build.ptr(kp), _build.ptr(vp), _build.ptr(o),
            B, S, H, K, qp.shape[-1], int(bool(causal)), int(window),
            float(softcap), float(math.sqrt(Dh)),
            int(q.dtype == torch.bfloat16), _build.stream(dev))
    return o if Dv == o.shape[-1] else o[..., :Dv].contiguous()
