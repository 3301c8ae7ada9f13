"""CUDA MLA decode attention (`csrc/mla_decode.cu`) and its ctypes wrapper.

One hand-written kernel for the weight-absorbed attention of one query
position over the bf16 latent cache, with the cache's `rms_norm` fused;
a row's splits run as one thread block cluster and merge in shared
memory, in a fixed order. The source is built at first use by
`kernels/_build.py` (nvcc for `sm_90a`, with `-Xptxas -v`, whose register
and spill lines the build log keeps). The wrapper checks device, dtype,
shape, contiguity and alignment, picks the splits and head groups from
the shapes and the card's SM count (never from the data, so a captured
CUDA graph serves every step), allocates the output with `torch.empty`,
launches on the current stream, raises on a
nonzero `cudaGetLastError()`, and adds one to `LAUNCHES["mla_decode"]`.
It records nothing for autograd, so it raises first on an input that
requires grad while autograd records (`_build.refuse_grad`). Nothing here
runs on the CPU; `ops.py` routes CPU tensors to the plain version in
`ref.py`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

_SRC = Path(__file__).resolve().parent / "csrc" / "mla_decode.cu"
NVCC_FLAGS = _build.BASE_FLAGS + ("-Xptxas", "-v") + _build.LINK_FLAGS

#: positions a tile (`T` in the source): a split covers whole tiles
TILE = 32
#: (latent width R, rope width Dr) the source is built for, and the most
#: heads one block takes at that width (more go in groups of blocks):
#: DeepSeek-V2-Lite, MiniCPM3, and both at the smoke configs' width
WIDTHS = {(512, 64): 16, (256, 32): 32, (32, 8): 16}
MAX_HEADS = 64
#: splits of a row: one cluster, 8 at most where any SM may take a block
MAX_SPLITS = 8

#: launches since the last reset (the plain version never counts)
LAUNCHES = {"mla_decode": 0}


def reset_launches() -> None:
    LAUNCHES["mla_decode"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    P, I, L, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.mla_decode_launch.argtypes = ([P] * 5 + [I, P, L, P, L]
                                      + [I] * 7 + [Fl, Fl] + [P] * 2)
    lib.mla_decode_launch.restype = ctypes.c_int


LIBRARY = _build.Library("mla_decode", _SRC, NVCC_FLAGS, _bind,
                         include_dirs=(_build.INCLUDE_DIR,))


def layout(B: int, S_max: int, H: int, R: int, Dr: int,
           n_sm: int) -> tuple[int, int]:
    """(splits a row, head groups) of a call: heads in as few groups as
    the width's block takes, then each row's positions split so that the
    blocks fill the card's `n_sm` SMs once (one block an SM), at most one
    split a tile and `MAX_SPLITS` a row."""
    groups = -(-H // WIDTHS[(R, Dr)])
    splits = n_sm // max(1, B * groups)
    return max(1, min(splits, -(-S_max // TILE), MAX_SPLITS)), groups


def _check_rows(name: str, t: torch.Tensor, B: int, dev) -> None:
    """q_pos / kv_valid: int32 [B] on `dev`, any stride (a broadcast
    position has stride 0)."""
    if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != (B,):
        raise ValueError(f"{name}: expected int32 [{B}] on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def mla_decode_fwd(q_lat, q_rope, c_kv, k_rope, kv_norm, q_pos, kv_valid, *,
                   eps: float, scale: float):
    """q_lat [B,1,H,R], q_rope [B,1,H,Dr], c_kv [B,S_max,R], k_rope
    [B,S_max,Dr] bf16 on the GPU, kv_norm [R] fp32 or bf16, q_pos and
    kv_valid int32 [B] -> o_lat [B,1,H,R] bf16, as
    `ref.mla_decode_reference`. (R, Dr) must be one of `WIDTHS` and H at
    most 64."""
    _build.refuse_grad("mla_decode", q_lat, q_rope, c_kv, k_rope)
    B, Sq, H, R = q_lat.shape
    S_max, Dr = c_kv.shape[1], k_rope.shape[-1]
    dev, bf = q_lat.device, torch.bfloat16
    if Sq != 1:
        raise ValueError(f"mla_decode: one query position, got {Sq}")
    if (R, Dr) not in WIDTHS:
        raise ValueError(f"mla_decode: latent and rope widths {(R, Dr)} not "
                         f"among {sorted(WIDTHS)}")
    if not 1 <= H <= MAX_HEADS:
        raise ValueError(f"mla_decode: {H} heads not in [1, {MAX_HEADS}]")
    _build.check("q_lat", q_lat, bf, (B, 1, H, R), dev)
    _build.check("q_rope", q_rope, bf, (B, 1, H, Dr), dev)
    _build.check("c_kv", c_kv, bf, (B, S_max, R), dev)
    _build.check("k_rope", k_rope, bf, (B, S_max, Dr), dev)
    _build.check("kv_norm", kv_norm, (torch.float32, bf), (R,), dev)
    _check_rows("q_pos", q_pos, B, dev)
    _check_rows("kv_valid", kv_valid, B, dev)
    for name, t in (("q_lat", q_lat), ("c_kv", c_kv), ("k_rope", k_rope),
                    ("kv_norm", kv_norm)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, groups = layout(B, S_max, H, R, Dr, n_sm)
    # no position at all: the plain version's empty sum
    o = torch.empty_like(q_lat) if S_max else torch.zeros_like(q_lat)
    if B and S_max:
        _build.launch(
            LAUNCHES, "mla_decode", LIBRARY.load().mla_decode_launch,
            _build.ptr(q_lat), _build.ptr(q_rope), _build.ptr(c_kv),
            _build.ptr(k_rope), _build.ptr(kv_norm),
            int(kv_norm.dtype == bf), _build.ptr(q_pos), q_pos.stride(0),
            _build.ptr(kv_valid), kv_valid.stride(0), B, S_max, H, R, Dr,
            splits, groups, float(eps), float(scale), _build.ptr(o),
            _build.stream(dev))
    return o
