"""CUDA decision kernels (`csrc/etf_ft.cu`) and their ctypes wrappers.

The source is compiled at first use with `nvcc` for `sm_90a` into a
shared library under `build/repro_torch/` at the repository root, named
by a hash of the source, so an edit rebuilds and an unchanged source is
reused. The library has a plain C interface: pointers go in as
`c_void_p`, every kernel runs on the current PyTorch stream, and every
entry point returns `cudaGetLastError()`, which the wrapper turns into
an exception.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, and adds one to `LAUNCHES[name]` when it
launches. Nothing here runs on the CPU; `ops.py` routes CPU tensors to
the plain versions in `ref.py`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent / "csrc" / "etf_ft.cu"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

#: launches per kernel since the last reset (one per wrapper call that
#: reached the GPU; the plain versions never count)
LAUNCHES = {"etf_ft_search_masked": 0, "etf_ft_search": 0, "push_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on first "
                       "use and need the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"etf_ft-{digest[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is not built yet; returns (path, seconds
    spent compiling, 0.0 when it was already there)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.etf_ft_search_masked_launch.argtypes = [P] * 10 + [I, I, I, P]
    lib.etf_ft_search_launch.argtypes = [P] * 7 + [I, I, I, P]
    lib.push_rows_launch.argtypes = [P] * 7 + [I, I, I, P]
    for fn in (lib.etf_ft_search_masked_launch, lib.etf_ft_search_launch,
               lib.push_rows_launch):
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")
    LAUNCHES[name] += 1


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def etf_ft_search_masked(avail, free, exec_t, now, slot_ok, pe_alive=None):
    """Masked decision search on the GPU. avail/exec_t [S, R, P] f32,
    free [S, P] f32, now [S] f32, slot_ok [S, R] bool, pe_alive [S, P]
    bool or None (all alive). Returns (ft_min f32, slot i32, pe i32,
    feasible bool), each [S]: the first global minimum of the masked
    finish-time matrix, as `ref.etf_ft_masked_reference`."""
    S, R, P = avail.shape
    dev = avail.device
    f32 = torch.float32
    _check("avail", avail, f32, (S, R, P), dev)
    _check("exec_t", exec_t, f32, (S, R, P), dev)
    _check("free", free, f32, (S, P), dev)
    _check("now", now, f32, (S,), dev)
    _check("slot_ok", slot_ok, torch.bool, (S, R), dev)
    if pe_alive is not None:
        _check("pe_alive", pe_alive, torch.bool, (S, P), dev)
    if R * P == 0:
        raise ValueError("etf_ft_search_masked: empty [R, P] matrix")
    ft_min = torch.empty(S, dtype=f32, device=dev)
    slot = torch.empty(S, dtype=torch.int32, device=dev)
    pe = torch.empty(S, dtype=torch.int32, device=dev)
    ok = torch.empty(S, dtype=torch.bool, device=dev)
    if S:
        _launch("etf_ft_search_masked", _lib().etf_ft_search_masked_launch,
                _ptr(avail), _ptr(free), _ptr(exec_t), _ptr(now),
                _ptr(slot_ok), _ptr(pe_alive), _ptr(ft_min), _ptr(slot),
                _ptr(pe), _ptr(ok), S, R, P, _stream(dev))
    return ft_min, slot, pe, ok


def etf_ft_search(avail, free, exec_t, now):
    """Unmasked search: avail/exec_t [B, R, P] f32, free [B, P], now [B].
    Returns (ft_min f32, slot i32, pe i32), each [B]; non-finite finish
    times never win unless every cell is non-finite (then BIG at 0, 0)."""
    B, R, P = avail.shape
    dev = avail.device
    f32 = torch.float32
    _check("avail", avail, f32, (B, R, P), dev)
    _check("exec_t", exec_t, f32, (B, R, P), dev)
    _check("free", free, f32, (B, P), dev)
    _check("now", now, f32, (B,), dev)
    if R * P == 0:
        raise ValueError("etf_ft_search: empty [R, P] matrix")
    ft_min = torch.empty(B, dtype=f32, device=dev)
    slot = torch.empty(B, dtype=torch.int32, device=dev)
    pe = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        _launch("etf_ft_search", _lib().etf_ft_search_launch,
                _ptr(avail), _ptr(free), _ptr(exec_t), _ptr(now),
                _ptr(ft_min), _ptr(slot), _ptr(pe), B, R, P, _stream(dev))
    return ft_min, slot, pe


def push_rows(pfin, cost, pcl, pv, pe_cluster, bases):
    """Push-time availability rows on the GPU: pfin/cost [S, K, MP] f32,
    pcl [S, K, MP] i32, pv [S, K, MP] bool, pe_cluster [P] i32, bases
    [S, K] f32. Returns rows [S, K, P] f32, as `ref.push_rows_reference`."""
    S, K, MP = pfin.shape
    P = pe_cluster.shape[0]
    dev = pfin.device
    f32 = torch.float32
    _check("pfin", pfin, f32, (S, K, MP), dev)
    _check("cost", cost, f32, (S, K, MP), dev)
    _check("pcl", pcl, torch.int32, (S, K, MP), dev)
    _check("pv", pv, torch.bool, (S, K, MP), dev)
    _check("pe_cluster", pe_cluster, torch.int32, (P,), dev)
    _check("bases", bases, f32, (S, K), dev)
    rows = torch.empty((S, K, P), dtype=f32, device=dev)
    if S * K * P:
        _launch("push_rows", _lib().push_rows_launch,
                _ptr(pfin), _ptr(cost), _ptr(pcl), _ptr(pv),
                _ptr(pe_cluster), _ptr(bases), _ptr(rows), S * K, MP, P,
                _stream(dev))
    return rows
