"""CUDA decision kernels (`csrc/etf_ft.cu`) and their ctypes wrappers.

The source is built at first use by `kernels/_build.py` (nvcc for
`sm_90a`, `-fmad=false`, into `build/repro_torch/`, named by a hash of
the source). Every entry point returns `cudaGetLastError()`, which the
wrapper turns into an exception.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, and adds one to `LAUNCHES[name]` when it
launches. The searches have a kernel of their own at the simulator's
[R, P] = `FIXED_RP` for 16-byte aligned matrices, counted under the
search's name; the generic kernel they take elsewhere is counted under
the name with `_generic` appended, so a path that leaves the fixed
kernel shows in the counts. Nothing here runs on the CPU; `ops.py` routes CPU tensors to
the plain versions in `ref.py`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check as _check, ptr as _ptr
from repro_torch.kernels._build import stream as _stream

_SRC = Path(__file__).resolve().parent / "csrc" / "etf_ft.cu"
NVCC_FLAGS = _build.BASE_FLAGS + ("-fmad=false",) + _build.LINK_FLAGS

#: launches per kernel since the last reset (one per wrapper call that
#: reached the GPU; the plain versions never count)
LAUNCHES = {"etf_ft_search_masked": 0, "etf_ft_search": 0, "push_rows": 0,
            "avail_rows": 0, "etf_ft_search_masked_generic": 0,
            "etf_ft_search_generic": 0}

#: the simulator's [R_MAX, PEs] (`soc.ETF_LAT_MAX_N`, the default SoC)
FIXED_RP = (16, 19)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.etf_ft_search_masked_launch.argtypes = [P] * 10 + [I] * 4 + [P]
    lib.etf_ft_search_launch.argtypes = [P] * 7 + [I] * 4 + [P]
    lib.push_rows_launch.argtypes = [P] * 7 + [I, I, I, P]
    lib.avail_rows_launch.argtypes = [P] * 10 + [I] * 5 + [P]
    for fn in (lib.etf_ft_search_masked_launch, lib.etf_ft_search_launch,
               lib.push_rows_launch, lib.avail_rows_launch):
        fn.restype = ctypes.c_int


LIBRARY = _build.Library("etf_ft", _SRC, NVCC_FLAGS, _bind)
library_path = LIBRARY.path
build = LIBRARY.build
_lib = LIBRARY.load


def _launch(name: str, fn, *args) -> None:
    _build.launch(LAUNCHES, name, fn, *args)


def _search_route(name: str, avail, exec_t) -> tuple[str, int]:
    """(count name, 1 for the fixed kernel or 0 for the generic one)."""
    fixed = (tuple(avail.shape[1:]) == FIXED_RP
             and avail.data_ptr() % 16 == 0 and exec_t.data_ptr() % 16 == 0)
    return (name, 1) if fixed else (name + "_generic", 0)


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
        name, fixed = _search_route("etf_ft_search_masked", avail, exec_t)
        _launch(name, _lib().etf_ft_search_masked_launch,
                _ptr(avail), _ptr(free), _ptr(exec_t), _ptr(now),
                _ptr(slot_ok), _ptr(pe_alive), _ptr(ft_min), _ptr(slot),
                _ptr(pe), _ptr(ok), S, R, P, fixed, _stream(dev))
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
        name, fixed = _search_route("etf_ft_search", avail, exec_t)
        _launch(name, _lib().etf_ft_search_launch,
                _ptr(avail), _ptr(free), _ptr(exec_t), _ptr(now),
                _ptr(ft_min), _ptr(slot), _ptr(pe), B, R, P, fixed,
                _stream(dev))
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


def avail_rows(tasks, finish, pe_of, preds, n_preds, out_kb, us_per_kb,
               pe_cluster, bases):
    """Push-time availability rows on the GPU, gathered from the
    simulator's state in one launch: tasks [S, K] i64 (lane-local, in
    [0, T)), the flat finish [S*T + 1] f32 and pe_of [S*T + 1] i64 buffers,
    preds [S, T, MP] i64, n_preds [S, T] i64, out_kb [S, T] f32, us_per_kb
    [] f32, pe_cluster [P] i32, bases [S, K] f32. Returns rows [S, K, P]
    f32, as `ref.avail_rows_reference`."""
    S, K = tasks.shape
    T, MP = preds.shape[1], preds.shape[2]
    P = pe_cluster.shape[0]
    dev = tasks.device
    f32, i64 = torch.float32, torch.int64
    _check("tasks", tasks, i64, (S, K), dev)
    _check("finish", finish, f32, (S * T + 1,), dev)
    _check("pe_of", pe_of, i64, (S * T + 1,), dev)
    _check("preds", preds, i64, (S, T, MP), dev)
    _check("n_preds", n_preds, i64, (S, T), dev)
    _check("out_kb", out_kb, f32, (S, T), dev)
    _check("us_per_kb", us_per_kb, f32, (), dev)
    _check("pe_cluster", pe_cluster, torch.int32, (P,), dev)
    _check("bases", bases, f32, (S, K), dev)
    rows = torch.empty((S, K, P), dtype=f32, device=dev)
    if S * K * P:
        _launch("avail_rows", _lib().avail_rows_launch,
                _ptr(tasks), _ptr(finish), _ptr(pe_of), _ptr(preds),
                _ptr(n_preds), _ptr(out_kb), _ptr(us_per_kb),
                _ptr(pe_cluster), _ptr(bases), _ptr(rows), S, K, T, MP, P,
                _stream(dev))
    return rows
