"""Build and binding helpers shared by the port's CUDA kernels.

Each kernel package keeps its source under `csrc/` and describes it as a
`Library`: the source is compiled at first use with `nvcc` for `sm_90a`
into a shared library under `build/repro_torch/` at the repository root,
named by a hash of every file in the source's `csrc/` directory and in
its include directories (`include/`, shared by the kernels, is passed as
`-I`) and of the flags, so an edit to a source or to a shared header
rebuilds every library that reads it and an unchanged source is reused.
The compiler's output is kept beside the library (`.log`), so that
`-Xptxas -v` register and spill lines can be read after a build.
The libraries have a plain C interface:
pointers go in as `c_void_p`, every kernel runs on the current PyTorch
stream, and every entry point returns `cudaGetLastError()`, which
`launch` turns into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: headers shared by the kernels (`ptx.cuh`)
INCLUDE_DIR = Path(__file__).resolve().parent / "include"
#: flags every library shares; a library may add its own (`-fmad=false`)
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3")
LINK_FLAGS = ("-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on first "
                       "use and need the CUDA toolkit")


class Library:
    """One CUDA source compiled into one shared library, loaded once.

    `bind(lib)` declares the entry points' `argtypes` and `restype` when
    the library is first loaded. `include_dirs` are passed to nvcc as
    `-I` and their files are part of the library's hash."""

    def __init__(self, name: str, src: Path, flags: tuple, bind,
                 include_dirs: tuple = ()):
        self.name, self.src, self.flags, self._bind = name, src, flags, bind
        self.include_dirs = tuple(Path(d) for d in include_dirs)
        self._cdll = None

    def path(self) -> Path:
        h = hashlib.sha256(" ".join(self.flags).encode())
        for i, root in enumerate((self.src.parent, *self.include_dirs)):
            for f in sorted(p for p in root.rglob("*") if p.is_file()):
                h.update(f"{i}/{f.relative_to(root)}".encode() + b"\0")
                h.update(f.read_bytes())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def ptxas_lines(self) -> list[str]:
        """The register, spill and wgmma lines that ptxas printed when the
        library was built with `-Xptxas -v` (else none)."""
        log = self.path().with_suffix(".log")
        if not log.exists():
            return []
        keys = ("Compiling entry", "registers", "spill", "wgmma")
        return [ln.strip() for ln in log.read_text().splitlines()
                if any(k in ln for k in keys)]

    def build(self) -> tuple[Path, float]:
        """Compile the library if it is not built yet; returns (path,
        seconds spent compiling, 0.0 when it was already there)."""
        out = self.path()
        if out.exists():
            return out, 0.0
        out.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        incs = [f"-I{d}" for d in self.include_dirs]
        cmd = [nvcc(), *self.flags, *incs, "-o", tmp, str(self.src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        return out, time.perf_counter() - t0

    def load(self) -> ctypes.CDLL:
        if self._cdll is None:
            path, _ = self.build()
            lib = ctypes.CDLL(str(path))
            self._bind(lib)
            self._cdll = lib
        return self._cdll


def records_grad(*ts) -> bool:
    """True while autograd records through any of `ts`: grad mode is on
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def refuse_grad(kernel: str, *ts) -> None:
    """Raise while autograd records through any of `ts`.

    The kernels are forward only, as the reference's Pallas kernels are
    (no `custom_vjp`): an output allocated here and written through ctypes
    would carry no `grad_fn`, and every gradient upstream of it would be
    lost without a word. The models take the plain forms while autograd
    records (`records_grad`), so a training step never reaches a kernel.
    Called before `check`, so it also holds for CPU tensors."""
    if records_grad(*ts):
        raise RuntimeError(
            f"{kernel}: an input requires grad, and the kernel has no "
            "backward (nor has the reference's Pallas kernel): train "
            "through the plain forms, or call it under torch.no_grad() or "
            "torch.inference_mode()")


def check(name: str, t: torch.Tensor, dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless `t` is a contiguous CUDA tensor on `device` of the
    given dtype (one dtype or a tuple of them) and shape."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, "
                         f"got {t.device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: expected {' or '.join(map(str, dtypes))}"
                         f", got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(counts: dict, name: str, fn, *args) -> None:
    """Call a C entry point; raise on its CUDA error code, else count one
    launch of `name` in `counts`."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")
    counts[name] += 1
