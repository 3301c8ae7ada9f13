"""Fault-tolerant checkpointing, on the JAX package's
`checkpoint/checkpoint.py`.

Layout:  <dir>/step_<N>/
             manifest.json     (leaf names, shapes, dtypes, step, meta)
             arrays.npz        (flat leaves, keyed "leaf_<i>")
         <dir>/LATEST          (atomic pointer file)

Properties, as in the reference:
  * atomic: written to a tmp dir, fsync'd, then os.replace'd; LATEST is
    swapped last, so a crash mid-write never corrupts the restore path.
  * async: `save_async` takes a host snapshot (a copy, so the in-place
    optimizer's next update cannot reach it), then writes on a daemon
    thread; `wait()` joins before the next save.

A tree is nested dicts, lists, tuples and named tuples of tensors, numpy
arrays and Python numbers (None holds no leaf); an `nn.Module` in it
stands for its `named_parameters()`. The leaves are flattened in a fixed
order (dicts and modules in their own order, sequences by index) and
named by their path, `1.m.stack.groups.0.3.attn.wq`; the manifest records
each leaf's name, shape and dtype, and `restore` checks the names
against the tree it restores into. bf16 has no numpy dtype: a bf16 leaf
is saved bit for bit as its int16 view, with "bfloat16" in the manifest.

Sharded trees (DTensors, `parallel/sharding.py`) are saved whole: every
rank gathers each leaf (`full_tensor()`), rank 0 writes, and the files
are those of the same tree on one device. A restore puts each leaf on
the placements of the DTensor it restores into, so a checkpoint written
on one mesh restores onto another (the trainer's elastic re-mesh).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

BF16 = "bfloat16"


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in the tree's fixed order."""
    def join(k):
        return f"{prefix}.{k}" if prefix else str(k)
    if tree is None:
        return []
    if isinstance(tree, nn.Module):
        return [(join(k), t) for k, t in tree.named_parameters()]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flatten(v, join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for k, v in zip(tree._fields, tree)
                for x in _flatten(v, join(k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, join(i))]
    return [(prefix, tree)]


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A numpy copy of a leaf that shares no memory with it, and the
    dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        if hasattr(leaf, "full_tensor"):      # a DTensor: gathered whole
            leaf = leaf.detach().full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        a = t.numpy()
    else:
        a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def snapshot(tree) -> Tuple[List[str], List[np.ndarray], List[str]]:
    """(names, host copies, dtype names) of every leaf."""
    names, arrays, dtypes = [], [], []
    for name, leaf in _flatten(tree):
        a, dt = _host(leaf)
        names.append(name)
        arrays.append(a)
        dtypes.append(dt)
    return names, arrays, dtypes


def _fsync_write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


def _save_host(path: str, snap, step: int, meta: Optional[dict]) -> str:
    names, arrays, dtypes = snap
    step_dir = os.path.join(path, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    apath = os.path.join(tmp_dir, "arrays.npz")
    with open(apath, "wb") as f:
        np.savez(f, **{f"leaf_{i}": a for i, a in enumerate(arrays)})
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "n_leaves": len(arrays),
        "step": step,
        "names": names,
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": dtypes,
        "meta": meta or {},
    }
    _fsync_write(os.path.join(tmp_dir, "manifest.json"), json.dumps(manifest))
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)
    latest_tmp = os.path.join(path, "LATEST.tmp")
    _fsync_write(latest_tmp, os.path.basename(step_dir))
    os.replace(latest_tmp, os.path.join(path, "LATEST"))
    return step_dir


def save(path: str, tree, step: int, meta: Optional[dict] = None) -> str:
    snap = snapshot(tree)
    step_dir = _save_host(path, snap, step, meta) if _writer() else \
        os.path.join(path, f"step_{step:08d}")
    _barrier()
    return step_dir


def latest_step(path: str) -> Optional[int]:
    lp = os.path.join(path, "LATEST")
    if not os.path.exists(lp):
        return None
    with open(lp) as f:
        name = f.read().strip()
    if not name.startswith("step_"):
        return None
    d = os.path.join(path, name)
    if not os.path.exists(os.path.join(d, "manifest.json")):
        return None
    return int(name[5:])


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == BF16 else t


def _placed(full: torch.Tensor, like, device) -> torch.Tensor:
    """A saved whole tensor on `device`, or, where `like` is a DTensor, on
    like's mesh and placements (every rank read the same file, so each
    keeps its own shard: no collective)."""
    full = full.to(device)
    if not hasattr(like, "placements"):
        return full
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full, like.device_mesh, like.placements,
                             src_data_rank=None)


def _writer() -> bool:
    """Whether this process writes checkpoints: the only one, or rank 0
    of a process group (every rank takes the snapshot, whose DTensor
    gathers are collective)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _rebuild(like, saved, device):
    """`like` with its leaves replaced, in order, by the (array, dtype)
    pairs of the iterator `saved`: tensors on `device` (default: each
    leaf's own device), numpy arrays, numbers; a module is filled in
    place (its parameters keep their identity)."""
    if like is None:
        return None
    if isinstance(like, nn.Module):
        with torch.no_grad():
            for _, p in like.named_parameters():
                p.copy_(_placed(_tensor(*next(saved)), p, p.device))
        return like
    if isinstance(like, dict):
        return {k: _rebuild(v, saved, device) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, saved, device) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, saved, device) for v in like)
    a, dtype = next(saved)
    if isinstance(like, torch.Tensor):
        return _placed(_tensor(a, dtype), like,
                       like.device if device is None else device)
    if dtype == BF16:
        raise ValueError("a bfloat16 leaf restores into a tensor only")
    if isinstance(like, (bool, int, float)):
        return type(like)(a.item())
    return a if isinstance(like, np.ndarray) else a[()]


def restore(path: str, like, step: Optional[int] = None, device=None
            ) -> Tuple[Any, int, dict]:
    """Restore into the structure of `like`. Tensor leaves come back as
    tensors on `device` (default: each leaf's own device), numpy leaves
    as arrays, numbers as numbers; a module in `like` is filled in place.
    Raises if the checkpoint's leaf names are not `like`'s."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    step_dir = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    names = [n for n, _ in _flatten(like)]
    if names != manifest["names"]:
        raise ValueError(f"{step_dir}: its leaves are not the tree's "
                         f"({len(manifest['names'])} saved, {len(names)} "
                         "asked for, or named otherwise)")
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        saved = ((data[f"leaf_{i}"], dt)
                 for i, dt in enumerate(manifest["dtypes"]))
        tree = _rebuild(like, saved, device)
    return tree, step, manifest["meta"]


class AsyncCheckpointer:
    """Serializes saves on a daemon thread; overlaps I/O with training.
    The host snapshot is taken before the thread starts. `saves` records
    each save: {"step", "bytes" written, "snapshot_s" (the copy to the
    host, which the caller waits for), "write_s" (on the thread)}."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saves: list = []

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()       # the other ranks read what rank 0 wrote
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, tree, step: int, meta: Optional[dict] = None):
        self.wait()
        t0 = time.perf_counter()
        snap = snapshot(tree)
        rec = {"step": step, "snapshot_s": time.perf_counter() - t0}
        self.saves.append(rec)

        def run():
            try:
                t1 = time.perf_counter()
                d = _save_host(self.path, snap, step, meta)
                rec["write_s"] = time.perf_counter() - t1
                rec["bytes"] = sum(os.path.getsize(os.path.join(d, f))
                                   for f in os.listdir(d))
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if _writer():
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()


def prune_old(path: str, keep: int = 3):
    if not os.path.isdir(path):
        return
    steps = sorted(
        int(d[5:]) for d in os.listdir(path)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{s:08d}"), ignore_errors=True)
