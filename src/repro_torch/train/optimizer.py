"""AdamW with global-norm clipping and a warmup + cosine schedule, on the
JAX package's `train/optimizer.py`.

The arithmetic is the reference's, in fp32 tensors: the schedule and the
bias corrections are fp32 scalars, as its `lr_at` and `b ** step` are;
each leaf's update is its `upd` step by step. Trees are {name: tensor}
dicts (`named`): a module's `named_parameters()`, whose names are the
reference's dict keys, so `_decay_mask` reads the last component as the
reference reads its path's last key. Unlike the reference, which returns
new trees, `adamw_update` updates the parameters and the state's moments
and masters in place (a checkpoint snapshot must be a copy: see
`checkpoint.AsyncCheckpointer`).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn


class AdamWState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    # fp32 master copy when training with bf16 weights; None => params
    # are the masters
    master: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def named(params) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a module's parameters, or a dict as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _libm() -> ctypes.CDLL:
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.cosf.argtypes = [ctypes.c_float]
    lib.cosf.restype = ctypes.c_float
    return lib


def _cosf(x: torch.Tensor) -> torch.Tensor:
    """cos of a 0-d fp32 tensor by the C library's `cosf`, which JAX's CPU
    `cos` gives bit for bit; `torch.cos` rounds about one argument in 20
    to the other neighbour."""
    return _f32(_libm().cosf(float(x)))


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at `step`, a 0-d fp32 tensor on the CPU, each
    operation rounded to fp32 as the reference's (run op by op)."""
    step = _f32(step)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1.0 + _cosf(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params, keep_master: bool = False) -> AdamWState:
    """Zero fp32 moments beside every parameter, on its device (and its
    placements, for a DTensor); with `keep_master`, fp32 copies of the
    parameters as masters."""
    p = named(params)
    zeros = {k: torch.zeros_like(t, dtype=torch.float32)
             for k, t in p.items()}
    master = ({k: t.detach().float().clone() for k, t in p.items()}
              if keep_master else None)
    return AdamWState(step=0, m=zeros,
                      v={k: z.clone() for k, z in zeros.items()},
                      master=master)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares in fp32, the leaves added
    one by one in the tree's order (the reference adds its leaves in
    sorted-key order with each slot's groups stacked: another order)."""
    total = None
    for x in named(tree).values():
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _decay_mask(name: str) -> bool:
    """Weight decay only on matrices (not norms/bias/1-d params)."""
    name = name.rsplit(".", 1)[-1]
    return not (name.startswith("ln") or name.startswith("b_")
                or name in ("final_norm", "norm", "q_norm", "kv_norm",
                            "lam", "A_log", "D", "dt_bias", "b"))


def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step on `params` (a module or {name: tensor}) with
    `grads` ({name: tensor}, any float dtype), in place. Returns (params,
    the state with the new step, {"grad_norm", "lr"})."""
    p = named(params)
    g_all = named(grads)
    gnorm = global_norm(g_all)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    c1 = float(1.0 - _f32(cfg.b1) ** _f32(step))
    c2 = float(1.0 - _f32(cfg.b2) ** _f32(step))
    lr_ = float(lr)
    masters = state.master if state.master is not None else p
    with torch.no_grad():
        for k, w in masters.items():
            g = g_all[k].float() * scale
            m, v = state.m[k], state.v[k]
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            if _decay_mask(k):
                delta = delta + cfg.weight_decay * w.float()
            new_w = w.float() - lr_ * delta
            if state.master is not None:
                w.copy_(new_w)
            p[k].copy_(new_w.to(p[k].dtype))
    return params, state._replace(step=step), {"grad_norm": gnorm,
                                                "lr": lr}
