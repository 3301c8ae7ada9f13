"""Primitive layers of the port, on the JAX package's `models/modules.py`.

Conventions, as in the reference:
  * parameters are fp32 at rest (`param_dtype`) and cast to the compute
    dtype inside `apply`; dense weights keep the reference's
    `[d_in, *d_out]` layout, not `nn.Linear`'s `[out, in]`;
  * every init takes a `torch.Generator` and draws on its device;
  * shapes use named comments: B batch, S seq, D d_model, H heads, K kv
    heads, Dh head dim, F d_ff, V vocab.

`Params` holds a nested dict of tensors as an `nn.Module` whose
parameter names are the reference's dict keys, so the functions on
tensors read `p["w_gate"]` as the JAX code does.

`plain_forms` (on `records_grad`, the kernels' own test,
`kernels/_build.py`) chooses the route at the model's three kernel
sites: the plain, differentiable forms while autograd records (as the
reference trains, under `use_pallas=False`) and on fake tensors, the
CUDA kernels otherwise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels._build import records_grad  # noqa: F401
from repro_torch.parallel import sharding as shd


def plain_forms(*ts) -> bool:
    """Whether a kernel site takes the reference's plain form: while
    autograd records through `ts` (no kernel has a backward), and on fake
    tensors (the dry-run's shape-only run, which counts the plain forms'
    products, as the reference's dry-run lowers them under
    `use_pallas=False`; a DTensor is fake if its shard is)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return records_grad(*ts) or any(
        isinstance(getattr(t, "_local_tensor", t), FakeTensor) for t in ts)


class Params(nn.Module):
    """A nested dict (or list) of tensors as a module. `p[key]` gives a
    tensor or a sub-`Params`; lists become `nn.ModuleList`s. The tensors
    are registered without gradients, so serving records nothing; a
    trainer turns them on with `module.requires_grad_(True)`."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Params(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, _module_list(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default


def map_params(module: Params, fn) -> Params:
    """A new module of `module`'s class and structure whose every tensor
    is `fn(tensor)` (registered without gradients, as `Params` does)."""
    def tree(m):
        if isinstance(m, nn.ModuleList):
            return [tree(c) for c in m]
        return {**{k: fn(t) for k, t in m._parameters.items()},
                **{k: tree(c) for k, c in m._modules.items()}}
    return type(module)(tree(module))


def _module_list(items) -> nn.ModuleList:
    return nn.ModuleList(_module_list(v) if isinstance(v, (list, tuple))
                         else Params(v) for v in items)


def truncated_normal(generator: torch.Generator, shape, std,
                     dtype=torch.float32) -> torch.Tensor:
    """std * a standard normal truncated to [-2, 2], drawn in place on the
    generator's device (inverse CDF of a uniform on [Phi(-2), Phi(2)])."""
    t = torch.empty(shape, dtype=dtype, device=generator.device)
    lim = math.erf(2.0 / math.sqrt(2.0))
    t.uniform_(-lim, lim, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return t.mul_(std)


def dense_init(generator: torch.Generator, d_in: int, d_out,
               std: Optional[float] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Weight of shape (d_in, *d_out) with fan-in scaled init."""
    if isinstance(d_out, int):
        d_out = (d_out,)
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    return truncated_normal(generator, (d_in, *d_out), std, dtype)


def _product(x, w):
    """x [..., d_in] @ w [d_in, *rest] -> [..., *rest]."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                     *w.shape[1:])


def linear(x, w, b=None):
    """x [..., d_in] @ w [d_in, *rest] -> [..., *rest]; w is cast to
    x's dtype at use, as in the reference."""
    w = w.to(x.dtype)
    if w.ndim == 2:
        y = x @ w                  # also takes the head's transposed view
    elif shd.is_dtensor(w) and shd.active_mesh() is not None:
        y = shd.local_linear(x, w, _product)
    else:
        y = _product(x, w)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def rms_norm(x, scale, eps: float = 1e-6, zero_centered: bool = False):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    s = scale.float()
    if zero_centered:
        s = s + 1.0
    return (y * s).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(d_rot: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                         device=device) / d_rot))


def apply_rope(x, positions, theta: float = 10000.0,
               rotary_pct: float = 1.0):
    """x [B, S, H, Dh]; positions [B, S] (int). Rotates the leading
    `rotary_pct` fraction of Dh, half-split convention."""
    d = x.shape[-1]
    d_rot = int(d * rotary_pct) // 2 * 2
    if d_rot == 0:
        return x
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    freqs = rope_freqs(d_rot, theta, x.device)             # [d_rot/2]
    ang = positions[..., None].float() * freqs             # [B, S, d_rot/2]
    cos = torch.cos(ang)[..., None, :]                     # [B, S, 1, ...]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(xr.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, kind: str):
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(generator, d_model, d_ff),
            "w_up": dense_init(generator, d_model, d_ff),
            "w_down": dense_init(generator, d_ff, d_model),
        }
    if kind == "gelu":
        zeros = lambda n: torch.zeros(n, device=generator.device)  # noqa: E731
        return {
            "w_up": dense_init(generator, d_model, d_ff),
            "b_up": zeros(d_ff),
            "w_down": dense_init(generator, d_ff, d_model),
            "b_down": zeros(d_model),
        }
    raise ValueError(kind)


def mlp_apply(p, x, kind: str):
    if kind == "swiglu":
        return linear(F.silu(linear(x, p["w_gate"]))
                      * linear(x, p["w_up"]), p["w_down"])
    if kind == "geglu":
        return linear(F.gelu(linear(x, p["w_gate"]), approximate="tanh")
                      * linear(x, p["w_up"]), p["w_down"])
    if kind == "gelu":
        h = F.gelu(linear(x, p["w_up"], p["b_up"]), approximate="tanh")
        return linear(h, p["w_down"], p["b_down"])
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# causal depthwise conv1d (griffin style, cached for decode)
# ---------------------------------------------------------------------------
def conv1d_init(generator: torch.Generator, width: int, channels: int):
    return {
        "w": truncated_normal(generator, (width, channels),
                              1.0 / math.sqrt(width)),
        "b": torch.zeros(channels, device=generator.device),
    }


def conv1d_apply(p, x):
    """Causal depthwise conv. x [B, S, C] -> [B, S, C]. Under a sharding
    policy each rank convolves its batch and channel shard, the sequence
    whole (`parallel/sharding.py::local_call`)."""
    if shd.is_dtensor(x) and shd.active_mesh() is not None:
        bat = shd.axis_for("batch", x.shape[0])
        ch = shd.head_axis(bat, x.shape[2])
        return shd.local_call(lambda x, w, b: conv1d_apply({"w": w, "b": b},
                                                           x),
                              (x, p["w"], p["b"]),
                              ((bat, None, ch), (None, ch), (ch,)),
                              ((bat, None, ch),))
    w = p["w"].to(x.dtype)                        # [W, C]
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):                        # small fixed width: unroll
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out + p["b"].to(x.dtype)


def conv1d_step(p, x_t, window):
    """Single decode step. x_t [B, C]; window [B, W-1, C] (trailing inputs).
    Returns (y_t [B, C], new_window). As in the reference, a wider window
    dtype promotes the step (an fp32 state keeps a bf16 step in fp32)."""
    w = p["w"].to(x_t.dtype)
    width = w.shape[0]
    full = torch.cat([window, x_t[:, None, :]], dim=1)  # [B, W, C], promoted
    y = (torch.einsum("bwc,wc->bc", full, w.to(full.dtype))
         + p["b"].to(x_t.dtype))
    return y, full[:, -(width - 1):, :] if width > 1 else window
