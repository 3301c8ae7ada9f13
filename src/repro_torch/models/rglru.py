"""RG-LRU recurrent block (Griffin / RecurrentGemma), on the JAX package's
`models/rglru.py` with the semantics it has under `use_pallas=True`.

y = W_out( RG_LRU(conv1d(W_x x)) * gelu(W_gate x) )

RG-LRU recurrence (per channel):
    r_t = sigmoid(w_r x_t + b_r)          recurrence gate
    i_t = sigmoid(w_i x_t + b_i)          input gate
    a_t = exp(-c * softplus(L) * r_t)     log-space decay, L learnable
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Scoring and a prefill that carries state both run the recurrence through
`kernels/rg_lru` (the CUDA kernel on the GPU, its plain sequential version
on the CPU): a carried h folds into step 0, as the reference's `_scan`
does, and the scan then starts from zero. While autograd records, and
on fake tensors (`modules.plain_forms`), both run the reference's
`_scan`, a log-depth associative scan, on every device, as the reference
trains under `use_pallas=False`: the kernel has no backward. Under a
sharding policy the kernel runs on each rank's batch and channel shard
(`_kernel_scan`). Decode carries h (and the conv window) in `RGLRUState`,
as the reference does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rg_lru import ops as rg_ops
from repro_torch.parallel import sharding as shd
from repro_torch.models import modules as nn


class RGLRUState(NamedTuple):
    h: torch.Tensor      # [B, R] recurrent state
    conv: torch.Tensor   # [B, W-1, R] conv window

    @staticmethod
    def init(batch, d_rnn, conv_width, dtype=torch.float32, device=None):
        return RGLRUState(
            torch.zeros((batch, d_rnn), dtype=dtype, device=device),
            torch.zeros((batch, conv_width - 1, d_rnn), dtype=dtype,
                        device=device))


def rglru_init(generator: torch.Generator, cfg):
    rc = cfg.rglru
    d = cfg.d_model
    r = rc.d_rnn or d
    dev = generator.device
    # Lambda init so that a ~ U(0.9, 0.999)^c-ish (Griffin appendix)
    u = torch.empty(r, device=dev).uniform_(0.9, 0.999, generator=generator)
    lam = torch.log(torch.expm1(-torch.log(u) / rc.c))  # softplus^-1
    return {
        "w_x": nn.dense_init(generator, d, r),
        "w_gate": nn.dense_init(generator, d, r),
        "conv": nn.conv1d_init(generator, rc.conv_width, r),
        "w_r": nn.dense_init(generator, r, r),
        "b_r": torch.zeros(r, device=dev),
        "w_i": nn.dense_init(generator, r, r),
        "b_i": torch.zeros(r, device=dev),
        "lam": lam,
        "w_out": nn.dense_init(generator, r, d),
    }


def _gates(p, cfg, u):
    """u [B,S,R] (post-conv) -> (a, bx) with h_t = a h_{t-1} + bx, fp32."""
    rc = cfg.rglru
    r = torch.sigmoid(nn.linear(u, p["w_r"], p["b_r"]).float())
    i = torch.sigmoid(nn.linear(u, p["w_i"], p["b_i"]).float())
    log_a = -rc.c * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bx = beta * (i * u.float())
    return a, bx


def _combine(x, y):
    """The recurrence's associative operator on (a, b) pairs."""
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, a2 * b1 + b2


def _assoc_scan(a, b):
    """Inclusive scan of `_combine` along axis 1 in log depth, in the
    order of `jax.lax.associative_scan`: combine adjacent pairs, scan the
    pairs, then fill in the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = _assoc_scan(ra, rb)                  # positions 1, 3, 5, ...
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)         # positions 0, 2, 4, ...
    eb = torch.cat([b[:, :1], eb], dim=1)

    def interleave(even, odd):
        out = torch.stack([even[:, :odd.shape[1]], odd], dim=2).flatten(1, 2)
        return torch.cat([out, even[:, odd.shape[1]:]], dim=1)

    return interleave(ea, oa), interleave(eb, ob)


def _scan(a, bx, h0=None):
    """The reference's `_scan`: h_t = a_t h_{t-1} + bx_t along axis 1 by an
    associative scan in fp32, differentiable, with a carried h0 folded
    into step 0. The model runs it while autograd records; the kernel
    (and its sequential plain version) otherwise. Under a sharding policy
    each rank scans its batch and channel shard."""
    if shd.is_dtensor(a) and shd.active_mesh() is not None:
        bat = shd.axis_for("batch", a.shape[0])
        spec = (bat, None, shd.head_axis(bat, a.shape[2]))
        return shd.local_call(_scan, (a, bx, h0),
                              (spec, spec, spec[::2]), (spec,))
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]],
                       dim=1)
    return _assoc_scan(a, bx)[1]


def _kernel_scan(a, bx, h0=None):
    """The recurrence by the kernel (its sequential plain version on the
    CPU), each rank on its batch and channel shard; a carry h0 is folded
    into step 0 first (two rounded operations, as the reference's
    `_scan`; bx is the caller's own, so in place), then the scan runs
    from zero: fmul(a_0, 0) + bx_0' is bx_0', so h equals the sequential
    recurrence from h0."""
    def scan(a, bx, h0):
        if h0 is not None:
            bx[:, 0] += a[:, 0] * h0.float()
        return rg_ops.rg_lru_scan(a, bx)

    bat = shd.axis_for("batch", a.shape[0])
    spec = (bat, None, shd.head_axis(bat, a.shape[2]))
    return shd.local_call(scan, (a, bx, h0), (spec, spec, spec[::2]),
                          (spec,))


def rglru_apply(p, cfg, x, state: Optional[RGLRUState] = None):
    """x [B,S,D] -> (y [B,S,D], new_state)."""
    rc = cfg.rglru
    gate = F.gelu(nn.linear(x, p["w_gate"]), approximate="tanh")
    u = nn.linear(x, p["w_x"])
    if state is None:
        u = nn.conv1d_apply(p["conv"], u)
        a, bx = _gates(p, cfg, u)
        h = (_scan(a, bx) if nn.plain_forms(a, bx)
             else _kernel_scan(a, bx))
        new_state = None
    elif x.shape[1] == 1:
        ut, conv_w = nn.conv1d_step(p["conv"], u[:, 0], state.conv)
        a, bx = _gates(p, cfg, ut[:, None, :])
        h = a * state.h[:, None, :].float() + bx
        new_state = RGLRUState(h[:, -1].to(state.h.dtype), conv_w)
    else:  # chunked prefill with carry
        full = torch.cat([state.conv.to(u.dtype), u], dim=1)
        u = nn.conv1d_apply(p["conv"], full)[:, state.conv.shape[1]:]
        a, bx = _gates(p, cfg, u)
        if nn.plain_forms(a, bx, state.h):
            h = _scan(a, bx, h0=state.h.float())
        else:
            h = _kernel_scan(a, bx, state.h)
        new_state = RGLRUState(
            h[:, -1].to(state.h.dtype),
            full[:, -(rc.conv_width - 1):, :].to(state.conv.dtype))
    y = nn.linear(h.to(x.dtype) * gate, p["w_out"])
    return y, new_state
