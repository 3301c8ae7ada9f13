"""Mamba-2 SSD (state-space duality) block, on the JAX package's
`models/ssd.py` with the semantics it has under `use_pallas=True`.

Block: in_proj -> (z, x, B, C, dt); causal conv1d on (x, B, C); SSD scan
with scalar-per-head decay A; gated RMSNorm on z; out_proj.

SSD chunked algorithm (Dao & Gu 2024, sec. 6): split the sequence into
chunks of length Q. Within a chunk the output is a masked (C B^T)
attention ("duality"); across chunks a small [H, N, P] state is carried.

The stateless path (scoring) runs the scan through `kernels/ssd_scan`
(the CUDA kernel on the GPU, its plain version on the CPU); a prefill
that carries state runs the plain chunked form `ssd_chunked` with `h0`,
and decode carries (conv windows, ssd state) in `SSDState` through
`ssd_step`, as the reference does. While autograd records, and on fake
tensors (`modules.plain_forms`), the stateless path runs `ssd_chunked`
too, on every device, as the reference trains under `use_pallas=False`:
the kernel has no backward. Under a sharding policy the scans and the
decode step run on each rank's batch and head shard (`_local_scan`,
`_local_step`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.parallel import sharding as shd
from repro_torch.models import modules as nn


class SSDState(NamedTuple):
    h: torch.Tensor          # [B, H, N, P] ssd state
    conv_x: torch.Tensor     # [B, W-1, H*P]
    conv_B: torch.Tensor     # [B, W-1, G*N]
    conv_C: torch.Tensor     # [B, W-1, G*N]

    @staticmethod
    def init(batch, n_heads, d_state, head_dim, conv_width, n_groups,
             dtype=torch.float32, device=None):
        w = conv_width - 1

        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        return SSDState(z(batch, n_heads, d_state, head_dim),
                        z(batch, w, n_heads * head_dim),
                        z(batch, w, n_groups * d_state),
                        z(batch, w, n_groups * d_state))


def ssd_dims(cfg):
    sc = cfg.ssd
    d_inner = sc.expand * cfg.d_model
    n_heads = d_inner // sc.head_dim
    return d_inner, n_heads


def ssd_init(generator: torch.Generator, cfg):
    sc = cfg.ssd
    d = cfg.d_model
    d_inner, n_heads = ssd_dims(cfg)
    gn = sc.n_groups * sc.d_state
    dev = generator.device
    u = torch.empty(n_heads, device=dev).uniform_(
        math.log(1e-3), math.log(1e-1), generator=generator)
    return {
        # fused input projection -> [z, x, B, C, dt]
        "w_in": nn.dense_init(generator, d, 2 * d_inner + 2 * gn + n_heads),
        "conv_x": nn.conv1d_init(generator, sc.conv_width, d_inner),
        "conv_B": nn.conv1d_init(generator, sc.conv_width, gn),
        "conv_C": nn.conv1d_init(generator, sc.conv_width, gn),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, device=dev)),
        "D": torch.ones(n_heads, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),  # softplus^-1(dt)
        "norm": torch.ones(d_inner, device=dev),
        "w_out": nn.dense_init(generator, d_inner, d),
    }


def _split_in(cfg, proj):
    sc = cfg.ssd
    d_inner, n_heads = ssd_dims(cfg)
    gn = sc.n_groups * sc.d_state
    return torch.split(proj, [d_inner, d_inner, gn, gn, n_heads], dim=-1)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan, the plain form the reference runs for a prefill
    that carries state.

    x  [B, S, H, P]   inputs (head_dim P)
    dt [B, S, H]      positive step sizes
    A  [H]            negative decay rates (A < 0)
    Bm [B, S, G, N], Cm [B, S, G, N] with H % G == 0
    h0 [B, H, N, P]   optional initial state
    Returns (y [B, S, H, P] in x's dtype, h_last [B, H, N, P] fp32).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        raise ValueError(f"ssd_chunked: chunk {chunk} does not divide {S}")
    nc = S // chunk
    rep = H // G

    xb = x.reshape(Bsz, nc, chunk, H, P)
    dtb = dt.reshape(Bsz, nc, chunk, H).float()
    # expand groups to heads
    Bb = Bm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Cb = Cm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    dA = dtb * A.float()                                 # [B,nc,Q,H] (<0)
    cum = torch.cumsum(dA, dim=2)                        # within-chunk cumsum
    # seg[b,c,i,j,h] = cum_i - cum_j; exp only on the causal half (j <= i),
    # where the reference's `where` keeps it, so the other half cannot
    # overflow
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Q(i),Q(j),H]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    L = torch.exp(seg.masked_fill(~causal, float("-inf")))
    del seg

    xdt = (xb * dtb[..., None]).float()                  # weight inputs by dt
    # intra-chunk (dual / attention-like) term; the scores keep the
    # compute dtype before the cast, as the reference's einsum does
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cb, Bb).float()
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores * L, xdt)
    del scores, L

    # chunk-final states: sum_j exp(cum_Q - cum_j) B_j x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)   # [B,nc,Q,H]
    states = torch.einsum("bcjhn,bcjhp->bchnp",
                          Bb.float() * decay_to_end[..., None], xdt)

    # carry the state across chunks: h_c = exp(sum dA_c) h_{c-1} + states_c
    chunk_decay = torch.exp(cum[:, :, -1, :])            # [B,nc,H]
    h = (torch.zeros_like(states[:, 0]) if h0 is None else h0.float())
    h_prev = torch.empty_like(states)                    # state entering c
    for c in range(nc):
        h_prev[:, c] = h
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]

    # inter-chunk contribution: C_i exp(cum_i) h_prev
    in_decay = torch.exp(cum)                            # [B,nc,Q,H]
    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           Cb.float() * in_decay[..., None], h_prev)

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y.to(x.dtype), h


def _head_specs(x, Bm):
    """(batch, heads, groups) axes of the SSD's per-rank split: heads over
    the model axis where they, and the B/C groups unless there is one,
    divide it (a single group then serves the same heads on every
    rank)."""
    H, G = x.shape[-2], Bm.shape[-2]
    bat = shd.axis_for("batch", x.shape[0])
    hd = shd.head_axis(bat, H, *(() if G == 1 else (G,)))
    return bat, hd, None if G == 1 else hd


def _local_scan(scan, x, dt, A, Bm, Cm, h0):
    """`scan(x, dt, A, Bm, Cm, h0)` -> (y, h_last), each rank on its batch
    and head shard (`_head_specs`)."""
    bat, hd, g = _head_specs(x, Bm)
    x_spec, h_spec = (bat, None, hd, None), (bat, hd, None, None)
    g_spec = (bat, None, g, None)
    return shd.local_call(
        scan, (x, dt, A, Bm, Cm, h0),
        (x_spec, x_spec[:3], (hd,), g_spec, g_spec, h_spec),
        (x_spec, h_spec))


def _local_step(x_t, dt_t, A, B_t, C_t, h):
    """`ssd_step` on each rank's batch and head shard."""
    bat, hd, g = _head_specs(x_t, B_t)
    h_spec = (bat, hd, None, None)
    return shd.local_call(
        ssd_step, (x_t, dt_t, A, B_t, C_t, h),
        ((bat, hd, None), (bat, hd), (hd,), (bat, g, None), (bat, g, None),
         h_spec), ((bat, hd, None), h_spec))


def ssd_step(x_t, dt_t, A, B_t, C_t, h):
    """Single decode step. x_t [B,H,P], dt_t [B,H], B_t/C_t [B,G,N],
    h [B,H,N,P] -> (y [B,H,P] in x_t's dtype, h' fp32)."""
    rep = x_t.shape[1] // B_t.shape[1]
    Bh = B_t.repeat_interleave(rep, dim=1).float()       # [B,H,N]
    Ch = C_t.repeat_interleave(rep, dim=1).float()
    dtf = dt_t.float()
    a = torch.exp(dtf * A.float())                       # [B,H]
    upd = torch.einsum("bhn,bhp->bhnp", Bh,
                       (x_t * dt_t[..., None]).float())
    h = a[..., None, None] * h.float() + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, h)
    return y.to(x_t.dtype), h


def ssd_apply(p, cfg, x, state: Optional[SSDState] = None):
    """x [B,S,D] -> (y [B,S,D], new_state)."""
    sc = cfg.ssd
    d_inner, n_heads = ssd_dims(cfg)
    proj = nn.linear(x, p["w_in"])
    z, xs, Bm, Cm, dt = _split_in(cfg, proj)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    B_, S, _ = x.shape
    if state is None or S > 1:
        if state is None:
            xs_c = nn.conv1d_apply(p["conv_x"], xs)
            Bc = nn.conv1d_apply(p["conv_B"], Bm)
            Cc = nn.conv1d_apply(p["conv_C"], Cm)
            h0 = None
        else:  # chunked prefill continuation
            def warm(pc, seq, win):
                full = torch.cat([win.to(seq.dtype), seq], dim=1)
                return (nn.conv1d_apply(pc, full)[:, win.shape[1]:],
                        full[:, -(sc.conv_width - 1):, :])
            xs_c, wx = warm(p["conv_x"], xs, state.conv_x)
            Bc, wb = warm(p["conv_B"], Bm, state.conv_B)
            Cc, wc = warm(p["conv_C"], Cm, state.conv_C)
            h0 = state.h
        xh = shd.split_heads(F.silu(xs_c), n_heads)
        Bh = shd.split_heads(F.silu(Bc), sc.n_groups)
        Ch = shd.split_heads(F.silu(Cc), sc.n_groups)
        dth = dt.reshape(B_, S, n_heads)
        qc = min(sc.chunk, S)
        while S % qc:
            qc //= 2
        kernel = state is None and not nn.plain_forms(xh, dth, A, Bh, Ch)

        def scan(x, dt, A, Bm, Cm, h0):
            if kernel:
                return ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=qc)
            # a carried state, or training: the plain chunked form
            return ssd_chunked(x, dt, A, Bm, Cm, chunk=qc, h0=h0)
        y, h_last = _local_scan(scan, xh, dth, A, Bh, Ch, h0)
        y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
        y = shd.merge_heads(y, n_heads)
        new_state = None
        if state is not None:
            new_state = SSDState(h_last, wx.to(state.conv_x.dtype),
                                 wb.to(state.conv_B.dtype),
                                 wc.to(state.conv_C.dtype))
    else:  # single-token decode; fp32 windows promote the step to fp32
        xt, wx = nn.conv1d_step(p["conv_x"], xs[:, 0], state.conv_x)
        Bt, wb = nn.conv1d_step(p["conv_B"], Bm[:, 0], state.conv_B)
        Ct, wc = nn.conv1d_step(p["conv_C"], Cm[:, 0], state.conv_C)
        xh = shd.split_heads(F.silu(xt), n_heads)
        y, h = _local_step(
            xh, dt.reshape(B_, 1, n_heads)[:, 0], A,
            shd.split_heads(F.silu(Bt), sc.n_groups),
            shd.split_heads(F.silu(Ct), sc.n_groups), state.h)
        y = y + xh * p["D"].to(y.dtype)[None, :, None]
        y = shd.merge_heads(y[:, None], n_heads)
        new_state = SSDState(h, wx.to(state.conv_x.dtype),
                             wb.to(state.conv_B.dtype),
                             wc.to(state.conv_C.dtype))

    y = nn.rms_norm(y * F.silu(z[:, :y.shape[1]]), p["norm"], cfg.norm_eps)
    return nn.linear(y, p["w_out"]), new_state
