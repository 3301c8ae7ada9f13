"""Mixture-of-experts MLP with sort-based capacity dispatch, on the JAX
package's `models/moe.py`.

Router: softmax top-k (+ optional always-on shared experts, DeepSeekMoE
style). Dispatch: within each of `G` token groups the (token, choice)
pairs are sorted by destination expert and packed into a [G, E*C, D]
buffer (C = capacity); the expert SwiGLU runs as three batched products
over the expert axis, and the outputs go back weighted by the router
gate. Choices beyond an expert's capacity are dropped (Switch/GShard
semantics; the aux load-balance loss keeps the drop rate low).

Three orders are pinned to the reference's, so that the same inputs give
the same experts, the same drops and, in bf16, the same sums:

  * the top k by a stable descending sort: on a tie the lower expert
    index wins, as `jax.lax.top_k` returns it (`torch.topk` promises no
    order, and bf16 router logits tie often);
  * the sort by expert is stable (`jnp.argsort` is), which decides the
    tokens kept at capacity;
  * each token's k weighted outputs are summed in expert order, rounded
    to x's dtype after each add, as the reference's sequential
    scatter-add applies them; no atomics, so a bf16 result does not
    depend on the device.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import modules as nn
from repro_torch.parallel import sharding as shd


def moe_init(generator: torch.Generator, cfg):
    mc = cfg.moe
    d = cfg.d_model
    f = mc.d_expert
    p = {
        "router": nn.dense_init(generator, d, mc.n_experts, std=0.02),
        "w_gate": _expert_stack(generator, mc.n_experts, d, f),
        "w_up": _expert_stack(generator, mc.n_experts, d, f),
        "w_down": _expert_stack(generator, mc.n_experts, f, d),
    }
    if mc.n_shared:
        p["shared"] = nn.mlp_init(generator, d, f * mc.n_shared, "swiglu")
    return p


def _expert_stack(generator, e, d_in, d_out):
    return nn.truncated_normal(generator, (e, d_in, d_out),
                               1.0 / math.sqrt(d_in))


def _sorted_topk(probs, k: int):
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def router_topk(logits, k: int) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """logits [..., E] -> (weights [..., k] fp32, idx [..., k], aux_loss).
    Leading dims may be (G, Tl)."""
    probs = torch.softmax(logits.float(), dim=-1)
    # the sort runs on each rank's rows (DTensor has no rule for it)
    rows = (shd.axis_for("batch", probs.shape[0]),) + (None,) * (
        probs.ndim - 1)
    w, idx = shd.local_call(lambda pr: _sorted_topk(pr, k), (probs,),
                            (rows,), (rows, rows))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss
    E = logits.shape[-1]
    if shd.is_dtensor(idx):
        # mean prob and choices per expert, reduced over the ranks' rows
        # (a DTensor cannot flatten the sharded leading dims)
        me = probs.mean(dim=tuple(range(probs.ndim - 1)))
        experts = torch.arange(E, device=idx.device)
        counts = (idx[..., None] == experts).sum(
            dim=tuple(range(idx.ndim)))
    else:
        me = probs.reshape(-1, E).mean(0)                  # mean prob per e
        counts = expert_counts(idx, E)
    ce = counts.float() / idx.numel()
    aux = E * torch.sum(me * ce)
    return w, idx, aux


def expert_counts(idx, n_experts: int) -> torch.Tensor:
    """Choices per expert [E] (int64) of idx [..., k]: `torch.bincount`'s
    integers by a scatter-add, which reads nothing back on the host
    (`bincount` reads the input's maximum on a GPU), so that a captured
    decode step can count."""
    flat = idx.reshape(-1).to(torch.int64)
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def capacity(cfg, tokens: int) -> int:
    """Slots per expert in a group of `tokens` tokens (at least 8)."""
    mc = cfg.moe
    return max(int(math.ceil(tokens * mc.top_k / mc.n_experts
                             * mc.capacity_factor)), 8)


def dispatch(idx, n_experts: int, cap: int):
    """The per-group sort of the (token, choice) pairs by expert.

    idx [G, Tl, k] -> (order, se, keep, dest), each [G, Tl*k] in sorted
    order: the stable permutation, the expert of each pair, whether it
    fits in its expert's `cap` slots, and its slot in the [E*cap] buffer
    (a dropped pair points at its expert's slot 0 and carries zeros)."""
    G, Tl, K = idx.shape
    flat_e = idx.reshape(G, Tl * K)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    experts = torch.arange(n_experts, device=idx.device, dtype=se.dtype)
    seg_start = torch.searchsorted(se, experts.repeat(G, 1))
    pos = (torch.arange(Tl * K, device=idx.device)[None]
           - torch.gather(seg_start, 1, se))
    keep = pos < cap
    dest = se * cap + torch.where(keep, pos, 0)
    return order, se, keep, dest


def _pack(xt, idx, w, E: int, C: int):
    """Sort a group's (token, choice) pairs by expert and pack the kept
    ones into h [G, E, C, D]; also returns the pairs' slots, kept flags,
    gate weights in xt's dtype and sort permutation, each [G, Tl*k]."""
    G, Tl, D = xt.shape
    K = idx.shape[-1]
    order, se, keep, dest = dispatch(idx, E, C)
    stok = torch.div(order, K, rounding_mode="floor")      # token of a pair
    sw = torch.gather(w.reshape(G, Tl * K).to(xt.dtype), 1, order)
    gidx = torch.arange(G, device=xt.device)[:, None]

    # kept pairs own their slots; a dropped pair, which adds zeros to its
    # expert's slot 0 in the reference, writes a spare row instead
    buf = torch.zeros((G, E * C + 1, D), dtype=xt.dtype, device=xt.device)
    buf[gidx, torch.where(keep, dest, E * C)] = xt[gidx, stok]
    return buf[:, :E * C].reshape(G, E, C, D), dest, keep, sw, order


def _experts(h, w_gate, w_up, w_down):
    """The expert SwiGLU over packed slots h [G, E, C, D] -> [G, E, C, D]:
    three batched products over the expert axis."""
    g = torch.einsum("gecd,edf->gecf", h, w_gate)
    u = torch.einsum("gecd,edf->gecf", h, w_up)
    return torch.einsum("gecf,efd->gecd", F.silu(g) * u, w_down)


def _combine(o, dest, keep, sw, order, K: int):
    """The experts' outputs o [G, E*C, D] back to their tokens (k pairs
    each), weighted by the gates: y [G, Tl, D]."""
    G, n_pairs = order.shape
    gidx = torch.arange(G, device=o.device)[:, None]
    contrib = o[gidx, dest] * (sw * keep)[..., None]       # sorted order
    # back to [G, Tl, k] by the inverse permutation; a token's pairs in
    # ascending sorted position are its experts in ascending order
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(n_pairs, device=o.device)
                 .expand(G, n_pairs))
    spos = torch.sort(inv.reshape(G, n_pairs // K, K), dim=-1).values
    per_tok = contrib[gidx[..., None], spos]               # [G, Tl, k, D]
    y = per_tok[:, :, 0]
    for j in range(1, K):                                  # reference order
        y = y + per_tok[:, :, j]
    return y


def moe_apply(p, cfg, x):
    """x [B, S, D] -> (y, aux_loss).

    Dispatch runs within `G = moe.n_dispatch_shards` independent token
    groups (G <= 1, or B not a multiple of G: one group)."""
    mc = cfg.moe
    B, S, D = x.shape
    T = B * S
    G = max(mc.n_dispatch_shards, 1)
    if B % G != 0:
        G = 1
    Tl = T // G
    K = mc.top_k
    E = mc.n_experts
    xt = x.reshape(G, Tl, D)
    w, idx, aux = router_topk(nn.linear(xt, p["router"]), K)
    C = capacity(cfg, Tl)

    # the dispatch's sorts, gathers and scatters run on each rank's
    # groups (DTensor has no rules for them)
    groups = (shd.axis_for("batch", G), None, None)
    h, dest, keep, sw, order = shd.local_call(
        lambda xt, idx, w: _pack(xt, idx, w, E, C), (xt, idx, w),
        (groups, groups, groups), (groups + (None,),) + (groups[:2],) * 4)
    if G > 1:
        # pin the EP layout: token groups on DP axes, experts on "model"
        h = shd.constrain(h, ("batch", "model", None, None))

    # the expert SwiGLU on each rank's experts (split over "model") and
    # groups; the expert weights are gathered over the FSDP axis
    experts = (groups[0], shd.head_axis(groups[0], E), None, None)
    weights = (experts[1], None, None)
    o = shd.local_call(
        _experts, (h, *(p[k].to(x.dtype) for k in ("w_gate", "w_up",
                                                    "w_down"))),
        (experts,) + (weights,) * 3, (experts,))
    o = o.reshape(G, E * C, D)
    y = shd.local_call(lambda *t: _combine(*t, K), (o, dest, keep, sw, order),
                       (groups,) + (groups[:2],) * 4, (groups,))

    y = y.reshape(T, D)
    if mc.n_shared:
        y = y + nn.mlp_apply(p["shared"], xt.reshape(T, D), "swiglu")
    return y.reshape(B, S, D), mc.aux_loss_coef * aux


def moe_apply_dense(p, cfg, x):
    """Dense-dispatch MoE (every expert on every token, O(E) FLOPs) as the
    plain check of `moe_apply`: no capacity, so equal to it when nothing
    is dropped."""
    mc = cfg.moe
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    w, idx, aux = router_topk(nn.linear(xt, p["router"]), mc.top_k)
    combine = torch.zeros((B * S, mc.n_experts), dtype=x.dtype,
                          device=x.device)
    combine.scatter_(1, idx, w.to(x.dtype))
    g = torch.einsum("td,edf->tef", xt, p["w_gate"].to(x.dtype))
    u = torch.einsum("td,edf->tef", xt, p["w_up"].to(x.dtype))
    o = torch.einsum("tef,efd->ted", F.silu(g) * u, p["w_down"].to(x.dtype))
    y = torch.einsum("ted,te->td", o, combine)
    if mc.n_shared:
        y = y + nn.mlp_apply(p["shared"], xt, "swiglu")
    return y.reshape(B, S, D), mc.aux_loss_coef * aux
