"""Block assembly: pre-norm residual blocks over a heterogeneous layer
pattern, on the JAX package's `models/transformer.py`.

The layer pattern (cfg.pattern) repeats with period P. The reference
stacks each slot's parameters along a group axis and scans over groups;
here `stack["groups"][slot][g]` is one layer's own `Params` and the scan
is a Python loop. Layers left over after the last full period join the
prologue, which runs BEFORE the groups, exactly as in the reference
(`stack_layout`): at 38 layers of (rglru, rglru, local) the two trailing
rglru layers of `pattern_full` run first.

Block kinds: "attn", "local", "rglru" and "ssd" (Mamba-2; its block has
no MLP and no second norm, and returns after the residual add, as in the
reference). MLA and MoE blocks raise `NotImplementedError`. Sharding
constraints and rematerialisation have no counterpart in inference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models import attention, rglru, ssd
from repro_torch.models import modules as nn

KINDS = ("attn", "local", "rglru", "ssd")


def _supported(cfg, kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    if kind == "attn" and cfg.attn_impl == "mla":
        raise NotImplementedError("MLA attention is not ported")
    if cfg.mlp_type == "moe":
        raise NotImplementedError("MoE MLPs are not ported")


# -------------------------- per-block init/apply ---------------------------
def block_init(generator: torch.Generator, cfg, kind: str, layer_idx: int):
    _supported(cfg, kind)
    dev = generator.device
    p: Dict[str, Any] = {"ln1": torch.ones(cfg.d_model, device=dev)}
    if kind in ("attn", "local"):
        p["attn"] = attention.attn_init(generator, cfg)
    elif kind == "rglru":
        p["attn"] = rglru.rglru_init(generator, cfg)
    else:
        p["attn"] = ssd.ssd_init(generator, cfg)
        return p                       # the SSD block has no separate MLP
    p["ln2"] = torch.ones(cfg.d_model, device=dev)
    if cfg.mlp_type != "none":
        p["mlp"] = nn.mlp_init(generator, cfg.d_model, cfg.d_ff,
                               cfg.mlp_type)
    return p


def block_apply(p, cfg, kind: str, x, positions, prefix_len=None,
                cache=None, cache_pos=None, kv_valid=None):
    """One residual block. Returns (x, new_cache, aux_loss); the aux loss
    is 0.0, since only MoE blocks (not ported) have one."""
    _supported(cfg, kind)
    h = nn.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ("attn", "local"):
        window = cfg.window if kind == "local" else 0
        y, new_cache = attention.attn_apply(
            p["attn"], cfg, h, positions, prefix_len=prefix_len,
            window=window, cache=cache, cache_pos=cache_pos,
            kv_valid=kv_valid)
    elif kind == "rglru":
        y, new_cache = rglru.rglru_apply(p["attn"], cfg, h, state=cache)
    else:
        y, new_cache = ssd.ssd_apply(p["attn"], cfg, h, state=cache)
        return x + y.to(x.dtype), new_cache, 0.0
    x = x + y.to(x.dtype)
    if "mlp" in p:
        h2 = nn.rms_norm(x, p["ln2"], cfg.norm_eps)
        y2 = nn.mlp_apply(p["mlp"], h2, cfg.mlp_type)
        x = x + y2.to(x.dtype)
    return x, new_cache, 0.0


# ----------------------------- stack init ----------------------------------
def stack_layout(cfg) -> Tuple[List[str], List[str], int]:
    """Returns (prologue_kinds, period_kinds, n_groups)."""
    pat = list(cfg.pattern_full)
    n_pro = cfg.moe.first_k_dense if (cfg.mlp_type == "moe"
                                      and cfg.moe is not None) else 0
    period = len(cfg.pattern)
    body = pat[n_pro:]
    n_groups = len(body) // period
    rem = len(body) - n_groups * period
    # any ragged tail joins the prologue (and runs first)
    prologue = pat[:n_pro] + (body[n_groups * period:] if rem else [])
    return prologue, list(cfg.pattern), n_groups


def stack_init(generator: torch.Generator, cfg):
    """{"prologue": [layer tree, ...], "groups": [[layer tree per group]
    per slot]}, drawn prologue first, then slot by slot."""
    prologue, period, n_groups = stack_layout(cfg)
    pro = [block_init(generator, cfg, kind, layer_idx=i)
           for i, kind in enumerate(prologue)]
    base = len(prologue)
    groups = [[block_init(generator, cfg, kind,
                          layer_idx=base + g * len(period) + slot)
               for g in range(n_groups)]
              for slot, kind in enumerate(period)]
    return {"prologue": pro, "groups": groups}


# ----------------------------- stack apply ---------------------------------
def stack_apply(params, cfg, x, positions, prefix_len=None,
                caches=None, cache_pos=None, kv_valid=None):
    """Apply all blocks: the prologue, then the groups in order. `caches`
    is None (scoring) or {"prologue": [cache, ...], "groups": [[cache per
    group] per slot]}. Returns (x, new_caches, total_aux)."""
    prologue, period, n_groups = stack_layout(cfg)
    new_caches: Dict[str, Any] = {"prologue": [],
                                  "groups": [[] for _ in period]}
    for i, kind in enumerate(prologue):
        c = None if caches is None else caches["prologue"][i]
        x, nc, _ = block_apply(params["prologue"][i], cfg, kind, x,
                               positions, prefix_len, c, cache_pos, kv_valid)
        new_caches["prologue"].append(nc)
    for g in range(n_groups):
        for slot, kind in enumerate(period):
            c = None if caches is None else caches["groups"][slot][g]
            x, nc, _ = block_apply(params["groups"][slot][g], cfg, kind, x,
                                   positions, prefix_len, c, cache_pos,
                                   kv_valid)
            new_caches["groups"][slot].append(nc)
    return x, (new_caches if caches is not None else None), 0.0


# ----------------------------- cache init ----------------------------------
def stack_cache_init(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                     device=None):
    """Build the cache tree matching stack_apply's expectations."""
    prologue, period, n_groups = stack_layout(cfg)

    def one(kind):
        _supported(cfg, kind)
        if kind == "rglru":
            r = cfg.rglru.d_rnn or cfg.d_model
            return rglru.RGLRUState.init(batch, r, cfg.rglru.conv_width,
                                         device=device)
        if kind == "ssd":  # fp32 whatever the cache dtype, as the reference
            sc = cfg.ssd
            _, n_heads = ssd.ssd_dims(cfg)
            return ssd.SSDState.init(batch, n_heads, sc.d_state,
                                     sc.head_dim, sc.conv_width,
                                     sc.n_groups, device=device)
        if kind == "local" and cfg.window and cfg.window < max_len:
            return attention.WindowKVCache.init(
                batch, cfg.window, cfg.n_kv_heads, cfg.d_head, dtype, device)
        return attention.KVCache.init(batch, max_len, cfg.n_kv_heads,
                                      cfg.d_head, dtype, device)

    return {"prologue": [one(k) for k in prologue],
            "groups": [[one(kind) for _ in range(n_groups)]
                       for kind in period]}
