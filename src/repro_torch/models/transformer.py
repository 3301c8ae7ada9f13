"""Block assembly: pre-norm residual blocks over a heterogeneous layer
pattern, on the JAX package's `models/transformer.py`.

The layer pattern (cfg.pattern) repeats with period P. The reference
stacks each slot's parameters along a group axis and scans over groups;
here `stack["groups"][slot][g]` is one layer's own `Params` and the scan
is a Python loop. Layers left over after the last full period join the
prologue, which runs BEFORE the groups, exactly as in the reference
(`stack_layout`): at 38 layers of (rglru, rglru, local) the two trailing
rglru layers of `pattern_full` run first.

Block kinds: "attn" (GQA, or MLA under `attn_impl="mla"`), "local",
"rglru" and "ssd" (Mamba-2; its block has no MLP and no second norm, and
returns after the residual add, as in the reference). Under
`mlp_type="moe"` the first `moe.first_k_dense` layers take a dense SwiGLU
of width `d_ff` and the others a MoE MLP, whose aux losses `stack_apply`
sums in fp32 in layer order. While autograd records, each block runs
under `_remat` at the reference's places: `cfg.remat` "full" recomputes
the block in the backward, "dots" keeps its matrix products' outputs and
recomputes the rest, "none" keeps everything. Sharding constraints sit at
the reference's places: the residual stream after each block's adds
is pinned to (batch, seq) by `parallel/sharding.py::constrain`, which
redistributes a DTensor under a sharding policy and does nothing
otherwise.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, List, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention, mla, moe, rglru, ssd
from repro_torch.models import modules as nn
from repro_torch.parallel import sharding as shd


def _dense_kind(cfg) -> str:
    """The dense MLP's kind: a MoE model's dense layers are SwiGLU."""
    return "swiglu" if cfg.mlp_type == "moe" else cfg.mlp_type


# -------------------------- per-block init/apply ---------------------------
def block_init(generator: torch.Generator, cfg, kind: str, layer_idx: int):
    dev = generator.device
    p: Dict[str, Any] = {"ln1": torch.ones(cfg.d_model, device=dev)}
    if kind in ("attn", "local"):
        if cfg.attn_impl == "mla" and kind == "attn":
            p["attn"] = mla.mla_init(generator, cfg)
        else:
            p["attn"] = attention.attn_init(generator, cfg)
    elif kind == "rglru":
        p["attn"] = rglru.rglru_init(generator, cfg)
    elif kind == "ssd":
        p["attn"] = ssd.ssd_init(generator, cfg)
        return p                       # the SSD block has no separate MLP
    else:
        raise ValueError(kind)
    p["ln2"] = torch.ones(cfg.d_model, device=dev)
    if cfg.mlp_type == "moe" and layer_idx >= cfg.moe.first_k_dense:
        p["mlp"] = moe.moe_init(generator, cfg)   # has "router": MoE block
    elif cfg.mlp_type != "none":
        p["mlp"] = nn.mlp_init(generator, cfg.d_model, cfg.d_ff,
                               _dense_kind(cfg))
    return p


def block_apply(p, cfg, kind: str, x, positions, prefix_len=None,
                cache=None, cache_pos=None, kv_valid=None):
    """One residual block. Returns (x, new_cache, aux_loss): the MoE MLP's
    fp32 aux loss, 0.0 for every other block."""
    aux = 0.0
    h = _gather_seq(nn.rms_norm(x, p["ln1"], cfg.norm_eps))
    if kind == "attn" and cfg.attn_impl == "mla":
        y, new_cache = mla.mla_apply(p["attn"], cfg, h, positions,
                                     cache=cache, cache_pos=cache_pos,
                                     kv_valid=kv_valid)
    elif kind in ("attn", "local"):
        window = cfg.window if kind == "local" else 0
        y, new_cache = attention.attn_apply(
            p["attn"], cfg, h, positions, prefix_len=prefix_len,
            window=window, cache=cache, cache_pos=cache_pos,
            kv_valid=kv_valid)
    elif kind == "rglru":
        y, new_cache = rglru.rglru_apply(p["attn"], cfg, h, state=cache)
    elif kind == "ssd":
        y, new_cache = ssd.ssd_apply(p["attn"], cfg, h, state=cache)
        return _residual(x + _residual(y.to(x.dtype))), new_cache, aux
    else:
        raise ValueError(kind)
    x = _residual(x + _residual(y.to(x.dtype)))
    if "mlp" in p:
        h2 = _gather_seq(nn.rms_norm(x, p["ln2"], cfg.norm_eps))
        if "router" in p["mlp"]:
            y2, aux = moe.moe_apply(p["mlp"], cfg, h2)
        else:
            y2 = nn.mlp_apply(p["mlp"], h2, _dense_kind(cfg))
        x = _residual(x + _residual(y2.to(x.dtype)))
    return x, new_cache, aux


def _gather_seq(h):
    """A block's normalised input whole along the sequence (batch still
    split): under sequence parallelism the residual stream is split over
    "model" along it, and the block's products take whole sequences, as
    Megatron's all-gather before the column-parallel layers (DTensor
    cannot flatten a batch and a sequence that are both split). A no-op
    otherwise."""
    return shd.constrain(h, ("batch", None, None))


def _residual(x):
    """The residual stream, and a block's output before it is added to
    it, pinned to (batch, seq) under a sharding policy
    (`parallel/sharding.py::constrain`; a no-op without one): a partial
    sum over "model" is reduced there (scattered along the sequence
    under sequence parallelism, as Megatron's reduce-scatter), so the
    add's gradient comes back in the layout the block's products
    take."""
    return shd.constrain(x, ("batch", "seq", None))


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


def empty_stack(cfg) -> Dict[str, Any]:
    """The stack tree with a None for every layer."""
    prologue, period, n_groups = stack_layout(cfg)
    return {"prologue": [None] * len(prologue),
            "groups": [[None] * n_groups for _ in period]}


def init_order(cfg, stack) -> Iterator[Tuple[list, int, str, int]]:
    """Every layer's place in `stack` (an `empty_stack`) in the order
    `stack_init` draws it: (the list holding it, its index there, kind,
    layer_idx); the prologue first, then slot by slot, group by group."""
    prologue, period, n_groups = stack_layout(cfg)
    for i, kind in enumerate(prologue):
        yield stack["prologue"], i, kind, i
    base = len(prologue)
    for slot, kind in enumerate(period):
        for g in range(n_groups):
            yield (stack["groups"][slot], g, kind,
                   base + g * len(period) + slot)


def stack_init(generator: torch.Generator, cfg):
    """{"prologue": [layer tree, ...], "groups": [[layer tree per group]
    per slot]}, drawn in `init_order`."""
    stack = empty_stack(cfg)
    for layers, i, kind, layer_idx in init_order(cfg, stack):
        layers[i] = block_init(generator, cfg, kind, layer_idx)
    return stack


# ----------------------------- stack apply ---------------------------------
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _remat(cfg, fn, p, x):
    """`fn(p, x)` with `cfg.remat` rematerialisation, as the reference's
    `jax.checkpoint` (policy `checkpoint_dots` under "dots") around a
    block. It applies only while autograd records through the block's
    parameters or input, so serving calls run `fn` as they are."""
    if cfg.remat == "none" or not torch.is_grad_enabled() \
            or not nn.records_grad(x, *p.parameters()):
        return fn(p, x)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, list(_DOTS))
    return ckpt.checkpoint(fn, p, x, use_reentrant=False, **kw)


def stack_apply(params, cfg, x, positions, prefix_len=None,
                caches=None, cache_pos=None, kv_valid=None):
    """Apply all blocks: the prologue, then the groups in order. `caches`
    is None (scoring) or {"prologue": [cache, ...], "groups": [[cache per
    group] per slot]}. Returns (x, new_caches, total_aux): the MoE aux
    losses summed in fp32 in the order the layers run (0.0 without MoE;
    the reference's added zeros change no sum)."""
    prologue, period, n_groups = stack_layout(cfg)
    aux_total = 0.0
    new_caches: Dict[str, Any] = {"prologue": [],
                                  "groups": [[] for _ in period]}

    def run(p, x, kind, c):
        return _remat(cfg, lambda pp, xx: block_apply(
            pp, cfg, kind, xx, positions, prefix_len, c, cache_pos,
            kv_valid), p, x)

    for i, kind in enumerate(prologue):
        c = None if caches is None else caches["prologue"][i]
        x, nc, aux = run(params["prologue"][i], x, kind, c)
        new_caches["prologue"].append(nc)
        aux_total = aux_total + aux
    for g in range(n_groups):
        for slot, kind in enumerate(period):
            c = None if caches is None else caches["groups"][slot][g]
            x, nc, aux = run(params["groups"][slot][g], x, kind, c)
            new_caches["groups"][slot].append(nc)
            aux_total = aux_total + aux
    return x, (new_caches if caches is not None else None), aux_total


# ----------------------------- cache init ----------------------------------
def stack_cache_init(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                     device=None):
    """Build the cache tree matching stack_apply's expectations."""
    prologue, period, n_groups = stack_layout(cfg)

    def one(kind):
        if kind == "attn" and cfg.attn_impl == "mla":
            m = cfg.mla
            return mla.MLACache.init(batch, max_len, m.kv_lora_rank,
                                     m.qk_rope_head_dim, dtype, device)
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
