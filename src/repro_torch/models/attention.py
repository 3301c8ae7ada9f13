"""GQA/MQA/MHA attention with causal / sliding-window masks, KV-cache
decode paths, and the flash kernel, on the JAX package's
`models/attention.py` with the semantics it has under `use_pallas=True`.

Without a prefix, attention over a fresh sequence goes to
`kernels/flash_attention`: the CUDA kernel on the GPU; on the CPU its
plain version, or `banded_sdpa` for a windowed sequence the reference's
dispatch would band (S a multiple of the window and at least two
windows). Attention over a cache, or with a prefix, goes to the plain
`sdpa`, as in the reference. While autograd records, a fresh sequence
takes the reference's plain dispatch (`banded_sdpa` or `sdpa`) on every
device: the kernel has no backward.

The caches are updated in place (the reference returns new arrays), which
saves a copy of each cache per step; the functions still return the
cache, so callers read the same as in the reference.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import modules as nn
from repro_torch.parallel import sharding as shd


class KVCache(NamedTuple):
    k: torch.Tensor    # [B, S_max, K, Dh]
    v: torch.Tensor    # [B, S_max, K, Dh]

    @staticmethod
    def init(batch, max_len, n_kv, d_head, dtype=torch.bfloat16,
             device=None):
        shape = (batch, max_len, n_kv, d_head)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


class WindowKVCache(NamedTuple):
    """Ring buffer holding only the trailing `W` positions (local attn)."""
    k: torch.Tensor    # [B, W, K, Dh]
    v: torch.Tensor    # [B, W, K, Dh]
    pos: torch.Tensor  # [W] absolute positions (-1 = empty slot), shared
                       # by the batch

    @staticmethod
    def init(batch, window, n_kv, d_head, dtype=torch.bfloat16,
             device=None):
        shape = (batch, window, n_kv, d_head)
        return WindowKVCache(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            torch.full((window,), -1, dtype=torch.int32, device=device))

    def update(self, k, v, cache_pos: int):
        """Write the last min(S, W) tokens of k/v (absolute start
        cache_pos) into the ring, in place. Returns the cache."""
        S = k.shape[1]
        W = self.k.shape[1]
        T = min(S, W)
        src0 = S - T
        new_abs = range(cache_pos + src0, cache_pos + S)
        slots = [a % W for a in new_abs]
        shd.write_rows(self.k, 1, slots, k[:, src0:])
        shd.write_rows(self.v, 1, slots, v[:, src0:])
        shd.write_rows(self.pos, 0, slots, torch.arange(
            new_abs.start, new_abs.stop, dtype=torch.int32,
            device=self.pos.device))
        return self


def attn_init(generator: torch.Generator, cfg):
    d, h, k_, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": nn.dense_init(generator, d, (h, dh)),
        "wk": nn.dense_init(generator, d, (k_, dh)),
        "wv": nn.dense_init(generator, d, (k_, dh)),
        "wo": nn.dense_init(generator, h * dh, d,
                            std=1.0 / math.sqrt(h * dh)),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((h, dh), device=dev)
        p["bk"] = torch.zeros((k_, dh), device=dev)
        p["bv"] = torch.zeros((k_, dh), device=dev)
    return p


def _mask_bias(q_pos, kv_pos, window: int, prefix_len=None):
    """Additive mask bias [B, 1, Sq, Skv] (0 or -inf), fp32.

    q_pos/kv_pos: [B, Sq] / [B, Skv] absolute positions (-1 = invalid slot).
    window > 0 limits attention to the trailing `window` positions.
    prefix_len [B] (optional): bidirectional attention within the prefix.
    """
    q = q_pos[:, :, None]            # [B, Sq, 1]
    k = kv_pos[:, None, :]           # [B, 1, Skv]
    ok = (k <= q) & (k >= 0)
    if window:
        ok &= k > q - window
    if prefix_len is not None:
        pl = prefix_len[:, None, None]
        ok |= (k < pl) & (q < pl) & (k >= 0)
    bias = torch.zeros_like(ok, dtype=torch.float32)
    return bias.masked_fill_(~ok, float("-inf"))[:, None]


def sdpa(q, k, v, bias, softcap: float = 0.0):
    """q [B,Sq,H,Dh], k/v [B,Skv,K,Dh] with H = K*G. Returns [B,Sq,H,Dh]
    in v's dtype.

    As in the reference, the scores are fp32 (bf16 products are exact in
    fp32, so upcasting the operands equals fp32 accumulation) and the
    softmax weights are cast to v's dtype before the PV product."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    G = H // K
    q = q.reshape(B, Sq, K, G, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())
    scores = scores / math.sqrt(Dh)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    scores = scores + bias[:, :, None, :, :]      # bias [B,1,Sq,Skv]
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, H, Dh)


def attn_apply(p, cfg, x, positions, prefix_len=None, window: int = 0,
               cache=None, cache_pos: Optional[int] = None,
               kv_valid=None):
    """Full attention forward.

    Training/prefill: cache=None, x [B, S, D].
    With cache: writes K/V at offset `cache_pos` and attends over the
    cache; `kv_valid` [B] bounds each row's valid cache length (defaults
    to cache_pos + S).
    """
    q = nn.linear(x, p["wq"], p.get("bq"))        # [B,S,H,Dh]
    k = nn.linear(x, p["wk"], p.get("bk"))
    v = nn.linear(x, p["wv"], p.get("bv"))
    q = nn.apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k = nn.apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    B, S = x.shape[0], x.shape[1]

    if cache is None:
        out = _attend(_fresh(cfg, window), q, k, v, positions, prefix_len)
    elif isinstance(cache, WindowKVCache):
        cache = cache.update(k, v, cache_pos)
        if S > 1:
            # windowed prefill: attend within the fresh sequence only
            # (window <= S assumed; the ring now holds the trailing W)
            out = _attend(_fresh(cfg, window), q, k, v, positions,
                          prefix_len)
        else:
            if kv_valid is None:
                kv_valid = torch.full((B,), cache_pos + S,
                                      dtype=torch.int32, device=x.device)
            kv_pos = cache.pos[None].expand(B, cache.pos.shape[0])
            kv_pos = torch.where((kv_pos >= 0)
                                 & (kv_pos < kv_valid[:, None]), kv_pos, -1)
            bias = _mask_bias(positions, kv_pos, window, prefix_len)
            out = _attend(functools.partial(sdpa, softcap=cfg.logit_softcap),
                          q, cache.k, cache.v, bias)
    else:
        S_max = cache.k.shape[1]
        rows = range(cache_pos, cache_pos + S)
        shd.write_rows(cache.k, 1, rows, k)
        shd.write_rows(cache.v, 1, rows, v)
        if kv_valid is None:
            kv_valid = torch.full((B,), cache_pos + S, dtype=torch.int32,
                                  device=x.device)
        kv_pos = torch.arange(S_max, dtype=torch.int32,
                              device=x.device)[None].expand(B, S_max)
        kv_pos = torch.where(kv_pos < kv_valid[:, None], kv_pos, -1)
        bias = _mask_bias(positions, kv_pos, window, prefix_len)
        out = _attend(functools.partial(sdpa, softcap=cfg.logit_softcap),
                      q, cache.k, cache.v, bias)
    y = nn.linear(shd.merge_heads(out, out.shape[2]), p["wo"])
    return y, cache


def _fresh(cfg, window: int):
    """Attention over a fresh sequence, as `_attend` calls it."""
    def fn(q, k, v, positions, prefix_len):
        return _sdpa_dispatch(cfg, q, k, v, positions, window, prefix_len)
    return fn


def _attend(fn, q, k, v, *rest):
    """`fn(q, k, v, *rest)` (an attention over [B, S, H|K, D] tensors;
    `rest` are [B, ...] positions, prefix lengths or a mask bias, or None)
    on each rank's batch and head shard under a sharding policy: heads
    and batch are independent, so each rank attends its own, the kernel
    included, with no collective inside. The heads split over "model"
    where both H and K divide it; a cache whose sequence is sharded is
    gathered along it first. Plain tensors: `fn` as it is."""
    bat = shd.axis_for("batch", q.shape[0])
    heads = (bat, None, shd.head_axis(bat, q.shape[2], k.shape[2]), None)
    rows = [None if t is None else (bat,) + (None,) * (t.ndim - 1)
            for t in rest]
    return shd.local_call(fn, (q, k, v, *rest), (heads,) * 3 + tuple(rows),
                          (heads,))


def banded_sdpa(q, k, v, positions, window: int, softcap: float = 0.0):
    """Block-banded local attention: O(S*w) memory/compute instead of the
    naive O(S^2). Queries in blocks of `window` attend to their own block
    and the previous one. Requires S % window == 0."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    w = window
    nb = S // w
    qb = q.reshape(B, nb, w, H, Dh)
    kb = k.reshape(B, nb, w, K, Dh)
    vb = v.reshape(B, nb, w, K, Dh)
    zeros = torch.zeros_like(kb[:, :1])
    k2 = torch.cat([torch.cat([zeros, kb[:, :-1]], 1), kb], 2)
    v2 = torch.cat([torch.cat([zeros, vb[:, :-1]], 1), vb], 2)
    posb = positions.reshape(B, nb, w)
    negs = torch.full_like(posb[:, :1], -1)
    pos2 = torch.cat([torch.cat([negs, posb[:, :-1]], 1), posb], 2)
    G = H // K
    qb = qb.reshape(B, nb, w, K, G, Dh)
    scores = torch.einsum("bnqkgd,bnskd->bnkgqs", qb.float(), k2.float())
    scores = scores / math.sqrt(Dh)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    ok = ((pos2[:, :, None, :] <= posb[:, :, :, None])
          & (pos2[:, :, None, :] > posb[:, :, :, None] - w)
          & (pos2[:, :, None, :] >= 0))              # [B,nb,w,2w]
    bias = torch.zeros(ok.shape, dtype=torch.float32, device=ok.device)
    bias = bias.masked_fill_(~ok, float("-inf"))[:, :, None, None]
    wgt = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    out = torch.einsum("bnkgqs,bnskd->bnqkgd", wgt, v2)
    return out.reshape(B, S, H, Dh)


def _sdpa_dispatch(cfg, q, k, v, positions, window, prefix_len):
    """Attention over a fresh sequence at positions 0..S-1. Without a
    prefix it is the flash kernel, as under the reference's
    `use_pallas=True`, whose plain version on the CPU is `banded_sdpa`
    where the reference's plain dispatch takes it. While autograd records,
    and on fake tensors (`nn.plain_forms`), it is the reference's plain
    dispatch on every device, as the reference trains under
    `use_pallas=False`: the kernel has no backward. The [B, 1, S, S] mask
    bias is built only for the plain path that reads it. Under a sharding
    policy it runs on each rank's batch and head shard (`_attend`)."""
    S = q.shape[1]
    bands = (window and prefix_len is None and S == k.shape[1]
             and S % window == 0 and S >= 2 * window)
    plain = nn.plain_forms(q, k, v)
    if prefix_len is None and not plain and not (
            bands and q.device.type == "cpu"):
        return flash_ops.flash_attention(q, k, v, causal=True,
                                         window=window,
                                         softcap=cfg.logit_softcap)
    if bands:
        return banded_sdpa(q, k, v, positions, window, cfg.logit_softcap)
    bias = _mask_bias(positions, positions, window, prefix_len)
    return sdpa(q, k, v, bias, cfg.logit_softcap)
