"""Multi-head latent attention (DeepSeek-V2 / MiniCPM3), on the JAX
package's `models/mla.py`.

Q path: an optional low-rank (q_lora) projection; per-head dims split into
a non-positional part (qk_nope) and a RoPE part (qk_rope).
KV path: a shared low-rank latent c_kv (kv_lora) is up-projected to K_nope
and V; a single shared RoPE key k_rope comes straight from x.

The decode cache stores only (c_kv, k_rope), updated in place like the
port's `KVCache`. `cfg.mla_absorb` attends over the cache in the latent
space instead (W_uk folded into the query, W_uv into the output). As in
the reference, MLA runs the plain attention (fp32 scores, additive -inf
mask) and never calls the flash kernel. The absorbed attention of one
query position over a bf16 cache, with autograd off, on CUDA (a decode
step), runs as the MLA decode kernel (`kernels/mla_decode`), which reads
the cache once with its `rms_norm` fused; everything else runs the plain
chain (`kernels/mla_decode/ref.py`). `MLA_DECODE_COUNTS` counts the
calls of each route as they run or are recorded into a CUDA graph.

Mixed dtypes promote as in JAX (an fp32 cache under a bf16 model gives an
fp32 attention output); torch's einsum takes one dtype, so the operands
are brought to the promoted one first.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.mla_decode import ops as decode_ops
from repro_torch.kernels.mla_decode import ref as decode_ref
from repro_torch.models import modules as nn
from repro_torch.parallel import sharding as shd

#: the absorbed attention's calls by route, counted as they run or are
#: recorded (a replayed CUDA graph runs none)
MLA_DECODE_COUNTS = {"kernel": 0, "plain": 0}
#: the device type the MLA decode kernel runs on
_KERNEL_DEVICE = "cuda"


class MLACache(NamedTuple):
    c_kv: torch.Tensor     # [B, S_max, R]   compressed latent
    k_rope: torch.Tensor   # [B, S_max, Dr]  shared rope key

    @staticmethod
    def init(batch, max_len, kv_lora, d_rope, dtype=torch.bfloat16,
             device=None):
        return MLACache(
            torch.zeros((batch, max_len, kv_lora), dtype=dtype,
                        device=device),
            torch.zeros((batch, max_len, d_rope), dtype=dtype,
                        device=device))


def mla_init(generator: torch.Generator, cfg):
    m = cfg.mla
    d = cfg.d_model
    h = cfg.n_heads
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = generator.device
    p = {}
    if m.q_lora_rank:
        p["w_dq"] = nn.dense_init(generator, d, m.q_lora_rank)
        p["q_norm"] = torch.ones(m.q_lora_rank, device=dev)
        p["w_uq"] = nn.dense_init(generator, m.q_lora_rank, (h, dq))
    else:
        p["w_q"] = nn.dense_init(generator, d, (h, dq))
    p["w_dkv"] = nn.dense_init(generator, d, m.kv_lora_rank)
    p["kv_norm"] = torch.ones(m.kv_lora_rank, device=dev)
    p["w_uk"] = nn.dense_init(generator, m.kv_lora_rank,
                              (h, m.qk_nope_head_dim))
    p["w_uv"] = nn.dense_init(generator, m.kv_lora_rank, (h, m.v_head_dim))
    p["w_kr"] = nn.dense_init(generator, d, m.qk_rope_head_dim)
    p["wo"] = nn.dense_init(generator, h * m.v_head_dim, d)
    return p


def _mla_q(p, cfg, x, positions):
    m = cfg.mla
    if m.q_lora_rank:
        cq = nn.rms_norm(nn.linear(x, p["w_dq"]), p["q_norm"], cfg.norm_eps)
        q = nn.linear(cq, p["w_uq"])
    else:
        q = nn.linear(x, p["w_q"])                          # [B,S,H,dq]
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = nn.apply_rope(q[..., m.qk_nope_head_dim:], positions,
                           cfg.rope_theta)
    return q_nope, q_rope


def _mla_latents(p, cfg, x, positions):
    c_kv = nn.linear(x, p["w_dkv"])                         # [B,S,R]
    k_rope = nn.apply_rope(
        nn.linear(x, p["w_kr"])[:, :, None, :], positions, cfg.rope_theta
    )[:, :, 0, :]                                           # [B,S,Dr]
    return c_kv, k_rope


def _scale(cfg) -> float:
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def _local(fn, heads_in, rows_in):
    """`fn(*heads_in, *rows_in)` on each rank's batch and head shard
    under a sharding policy (`attention._attend`'s split): `heads_in` are
    [B, S, H, ...] tensors, `rows_in` [B, ...] ones whole over the heads
    (latents, rope keys, positions, gathered along a sharded cache
    sequence); the output is [B, S, H, ...]."""
    t = heads_in[0]
    bat = shd.axis_for("batch", t.shape[0])
    heads = (bat, None, shd.head_axis(bat, t.shape[2]), None)
    rows = tuple((bat,) + (None,) * (r.ndim - 1) for r in rows_in)
    return shd.local_call(fn, (*heads_in, *rows_in),
                          (heads,) * len(heads_in) + rows, (heads,))


def _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, q_pos, kv_pos):
    """Attention over (possibly cached) latents."""
    ckn = nn.rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_nope = nn.linear(ckn, p["w_uk"])                      # [B,Skv,H,dn]
    v = nn.linear(ckn, p["w_uv"])                           # [B,Skv,H,dv]

    def core(q_nope, q_rope, k_nope, v, k_rope, q_pos, kv_pos):
        s_nope = torch.einsum("bqhd,bkhd->bhqk", q_nope.float(),
                              k_nope.float())
        scores = decode_ref.scores(s_nope, q_rope, k_rope, q_pos, kv_pos,
                                   _scale(cfg))
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, v)

    out = _local(core, (q_nope, q_rope, k_nope, v), (k_rope, q_pos, kv_pos))
    return nn.linear(shd.merge_heads(out, out.shape[2]), p["wo"])


def _kernel_route(q_lat, q_rope, c_kv, k_rope) -> bool:
    """Whether the absorbed attention runs as the MLA decode kernel: one
    query position, bf16 query and cache, no autograd recording, on
    CUDA."""
    ts = (q_lat, q_rope, c_kv, k_rope)
    return (q_lat.shape[1] == 1
            and all(t.dtype == torch.bfloat16 for t in ts)
            and not nn.records_grad(*ts)
            and all(t.device.type == _KERNEL_DEVICE for t in ts))


def _mla_attend_absorbed(p, cfg, q_nope, q_rope, c_kv, k_rope, q_pos,
                         kv_valid):
    """Weight-absorbed attention in the compressed latent space:
        score = (W_uk^T q_nope)^T c_kv + q_rope^T k_rope
        out   = W_uv^T (softmax(score) c_kv)
    One read of (c_kv, k_rope) a step, no per-step K/V expansion; rows
    past `kv_valid` [B] and past each query's position are masked."""
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope,
                         p["w_uk"].to(q_nope.dtype))         # [B,Sq,H,R]
    if _kernel_route(q_lat, q_rope, c_kv, k_rope):
        MLA_DECODE_COUNTS["kernel"] += 1
        norm = p["kv_norm"]
        if shd.is_dtensor(norm):
            norm = norm.full_tensor()

        def core(q_lat, q_rope, c_kv, k_rope, q_pos, kv_valid):
            return decode_ops.mla_decode(
                q_lat, q_rope, c_kv, k_rope, norm, q_pos[:, 0], kv_valid,
                eps=cfg.norm_eps, scale=_scale(cfg))

        o_lat = _local(core, (q_lat, q_rope), (c_kv, k_rope, q_pos, kv_valid))
    else:
        MLA_DECODE_COUNTS["plain"] += 1
        ckn = nn.rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)  # [B,Skv,R]
        kv_pos = decode_ref.kv_positions(kv_valid, c_kv.shape[1])
        o_lat = _local(functools.partial(decode_ref.latent_attention,
                                         scale=_scale(cfg)),
                       (q_lat, q_rope), (ckn, k_rope, q_pos, kv_pos))
    out = torch.einsum("bqhr,rhd->bqhd", o_lat, p["w_uv"].to(o_lat.dtype))
    return nn.linear(shd.merge_heads(out, out.shape[2]), p["wo"])


def mla_apply(p, cfg, x, positions, cache: Optional[MLACache] = None,
              cache_pos: Optional[int] = None, kv_valid=None):
    """Without a cache: causal attention over x's own latents. With one:
    writes (c_kv, k_rope) at `cache_pos` (a host int, or an int64 tensor
    [1] on the device) in place and attends over the cache; `kv_valid`
    [B] bounds each row's valid length (default cache_pos + S)."""
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_latents(p, cfg, x, positions)
    if cache is None:
        return _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope,
                           positions, positions), None
    B, S = x.shape[0], x.shape[1]
    S_max = cache.c_kv.shape[1]
    if torch.is_tensor(cache_pos):
        # a captured step's position, read on the device: the same rows
        # and valid length as at the host int
        rows = cache_pos + torch.arange(S, device=x.device)
        for buf, val in zip(cache, (c_kv, k_rope)):
            buf.index_copy_(1, rows, val.to(buf.dtype))
        valid = (cache_pos + S).to(torch.int32).expand(B)
    else:
        rows = range(cache_pos, cache_pos + S)
        shd.write_rows(cache.c_kv, 1, rows, c_kv)
        shd.write_rows(cache.k_rope, 1, rows, k_rope)
        valid = torch.full((B,), cache_pos + S, dtype=torch.int32,
                           device=x.device)
    if kv_valid is None:
        kv_valid = valid
    # the cache splits its sequence over "model" under a sharding policy;
    # the products over it take whole sequences (an all-gather of the
    # small latent cache a step; a no-op otherwise)
    whole = ("batch", None, None)
    cached = (shd.constrain(cache.c_kv, whole),
              shd.constrain(cache.k_rope, whole))
    if cfg.mla_absorb:
        y = _mla_attend_absorbed(p, cfg, q_nope, q_rope, *cached, positions,
                                 kv_valid)
    else:
        y = _mla_attend(p, cfg, q_nope, q_rope, *cached, positions,
                        decode_ref.kv_positions(kv_valid, S_max))
    return y, cache
