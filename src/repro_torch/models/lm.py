"""Language-model wrapper of the port: embeddings, the block stack, the
tied head, and the scoring and serving entry points, on the JAX
package's `models/lm.py`.

scoring:
    forward(p, cfg, tokens, caches=None) -> (logits, None, aux)
serving:
    init_caches(cfg, batch, max_len) -> caches
    prefill(p, cfg, tokens, caches) -> (last_logits, caches)
    decode_step(p, cfg, token, pos, caches) -> (logits, caches)

Parameters live in an `LM` module whose parameter names are the
reference's dict keys; the functions on tensors are plain functions, as
in the reference. `loss_fn`, training, multi-codebook streams and prefix
embeddings are not ported.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.device import resolve
from repro_torch.models import modules as nn
from repro_torch.models import transformer


class LM(nn.Params):
    """All parameters of one model: `embed` [V, D], `stack` ("prologue": a
    list of layers, "groups": per pattern slot a list of layers, one per
    group), `final_norm` [D] and, when untied, `head` [D, V]."""


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _supported(cfg) -> None:
    if cfg.n_codebooks > 1:
        raise NotImplementedError("multi-codebook models are not ported")


def lm_init(cfg, generator: torch.Generator, device="cuda") -> LM:
    """Random parameters drawn from `generator`, which must live on
    `device` (the GPU unless the caller asks for the CPU)."""
    cfg.validate()
    _supported(cfg)
    dev = resolve(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}: draw them on the same device")
    V = cfg.vocab_padded
    p: Dict[str, Any] = {
        "embed": nn.truncated_normal(generator, (V, cfg.d_model), 0.02),
        "stack": transformer.stack_init(generator, cfg),
        "final_norm": torch.ones(cfg.d_model, device=generator.device),
    }
    if not cfg.tie_embeddings:
        p["head"] = nn.truncated_normal(generator, (cfg.d_model, V), 0.02)
    return LM(p)


def _embed(p, cfg, tokens):
    """Gather, then cast: the same values as the reference's cast of the
    whole table before the gather, without the table-sized copy."""
    dt = compute_dtype(cfg)
    x = p["embed"][tokens].to(dt)
    if cfg.embed_scale:
        # the scale rounded to the compute dtype first, as jnp.asarray does
        x = x * float(torch.tensor(cfg.embed_scale, dtype=dt))
    return x


def _head(p, cfg, x):
    if cfg.tie_embeddings:
        logits = nn.linear(x, p["embed"].to(x.dtype).T)
    else:
        logits = nn.linear(x, p["head"])
    if cfg.vocab_padded != cfg.vocab:   # mask padding rows
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits + torch.where(pad, -1e9, 0.0).to(logits.dtype)
    return logits


def forward(p, cfg, tokens, prefix_embeds=None, positions=None,
            caches=None, cache_pos=None, kv_valid=None,
            head_mode: str = "all"):
    """Full forward over tokens [B, S]. head_mode: "all" | "last" (only
    the final position's logits, as prefill) | "none" (the final hidden
    states). Returns (logits_or_hidden, new_caches, aux_loss)."""
    _supported(cfg)
    if prefix_embeds is not None:
        raise NotImplementedError("prefix embeddings are not ported")
    x = _embed(p, cfg, tokens)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        base = 0 if cache_pos is None else int(cache_pos)
        positions = base + torch.arange(
            S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x, new_caches, aux = transformer.stack_apply(
        p["stack"], cfg, x, positions, caches=caches,
        cache_pos=None if cache_pos is None else int(cache_pos),
        kv_valid=kv_valid)
    x = nn.rms_norm(x, p["final_norm"], cfg.norm_eps)
    if head_mode == "none":
        return x, new_caches, aux
    if head_mode == "last":
        x = x[:, -1:]
    return _head(p, cfg, x), new_caches, aux


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------
def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                device="cuda"):
    return transformer.stack_cache_init(cfg, batch, max_len, dtype,
                                        resolve(device))


def prefill(p, cfg, tokens, caches, prefix_embeds=None, kv_valid=None):
    """Prefill from position 0. Returns (last_logits [B, V], caches)."""
    logits, caches, _ = forward(p, cfg, tokens, prefix_embeds=prefix_embeds,
                                caches=caches, cache_pos=0,
                                kv_valid=kv_valid, head_mode="last")
    return logits[:, 0], caches


def decode_step(p, cfg, token, pos: int, caches, kv_valid=None,
                positions=None):
    """One decode step. token [B]; pos is the cache offset of the token.
    Returns (logits [B, V], caches)."""
    logits, caches, _ = forward(p, cfg, token[:, None], caches=caches,
                                cache_pos=pos, kv_valid=kv_valid,
                                positions=positions)
    return logits[:, 0], caches


def param_count(p) -> int:
    return sum(t.numel() for t in p.parameters())
