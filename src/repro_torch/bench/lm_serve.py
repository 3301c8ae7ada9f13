"""LM inference on one device: scoring and greedy serving, for every
registered config.

Builds the model from a seed on the device (random weights, fp32 at rest
or, for models too large for that, bf16 at rest: `build`; the config's
compute dtype), then

  * scores `score_batch` sequences: `lm.forward` over [score_batch,
    score_len] tokens ([score_batch, K, score_len] for K codebooks, after
    the prefix embeddings of a prefix model), every position's logits
    (the flash kernel in each full-causal GQA layer and each local layer,
    the RG-LRU kernel in each recurrent layer, the SSD kernel in each
    Mamba-2 layer; MLA layers and prefix models run the plain
    attention, as in the reference), then `lm.loss_fn` on the same
    tokens;
  * serves `batch` requests: `lm.prefill` of [batch, prompt_len] random
    prompts into the caches (a MoE model at its no-drop capacity,
    `serving_config`), then `decode_steps` greedy `lm.decode_step`s,
    each codebook's token its own argmax; an MLA model decodes a second
    time from the same caches with `mla_absorb=True`;
  * checks the serving logits against `lm.forward` over the same tokens
    at the same positions (the relative max-abs error of the JAX
    package's ring-cache test, and the share of positions whose greedy
    token agrees).

Run on the GPU with `python -m repro_torch.bench.lm_serve [--arch
deepseek-v2-lite-16b] [--rest-dtype bfloat16] [--score-batch 4]`;
`run(cfg=..., device="cpu")` with a small config and short lengths takes
the plain PyTorch path. `run` returns its numbers; launches are counted
per phase from the kernels' `LAUNCHES`, which it reads and never resets.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch import configs
from repro_torch.core.device import resolve
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rg_lru import ops as rg_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import lm, transformer


def launches() -> dict:
    return {**flash_ops.LAUNCHES, **rg_ops.LAUNCHES, **ssd_ops.LAUNCHES}


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def build(cfg, seed: int, device, rest_dtype=None) -> lm.LM:
    """The model's random parameters from `seed`. `rest_dtype` None: fp32
    at rest (`lm.lm_init`). A dtype (bf16 for models too large for fp32
    at rest): drawn in `lm_init`'s order, the embedding, then layer by
    layer in `transformer.init_order`, then the head, each tensor cast as
    soon as it is drawn. `linear` casts every weight to the compute dtype
    at use, so a bf16 model's logits are the same bit for bit where every
    parameter is used in the compute dtype and the norm scales are 1 and
    the biases 0, as at random init (not so the fp32 recurrences of
    RecurrentGemma and Mamba-2)."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if rest_dtype is None:
        return lm.lm_init(cfg, gen, device=dev)
    cfg.validate()
    p = {"embed": lm.embed_init(gen, cfg).to(rest_dtype)}
    stack = transformer.empty_stack(cfg)
    for layers, i, kind, layer_idx in transformer.init_order(cfg, stack):
        layers[i] = _cast(transformer.block_init(gen, cfg, kind, layer_idx),
                          rest_dtype)
    p["stack"] = stack
    p["final_norm"] = torch.ones(cfg.d_model, dtype=rest_dtype, device=dev)
    if not cfg.tie_embeddings:
        p["head"] = lm.head_init(gen, cfg).to(rest_dtype)
    return lm.LM(p)


def serving_config(cfg):
    """cfg as serving runs it: a MoE model at the capacity factor
    `n_experts / top_k`, where no choice can drop (C = T), so that scoring
    T tokens and decoding B keep the same choices. (The reference's
    consistency test raises its 4-expert smoke configs to 4.0, which is
    that and more; at the published 1.25 a random-init DeepSeek-V2-Lite
    drops about half the choices it scores.)"""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def check_tokens(prompts, served):
    """The sequences the served logits were computed over: the prompts
    [B, (K,) P] followed by the greedy tokens of all but the last step."""
    return torch.cat([prompts, served[..., :-1, :].argmax(-1)], dim=-1)


def serve_check(p, cfg, prompts, served, prefix_embeds=None) -> dict:
    """Hold the serving logits to `lm.forward` over the same tokens.
    `served` [B, T, V] ([B, K, T, V]) are the prefill's last logits then
    each decode step's, for positions P-1 .. P+T-2 of prompts [B, P]
    ([B, K, P]) followed by the greedy tokens; the last step's own token
    is not fed. The head runs only at those T positions. The padded vocab
    columns (masked to -1e9) are left out of the comparison."""
    P = prompts.shape[-1]
    T = served.shape[-2]
    tokens = check_tokens(prompts, served)
    hidden, _, _ = lm.forward(p, cfg, tokens, prefix_embeds=prefix_embeds,
                              head_mode="none")
    ref = lm._head(p, cfg, hidden[:, P - 1:P - 1 + T])[..., :cfg.vocab]
    ref = ref.float()
    got = served[..., :cfg.vocab].float()
    rel = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    return {"positions": got[..., 0].numel(), "rel_max_abs": rel,
            "argmax_agree": agree}


def _decode(p, cfg, last, caches, start: int, steps: int, dev) -> dict:
    """`steps` greedy decode steps from the prefill's last logits, the
    first token at cache offset `start`. Returns the served logits
    [B, (K,) steps + 1, V], the launches, and the time: the first step
    apart (`decode_first_ms`: what a set of caches' first step does once,
    such as capturing the step's CUDA graph in `lm.decode_step`), the
    others a step."""
    served = [last]
    n0 = launches()
    t = [time.perf_counter()]
    for i in range(steps):
        logits, caches = lm.decode_step(p, cfg, served[-1].argmax(-1),
                                        start + i, caches)
        served.append(logits)
        if i == 0:
            _sync(dev)
            t.append(time.perf_counter())
    _sync(dev)
    t.append(time.perf_counter())
    dt = t[-1] - t[min(1, steps)]
    return {"served": torch.stack(served, dim=-2),
            "decode_first_ms": (t[min(1, steps)] - t[0]) * 1e3,
            "decode_ms_per_step": dt * 1e3 / max(steps - 1, 1),
            "decode_tok_per_s": last.shape[0] * (steps - 1) / max(dt, 1e-9),
            "decode_launches": _diff(launches(), n0)}


def run(device="cuda", cfg=None, seed: int = 0, score_len: int = 4096,
        batch: int = 4, prompt_len: int = 4096, decode_steps: int = 32,
        score_batch: int = 1, arch: str = "recurrentgemma-9b",
        rest_dtype=None) -> dict:
    """Score `score_batch` sequences (logits, then `lm.loss_fn` on the same
    tokens) and serve `batch` greedy requests on `device` with the model
    `cfg` (default: the full config of `arch`), built by `build` with
    `rest_dtype`. Models with a prefix (`cfg.n_prefix_embeds`) get that
    many seeded prefix embeddings (0.02 x normal) before every sequence;
    multi-codebook models take [B, K, S] tokens and decode each codebook
    greedily. Serving (and its check) runs `serving_config(cfg)`; an MLA
    model decodes a second time from the same prefill with
    `mla_absorb=True`. Returns wall seconds, tokens per second, peak
    device memory, kernel launches per phase, the serving checks of
    `serve_check` and, under "kept", each decode's checked token
    sequences and served logits (the vocab's columns) on the CPU."""
    dev = resolve(device)
    cfg = cfg or configs.get_config(arch)
    scfg = serving_config(cfg)
    K, npre = cfg.n_codebooks, cfg.n_prefix_embeds
    out = {"arch": cfg.name, "device": str(dev),
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "dtype": cfg.dtype,
           "rest_dtype": str(rest_dtype or torch.float32).removeprefix(
               "torch."),
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "n_codebooks": K, "n_prefix_embeds": npre,
           "score_batch": score_batch, "score_len": score_len,
           "batch": batch, "prompt_len": prompt_len}
    if cfg.moe is not None:
        out["capacity_factor"] = cfg.moe.capacity_factor
        out["serve_capacity_factor"] = scfg.moe.capacity_factor

    def tokens(n, length):
        shape = (n, K, length) if K > 1 else (n, length)
        return torch.randint(0, cfg.vocab, shape, generator=gen, device=dev)

    def prefix(n):
        if not npre:
            return None
        return 0.02 * torch.randn((n, npre, cfg.d_model), generator=gen,
                                  device=dev)

    with torch.inference_mode():
        t0 = time.perf_counter()
        p = build(cfg, seed, dev, rest_dtype)
        _sync(dev)
        out["build_s"] = time.perf_counter() - t0
        out["params"] = lm.param_count(p)
        out["active_params"] = lm.active_param_count(cfg, p)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        toks, score_pe = tokens(score_batch, score_len), prefix(score_batch)
        prompts, serve_pe = tokens(batch, prompt_len), prefix(batch)
        # warm-up: library handles and the kernels' first load
        lm.forward(p, cfg, toks[..., :min(score_len, 64)],
                   prefix_embeds=score_pe)
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

        n0 = launches()
        t0 = time.perf_counter()
        logits, _, aux = lm.forward(p, cfg, toks, prefix_embeds=score_pe)
        _sync(dev)
        out["forward_s"] = time.perf_counter() - t0
        out["forward_launches"] = _diff(launches(), n0)
        want = ((score_batch, K, score_len, cfg.vocab_padded) if K > 1
                else (score_batch, score_len, cfg.vocab_padded))
        if tuple(logits.shape) != want:
            raise AssertionError(f"forward logits {tuple(logits.shape)}")
        out["forward_finite"] = bool(torch.isfinite(logits).all())
        out["score_tok_per_s"] = score_batch * score_len / out["forward_s"]
        out["aux"] = float(aux)
        del logits

        batch_ = {"tokens": toks, "labels": toks}
        if score_pe is not None:
            batch_["prefix_embeds"] = score_pe
        n0 = launches()
        t0 = time.perf_counter()
        loss, metrics = lm.loss_fn(p, cfg, batch_)
        out["loss"] = float(loss)
        out["loss_s"] = time.perf_counter() - t0
        out["loss_launches"] = _diff(launches(), n0)
        out["loss_ce"] = float(metrics["ce"])
        out["loss_ntok"] = float(metrics["ntok"])

        max_len = npre + prompt_len + decode_steps
        caches = lm.init_caches(scfg, batch, max_len,
                                dtype=lm.compute_dtype(cfg), device=dev)
        n0 = launches()
        t0 = time.perf_counter()
        last, caches = lm.prefill(p, scfg, prompts, caches,
                                  prefix_embeds=serve_pe)
        _sync(dev)
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_launches"] = _diff(launches(), n0)
        out["prefill_tok_per_s"] = batch * prompt_len / out["prefill_s"]

        dec = _decode(p, scfg, last, caches, npre + prompt_len, decode_steps,
                      dev)
        served = dec.pop("served")
        out["decode_steps"] = decode_steps
        out.update(dec)
        out["serve_finite"] = bool(torch.isfinite(served).all())
        if cfg.attn_impl == "mla":
            # decode writes position P + i before it reads it, and masks
            # every later one: the same caches serve a second decode
            acfg = dataclasses.replace(scfg, mla_absorb=True)
            adec = _decode(p, acfg, last, caches, npre + prompt_len,
                           decode_steps, dev)
            aserved = adec.pop("served")
            adec["serve_finite"] = bool(torch.isfinite(aserved).all())
            out["absorbed"] = adec
        if dev.type == "cuda":
            out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        n0 = launches()
        out["check"] = serve_check(p, scfg, prompts, served, serve_pe)
        out["check"]["launches"] = _diff(launches(), n0)
        if "absorbed" in out:
            out["absorbed"]["check"] = serve_check(p, scfg, prompts, aserved,
                                                   serve_pe)
        out["kept"] = {
            name: (check_tokens(prompts, x).cpu(),
                   x[..., :cfg.vocab].float().cpu())
            for name, x in (("expanded", served),
                            ("absorbed", aserved if "absorbed" in out
                             else None)) if x is not None}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="recurrentgemma-9b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--score-batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rest-dtype", choices=("float32", "bfloat16"),
                    default="float32")
    a = ap.parse_args()
    rest = None if a.rest_dtype == "float32" else torch.bfloat16
    out = run(a.device, seed=a.seed, arch=a.arch, score_batch=a.score_batch,
              rest_dtype=rest)
    out.pop("kept")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
