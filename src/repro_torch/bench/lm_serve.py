"""LM inference on one device: scoring and greedy serving.

Builds the model from a seed on the device (random weights, fp32 at
rest, the config's compute dtype), then

  * scores `score_batch` sequences: `lm.forward` over [score_batch,
    score_len] tokens, every position's logits (RecurrentGemma: the
    RG-LRU kernel in each recurrent layer, the flash kernel in each local
    layer; Mamba-2: the SSD kernel in each layer);
  * serves `batch` requests: `lm.prefill` of [batch, prompt_len] random
    prompts into the caches (local layers keep a window ring cache when
    the window is shorter than the cache and run the flash kernel;
    recurrent and SSD layers carry state through their plain chunked
    forms), then `decode_steps` greedy `lm.decode_step`s;
  * checks the serving logits against `lm.forward` over the same tokens
    at the same positions (the relative max-abs error of the JAX
    package's ring-cache test, and the share of positions whose greedy
    token agrees).

Run on the GPU with `python -m repro_torch.bench.lm_serve [--arch
mamba2-780m] [--score-batch 4]`; `run(cfg=..., device="cpu")` with a
small config and short lengths takes the plain PyTorch path. `run`
returns its numbers; launches are counted per phase from the kernels'
`LAUNCHES`, which it reads and never resets.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import configs
from repro_torch.core.device import resolve
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rg_lru import ops as rg_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import lm


def launches() -> dict:
    return {**flash_ops.LAUNCHES, **rg_ops.LAUNCHES, **ssd_ops.LAUNCHES}


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(cfg, seed: int, device) -> lm.LM:
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return lm.lm_init(cfg, gen, device=dev)


def serve_check(p, cfg, prompts, served) -> dict:
    """Hold the serving logits to `lm.forward` over the same tokens.
    `served` [B, T, V] are the prefill's last logits then each decode
    step's, for positions P-1 .. P+T-2 of prompts [B, P] followed by the
    greedy tokens; the last step's own token is not fed. The head runs
    only at those T positions. The padded vocab columns (masked to -1e9)
    are left out of the comparison."""
    B, P = prompts.shape
    T = served.shape[1]
    tokens = torch.cat([prompts, served[:, :-1].argmax(-1)], dim=1)
    hidden, _, _ = lm.forward(p, cfg, tokens, head_mode="none")
    ref = lm._head(p, cfg, hidden[:, P - 1:P - 1 + T])[..., :cfg.vocab]
    ref = ref.float()
    got = served[..., :cfg.vocab].float()
    rel = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    return {"positions": B * T, "rel_max_abs": rel, "argmax_agree": agree}


def run(device="cuda", cfg=None, seed: int = 0, score_len: int = 4096,
        batch: int = 4, prompt_len: int = 4096, decode_steps: int = 32,
        score_batch: int = 1, arch: str = "recurrentgemma-9b") -> dict:
    """Score `score_batch` sequences and serve `batch` greedy requests on
    `device` with the model `cfg` (default: the full config of `arch`).
    Returns wall seconds, tokens per second, peak device memory, kernel
    launches per phase and the serving check of `serve_check`."""
    dev = resolve(device)
    cfg = cfg or configs.get_config(arch)
    out = {"arch": cfg.name, "device": str(dev),
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "score_batch": score_batch, "score_len": score_len,
           "batch": batch, "prompt_len": prompt_len}
    with torch.inference_mode():
        t0 = time.perf_counter()
        p = build(cfg, seed, dev)
        _sync(dev)
        out["build_s"] = time.perf_counter() - t0
        out["params"] = lm.param_count(p)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        toks = torch.randint(0, cfg.vocab, (score_batch, score_len),
                             generator=gen, device=dev)
        prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                                generator=gen, device=dev)
        # warm-up: library handles and the kernels' first load
        lm.forward(p, cfg, toks[:, :min(score_len, 64)])
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

        n0 = launches()
        t0 = time.perf_counter()
        logits, _, _ = lm.forward(p, cfg, toks)
        _sync(dev)
        out["forward_s"] = time.perf_counter() - t0
        out["forward_launches"] = _diff(launches(), n0)
        if tuple(logits.shape) != (score_batch, score_len,
                                   cfg.vocab_padded):
            raise AssertionError(f"forward logits {tuple(logits.shape)}")
        out["forward_finite"] = bool(torch.isfinite(logits).all())
        out["score_tok_per_s"] = score_batch * score_len / out["forward_s"]
        del logits

        max_len = prompt_len + decode_steps
        caches = lm.init_caches(cfg, batch, max_len,
                                dtype=lm.compute_dtype(cfg), device=dev)
        n0 = launches()
        t0 = time.perf_counter()
        last, caches = lm.prefill(p, cfg, prompts, caches)
        _sync(dev)
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_launches"] = _diff(launches(), n0)
        out["prefill_tok_per_s"] = batch * prompt_len / out["prefill_s"]

        served = [last]
        n0 = launches()
        t0 = time.perf_counter()
        for i in range(decode_steps):
            tok = served[-1].argmax(-1)
            logits, caches = lm.decode_step(p, cfg, tok, prompt_len + i,
                                            caches)
            served.append(logits)
        _sync(dev)
        dt = time.perf_counter() - t0
        out["decode_steps"] = decode_steps
        out["decode_ms_per_step"] = dt * 1e3 / max(decode_steps, 1)
        out["decode_tok_per_s"] = batch * decode_steps / max(dt, 1e-9)
        out["decode_launches"] = _diff(launches(), n0)
        served = torch.stack(served, dim=1)
        out["serve_finite"] = bool(torch.isfinite(served).all())
        if dev.type == "cuda":
            out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        n0 = launches()
        out["check"] = serve_check(p, cfg, prompts, served)
        out["check"]["launches"] = _diff(launches(), n0)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="recurrentgemma-9b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--score-batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    print(json.dumps(run(a.device, seed=a.seed, arch=a.arch,
                         score_batch=a.score_batch), indent=1))


if __name__ == "__main__":
    main()
