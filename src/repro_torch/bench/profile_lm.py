"""Where LM inference and training time goes on the GPU.

    python -m repro_torch.bench.profile_lm [--arch deepseek-v2-lite-16b]
        [--score-batch 4] [--decode-steps 8] [--rest-dtype bfloat16]
    python -m repro_torch.bench.profile_lm --entry train_step \
        [--arch mamba2-780m]

`--entry train_step` traces two training steps of the full-width model
(`train_step.make_train_step`, 4 x 2048 tokens of `SyntheticLM`, fp32
params and AdamW moments, the config's remat), after one untraced, and
prints the same split, with the regions `ssd_chunked` (the plain scan's
forward and its recomputation) and `adamw` (the update).

Builds the full-width model of `--arch` (default recurrentgemma-9b) from
a seed (as `lm_serve.build`, fp32 or bf16 at rest), warms each phase up
once, then traces with `torch.profiler`: one `forward` of
[`--score-batch`, 4096] tokens (default 1), one `prefill` of [4, 4096]
and `--decode-steps` decode steps at batch 4, served as `lm_serve`
serves (`serving_config`: a MoE model at its no-drop capacity; an MLA
model's decode traced a second time with `mla_absorb`). A prefix model
gets its prefix embeddings, a multi-codebook model [B, K, S] tokens.
Prints one JSON line per phase: wall and device-busy milliseconds, the
device's idle share, kernel launches, and device time by kernel group
(GEMMs, each hand-written kernel, copies and casts, other elementwise
and reduction kernels), by model region (`moe`: each MoE MLP, its GEMMs
apart from its dispatch, i.e. the router's softmax, the sort, gathers and
scatters; `mla`: each MLA attention, its GEMMs apart from the rest:
scores, mask, softmax, casts, or the MLA decode kernel) and by the
kernels that take most of it.
Wall time is taken around the traced region, which ends in a
synchronize, so it includes the profiler's own cost.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

import contextlib
import dataclasses

from repro_torch import configs
from repro_torch.bench.lm_serve import build, serving_config
from repro_torch.bench.profile_sweep import _device_us
from repro_torch.core.device import resolve
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import lm, mla, moe, ssd
from repro_torch.train import optimizer as optim
from repro_torch.train import train_step as ts

GROUPS = (  # first match wins
    ("flash_attention", ("flash_fwd",)),  # both dtypes' kernels
    ("rg_lru", ("rg_lru_kernel", "rg_lru_tma_kernel")),  # both routes
    ("ssd_scan", ("ssd_scan",)),          # both dtypes' kernels
    ("mla_decode", ("mla_decode",)),      # the absorbed decode's attention
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("copy_cast", ("copy", "cast", "convert")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


REGIONS = (("moe", moe, "moe_apply"), ("mla", mla, "mla_apply"))
# a training step's: the plain SSD scan (its forward and its recomputation
# under remat; its backward runs on autograd's thread, outside the range)
# and the AdamW update
TRAIN_REGIONS = (("ssd_chunked", ssd, "ssd_chunked"),
                 ("adamw", optim, "adamw_update"))


@contextlib.contextmanager
def _regions(regions=REGIONS):
    """Each call of the regions' functions inside a profiler range named
    after its region, for the time of the trace."""
    saved = [(mod, name, getattr(mod, name)) for _, mod, name in regions]
    for region, mod, name in regions:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _region=region, **k):
            with record_function(_region):
                return _fn(*a, **k)
        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _region_ms(prof, steps: int, regions=REGIONS) -> dict:
    """Device ms a step of the kernels launched inside each region's
    ranges, GEMMs apart from the rest, and those kernels' count a step
    (`<region>_kernels`)."""
    out: dict = {}
    regions = {name for name, _, _ in regions}
    for e in prof.events():
        if e.name not in regions:
            continue
        todo = [e]
        while todo:
            ev = todo.pop()
            todo.extend(ev.cpu_children)
            for k in getattr(ev, "kernels", ()):
                part = "gemm" if _group(k.name) == "gemm" else "rest"
                key = f"{e.name}_{part}"
                out[key] = out.get(key, 0.0) + k.duration / 1e3 / steps
                key = f"{e.name}_kernels"
                out[key] = out.get(key, 0.0) + 1 / steps
    return out


def _trace(fn, steps: int = 1, region_fns=REGIONS) -> dict:
    torch.cuda.synchronize()
    with _regions(region_fns), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    regions = {name for name, _, _ in region_fns}
    gpu = [e for e in prof.key_averages() if _device_us(e) > 0 and
           str(getattr(e, "device_type", "")).endswith("CUDA")
           and e.key not in regions]     # a range's span is no kernel
    busy = sum(_device_us(e) for e in gpu)
    groups: dict = {}
    for e in gpu:
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + _device_us(e) / 1e3 / steps
    top = sorted(gpu, key=_device_us, reverse=True)[:8]
    return {
        "steps": steps, "wall_ms": wall * 1e3 / steps,
        "device_busy_ms": busy / 1e3 / steps,
        "device_idle_share": 1.0 - busy / 1e6 / wall,
        "kernels": sum(e.count for e in gpu) / steps,
        "device_ms_by_group": groups,
        "device_ms_by_region": _region_ms(prof, steps, region_fns),
        "top_kernels": [{"name": e.key[:70], "calls": e.count / steps,
                         "device_ms": _device_us(e) / 1e3 / steps}
                        for e in top]}


def run(device="cuda", seed: int = 0, seq: int = 4096, batch: int = 4,
        decode_steps: int = 8, arch: str = "recurrentgemma-9b",
        score_batch: int = 1, rest_dtype=None) -> dict:
    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("profile_lm measures the GPU; it has no CPU mode")
    cfg = configs.get_config(arch)
    scfg = serving_config(cfg)
    K, npre = cfg.n_codebooks, cfg.n_prefix_embeds
    out = {"device": torch.cuda.get_device_name(dev), "arch": cfg.name,
           "dtype": cfg.dtype,
           "rest_dtype": str(rest_dtype or torch.float32).removeprefix(
               "torch."),
           "score_batch": score_batch}
    with torch.inference_mode():
        p = build(cfg, seed, dev, rest_dtype)
        g = torch.Generator(device=dev).manual_seed(seed + 1)

        def tokens(n):
            shape = (n, K, seq) if K > 1 else (n, seq)
            return torch.randint(0, cfg.vocab, shape, generator=g,
                                 device=dev)

        def prefix(n):
            return (0.02 * torch.randn((n, npre, cfg.d_model), generator=g,
                                       device=dev) if npre else None)

        toks, tpe = tokens(score_batch), prefix(score_batch)
        prompts, ppe = tokens(batch), prefix(batch)
        max_len = npre + seq + 2 * decode_steps + 1

        def caches():
            return lm.init_caches(scfg, batch, max_len,
                                  dtype=lm.compute_dtype(cfg), device=dev)

        def forward():
            lm.forward(p, cfg, toks, prefix_embeds=tpe)

        forward()
        out["forward"] = _trace(forward)
        c = caches()
        lm.prefill(p, scfg, prompts, c, prefix_embeds=ppe)
        c = caches()
        out["prefill"] = _trace(lambda: lm.prefill(p, scfg, prompts, c,
                                                   prefix_embeds=ppe))
        tok = prompts[..., -1]
        variants = [("decode", scfg)]
        if cfg.attn_impl == "mla":
            variants.append(("decode_absorbed",
                             dataclasses.replace(scfg, mla_absorb=True)))
        for name, dcfg in variants:
            pos = [npre + seq]

            def step():
                lm.decode_step(p, dcfg, tok, pos[0], c)
                pos[0] += 1

            step()
            out[name] = _trace(step, decode_steps)
    return out


def run_train_step(device="cuda", seed: int = 0, arch: str = "mamba2-780m",
                   batch: int = 4, seq: int = 2048, steps: int = 2) -> dict:
    """One training step of the full-width model (fp32 params and AdamW
    moments, the config's compute dtype and remat), warmed up once, then
    `steps` steps traced: wall and device ms a step, idle share, kernels,
    device ms by kernel group and by region (the plain SSD scan, AdamW)."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("profile_lm measures the GPU; it has no CPU mode")
    cfg = configs.get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = lm.lm_init(cfg, gen, device=dev).requires_grad_(True)
    state = [optim.adamw_init(p)]
    step = ts.make_train_step(cfg, optim.AdamWConfig(
        lr_peak=1e-3, warmup_steps=1, total_steps=100))
    data = SyntheticLM(vocab=cfg.vocab, batch=batch, seq_len=seq,
                       n_codebooks=cfg.n_codebooks, seed=seed)
    batches = [ts.to_device(next(data), dev) for _ in range(steps + 1)]

    def one():
        _, state[0], m = step(p, state[0], batches.pop())
        float(m["loss"])

    one()
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"device": torch.cuda.get_device_name(dev), "arch": cfg.name,
           "dtype": cfg.dtype, "remat": cfg.remat, "batch": batch,
           "seq": seq, "train_step": _trace(one, steps, TRAIN_REGIONS)}
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default=None, choices=configs.ARCH_IDS,
                    help="default: recurrentgemma-9b to serve, mamba2-780m "
                    "to train")
    ap.add_argument("--score-batch", type=int, default=1)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--rest-dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--entry", choices=("serve", "train_step"),
                    default="serve")
    a = ap.parse_args()
    if a.entry == "train_step":
        res = run_train_step(a.device, arch=a.arch or "mamba2-780m")
        print(json.dumps({"phase": "train_step", "device": res["device"],
                          "arch": res["arch"], "remat": res["remat"],
                          "peak_mem_bytes": res["peak_mem_bytes"],
                          **res["train_step"]}))
        return
    res = run(a.device, decode_steps=a.decode_steps,
              arch=a.arch or "recurrentgemma-9b",
              score_batch=a.score_batch,
              rest_dtype=None if a.rest_dtype == "float32"
              else torch.bfloat16)
    for phase in ("forward", "prefill", "decode", "decode_absorbed"):
        if phase in res:
            print(json.dumps({"phase": phase, "device": res["device"],
                              "arch": res["arch"], **res[phase]}))


if __name__ == "__main__":
    main()
