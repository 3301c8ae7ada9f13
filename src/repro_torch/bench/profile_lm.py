"""Where LM inference time goes on the GPU.

    python -m repro_torch.bench.profile_lm [--arch mamba2-780m]
        [--score-batch 4] [--decode-steps 8]

Builds the full-width model of `--arch` (default recurrentgemma-9b) from
a seed (as `lm_serve` does), warms each phase up once, then traces with
`torch.profiler`: one `forward` of [`--score-batch`, 4096] tokens
(default 1), one `prefill` of [4, 4096] and `--decode-steps` decode
steps at batch 4.
Prints one JSON line per phase: wall and device-busy milliseconds, the
device's idle share, kernel launches, and device time by kernel group
(GEMMs, each hand-written kernel, copies and casts, other elementwise
and reduction kernels) and by the kernels that take most of it. Wall
time is taken around the traced region, which ends in a synchronize, so
it includes the profiler's own cost.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.bench.lm_serve import build
from repro_torch.bench.profile_sweep import _device_us
from repro_torch.core.device import resolve
from repro_torch.models import lm

GROUPS = (  # first match wins
    ("flash_attention", ("flash_fwd",)),  # both dtypes' kernels
    ("rg_lru", ("rg_lru_kernel", "rg_lru_tma_kernel")),  # both routes
    ("ssd_scan", ("ssd_scan",)),          # both dtypes' kernels
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("copy_cast", ("copy", "cast", "convert")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _trace(fn, steps: int = 1) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gpu = [e for e in prof.key_averages() if _device_us(e) > 0 and
           str(getattr(e, "device_type", "")).endswith("CUDA")]
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
        "top_kernels": [{"name": e.key[:70], "calls": e.count / steps,
                         "device_ms": _device_us(e) / 1e3 / steps}
                        for e in top]}


def run(device="cuda", seed: int = 0, seq: int = 4096, batch: int = 4,
        decode_steps: int = 8, arch: str = "recurrentgemma-9b",
        score_batch: int = 1) -> dict:
    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("profile_lm measures the GPU; it has no CPU mode")
    cfg = configs.get_config(arch)
    out = {"device": torch.cuda.get_device_name(dev), "arch": cfg.name,
           "dtype": cfg.dtype, "score_batch": score_batch}
    with torch.inference_mode():
        p = build(cfg, seed, dev)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        toks = torch.randint(0, cfg.vocab, (score_batch, seq),
                             generator=g, device=dev)
        prompts = torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                                device=dev)
        max_len = seq + 2 * decode_steps + 1

        def caches():
            return lm.init_caches(cfg, batch, max_len,
                                  dtype=lm.compute_dtype(cfg), device=dev)

        def forward():
            lm.forward(p, cfg, toks)

        forward()
        out["forward"] = _trace(forward)
        c = caches()
        lm.prefill(p, cfg, prompts, c)
        c = caches()
        out["prefill"] = _trace(lambda: lm.prefill(p, cfg, prompts, c))
        tok = prompts[:, -1]
        pos = [seq]

        def step():
            lm.decode_step(p, cfg, tok, pos[0], c)
            pos[0] += 1

        step()
        out["decode"] = _trace(step, decode_steps)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="recurrentgemma-9b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--score-batch", type=int, default=1)
    ap.add_argument("--decode-steps", type=int, default=8)
    a = ap.parse_args()
    res = run(a.device, decode_steps=a.decode_steps, arch=a.arch,
              score_batch=a.score_batch)
    for phase in ("forward", "prefill", "decode"):
        print(json.dumps({"phase": phase, "device": res["device"],
                          "arch": res["arch"], **res[phase]}))


if __name__ == "__main__":
    main()
