"""Where a super-step's time goes on the GPU.

    python -m repro_torch.bench.profile_sweep [--mode ETF] [--steps 64]

Builds one oracle-sized sweep (40 mixes x 14 rates, 60 frames per
workload), runs 32 super-steps of the engine to warm up, then traces
`--steps` more with `torch.profiler` and prints one JSON line: wall and
device-busy milliseconds per super-step, the device's idle share, device
kernels and host-side operator calls per super-step, and the kernels
that take most device time. Wall time is taken around the traced steps,
which end in a synchronize, so it includes the profiler's own cost.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import simulator as sim, workloads
from repro_torch.core.device import resolve


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, name, None)
        if val is not None:
            return float(val)
    return 0.0


WARM_STEPS = 32


def run(device="cuda", mode: int = sim.MODE_ETF, n_instances: int = 60,
        steps: int = 64) -> dict:
    dev = resolve(device)
    suite = workloads.default_suite(n_instances=n_instances)
    cells = [(m, r) for m in range(suite.mixes.shape[0])
             for r in range(len(suite.rates))]
    params = sim.make_params(device=dev)
    wl = sim._engine_workload(suite.build_many(cells), dev)
    ctx = sim._make_ctx(params, wl)
    tree = sim.DTree(*[x.expand(ctx.S, *x.shape)
                       for x in sim.always_fast_tree(dev)])
    thr = torch.full((ctx.S,), 1e9, device=dev)
    s = sim._init_state(ctx, wl)
    run_all = torch.ones(ctx.S, dtype=torch.bool, device=dev)

    def step(st):
        running = (st.n_done < wl.n_tasks) & run_all
        return sim._masked_step(ctx, mode, params, st, wl, tree, thr,
                                running)[0]

    for _ in range(WARM_STEPS):
        s = step(s)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            s = step(s)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evts = prof.key_averages()
    gpu = [e for e in evts if _device_us(e) > 0 and
           str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(_device_us(e) for e in gpu)
    ops = [e for e in evts if e.key.startswith("aten::")]
    top = sorted(gpu, key=_device_us, reverse=True)[:10]
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "mode": sim.MODE_NAMES[mode], "lanes": ctx.S, "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernels_per_step": sum(e.count for e in gpu) / steps,
        "aten_calls_per_step": sum(e.count for e in ops) / steps,
        "top_kernels": [{"name": e.key[:80], "calls_per_step":
                         e.count / steps,
                         "device_us_per_step": _device_us(e) / steps}
                        for e in top],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", default="ETF",
                    choices=[v for v in sim.MODE_NAMES.values()])
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args()
    mode = {v: k for k, v in sim.MODE_NAMES.items()}[args.mode]
    print(json.dumps(run(args.device, mode, steps=args.steps)))


if __name__ == "__main__":
    main()
