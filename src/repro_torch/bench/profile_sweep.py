"""Where a super-step's time goes on the GPU, eager and captured.

    python -m repro_torch.bench.profile_sweep [--mode ETF] [--steps 64]

Builds one oracle-sized sweep (40 mixes x 14 rates, 60 frames per
workload) and runs one block of `sim.POLL_EVERY` super-steps eagerly to
warm up. Then it traces `--steps` eager super-steps with `torch.profiler`,
records one block in a CUDA graph as the simulator does, and traces
`--steps` more as replays of it (`--steps` a multiple of `POLL_EVERY`).
It prints one JSON line with both sets of numbers: wall and device-busy
milliseconds per super-step, the device's idle share, device kernels and
host-side operator calls per super-step, and the kernels that take most
device time. Wall time is taken around the traced steps, which end in a
synchronize, so it includes the profiler's own cost.
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


def _traced(fn, n_blocks: int) -> dict:
    """Trace `n_blocks` calls of `fn` (one block of super-steps each)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_blocks):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = n_blocks * sim.POLL_EVERY
    evts = prof.key_averages()
    gpu = [e for e in evts if _device_us(e) > 0 and
           str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(_device_us(e) for e in gpu)
    ops = [e for e in evts if e.key.startswith("aten::")]
    top = sorted(gpu, key=_device_us, reverse=True)[:10]
    return {
        "steps": steps,
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


def run(device="cuda", mode: int = sim.MODE_ETF, n_instances: int = 60,
        steps: int = 64) -> dict:
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError("profile_sweep measures the GPU; it has no CPU run")
    if steps <= 0 or steps % sim.POLL_EVERY:
        raise ValueError(f"--steps must be a positive multiple of "
                         f"{sim.POLL_EVERY}, got {steps}")
    suite = workloads.default_suite(n_instances=n_instances)
    cells = [(m, r) for m in range(suite.mixes.shape[0])
             for r in range(len(suite.rates))]
    params = sim.make_params(device=dev)
    wl = sim._engine_workload(suite.build_many(cells), dev)
    ctx = sim._make_ctx(params, wl)
    tree = sim.DTree(*[x.expand(ctx.S, *x.shape)
                       for x in sim.always_fast_tree(dev)])
    thr = torch.full((ctx.S,), 1e9, device=dev)
    max_iters = 3 * ctx.T + ctx.I + 64
    state = {"s": sim._init_state(ctx, wl),
             "it": torch.zeros(ctx.S, dtype=torch.int64, device=dev)}

    def block(st, it):
        return sim._block(ctx, mode, params, st, wl, tree, thr, it,
                          max_iters)

    def eager():
        state["s"], state["it"] = block(state["s"], state["it"])

    eager()                                   # warm-up
    n_blocks = steps // sim.POLL_EVERY
    out = {"device": torch.cuda.get_device_name(dev),
           "mode": sim.MODE_NAMES[mode], "lanes": ctx.S,
           "eager": _traced(eager, n_blocks)}
    replay = sim._capture(block, state["s"], state["it"])
    out["graph"] = _traced(replay, n_blocks)
    out["running_lanes_after"] = int(sim._running(
        wl, state["s"], state["it"], max_iters).sum())
    return out


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
