"""Chunk size against wall time: the measurement behind the chunk-size
autotune's ladder and probe grid (`common._BATCH_CANDIDATES`,
`common._probe_cells`).

    python -m repro_torch.bench.chunk_sizes [--device cuda]
        [--sizes 32,64,128,256,560] [--repeats 2] [--json PATH]

Part 1 runs one full-grid sweep (40 mixes x 14 rates, 60 frames per
workload: an oracle sweep's size) of ETF and of LUT through
`campaign.run_campaign` at each chunk size, in turns (the sizes up, then
down), after one warm-up sweep of each mode. Each run records its wall
time (host clock around the sweep and its copy to the host), its chunks,
its super-steps and the device's peak allocated bytes. Part 2 times the
autotune's probe at each candidate (`common._probe_sweep_s`: a warm-up
sweep, then a timed one, LUT through `sim.run_batch`), on
two grids at 6 frames: the reference's 8 mixes x 4 rates and the full
40 x 14. A chunk clamps to the sweep, so on the 32-scenario grid every
candidate from 32 up is the same single chunk. It prints one line a run
and, with `--json`, writes every number.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.bench import common
from repro_torch.core import campaign, simulator as sim, workloads
from repro_torch.core.device import resolve

FULL = common._probe_cells("cuda")              # all 40 x 14
REFERENCE_PROBE = common._probe_cells("cpu")    # the reference's 8 x 4
PROBE_CANDIDATES = (32, 64, 128, 256, 1024)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_reset(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev: torch.device) -> int | None:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def sweep_at(mode: int, stacked, params, batch: int,
             dev: torch.device) -> dict:
    """One campaign sweep at chunk size `batch`: wall s, chunks,
    super-steps and peak bytes."""
    _sync(dev)
    _peak_reset(dev)
    t0 = time.perf_counter()
    out = campaign.run_campaign(mode, stacked, params, batch_size=batch,
                                device=dev)
    wall = time.perf_counter() - t0
    return {"mode": sim.MODE_NAMES[mode], "batch": batch,
            "chunks": out.stats["n_chunks"], "wall_s": wall,
            "steps": out.stats["steps"],
            "occupancy": out.stats["occupancy"], "peak_bytes": _peak(dev),
            "avg_exec_us_sum": float(np.sum(out.result.avg_exec_us))}


def run(device="cuda", sizes=(32, 64, 128, 256, 560),
        repeats: int = 2) -> dict:
    dev = resolve(device)
    params = sim.make_params(device=dev)
    stacked = workloads.default_suite(n_instances=60).build_many(FULL)
    sweeps = []
    for mode in (sim.MODE_ETF, sim.MODE_LUT):
        warm = sweep_at(mode, stacked, params, max(sizes), dev)
        print(f"# warm-up {warm['mode']} at {warm['batch']}: "
              f"{warm['wall_s']:.3f}s", flush=True)
        for rep in range(repeats):
            for b in (sizes if rep % 2 == 0 else sizes[::-1]):
                rec = sweep_at(mode, stacked, params, b, dev)
                rec["repeat"] = rep
                sweeps.append(rec)
                print(json.dumps(rec), flush=True)
    probes = []
    suite = workloads.default_suite(n_instances=common._PROBE_FRAMES)
    for grid, cells in (("reference 8 x 4", REFERENCE_PROBE),
                        ("full 40 x 14", FULL)):
        tiny = suite.build_many(cells)
        t00 = time.perf_counter()
        for b in PROBE_CANDIDATES:
            rec = {"grid": grid, "scenarios": len(cells), "batch": b,
                   "chunks": -(-len(cells) // min(b, len(cells))),
                   "timed_s": common._probe_sweep_s(tiny, params, b, dev)}
            probes.append(rec)
            print(json.dumps(rec), flush=True)
        print(f"# probe on the {grid} grid: {len(PROBE_CANDIDATES)} "
              f"candidates in {time.perf_counter() - t00:.3f}s with their "
              "warm-ups", flush=True)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"device": name, "torch": torch.__version__, "sweeps": sweeps,
            "probes": probes}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default="32,64,128,256,560")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--json", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    sizes = tuple(int(s) for s in args.sizes.split(","))
    out = run(args.device, sizes, args.repeats)
    if args.json:
        campaign.atomic_write_json(args.json, out)
    return out


if __name__ == "__main__":
    main()
