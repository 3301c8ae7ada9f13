"""The port's benchmark harness: every DAS section of the paper's
benchmark and the serving section on one shared pipeline, with a run
record of its own.

    python -m repro_torch.bench.run [--device cuda] [--only fig2,fig3,...]
                                    [--csv] [--json PATH] [--resume DIR]

The port of `benchmarks/run.py`. The sections run in the reference's
order on one `Bench`, so the two oracle sweeps and the DAS training
happen once (`roofline` prints the dry-run record's table, or nothing
without one); every sweep goes through the crash-safe campaign runner.
`--resume DIR` checkpoints every sweep's chunks into DIR (atomic
write-temp + rename); the same command run again after a crash or a
SIGKILL resumes from the completed chunks and gives byte-identical
results. `--json PATH` writes the record atomically: `total_s`, `env`
(device name, the `nvidia-smi` power limit, torch version, devices,
the chunk size and its source: `env`, `cache` or `probe`, frames per
workload and the training grid), `derived`
(summary40's five numbers), `campaign` (the campaign counters:
chunks computed and reused, retries, timeouts, out-of-memory shrinks,
stall trips, chunk wall times, occupancy; `common.Bench.campaign_stats`),
`kernels` (the decision kernels' launches over the run, by
`LAUNCHES`) and `sections` (each section's `wall_s` and result, or its
error). The reference's record, `benchmarks/BENCH_sweep.json`, is never
overwritten. Sizes and the campaign follow the reference's environment
knobs (see `common`).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.bench import (common, faults, fig2, fig3, heuristic,
                               overhead, roofline_table, serving_das,
                               summary40, table2)
from repro_torch.core import campaign, simulator as sim
from repro_torch.kernels.etf_ft import ops

SECTIONS = [
    ("fig2", "Fig.2: exec time + EDP, 3 workloads x 4 schedulers", fig2.run),
    ("fig3", "Fig.3: DAS decision mix + scheduling energy", fig3.run),
    ("table2", "Table II: classifier accuracy/storage", table2.run),
    ("summary40", "40-workload summary claims", None),
    ("heuristic", "static-threshold heuristic comparison", heuristic.run),
    ("overhead", "scheduling overhead anchors", overhead.run),
    ("faults", "fault-injection degradation curves", faults.run),
    ("serving_das", "beyond-paper: DAS serving dispatch", serving_das.run),
    ("roofline", "dry-run roofline table", roofline_table.run),
]
# sections of the reference's harness the port does not run: none left
NOT_PORTED: dict = {}
REFERENCE_RECORD = (Path(__file__).resolve().parents[3] / "benchmarks"
                    / "BENCH_sweep.json")


def _jsonable(obj):
    """JSON coercion for numpy scalars and arrays in section results;
    anything else degrades to its repr."""
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return repr(obj)


def _power_limit(device: torch.device) -> str | None:
    """`nvidia-smi`'s name and power limit of the card, or None."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    idx = device.index or 0
    return out[idx] if idx < len(out) else None


def env_record(bench: common.Bench, full_grid: bool) -> dict:
    dev = bench.device
    return {
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "nvidia_smi_name_power_limit": _power_limit(dev),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "n_devices": len(sim._resolve_devices(None, dev)),
        "bench_devices": os.environ.get("REPRO_BENCH_DEVICES"),
        **dict(zip(("batch_size", "batch_size_source"),
                   common.resolve_batch_size(dev))),
        "campaign_dir": bench.campaign_dir,
        "full_grid": full_grid,
        "n_instances": int(bench.suite.n_instances),
        "train_grid": [len(bench.train_mixes), len(bench.train_rates)],
    }


def run_sections(bench: common.Bench, only=None, csv: bool = False,
                 full_grid: bool = True) -> tuple[dict, list]:
    """Run the sections (all, or the names in `only`) in order; returns
    (results by name, [(name, exception), ...])."""
    results, failures = {}, []
    for name, title, fn in SECTIONS:
        if only and name not in only:
            continue
        print(f"\n{'=' * 72}\n== {name}: {title}\n{'=' * 72}", flush=True)
        t0 = time.perf_counter()
        try:
            if name == "summary40":
                out = summary40.run(bench=bench, csv=csv,
                                    n_mixes=40 if full_grid else 14)
            else:
                out = fn(bench, csv=csv)
            results[name] = {"wall_s": time.perf_counter() - t0,
                             "result": out}
        except Exception as e:  # noqa: BLE001 -- recorded, then exit 1
            failures.append((name, e))
            results[name] = {"wall_s": time.perf_counter() - t0,
                             "error": f"{type(e).__name__}: {e}"}
            traceback.print_exc()
        print(f"-- {name} done in {time.perf_counter() - t0:.1f}s",
              flush=True)
    return results, failures


def derived(results: dict) -> dict:
    """summary40's five headline numbers, when it ran."""
    s40 = results.get("summary40", {}).get("result")
    if not isinstance(s40, dict):
        return {}
    return {k: s40[k] for k in summary40.DERIVED if k in s40}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--csv", action="store_true",
                    help="emit name,us_per_call,derived CSV lines")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the run record to PATH")
    ap.add_argument("--only", default=None,
                    help="comma-separated section names")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="checkpoint sweep chunks into DIR and resume any "
                         "completed chunks from a previous (killed) run")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    known = {n for n, _, _ in SECTIONS} | set(NOT_PORTED)
    if only and only - known:
        raise SystemExit(f"unknown sections {sorted(only - known)}")
    if args.json and Path(args.json).resolve() == REFERENCE_RECORD:
        raise SystemExit(f"refusing to overwrite the reference's record "
                         f"{REFERENCE_RECORD}")
    for name, why in NOT_PORTED.items():
        if only is None or name in only:
            print(f"== {name}: {why}")

    cfg = common.env_config()
    bench = common.bench_from_env(args.device, campaign_dir=args.resume)
    # the chunk size first: a probe's sweeps are not the sections' launches
    common.resolve_batch_size(bench.device)
    ops.reset_launches()
    t00 = time.perf_counter()
    results, failures = run_sections(bench, only, args.csv,
                                     cfg["full_grid"])
    if bench.device.type == "cuda":
        torch.cuda.synchronize(bench.device)
    total = time.perf_counter() - t00
    print(f"\nall sections done in {total:.1f}s; {len(failures)} failures")
    record = {
        "total_s": total,
        "env": env_record(bench, cfg["full_grid"]),
        "derived": derived(results),
        "campaign": bench.campaign_stats(),
        "kernels": dict(ops.LAUNCHES),
        "sweeps": bench.sweeps,
        "not_ported": NOT_PORTED,
        "sections": results,
    }
    if args.json:
        path = Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        # a crash mid-write leaves no torn file
        campaign.atomic_write_json(str(path), record, default=_jsonable)
        print(f"wrote {path}")
    if failures:
        raise SystemExit(1)
    return record


if __name__ == "__main__":
    main()
