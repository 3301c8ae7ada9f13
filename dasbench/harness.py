"""The benchmark of the port's scheduling sweeps on the H100.

    python3 dasbench/run.py --workload NAME --seed N --seconds S --trace 0|1

A run finds its cell in `BENCHMARK.json` by name, and by the names there
its files: the configuration (`configs/<config>.json`), the traffic
(`traffic/<traffic>.json`), its limits (`limits/<workload>.json`) and a
reader for each metric it reports (`metrics/<metric>.py`). It loads,
warms up one sweep of each scheduler mode of the traffic at the cell's
shapes, then runs sweeps back to back through the port's
`campaign.run_campaign` (one client in a closed loop: a researcher's
script sweeping a grid after a grid). Sweep `k` gets inputs drawn from
`(seed, k)`. The window closes at the end of the first cycle of the
traffic's modes that ends after `--seconds`. Then the check holds a
sample of the window's scenarios, drawn from the seed, to the plain
reference (`check`), and the run prints its result as one JSON line.
With `--trace 1` the window's first sweep is traced (`trace`) and the
line carries the per-layer metrics instead of the end-to-end ones.

That is the DSSoC lane, a configuration file without `kind` or with
`kind` "dssoc". A configuration of `kind` "lm" runs the language-model
lane (`lm_lane`) through the same command, files and result line.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from dasbench import check, inputs, trace
from dasbench.reference import ref_sim

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# where the program keeps the chunk size's autotune cache in a checkout
CACHE_DIR = HERE / ".cache" / "autotune"
OUT_DIR = HERE / "out"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Readings:
    """What the metric readers read."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    sweeps: List[dict]        # every sweep of the window
    traced: List[dict]        # the traced sweep, or none
    trace: Dict | None        # `trace.reduce` of the slice


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve_cell(root: Path, workload: str) -> dict:
    """The cell's entries and files, found by the names in
    `BENCHMARK.json`."""
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return {
        "cell": cell,
        "config": _load(root / config["file"]),
        "traffic": _load(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": _load(HERE / "limits" / f"{workload}.json"),
        "end_to_end": e2e,
        "per_layer": layer,
    }


def reader(name: str):
    """The `read` function of `metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "dasbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _isolate_env() -> None:
    """The program's knobs as the benchmark sets them, whatever the
    caller's environment holds: every chunk size from the autotune, whose
    cache lives in the checkout."""
    for k in [k for k in os.environ if k.startswith("REPRO_BENCH_")]:
        del os.environ[k]
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    os.environ["REPRO_BENCH_CACHE_DIR"] = str(CACHE_DIR)


def loaded_forbidden() -> List[str]:
    """Top-level names of loaded modules that the run must not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def run(spec: dict, seed: int, seconds: float, traced: bool,
        device: str, t_start: float, log=print) -> dict:
    """One run of a cell: set-up, window, check. Returns the result
    line's object. `device` is "cuda" for a benchmark run; the tests
    drive the same path on the CPU at a small size."""
    if spec["config"].get("kind", "dssoc") == "lm":
        from dasbench import lm_lane
        return lm_lane.run(spec, seed, seconds, traced, device, t_start, log)
    import torch
    from dasbench.program import Program

    config, traffic = spec["config"], spec["traffic"]
    marks = [time.perf_counter()]
    tr = inputs.Traffic(config, traffic)
    prog = Program(config, device)
    marks.append(time.perf_counter())
    batch = prog.chunk()
    marks.append(time.perf_counter())
    # warm-up: a sweep of each mode at the cell's shapes
    for i in range(tr.cycle):
        sw = tr.sweep(seed, inputs.WARMUP - tr.cycle + 1 + i)
        prog.sweep(sw.mode, sw.wl, sw.plan, batch, sw.policy)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t_start
    log("# set-up s: imports {:.3f}, inputs and program {:.3f}, chunk size "
        "{:.3f}, warm-up {:.3f}".format(marks[0] - t_start, *[
            b - a for a, b in zip(marks, marks[1:])]))

    check_cfg = traffic["check"]
    keep = int(check_cfg["keep_per_sweep"])
    sweeps: List[dict] = []
    kept: List[check.Row] = []
    attempted = failed = 0
    # A traced run sweeps the window's first inputs twice: untraced, for
    # the wall that the device's idle share is read against (the profiler
    # slows the sweep it traces), then traced.
    slice_ = trace.Slice() if traced else None
    repeat = traced
    results = None
    t0 = time.perf_counter()
    k = 0
    while True:
        tracing = traced and not repeat and k == 0
        on = slice_ if tracing else None
        if tracing:
            slice_.start()
        ts = time.perf_counter()
        with trace.span(on, "draw"):
            sw = tr.sweep(seed, k)
        with trace.span(on, "run_campaign"):
            res, stats = prog.sweep(sw.mode, sw.wl, sw.plan, batch,
                                    sw.policy)
        with trace.span(on, "keep"):
            S = int(res.n_done.shape[0])
            lanes = set(inputs.rng(seed, k, inputs.SAMPLE).choice(
                S, size=min(keep, S), replace=False).tolist())
            lanes.add(int(np.argmax(res.n_iters)))
            lanes = sorted(lanes)
            kept += [check.Row(k, j, out) for j, out in
                     zip(lanes, prog.rows(res, lanes))]
            bad = int(((np.asarray(res.stall_reason) != 0)
                       | np.asarray(res.stalled)).sum())
        te = time.perf_counter()
        attempted += S
        failed += bad
        sweeps.append({
            "index": k, "mode": sw.mode, "scenarios": S,
            "events": int(np.asarray(res.n_iters, np.int64).sum()),
            "lane_trips": stats["lane_trips"],
            "active_trips": stats["active_trips"],
            "steps": stats["steps"], "wall_s": te - ts,
            "decisions": int(np.asarray(res.n_decisions, np.int64).sum()),
            "slow": int(np.asarray(res.n_slow, np.int64).sum()),
            "chunk_lanes": -(-S // stats["n_chunks"]),
            "plan": sw.plan is not None, "traced": tracing})
        del res
        if tracing:
            results = slice_.stop()
            sweeps[-1]["untraced_wall_s"] = sweeps[0]["wall_s"]
        if repeat:
            repeat = False
            continue
        k += 1
        if k % tr.cycle == 0 and te - t0 >= seconds:
            break
    window_s = te - t0
    summary = None
    if results is not None:
        tq = time.perf_counter()
        summary = trace.reduce(*results)
        log(f"# trace: {summary['n_kernels']} kernels in the slice, "
            f"reduced in {time.perf_counter() - tq:.2f}s")
    del results, prog

    walls = [s["wall_s"] for s in sweeps]
    log(f"# sweeps: {len(sweeps)} in {window_s:.4f}s; wall s median "
        f"{statistics.median(walls):.4f} min {min(walls):.4f} max "
        f"{max(walls):.4f}; " + ", ".join(
            f"{s['mode']} {s['wall_s']:.4f}" for s in sweeps))
    r = Readings(spec["cell"], config, traffic, setup_s, window_s, sweeps,
                 [s for s in sweeps if s["traced"]], summary)
    out = result_line(spec, r, traced, attempted, failed, device,
                      "traced_sweeps")
    if cuda:
        torch.cuda.empty_cache()
    # the check, once the program's state is gone
    sample = check.pick_sample(inputs.rng(seed, inputs.WARMUP,
                                          inputs.SAMPLE),
                               kept, int(check_cfg["sample"]))
    tq = time.perf_counter()
    out["correct"], out["check"] = verdict(tr, seed, sample, spec["limits"],
                                           failed)
    log(f"# check: {len(sample)} scenarios against the reference in "
        f"{time.perf_counter() - tq:.2f}s")
    return out


def result_line(spec: dict, r, traced: bool, attempted: int, failed: int,
                device: str, traced_key: str) -> dict:
    """The result line's object, of either lane, but for its check: the
    cell's metrics read from `r` (its `Readings`; the per-layer ones in a
    traced run, else the end-to-end ones), the device and its peak, and
    with a trace its busy time and breakdown, whose reduction is also
    written to `out/<cell>.trace.json` beside `r.traced` under
    `traced_key`. Read before the check, whose reference would raise the
    device's peak."""
    import torch

    cuda = device == "cuda"
    metrics = {}
    for m in (spec["per_layer"] if traced else spec["end_to_end"]):
        v = reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": None, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda
                      else "cpu",
                      "count": int(spec["cell"]["chips"]),
                      "memory_peak_bytes": int(
                          torch.cuda.max_memory_allocated() if cuda
                          else 0)}}
    summary = r.trace
    if summary is not None:
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = trace.breakdown(summary)
        OUT_DIR.mkdir(exist_ok=True)
        with open(OUT_DIR / f"{spec['cell']['name']}.trace.json", "w") as f:
            json.dump({k: v for k, v in summary.items() if k != "gaps"}
                      | {"longest_gaps": out["breakdown"]["idle_gaps"],
                         traced_key: r.traced}, f, indent=1)
    return out


def reference_numbers(tr: inputs.Traffic, seed: int,
                      sample: List[check.Row],
                      outputs: List[dict] | None = None) -> List[dict]:
    """Each sampled row's numbers against the reference. `outputs`
    replaces the program's rows (the control puts the reference in the
    program's place)."""
    soc = ref_sim.Soc.from_config(tr.config["soc"])
    per, sw = [], None
    for i, row in enumerate(sample):
        if sw is None or sw.index != row.sweep:
            sw = tr.sweep(seed, row.sweep)
        wl, plan = inputs.scenario(sw, row.lane)
        ref = ref_sim.simulate_ref(ref_sim.MODES[sw.mode], wl, soc, plan,
                                   policy=sw.policy)
        out = row.out if outputs is None else outputs[i]
        per.append(check.numbers(out, ref, int(wl.n_tasks)))
    return per


def verdict(tr, seed, sample, limits, failed) -> tuple:
    """(correct, the check's numbers each beside its limit)."""
    per = reference_numbers(tr, seed, sample)
    ok, rows = check.judge(check.readings(per), limits)
    shown = {"scenarios_failed": {"value": failed, "limit": 0}}
    shown.update({k: {"value": v, "limit": lim} for k, v, lim in rows})
    return bool(ok and failed == 0 and sample), shown


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = resolve_cell(ROOT, args.workload)
    _isolate_env()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    chips = int(spec["cell"]["chips"])
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"dasbench: the cell needs {chips} CUDA device(s); torch sees "
              f"{seen}", file=sys.stderr)
        return 2
    out = run(spec, args.seed, args.seconds, bool(args.trace), "cuda",
              t_start)
    bad = loaded_forbidden()
    if bad:
        print(f"dasbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(f"check correct: {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
