"""The control of a cell's check: the reference one precision down in the
program's place.

    python3 dasbench/control.py --workload NAME --seeds 1,2,3 [--sweeps 4]

The configurations state float32 times; the control computes the
sampled scenarios with `reference/ref_sim.py` in bfloat16 and hands
those results to the cell's own check, which holds them to the float64
reference as it holds the program's. For each seed it makes the inputs
of the cell's first `--sweeps` sweeps as a run makes them, draws a
run's sample from them, and prints one JSON line: the check's numbers
each beside its limit, and `correct`, which has to come out false. It
needs no GPU: the control replaces the program.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from dasbench import check, harness, inputs  # noqa: E402
from dasbench.reference import ref_sim  # noqa: E402


def run(spec: dict, seed: int, n_sweeps: int) -> dict:
    tr = inputs.Traffic(spec["config"], spec["traffic"])
    chk = spec["traffic"]["check"]
    rows = []
    for k in range(n_sweeps):
        S = tr.lanes()
        lanes = inputs.rng(seed, k, inputs.SAMPLE).choice(
            S, size=min(int(chk["keep_per_sweep"]), S), replace=False)
        rows += [check.Row(k, int(j), {"n_iters": 0}) for j in sorted(lanes)]
    sample = check.pick_sample(inputs.rng(seed, inputs.WARMUP, inputs.SAMPLE),
                               rows, int(chk["sample"]))
    soc = ref_sim.Soc.from_config(spec["config"]["soc"])
    outs, sw = [], None
    for row in sample:
        if sw is None or sw.index != row.sweep:
            sw = tr.sweep(seed, row.sweep)
        wl, plan = inputs.scenario(sw, row.lane)
        b = ref_sim.simulate_ref(ref_sim.MODES[sw.mode], wl, soc, plan,
                                 precision="bfloat16", policy=sw.policy)
        outs.append({**b, "total_energy_uj": b["task_energy_uj"]
                     + b["sched_energy_uj"]})
    per = harness.reference_numbers(tr, seed, sample, outputs=outs)
    ok, shown = check.judge(check.readings(per), spec["limits"])
    return {"workload": spec["cell"]["name"], "seed": seed,
            "correct": bool(ok), "scenarios_checked": len(sample),
            "check": {k: {"value": v, "limit": lim} for k, v, lim in shown}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sweeps", type=int, default=4)
    args = ap.parse_args(argv)
    spec = harness.resolve_cell(harness.ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run(spec, seed, args.sweeps)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
