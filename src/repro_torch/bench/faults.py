"""Fault-injection degradation curves: scheduler quality as PEs die.

The port of `benchmarks/faults.py`. Fails the accelerator PEs one more
at a time (FFT -> FIR -> FEC -> SAP) at t = 0 and sweeps LUT, ETF and DAS
over the scenarios in one `run_batch` call per mode (the same workload
stacked once a point, with `faults.stack_plans` along the scenario
axis). Graceful degradation means the latency curve does not fall as
PEs die and every scenario still completes all jobs (failures at t = 0
revoke nothing in flight, so this isolates pure scheduling degradation).

    python -m repro_torch.bench.faults [--device cpu] [--smoke] [--csv]

`--smoke` runs a 4-point curve with LUT and ETF only (no classifier
training); the exit code is 1 unless every check passes.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from repro_torch.bench import common
from repro_torch.core import faults, simulator as sim, soc, workloads

# the cell to degrade: a mid-load mix x rate (latency-sensitive but not
# saturated, so extra CPU pressure is visible without stalling)
MIX_IDX, RATE_IDX = 5, 6

# kill accelerators in cluster order: FFT(4) -> FIR(4) -> FEC(1) -> SAP(2)
ACCEL_PES = np.where(soc.PE_CLUSTER >= soc.FFT_ACC)[0]

# tolerated non-monotonicity: a k+1 point may undercut point k by 2%
# (re-placement can shift NoC traffic in the survivors' favour slightly)
MONO_TOL = 1.02


def plan_for(k: int) -> faults.FaultPlan:
    """The first `k` accelerator PEs dead from t = 0."""
    plan = faults.healthy_plan()
    if k:
        plan = faults.fail_pes(plan, ACCEL_PES[:k].tolist(), at=0.0)
    return plan


def stress_plans() -> faults.FaultPlan:
    """The fault path's stress set on this section's cell: `random_plan(k)`
    for k < 16, stacked (permanent failures with and without repair, and
    glitches); odd seeds with no retry budget, so kills drop jobs, even
    seeds with a 6 us deadline (`random_plan`'s own is infinite), which
    drops jobs in every mode at 60 frames. Every fault phase can fire."""
    plans = []
    for k in range(16):
        plan = faults.random_plan(k)
        plans.append(faults.with_retries(plan, 0) if k % 2
                     else faults.with_deadline(plan, 6.0))
    return faults.stack_plans(plans)


def _monotone(avg: List[float]) -> bool:
    return all(b >= a / MONO_TOL for a, b in zip(avg, avg[1:]))


def run(bench: common.Bench, csv: bool = False, smoke: bool = False) -> Dict:
    ks = ([0, 4, 8, len(ACCEL_PES)] if smoke
          else list(range(len(ACCEL_PES) + 1)))
    wl_b = workloads.stack_workloads(
        [bench.cell_workload(MIX_IDX, RATE_IDX)] * len(ks))
    plan_b = faults.stack_plans([plan_for(k) for k in ks])

    sweeps = [("LUT", sim.MODE_LUT, None), ("ETF", sim.MODE_ETF, None)]
    if not smoke:
        sweeps.append(("DAS", sim.MODE_DAS, bench.das_policy().tree))

    t0 = time.perf_counter()
    out = {name: bench.sweep(mode, wl_b, tree=tree, plan=plan_b,
                             label=f"faults {name}")
           for name, mode, tree in sweeps}
    us = time.perf_counter() - t0

    ok = True
    curves = {}
    for name, r in out.items():
        avg = [float(x) for x in r.avg_exec_us]
        edp = [float(x) for x in r.edp]
        drops = [int(x) for x in r.n_dropped_jobs]
        retries = [int(x) for x in r.n_retries]
        stalls = [bool(x) for x in r.stalled]
        mono = _monotone(avg)
        healthy = not any(stalls) and not any(drops)
        ok = ok and mono and healthy
        curves[name] = {"k": ks, "avg_exec_us": avg, "edp": edp,
                        "dropped_jobs": drops, "retries": retries,
                        "monotone": mono}
        if not csv:
            pts = "  ".join(f"k={k}:{a:7.2f}" for k, a in zip(ks, avg))
            print(f"{name:4s} avg exec (us) vs dead accel PEs: {pts}")
            print(f"     EDP x{edp[-1]/edp[0]:.2f} at full accel loss; "
                  f"drops={sum(drops)} retries={sum(retries)} "
                  f"stalls={sum(stalls)}  "
                  f"monotone: {'PASS' if mono else 'MISS'}")
    if csv:
        slope = {n: c["avg_exec_us"][-1] / c["avg_exec_us"][0]
                 for n, c in curves.items()}
        deg = "|".join(f"{n}:{s:.3f}" for n, s in slope.items())
        print(f"faults,{us*1e6:.0f},{deg}")
    else:
        print(f"  check: degradation curves monotone, no stalls/drops: "
              f"{'PASS' if ok else 'MISS'}")
    return {"curves": curves, "ok": ok}


def main(argv=None) -> None:
    args = common.cli(__doc__.splitlines()[0], argv,
                      extra=[("--smoke", "4-point curve, LUT/ETF only")])
    res = run(common.bench_from_env(args.device), csv=args.csv,
              smoke=args.smoke)
    if not res["ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
