"""Fig. 2 reproduction: average execution time (a-c) and EDP (d-f) of DAS,
LUT, ETF, ETF-ideal for three representative workloads across data rates.

The port of `benchmarks/fig2.py`. Workload selection mirrors the paper:
workload-1 = low data-rate behaviour (temporal-mitigation mix, never
congests), workload-2 = moderate (wifi-rx: scarce-FEC contention, the
ETF-wins regime), workload-3 = high rate (app-1: ETF's quadratic
overhead collapses, DAS falls back to LUT).

    python -m repro_torch.bench.fig2 [--device cpu] [--csv]
"""
from __future__ import annotations

import time

from repro_torch.bench import common
from repro_torch.core import workloads

# mix indices in workloads.workload_mixes(): 3 = temporal-only,
# 1 = wifi-rx-only, 4 = app1-only
WL = [("workload-1 (low rate: temporal)", 3),
      ("workload-2 (moderate: wifi-rx)", 1),
      ("workload-3 (high rate: app-1)", 4)]
RATE_IDX = [0, 3, 5, 7, 9, 10, 11, 12, 13]


def run(bench: common.Bench, csv: bool = False):
    rows = []
    for title, mi in WL:
        if not csv:
            print(f"\n== {title} ==")
            print(f"{'rate':>7} | {'LUT':>8} {'ETF':>8} {'DAS':>8} "
                  f"{'DAS-FS':>8} {'ETFideal':>8} | {'EDP LUT':>9} "
                  f"{'EDP ETF':>9} {'EDP DAS-FS':>10}")
        # one batched sweep per mode over this workload's rate axis
        t0 = time.perf_counter()
        grid = bench.eval_modes_grid([(mi, ri) for ri in RATE_IDX],
                                     with_fs=True)
        us = (time.perf_counter() - t0) / len(RATE_IDX)
        for idx, ri in enumerate(RATE_IDX):
            rate = float(workloads.DATA_RATES_MBPS[ri])
            r = {"workload": title, "rate_mbps": rate, "us_per_call": us,
                 **{f"exec_{k}": float(v.avg_exec_us[idx])
                    for k, v in grid.items()},
                 **{f"edp_{k}": float(v.edp[idx]) for k, v in grid.items()}}
            rows.append(r)
            if csv:
                print(f"fig2,{us*1e6:.0f},"
                      f"{title}|{rate}|{r['exec_DAS-FS']:.3f}")
            else:
                print(f"{rate:7.1f} | {r['exec_LUT']:8.2f} "
                      f"{r['exec_ETF']:8.2f} {r['exec_DAS']:8.2f} "
                      f"{r['exec_DAS-FS']:8.2f} "
                      f"{r['exec_ETF-ideal']:8.2f} | {r['edp_LUT']:9.0f} "
                      f"{r['edp_ETF']:9.0f} {r['edp_DAS-FS']:10.0f}")
    # paper-claim checks (trend-level)
    by_wl = {}
    for r in rows:
        by_wl.setdefault(r["workload"], []).append(r)
    lo = by_wl[WL[0][0]][0]
    mid = by_wl[WL[1][0]][-3]
    hi = by_wl[WL[2][0]][-1]
    checks = [
        ("low-rate: DAS <= ETF exec", lo["exec_DAS"] <= lo["exec_ETF"] * 1.02),
        ("low-rate: DAS EDP well below ETF EDP",
         lo["edp_DAS"] < 0.7 * lo["edp_ETF"]),
        ("moderate: DAS <= LUT exec",
         mid["exec_DAS"] <= mid["exec_LUT"] * 1.02),
        ("high-rate wl3: DAS-FS ~ LUT (ETF collapses)",
         hi["exec_DAS-FS"] <= hi["exec_LUT"] * 1.15),
    ]
    for name, ok in checks:
        print(f"  check: {name}: {'PASS' if ok else 'MISS'}")
    return rows


def main(argv=None) -> None:
    args = common.cli(__doc__.splitlines()[0], argv)
    run(common.bench_from_env(args.device), csv=args.csv)


if __name__ == "__main__":
    main()
