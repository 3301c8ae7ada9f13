"""Fig. 3 reproduction: DAS decision split (fast vs slow) per data rate and
the total scheduling-energy overhead of LUT, ETF and DAS (uniform mix).

The port of `benchmarks/fig3.py`.

    python -m repro_torch.bench.fig3 [--device cpu] [--csv]
"""
from __future__ import annotations

import time

from repro_torch.bench import common
from repro_torch.core import workloads

MIX = 5  # uniform five-app mix


def run(bench: common.Bench, csv: bool = False):
    rows = []
    print(f"{'rate':>7} | {'fast%':>6} {'slow%':>6} | "
          f"{'E_LUT uJ':>9} {'E_ETF uJ':>9} {'E_DAS uJ':>9} | "
          f"{'DAS ns/dec':>10} {'DAS nJ/dec':>10}")
    all_rates = range(len(workloads.DATA_RATES_MBPS))
    t0 = time.perf_counter()
    grid = bench.eval_modes_grid([(MIX, ri) for ri in all_rates])
    us = (time.perf_counter() - t0) / len(workloads.DATA_RATES_MBPS)
    d = grid["DAS"]
    for ri in all_rates:
        n = max(int(d.n_decisions[ri]), 1)
        fast = int(d.n_fast[ri]) / n
        rate = float(workloads.DATA_RATES_MBPS[ri])
        lat_ns = float(d.sched_time_us[ri]) / n * 1e3
        e_nj = float(d.sched_energy_uj[ri]) / n * 1e3
        rows.append({
            "rate_mbps": rate, "fast_frac": fast, "slow_frac": 1 - fast,
            "sched_e_lut": float(grid["LUT"].sched_energy_uj[ri]),
            "sched_e_etf": float(grid["ETF"].sched_energy_uj[ri]),
            "sched_e_das": float(d.sched_energy_uj[ri]),
            "das_ns_per_decision": lat_ns,
            "das_nj_per_decision": e_nj,
            "us_per_call": us,
        })
        if csv:
            print(f"fig3,{us*1e6:.0f},{rate}|{fast:.3f}|{e_nj:.2f}")
        else:
            print(f"{rate:7.1f} | {fast:6.2f} {1-fast:6.2f} | "
                  f"{rows[-1]['sched_e_lut']:9.3f} "
                  f"{rows[-1]['sched_e_etf']:9.3f} "
                  f"{rows[-1]['sched_e_das']:9.3f} | "
                  f"{lat_ns:10.1f} {e_nj:10.2f}")
    lo, hi = rows[0], rows[-1]
    print(f"  check: lowest rate uses fast for "
          f"{lo['fast_frac']*100:.0f}% (paper: 100%): "
          f"{'PASS' if lo['fast_frac'] > 0.95 else 'MISS'}")
    print(f"  paper anchors: DAS heavy-load ~65 ns / 27.2 nJ per decision; "
          f"ours at top rate: {hi['das_ns_per_decision']:.0f} ns / "
          f"{hi['das_nj_per_decision']:.1f} nJ")
    return rows


def main(argv=None) -> None:
    args = common.cli(__doc__.splitlines()[0], argv)
    run(common.bench_from_env(args.device), csv=args.csv)


if __name__ == "__main__":
    main()
