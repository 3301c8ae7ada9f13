"""The 40-workload summary (paper IV-C): DAS speedup and EDP reduction vs
ETF at low data rates and vs LUT at high workload complexity, plus the
fraction of (workload, rate) cells where DAS >= min(LUT, ETF).

The port of `benchmarks/summary40.py`. Run on the GPU with
`python -m repro_torch.bench.summary40` (`--device cpu` for the plain
PyTorch path).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.bench.common import N_INSTANCES, Bench
from repro_torch.core import simulator as sim

LOW_RATES = [0, 1, 2]
HIGH_RATES = [11, 12, 13]
DERIVED = ("speedup_vs_etf_low", "edp_red_vs_etf_low",
           "speedup_vs_lut_high", "edp_red_vs_lut_high",
           "das_matches_best_frac")


def run(device="cuda", n_instances: int = N_INSTANCES, n_mixes: int = 40,
        train_mixes=None, train_rates=None, bench: Bench | None = None,
        csv: bool = False) -> dict:
    """The summary pipeline on `device`: both oracle datasets, the three
    DAS policies and six evaluation sweeps over `n_mixes` x 6 rates.
    Returns the five `DERIVED` numbers, plus `n_mixes`, `n_cells`, the
    oracle sample counts, the record of each sweep it ran, the three
    trees (as lists) and the wall seconds. `bench` runs it on an existing
    pipeline (its datasets and policies reused; the other arguments but
    `n_mixes` ignored)."""
    t0 = time.perf_counter()
    if bench is None:
        bench = Bench(device, n_instances=n_instances,
                      train_mixes=train_mixes, train_rates=train_rates)
    first = len(bench.sweeps)
    # the paper labels pendings by "the target metric, such as the average
    # execution time OR energy-delay product": exec-trained policy for the
    # speedup claims, EDP-trained policy for the EDP claims.
    pol_edp = bench.das_policy_auto("edp")
    cells = [(mi, ri) for mi in range(n_mixes)
             for ri in LOW_RATES + HIGH_RATES]
    grid = bench.eval_modes_grid(cells, with_fs=True)
    de = bench.eval_grid(cells, sim.MODE_DAS, tree=pol_edp.tree,
                         label="grid DAS-EDP")
    d = grid["DAS-FS"].avg_exec_us.astype(np.float64)
    lut = grid["LUT"].avg_exec_us.astype(np.float64)
    etf = grid["ETF"].avg_exec_us.astype(np.float64)
    de_edp = de.edp.astype(np.float64)
    low = np.array([ri in LOW_RATES for _, ri in cells])
    best = d <= np.minimum(lut, etf) * 1.02
    out = {
        "speedup_vs_etf_low": float(np.mean(etf[low] / d[low])),
        "edp_red_vs_etf_low": float(np.mean(
            1 - de_edp[low] / grid["ETF"].edp.astype(np.float64)[low])),
        "speedup_vs_lut_high": float(np.mean(lut[~low] / d[~low])),
        "edp_red_vs_lut_high": float(np.mean(
            1 - de_edp[~low] / grid["LUT"].edp.astype(np.float64)[~low])),
        "das_matches_best_frac": float(best.sum()) / len(cells),
    }
    trees = {"DAS": bench.das_policy().tree,
             "DAS-FS": bench.das_policy_auto().tree, "DAS-EDP": pol_edp.tree}
    out.update(
        n_mixes=n_mixes,
        n_cells=len(cells),
        n_samples={m: len(bench.dataset(m)) for m in ("avg_exec_us", "edp")},
        sweeps=bench.sweeps[first:],
        trees={k: {f: v.tolist() for f, v in t._asdict().items()}
               for k, t in trees.items()},
        wall_s=time.perf_counter() - t0,
    )
    if csv:
        print(f"summary40,{out['wall_s'] * 1e6:.0f}," + "|".join(
            f"{out[k]:.3f}" for k in DERIVED[:4]))
    else:
        print(f"over {n_mixes} workload mixes ({len(cells)} cells): DAS vs "
              f"ETF at low rates {out['speedup_vs_etf_low']:.2f}x, EDP "
              f"{-out['edp_red_vs_etf_low'] * 100:+.0f}%; DAS vs LUT at high "
              f"rates {out['speedup_vs_lut_high']:.2f}x, EDP "
              f"{-out['edp_red_vs_lut_high'] * 100:+.0f}%; DAS >= both in "
              f"{out['das_matches_best_frac'] * 100:.0f}% of cells")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    print(json.dumps(run(ap.parse_args().device), indent=1))


if __name__ == "__main__":
    main()
