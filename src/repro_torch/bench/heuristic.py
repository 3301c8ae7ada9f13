"""The static data-rate-threshold heuristic comparison (paper IV-C): DAS
should beat a judiciously chosen fixed threshold across rates.

The port of `benchmarks/heuristic.py`. The threshold is chosen by
simulation: every candidate (the distinct training data rates) runs on a
selection grid in one batched sweep, the grid tiled once per candidate
and each lane carrying its own `rate_threshold`; the lowest mean
execution time wins. DAS then meets it on an evaluation grid.

    python -m repro_torch.bench.heuristic [--device cpu] [--csv]
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.bench import common
from repro_torch.core import simulator as sim

MIXES = [0, 1, 3, 4, 5]
# selection grid for picking the threshold (distinct from the evaluation
# grid, like the paper's train/eval split)
SELECT_RATES = [1, 5, 9, 13]
EVAL_RATES = [0, 3, 5, 7, 9, 11, 13]


def best_threshold(bench: common.Bench) -> float:
    """One batched sweep over (candidate x mix x rate); the candidate
    with the lowest mean execution time wins."""
    cand = np.unique(np.asarray(bench.dataset().rates, np.float32))
    cells = [(mi, ri) for mi in MIXES for ri in SELECT_RATES]
    thr_axis = np.repeat(cand, len(cells)).astype(np.float32)
    res = bench.eval_grid(cells * len(cand), sim.MODE_THRESHOLD,
                          rate_threshold=thr_axis, label="heuristic-select")
    per_cand = np.asarray(res.avg_exec_us).reshape(len(cand), len(cells))
    return float(cand[np.argmin(per_cand.mean(axis=1))])


def run(bench: common.Bench, csv: bool = False):
    thr = best_threshold(bench)
    pol = bench.das_policy()
    t0 = time.perf_counter()
    cells = [(mi, ri) for mi in MIXES for ri in EVAL_RATES]
    d = bench.eval_grid(cells, sim.MODE_DAS, tree=pol.tree)
    h = bench.eval_grid(cells, sim.MODE_THRESHOLD, rate_threshold=thr)
    gains = [float(hx) / float(dx)
             for hx, dx in zip(h.avg_exec_us, d.avg_exec_us)]
    das_wins = sum(g >= 1.0 for g in gains)
    total = len(gains)
    us = time.perf_counter() - t0
    mean_gain = float(np.mean(gains))
    if csv:
        print(f"heuristic,{us*1e6:.0f},{thr}|{mean_gain:.4f}")
    else:
        print(f"threshold={thr:.0f} Mbps (simulation-fit on the selection "
              "grid, one batched candidate sweep)")
        print(f"  DAS vs heuristic mean exec-time ratio: {mean_gain:.3f} "
              f"(paper: 13% lower => 1.13); DAS wins/ties "
              f"{das_wins}/{total}")
        ok = mean_gain >= 0.99 and das_wins * 2 >= total
        print(f"  check: DAS matches the simulation-fit optimum and "
              f"wins/ties most cells: {'PASS' if ok else 'MISS'}")
    return {"threshold": thr, "mean_gain": mean_gain,
            "das_wins": das_wins, "total": total}


def main(argv=None) -> None:
    args = common.cli(__doc__.splitlines()[0], argv)
    run(common.bench_from_env(args.device), csv=args.csv)


if __name__ == "__main__":
    main()
