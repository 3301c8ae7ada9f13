"""Shared benchmark pipeline: the workload suite, the oracle datasets, the
trained DAS policies and the per-mode evaluation grids, on one device.

The port of the summary40 path of `benchmarks/common.py`. The two
oracle sweeps (`MODE_ORACLE` and `MODE_ETF` over the training grid) are
metric-independent, since only the labelling of pending samples reads
the metric, so they run once and serve the datasets of both metrics.
Every sweep is one `sim.run_batch` call; its wall time, super-steps,
retired events and health counters are kept in `Bench.sweeps`.

A `Bench` holds its caches itself, so two pipelines in one process (the
GPU run and a CPU cross-check, say) never share results.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import classifier as clf
from repro_torch.core import das, oracle, simulator as sim, workloads
from repro_torch.core.device import resolve

N_INSTANCES = 60          # frames per workload, as the reference's default


class Bench:
    """One benchmark pipeline on one device.

    `train_mixes` / `train_rates` pick the oracle grid (default: the
    paper's full 40 mixes x 14 rates). Every sweep is one chunk: the
    whole grid fits on the card, and a chunk's super-step count is set
    by its slowest lane, so fewer chunks means fewer super-steps.
    """

    def __init__(self, device="cuda", n_instances: int = N_INSTANCES,
                 train_mixes: Sequence[int] | None = None,
                 train_rates: Sequence[int] | None = None):
        self.device = resolve(device)
        self.suite = workloads.default_suite(n_instances=n_instances)
        self.params = sim.make_params(device=self.device)
        self.train_mixes = list(range(self.suite.mixes.shape[0])
                                if train_mixes is None else train_mixes)
        self.train_rates = list(range(len(self.suite.rates))
                                if train_rates is None else train_rates)
        self.sweeps: List[Dict] = []
        self._oracle_sweeps: Dict[int, sim.SimResult] = {}
        self._datasets: Dict[str, oracle.OracleDataset] = {}
        self._policies: Dict[Tuple[str, str], das.DASPolicy] = {}
        self._cells: Dict[Tuple[int, int], workloads.FlatWorkload] = {}

    # -- sweeps ------------------------------------------------------------
    def sweep(self, mode: int, stacked: workloads.FlatWorkload, tree=None,
              rate_threshold=1e9, label: str = "") -> sim.SimResult:
        """One batched sweep; returns the result as numpy arrays."""
        tel: List[Dict] = []
        t0 = time.perf_counter()
        res = sim.run_batch(mode, stacked, self.params, tree=tree,
                            rate_threshold=rate_threshold,
                            device=self.device, telemetry=tel)
        res = sim.to_numpy(res)    # waits for the device
        wall = time.perf_counter() - t0
        self.sweeps.append({
            "label": label or sim.MODE_NAMES[mode],
            "scenarios": int(res.n_done.shape[0]),
            "wall_s": wall,
            "steps": sum(t["steps"] for t in tel),
            "events": sum(t["events"] for t in tel),
            **health(res),
        })
        return res

    def dataset(self, metric: str = "avg_exec_us") -> oracle.OracleDataset:
        if metric not in self._datasets:
            def runner(m, stacked, p, bs):
                if m not in self._oracle_sweeps:
                    self._oracle_sweeps[m] = self.sweep(
                        m, stacked, label=f"oracle {sim.MODE_NAMES[m]}")
                return self._oracle_sweeps[m]

            self._datasets[metric] = oracle.generate(
                self.suite, self.params, mix_indices=self.train_mixes,
                rate_indices=self.train_rates, metric=metric,
                runner=runner, device=self.device)
        return self._datasets[metric]

    def das_policy(self) -> das.DASPolicy:
        """The paper's feature pair (rate, big-cluster availability)."""
        key = ("paper", "avg_exec_us")
        if key not in self._policies:
            self._policies[key] = das.fit_policy(self.dataset())
        return self._policies[key]

    def das_policy_auto(self, metric: str = "avg_exec_us") -> das.DASPolicy:
        """2 features chosen by greedy selection instead of the paper's
        pair."""
        key = ("auto", metric)
        if key not in self._policies:
            ds = self.dataset(metric)
            tr, _ = oracle.train_test_split(ds)
            idx = np.random.RandomState(0).permutation(len(tr))[:6000]
            sel = clf.greedy_select(tr.features[idx], tr.labels[idx], k=2)
            self._policies[key] = das.fit_policy(ds, feature_ids=sel)
        return self._policies[key]

    # -- evaluation grids --------------------------------------------------
    def cell_workload(self, mix_idx: int,
                      rate_idx: int) -> workloads.FlatWorkload:
        key = (mix_idx, rate_idx)
        if key not in self._cells:
            self._cells[key] = self.suite.build(mix_idx, rate_idx)
        return self._cells[key]

    def eval_grid(self, cells: Sequence[Tuple[int, int]], mode: int,
                  tree=None, label: str = "") -> sim.SimResult:
        """One batched sweep of `mode` over `[(mix_idx, rate_idx), ...]`;
        a numpy `SimResult` with one row per cell, in order."""
        stacked = workloads.stack_workloads(
            [self.cell_workload(mi, ri) for mi, ri in cells])
        return self.sweep(mode, stacked, tree=tree,
                          label=label or f"grid {sim.MODE_NAMES[mode]}")

    def eval_modes_grid(self, cells: Sequence[Tuple[int, int]],
                        with_fs: bool = False) -> Dict[str, sim.SimResult]:
        """All scheduler modes over a cell grid, one batched sweep each.
        DAS = the paper's feature pair; DAS-FS = the same depth-2 tree on
        the 2 features the greedy selection picks."""
        out = {
            "LUT": self.eval_grid(cells, sim.MODE_LUT),
            "ETF": self.eval_grid(cells, sim.MODE_ETF),
            "ETF-ideal": self.eval_grid(cells, sim.MODE_ETF_IDEAL),
            "DAS": self.eval_grid(cells, sim.MODE_DAS,
                                  tree=self.das_policy().tree),
        }
        if with_fs:
            out["DAS-FS"] = self.eval_grid(
                cells, sim.MODE_DAS, tree=self.das_policy_auto().tree,
                label="grid DAS-FS")
        return out


def health(res: sim.SimResult) -> Dict[str, int]:
    """Counters that must be zero on a clean sweep."""
    unfinished = int((np.asarray(res.stall_reason) != sim.STALL_NONE).sum())
    return {"stalled": int(np.asarray(res.stalled).sum()),
            "unfinished": unfinished,
            "ready_drop": int(np.asarray(res.ready_drop).sum())}
