"""Two-execution oracle generation for DAS training data (paper Fig. 1).

First execution (MODE_ORACLE): both schedulers run at every decision; if they
agree the sample is labeled F immediately; otherwise the label is *pending*
and the fast decision is followed.

Second execution (MODE_ETF): the same scenario follows the slow scheduler
throughout. If the target metric (avg execution time or EDP) improves versus
the first execution, pending labels become S, else F.

`generate` runs the whole (mix x rate) grid through two batched simulator
calls (`sim.run_batch`, one `MODE_ORACLE` + one `MODE_ETF` sweep over the
scenario axis) instead of 2 x len(grid) sequential runs; the resulting
dataset is identical to the sequential path (`batched=False`), which is
kept for differential testing.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

import numpy as np
import torch

from repro_torch.core import simulator as sim
from repro_torch.core.device import resolve
from repro_torch.core.workloads import FlatWorkload, WorkloadSuite

LABEL_F, LABEL_S = 0, 1


@dataclasses.dataclass
class OracleDataset:
    features: np.ndarray   # [N, N_FEATURES] f32
    labels: np.ndarray     # [N] int32 (0=F, 1=S)
    groups: np.ndarray     # [N] int32 (workload-mix id of each sample)
    rates: np.ndarray      # [N] f32 (nominal data rate of the run)

    def __len__(self) -> int:
        return int(self.labels.shape[0])


def label_one_run(
    wl: FlatWorkload,
    params: sim.SimParams,
    metric: str = "avg_exec_us",
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Run the two executions for one (workload, rate) scenario.

    Returns (features [D, F], labels [D], info).
    """
    r1 = sim.to_numpy(sim.run(sim.MODE_ORACLE, wl, params,
                              device=device))   # follows fast
    r2 = sim.to_numpy(sim.run(sim.MODE_ETF, wl, params,
                              device=device))   # follows slow
    n_dec = int(r1.n_decisions)
    feats = r1.log_feat[:n_dec]
    agree = r1.log_agree[:n_dec].astype(bool)

    m1 = float(getattr(r1, metric))
    m2 = float(getattr(r2, metric))
    pending_label = LABEL_S if m2 < m1 else LABEL_F
    labels = np.where(agree, LABEL_F, pending_label).astype(np.int32)
    info = {
        "metric_fast_run": m1,
        "metric_slow_run": m2,
        "pending_label": pending_label,
        "n_decisions": n_dec,
        "agreement_rate": float(agree.mean()) if n_dec else 0.0,
    }
    return feats, labels, info


def generate(
    suite: WorkloadSuite,
    params: sim.SimParams | None = None,
    mix_indices: Iterable[int] | None = None,
    rate_indices: Iterable[int] | None = None,
    metric: str = "avg_exec_us",
    seed: int = 0,
    verbose: bool = False,
    batched: bool = True,
    batch_size: int | None = None,
    runner=None,
    device="cuda",
) -> OracleDataset:
    """Generate the oracle dataset over (mix x rate) scenarios.

    With `batched=True` (default) all scenarios are built up front and
    labeled from one vmapped `MODE_ORACLE` sweep plus one vmapped
    `MODE_ETF` sweep; `batch_size` chunks the scenario axis to bound
    memory (see `sim.run_batch`). `batched=False` is the original
    scenario-at-a-time loop; both paths produce identical datasets.

    `runner` swaps the sweep engine for the batched path: a callable
    `(mode, stacked, params, batch_size) -> SimResult` — the benchmark
    (`bench.common`) passes one that shares the two sweeps between the
    datasets of both metrics.
    """
    dev = resolve(device)
    params = params or sim.make_params(device=dev)
    mix_indices = list(mix_indices if mix_indices is not None
                       else range(suite.mixes.shape[0]))
    rate_indices = list(rate_indices if rate_indices is not None
                        else range(len(suite.rates)))
    cells = [(mi, ri) for mi in mix_indices for ri in rate_indices]

    feats: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    groups: List[np.ndarray] = []
    rates: List[np.ndarray] = []

    def emit(mi, ri, f, l, info):
        feats.append(f)
        labels.append(l)
        groups.append(np.full(l.shape[0], mi, np.int32))
        rates.append(np.full(l.shape[0], float(suite.rates[ri]),
                             np.float32))
        if verbose:
            print(f"mix={mi:2d} rate={float(suite.rates[ri]):7.1f} "
                  f"n={info['n_decisions']:5d} "
                  f"agree={info['agreement_rate']:.2f} "
                  f"pending->{'S' if info['pending_label'] else 'F'} "
                  f"(F-run {info['metric_fast_run']:.2f} vs "
                  f"S-run {info['metric_slow_run']:.2f})")

    if batched:
        if runner is None:
            def runner(m, s, p, bs):
                return sim.run_batch(m, s, p, batch_size=bs, device=dev)
        stacked = suite.build_many(cells, seed=seed)
        r1 = runner(sim.MODE_ORACLE, stacked, params, batch_size)
        r2 = runner(sim.MODE_ETF, stacked, params, batch_size)
        r1, r2 = _host(r1), _host(r2)
        all_n_dec = r1.n_decisions
        all_feat = r1.log_feat
        all_agree = r1.log_agree
        all_m1 = getattr(r1, metric)
        all_m2 = getattr(r2, metric)
        for k, (mi, ri) in enumerate(cells):
            n_dec = int(all_n_dec[k])
            f = all_feat[k, :n_dec]
            agree = all_agree[k, :n_dec].astype(bool)
            m1, m2 = float(all_m1[k]), float(all_m2[k])
            pending_label = LABEL_S if m2 < m1 else LABEL_F
            l = np.where(agree, LABEL_F, pending_label).astype(np.int32)
            emit(mi, ri, f, l, {
                "metric_fast_run": m1, "metric_slow_run": m2,
                "pending_label": pending_label, "n_decisions": n_dec,
                "agreement_rate": float(agree.mean()) if n_dec else 0.0,
            })
    else:
        for mi, ri in cells:
            wl = suite.build(mi, ri, seed=seed)
            f, l, info = label_one_run(wl, params, metric=metric,
                                       device=dev)
            emit(mi, ri, f, l, info)

    return OracleDataset(
        features=np.concatenate(feats, axis=0),
        labels=np.concatenate(labels, axis=0),
        groups=np.concatenate(groups, axis=0),
        rates=np.concatenate(rates, axis=0),
    )


def _host(res: sim.SimResult) -> sim.SimResult:
    """A runner's result as numpy (runners may return tensors or numpy)."""
    return sim.SimResult(*[x.cpu().numpy() if torch.is_tensor(x)
                           else np.asarray(x) for x in res])


def train_test_split(ds: OracleDataset, test_frac: float = 0.25,
                     seed: int = 0):
    rng = np.random.RandomState(seed)
    n = len(ds)
    idx = rng.permutation(n)
    cut = int(n * (1 - test_frac))
    tr, te = idx[:cut], idx[cut:]
    mk = lambda ii: OracleDataset(ds.features[ii], ds.labels[ii],
                                  ds.groups[ii], ds.rates[ii])
    return mk(tr), mk(te)
