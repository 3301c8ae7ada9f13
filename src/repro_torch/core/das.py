"""DAS: end-to-end training + deployment of the preselection classifier.

`train_das` generates the oracle dataset, fits the depth-2 decision tree on
the paper's two features (input data rate + earliest big-cluster
availability), and returns a deployable `DASPolicy` whose `tree` plugs into
the simulator (MODE_DAS) or the serving dispatcher.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core import classifier as clf
from repro_torch.core import oracle
from repro_torch.core import simulator as sim
from repro_torch.core.device import resolve
from repro_torch.core.simulator import FEAT_BIG_AVAIL, FEAT_RATE
from repro_torch.core.workloads import WorkloadSuite

PAPER_FEATURES = (FEAT_RATE, FEAT_BIG_AVAIL)


@dataclasses.dataclass
class DASPolicy:
    tree: sim.DTree                 # depth-2, simulator-ready
    dtree: clf.DecisionTree         # host-side classifier
    feature_ids: Sequence[int]
    train_accuracy: float
    test_accuracy: float
    n_train: int

    def run(self, wl, params=None, plan=None,
            device="cuda") -> sim.SimResult:
        """Simulate this policy on `wl`; `plan` is an optional
        `faults.FaultPlan` for fault-injection runs."""
        return sim.run(sim.MODE_DAS, wl, params, tree=self.tree, plan=plan,
                       device=device)


def fit_policy(ds: oracle.OracleDataset,
               feature_ids: Sequence[int] = PAPER_FEATURES,
               depth: int = 2,
               test_frac: float = 0.25,
               seed: int = 0) -> DASPolicy:
    tr, te = oracle.train_test_split(ds, test_frac=test_frac, seed=seed)
    cols = list(feature_ids)
    tree = clf.DecisionTree.fit(tr.features[:, cols], tr.labels, depth=depth,
                                feature_ids=cols)
    return DASPolicy(
        tree=tree.to_depth2_arrays(),
        dtree=tree,
        feature_ids=cols,
        train_accuracy=tree.accuracy(tr.features[:, cols], tr.labels),
        test_accuracy=tree.accuracy(te.features[:, cols], te.labels),
        n_train=len(tr),
    )


def train_das(suite: WorkloadSuite,
              params: sim.SimParams | None = None,
              mix_indices: Iterable[int] | None = None,
              rate_indices: Iterable[int] | None = None,
              metric: str = "avg_exec_us",
              feature_ids: Sequence[int] = PAPER_FEATURES,
              verbose: bool = False,
              batch_size: int | None = None,
              device="cuda") -> DASPolicy:
    """End-to-end DAS training; the oracle pass runs the whole
    (mix x rate) grid through the batched simulator (`batch_size` chunks
    the scenario axis, see `oracle.generate`)."""
    dev = resolve(device)
    params = params or sim.make_params(device=dev)
    ds = oracle.generate(suite, params, mix_indices=mix_indices,
                         rate_indices=rate_indices, metric=metric,
                         verbose=verbose, batch_size=batch_size,
                         device=dev)
    return fit_policy(ds, feature_ids=feature_ids)
