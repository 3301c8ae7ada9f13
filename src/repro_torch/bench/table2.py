"""Table II reproduction: classification accuracy and storage of LR and DT
classifiers against the number of features (our profiles, the paper's
method).

The port of `benchmarks/table2.py`. The training profiles are the
pipeline's oracle dataset (`Bench.dataset()`); the classifiers train on
its first 20,000 training samples in `RandomState(0)` order.

    python -m repro_torch.bench.table2 [--device cpu] [--csv]
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.bench import common
from repro_torch.core import classifier as clf, oracle, simulator as sim


def run(bench: common.Bench, csv: bool = False):
    ds = bench.dataset()
    tr, te = oracle.train_test_split(ds)
    sub = np.random.RandomState(0).permutation(len(tr))[:20000]
    Xs, ys = tr.features[sub], tr.labels[sub]

    scores = clf.feature_scores(Xs[:4000], ys[:4000], depth=2)
    order = np.argsort(-scores)
    top6 = [int(i) for i in order[:6]]
    paper2 = [sim.FEAT_RATE, sim.FEAT_BIG_AVAIL]
    all_cols = list(range(Xs.shape[1]))

    rows = []
    for name, fit, cols in (
            ("LR (2 feat, paper pair)", lambda: clf.LogisticRegression.fit(
                Xs[:, paper2], ys, device=bench.device), paper2),
            ("LR (62 feat)", lambda: clf.LogisticRegression.fit(
                Xs, ys, device=bench.device), all_cols),
            ("DT d2 (1 feat: rate)", lambda: clf.DecisionTree.fit(
                Xs[:, [sim.FEAT_RATE]], ys, 2), [sim.FEAT_RATE]),
            ("DT d2 (2 feat, paper pair)", lambda: clf.DecisionTree.fit(
                Xs[:, paper2], ys, 2), paper2),
            ("DT d2 (2 feat, selected)", lambda: clf.DecisionTree.fit(
                Xs[:, top6[:2]], ys, 2), top6[:2]),
            ("DT d4 (6 feat)", lambda: clf.DecisionTree.fit(
                Xs[:, top6], ys, 4), top6),
            ("DT d16 (62 feat)", lambda: clf.DecisionTree.fit(Xs, ys, 16),
             all_cols)):
        t0 = time.perf_counter()
        model = fit()
        acc = model.accuracy(te.features[:, cols], te.labels)
        rows.append({
            "classifier": name, "n_features": len(cols), "accuracy": acc,
            "storage_kb": model.storage_kb(),
            "us_per_call": time.perf_counter() - t0,
        })

    print(f"{'classifier':28s} {'#feat':>5} {'acc%':>7} {'KB':>8}")
    for r in rows:
        if csv:
            print(f"table2,{r['us_per_call']*1e6:.0f},"
                  f"{r['classifier']}|{r['accuracy']*100:.2f}|"
                  f"{r['storage_kb']:.3f}")
        else:
            print(f"{r['classifier']:28s} {r['n_features']:5d} "
                  f"{r['accuracy']*100:7.2f} {r['storage_kb']:8.3f}")
    print(f"  top-6 selected features: "
          f"{[sim.FEAT_NAMES[i] for i in top6]}")
    d16, d2 = rows[-1]["accuracy"], rows[4]["accuracy"]
    print(f"  check: deep tree >= shallow tree accuracy: "
          f"{'PASS' if d16 >= d2 - 0.02 else 'MISS'}")
    small = rows[3]["storage_kb"] < rows[-1]["storage_kb"] / 100
    print(f"  check: shallow DT storage << deep DT storage: "
          f"{'PASS' if small else 'MISS'}")
    return rows


def main(argv=None) -> None:
    args = common.cli(__doc__.splitlines()[0], argv)
    run(common.bench_from_env(args.device), csv=args.csv)


if __name__ == "__main__":
    main()
