"""Serve a model with DAS-dispatched continuous batching: train the
dispatch classifier, then sweep request rates against LUT/ETF baselines.

    PYTHONPATH=src python -m repro_torch.examples.serve_das [--arch minicpm3-4b]

The port of `examples/serve_das.py`: replicas of 8 H100 cards, clocked
by the cost model (`serve/costmodel.py`); no card is needed.
"""
import argparse


def main(argv=None) -> None:
    from repro_torch import configs
    from repro_torch.serve import costmodel as cm
    from repro_torch.serve import dispatch as dsp
    from repro_torch.serve import engine as eng

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm3-4b",
                    choices=configs.ARCH_IDS)
    args = ap.parse_args(argv)

    cfg = eng.EngineConfig(n_replicas=4, max_batch=16)
    spec = cm.ReplicaSpec("h100-8", n_chips=8)
    mc = cm.ModelCost.from_config(configs.get_config(args.arch))

    scenarios = [(r, 120, s) for r in (2, 10, 40, 120, 300) for s in (0, 1)]
    das = dsp.train_das_dispatcher(scenarios, cfg, spec, mc)
    print(f"DAS dispatcher trained: acc {das.train_accuracy:.3f}, "
          f"slow-label fraction {das.label_slow_frac:.3f}\n")

    print(f"{'req/s':>6} | {'LUT ms':>8} {'ETF ms':>8} {'DAS ms':>8} | "
          "slow%")
    for rate in (5, 20, 60, 150, 350):
        row = {}
        for name, d in (("LUT", dsp.LUTDispatcher(4)),
                        ("ETF", dsp.ETFDispatcher()),
                        ("DAS", dsp.DASDispatcher(das.tree, 4))):
            reqs = eng.poisson_requests(rate, 150, seed=3)
            row[name] = eng.run_engine(reqs, d, cfg, spec, mc)
        sf = row["DAS"].dispatch_slow / max(
            row["DAS"].dispatch_fast + row["DAS"].dispatch_slow, 1)
        print(f"{rate:6.0f} | {row['LUT'].mean_latency_s*1e3:8.1f} "
              f"{row['ETF'].mean_latency_s*1e3:8.1f} "
              f"{row['DAS'].mean_latency_s*1e3:8.1f} | {sf:5.0%}")


if __name__ == "__main__":
    main()
