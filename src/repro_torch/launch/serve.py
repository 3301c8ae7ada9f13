"""Serving launcher: continuous-batching engine + DAS dispatch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-34b \
        --dispatcher das --rate 50 --requests 500

The port of `repro/launch/serve.py`. The engine's clock is the roofline
cost model of a replica of `--chips-per-replica` H100 cards
(`serve/costmodel.py`); it runs no model and needs no card.
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.serve import costmodel as cm
from repro_torch.serve import dispatch as dsp
from repro_torch.serve import engine as eng


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-34b", choices=configs.ARCH_IDS)
    ap.add_argument("--dispatcher", default="das",
                    choices=["lut", "etf", "das", "threshold"])
    ap.add_argument("--rate", type=float, default=50.0)
    ap.add_argument("--requests", type=int, default=300)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--chips-per-replica", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = eng.EngineConfig(n_replicas=args.replicas)
    spec = cm.ReplicaSpec("h100", n_chips=args.chips_per_replica)
    mc = cm.ModelCost.from_config(configs.get_config(args.arch))

    if args.dispatcher == "lut":
        d = dsp.LUTDispatcher(args.replicas)
    elif args.dispatcher == "etf":
        d = dsp.ETFDispatcher()
    elif args.dispatcher == "threshold":
        d = dsp.ThresholdDispatcher(50.0, args.replicas)
    else:
        scen = [(r, 150, s) for r in (2, 10, 40, 120, 300) for s in (0, 1)]
        d = dsp.train_das_dispatcher(scen, cfg, spec, mc)
        print(f"trained DAS dispatcher: acc={d.train_accuracy:.3f} "
              f"slow-label-frac={d.label_slow_frac:.3f}")

    reqs = eng.poisson_requests(args.rate, args.requests, args.seed)
    res = eng.run_engine(reqs, d, cfg, spec, mc)
    print(f"arch={args.arch} dispatcher={args.dispatcher} rate={args.rate}")
    print(f"  mean latency {res.mean_latency_s*1e3:.1f} ms | p99 "
          f"{res.p99_latency_s*1e3:.1f} ms | ttft {res.mean_ttft_s*1e3:.1f}"
          f" ms | {res.throughput_rps:.1f} req/s")
    print(f"  energy {res.energy_j/1e3:.2f} kJ | EDP {res.edp:.0f} | "
          f"fast/slow dispatches {res.dispatch_fast}/{res.dispatch_slow}")
    return res


if __name__ == "__main__":
    main()
