"""End-to-end DSSoC study: sweep all 14 data rates on a chosen application
mix and print the four-scheduler comparison (a Fig. 2 panel).

    PYTHONPATH=src python -m repro_torch.examples.soc_simulation [mix_idx]
        [--device cpu]

The port of `examples/soc_simulation.py`; it runs on the GPU unless
`--device` says otherwise, each scheduler as one batched sweep over the
14 rates.
"""
import argparse


def main(argv=None) -> None:
    from repro_torch.core import das, simulator as sim, workloads

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mix", nargs="?", type=int, default=5,
                    help="mix index (default 5, the uniform five-app mix)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mix, device = args.mix, args.device
    suite = workloads.default_suite(n_instances=60)
    params = sim.make_params(device=device)

    policy = das.train_das(suite, params, mix_indices=[0, 1, 3, 4, 5],
                           rate_indices=[0, 5, 9, 12, 13], device=device)

    stacked = suite.build_many([(mix, ri) for ri in range(len(suite.rates))])
    r = {name: sim.to_numpy(sim.run_batch(mode, stacked, params,
                                          device=device, **kw))
         for name, mode, kw in (("LUT", sim.MODE_LUT, {}),
                                ("ETF", sim.MODE_ETF, {}),
                                ("IDE", sim.MODE_ETF_IDEAL, {}),
                                ("DAS", sim.MODE_DAS,
                                 {"tree": policy.tree}))}
    print(f"mix {mix}: ratios {suite.mixes[mix].round(2)}")
    print(f"{'rate Mbps':>10} | {'LUT':>8} {'ETF':>8} {'ETF-ideal':>9} "
          f"{'DAS':>8} | {'DAS slow%':>9}")
    for ri in range(len(suite.rates)):
        sf = int(r["DAS"].n_slow[ri]) / max(int(r["DAS"].n_decisions[ri]), 1)
        print(f"{float(suite.rates[ri]):10.1f} | "
              f"{float(r['LUT'].avg_exec_us[ri]):8.2f} "
              f"{float(r['ETF'].avg_exec_us[ri]):8.2f} "
              f"{float(r['IDE'].avg_exec_us[ri]):9.2f} "
              f"{float(r['DAS'].avg_exec_us[ri]):8.2f} | {sf:9.0%}")


if __name__ == "__main__":
    main()
