"""Quickstart: train the DAS preselection classifier and beat both
underlying schedulers on a congested workload.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port of `examples/quickstart.py`; it runs on the GPU unless
`--device` says otherwise.
"""
import argparse


def main(argv=None) -> None:
    from repro_torch.core import das, simulator as sim, workloads

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    # 1. build a workload suite (mixes of the five streaming applications)
    suite = workloads.default_suite(n_instances=40)
    params = sim.make_params(device=device)

    # 2. train DAS: two-execution oracle -> depth-2 decision tree on the
    #    paper's two features (input data rate, big-cluster availability)
    policy = das.train_das(
        suite, params,
        mix_indices=[0, 1, 3, 4, 5],      # tx/rx/temporal/app1/uniform mixes
        rate_indices=[0, 5, 9, 12, 13], device=device)
    print(f"classifier: train acc {policy.train_accuracy:.3f}, "
          f"test acc {policy.test_accuracy:.3f} on {policy.n_train} samples")

    # 3. evaluate on a congested wifi-rx workload
    wl = suite.build(mix_idx=1, rate_idx=11)
    for name, mode, kw in [
        ("LUT (fast)", sim.MODE_LUT, {}),
        ("ETF (slow)", sim.MODE_ETF, {}),
        ("DAS", sim.MODE_DAS, {"tree": policy.tree}),
    ]:
        r = sim.to_numpy(sim.run(mode, wl, params, device=device, **kw))
        frac = int(r.n_slow) / max(int(r.n_decisions), 1)
        print(f"{name:12s} avg exec {float(r.avg_exec_us):7.2f} us | "
              f"EDP {float(r.edp):9.0f} | slow-scheduler use {frac:4.0%}")


if __name__ == "__main__":
    main()
