"""Beyond-paper section: DAS dispatch in the LM serving engine
(DESIGN.md section 3). A pool of 4 replicas of 8 H100 cards each serving
yi-34b, a request-rate ladder, LUT vs ETF vs DAS.

    PYTHONPATH=src python -m repro_torch.bench.serving_das

The port of `benchmarks/serving_das.py`. The engine's clock is the cost
model (`serve/costmodel.py`), so the section runs no kernel; `spec`
swaps the replica's constants (another card's, for a parity check
against the reference's record).
"""
from __future__ import annotations

import time

from repro_torch import configs
from repro_torch.serve import costmodel as cm
from repro_torch.serve import dispatch as dsp
from repro_torch.serve import engine as eng

RATES = (2, 10, 30, 80, 200, 400)


def run(bench=None, csv: bool = False, arch: str = "yi-34b",
        spec: cm.ReplicaSpec | None = None):
    """One row per request rate: mean latency and EDP of LUT, ETF and
    DAS. `bench` is unused (the sections' common signature)."""
    cfg = eng.EngineConfig(n_replicas=4, max_batch=16)
    spec = spec or cm.ReplicaSpec("h100-8", n_chips=8)
    mc = cm.ModelCost.from_config(configs.get_config(arch))

    t0 = time.perf_counter()
    scen = [(r, 150, s) for r in (2, 8, 20, 50, 120, 300) for s in (0, 1)]
    das = dsp.train_das_dispatcher(scen, cfg, spec, mc)
    train_s = time.perf_counter() - t0

    rows = []
    beats = 0
    print(f"({spec.name}: DAS dispatcher acc {das.train_accuracy:.3f}, "
          f"trained in {train_s:.1f}s)")
    print(f"{'rate':>6} | {'LUT ms':>8} {'ETF ms':>8} {'DAS ms':>8} | "
          f"{'slow%':>6} | EDP LUT/ETF/DAS")
    for rate in RATES:
        res = {}
        for name, d in (("LUT", dsp.LUTDispatcher(4)),
                        ("ETF", dsp.ETFDispatcher()),
                        ("DAS", dsp.DASDispatcher(das.tree, 4))):
            reqs = eng.poisson_requests(rate, 200, seed=7)
            res[name] = eng.run_engine(reqs, d, cfg, spec, mc)
        r = res["DAS"]
        sf = r.dispatch_slow / max(r.dispatch_fast + r.dispatch_slow, 1)
        best = min(res["LUT"].mean_latency_s, res["ETF"].mean_latency_s)
        if r.mean_latency_s <= best * 1.01:
            beats += 1
        rows.append({"rate": rate,
                     **{f"lat_{k}": v.mean_latency_s
                        for k, v in res.items()},
                     **{f"edp_{k}": v.edp for k, v in res.items()}})
        if csv:
            print(f"serving_das,{rate},{r.mean_latency_s*1e3:.1f}")
        else:
            print(f"{rate:6.0f} | {res['LUT'].mean_latency_s*1e3:8.1f} "
                  f"{res['ETF'].mean_latency_s*1e3:8.1f} "
                  f"{r.mean_latency_s*1e3:8.1f} | {sf:6.2f} | "
                  f"{res['LUT'].edp:8.0f}/{res['ETF'].edp:8.0f}/"
                  f"{r.edp:8.0f}")
    print(f"  check: DAS matches/beats best at >=4/6 rates: "
          f"{'PASS' if beats >= 4 else 'MISS'} ({beats}/{len(RATES)})")
    return rows


if __name__ == "__main__":
    run()
