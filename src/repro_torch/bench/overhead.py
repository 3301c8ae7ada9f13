"""Scheduling-overhead anchors (paper I / IV-C): per-decision latency and
energy of LUT, ETF and DAS under heavy load, and the wall time of the ETF
finish-time search.

The port of `benchmarks/overhead.py`. The anchors come from the SoC
model (`soc`; the ETF latency at 8 ready tasks from `ETF_LAT_TABLE`) and
from one DAS run of the uniform mix at its second-highest rate. The
search is timed at the reference's batch of 64 decisions over a 64 x 19
matrix, which takes the generic kernel, and at the simulator's own
shape, one oracle sweep's lanes over 16 x 19, which takes the fixed
one: on a CUDA device the hand-written kernels (masked and unmasked)
beside their plain versions on the card, on the CPU the plain versions.

    python -m repro_torch.bench.overhead [--device cpu] [--csv]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench import common
from repro_torch.core import simulator as sim, soc
from repro_torch.kernels.etf_ft import ops, ref

REPS = 20
B_REF, R_REF = 64, 64     # the reference's timing shape (x 19 PEs)


def _inputs(B: int, R: int, P: int, device, seed: int = 0):
    """Search inputs from a seed: avail, free, exec, now, slot_ok,
    pe_alive (all slots and PEs live, as the reference times them)."""
    rng = np.random.RandomState(seed)
    avail = rng.uniform(size=(B, R, P)).astype(np.float32) * 10
    free = rng.uniform(size=(B, P)).astype(np.float32) * 10
    ex = rng.uniform(size=(B, R, P)).astype(np.float32) * 5
    return tuple(torch.as_tensor(x, device=device) for x in (
        avail, free, ex, np.zeros(B, np.float32), np.ones((B, R), bool),
        np.ones((B, P), bool)))


def _time_us(fn, device, reps: int = REPS) -> float:
    """Mean time per call in microseconds after one warm call (which
    builds and loads a kernel on first use); on a CUDA device between two
    events around `reps` calls."""
    fn()
    if device.type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def search_times(device, path_batch: int) -> dict:
    """The searches' time per call at both shapes, keyed
    `etf_ft[_masked]_{plain,cuda}_us_per_{batch64,path_batch}`."""
    out = {"path_batch": path_batch}
    for tag, (B, R) in (("batch64", (B_REF, R_REF)),
                        ("path_batch", (path_batch, sim.R_MAX))):
        x = _inputs(B, R, soc.N_PES, device)
        routes = [("plain", lambda: ref.etf_ft_reference(*x[:4]),
                   lambda: ref.etf_ft_masked_reference(*x))]
        if device.type == "cuda":
            routes.append(("cuda", lambda: ops.etf_ft(*x[:4]),
                           lambda: ops.etf_decide(*x)))
        for route, unmasked, masked in routes:
            out[f"etf_ft_{route}_us_per_{tag}"] = _time_us(unmasked, device)
            out[f"etf_ft_masked_{route}_us_per_{tag}"] = _time_us(masked,
                                                                  device)
    return out


def run(bench: common.Bench, csv: bool = False):
    pol = bench.das_policy()
    res = bench.eval_cell(5, 12, sim.MODE_DAS, tree=pol.tree)
    n = max(int(res.n_decisions), 1)
    rows = {
        "LUT_ns": float(soc.LUT_LATENCY_US) * 1e3,
        "LUT_nJ": float(soc.LUT_ENERGY_UJ) * 1e3,
        "ETF_ns_q8": float(soc.ETF_LAT_TABLE[8]) * 1e3,
        "DAS_heavy_ns": float(res.sched_time_us) / n * 1e3,
        "DAS_heavy_nJ": float(res.sched_energy_uj) / n * 1e3,
    }
    rows.update(search_times(
        bench.device, len(bench.train_mixes) * len(bench.train_rates)))
    for k, v in rows.items():
        if csv:
            print(f"overhead,{v:.1f},{k}")
        else:
            print(f"  {k:38s} {v:10.1f}")
    print("  paper anchors: LUT 6 ns / 2.3 nJ; DAS heavy ~65 ns / 27.2 nJ")
    return rows


def main(argv=None) -> None:
    args = common.cli(__doc__.splitlines()[0], argv)
    run(common.bench_from_env(args.device), csv=args.csv)


if __name__ == "__main__":
    main()
