"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA decision kernels from `src/repro_torch/kernels/etf_ft/
csrc/etf_ft.cu` into `build/repro_torch/`, holds each kernel to its plain
PyTorch version on the card, drives the port's main path (the summary40
pipeline at the benchmark's full size: 40 mixes x 14 rates, 60 frames per
workload, 19 PEs) through the kernels, checks its outcome against
`benchmarks/BENCH_sweep.json`, and checks the card's schedules against the
CPU's. Each phase prints one line with its result and seconds; any failure
raises and the exit code is not 0. The last line of standard output is
`{"ok": true, "device": {...}}`; the line before it lists each kernel with
its launches on the main path, its error against the plain version, its
time per call, the plain version's time and its bound.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks from NVIDIA's data sheet (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
MAIN_S = 560            # scenarios in one oracle sweep (40 mixes x 14 rates)
TOL_DERIVED = 1e-3      # the four ratios against BENCH_sweep.json
TOL_AGG = 1e-6          # card vs CPU float aggregates (reduction order)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------
def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[1 device] {torch.cuda.get_device_name(0)} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"count {torch.cuda.device_count()} | name, power limit:")
    log(smi)
    return smi


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def phase_build() -> float:
    from repro_torch.kernels.etf_ft import kernel
    t0 = time.perf_counter()
    path, secs = kernel.build()
    kernel._lib()
    log(f"[2 build] {path.relative_to(ROOT)} nvcc {secs:.2f}s "
        f"(phase {time.perf_counter() - t0:.2f}s)")
    return secs


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions on the card
# ---------------------------------------------------------------------------
def _bits_equal(a, b) -> bool:
    """Bit equality; NaN cells must be NaN on both sides."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb):
            return False
        a = torch.where(na, 0.0, a)
        b = torch.where(nb, 0.0, b)
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _max_abs_err(a, b) -> float:
    import torch
    if a.is_floating_point():
        ok = torch.isfinite(a) & torch.isfinite(b)
        return float((a[ok].double() - b[ok].double()).abs().max()) \
            if bool(ok.any()) else 0.0
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def search_case(S, R=16, P=19, seed=0, ties=False, special=False):
    """Random masked-search inputs on the card, built from numpy."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    avail = (rng.uniform(size=(S, R, P)) * 10).astype(np.float32)
    free = (rng.uniform(size=(S, P)) * 10).astype(np.float32)
    ex = np.where(rng.uniform(size=(S, R, P)) < 0.3, np.inf,
                  rng.uniform(size=(S, R, P)) * 5).astype(np.float32)
    if ties:
        avail = np.round(avail / 5) * 5
        free = np.round(free / 5) * 5
        ex = np.round(ex)
    now = (rng.uniform(size=S) * 3).astype(np.float32)
    slot_ok = rng.uniform(size=(S, R)) < 0.7
    alive = rng.uniform(size=(S, P)) < 0.8
    if special:
        slot_ok[0] = False                       # an all-masked lane
        avail.reshape(-1)[rng.randint(avail.size, size=8)] = np.inf
        avail.reshape(-1)[rng.randint(avail.size, size=8)] = -np.inf
        ex.reshape(-1)[rng.randint(ex.size, size=8)] = -np.inf
        avail.reshape(-1)[rng.randint(avail.size, size=4)] = np.nan
        free.reshape(-1)[rng.randint(free.size, size=2)] = np.nan
    dev = "cuda"
    return tuple(torch.as_tensor(x, device=dev) for x in
                 (avail, free, ex, now, slot_ok, alive))


def push_case(S, K=4, MP=4, P=19, seed=0, all_patterns=False, nan=False):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    pfin = (rng.uniform(size=(S, K, MP)) * 100).astype(np.float32)
    cost = (rng.uniform(size=(S, K, MP)) * 10).astype(np.float32)
    pcl = rng.randint(0, 6, size=(S, K, MP)).astype(np.int32)
    pv = rng.uniform(size=(S, K, MP)) < 0.6
    if all_patterns:      # every validity pattern of the MP predecessors
        pats = (np.arange(2 ** MP)[:, None] >> np.arange(MP)) & 1
        pv = pats[np.arange(S * K) % 2 ** MP].reshape(S, K, MP) > 0
    if nan:
        pfin.reshape(-1)[rng.randint(pfin.size, size=4)] = np.nan
        cost.reshape(-1)[rng.randint(cost.size, size=4)] = np.inf
    pecl = rng.randint(0, 6, size=P).astype(np.int32)
    bases = (rng.uniform(size=(S, K)) * 50).astype(np.float32)
    return tuple(torch.as_tensor(x, device="cuda") for x in
                 (pfin, cost, pcl, pv, pecl, bases))


def _device_ms(fn, iters=200) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph,
    replayed between two events (launch overhead amortised)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(5):
        t0.record()
        g.replay()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / iters)
    return best


def _call_ms(fn, iters=200) -> float:
    """Wall time per call as a caller sees it (launch overhead included)."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_kernels() -> dict:
    import torch
    from repro_torch.kernels.etf_ft import kernel, ref
    t0 = time.perf_counter()
    err = {"etf_ft_search_masked": 0.0, "etf_ft_search": 0.0,
           "push_rows": 0.0}
    n_cases = 0
    for S in (1, 7, MAIN_S, 4096):
        for seed, (ties, special) in enumerate(
                [(False, False), (True, False), (False, True),
                 (True, True)]):
            case = search_case(S, seed=1000 * S + seed, ties=ties,
                               special=special)
            for name, alive in (("etf_ft_search_masked", case[5]),
                                ("etf_ft_search_masked", None)):
                c = case[:5] + (alive,)
                got = kernel.etf_ft_search_masked(*c)
                want = ref.etf_ft_masked_reference(*c)
                for a, b in zip(got, want):
                    if not _bits_equal(a, b):
                        raise AssertionError(
                            f"{name} S={S} ties={ties} special={special} "
                            f"alive={alive is not None}: kernel != plain")
                    err[name] = max(err[name], _max_abs_err(a, b))
            got = kernel.etf_ft_search(*case[:4])
            want = ref.etf_ft_reference(*case[:4])
            for a, b in zip(got, want):
                if not _bits_equal(a, b):
                    raise AssertionError(f"etf_ft_search S={S} ties={ties} "
                                         f"special={special}: kernel != plain")
                err["etf_ft_search"] = max(err["etf_ft_search"],
                                           _max_abs_err(a, b))
            n_cases += 3
        for seed, (pats, nan) in enumerate([(False, False), (True, False),
                                            (True, True)]):
            case = push_case(S, seed=2000 * S + seed, all_patterns=pats,
                             nan=nan)
            got = kernel.push_rows(*case)
            want = ref.push_rows_reference(*case, 6)
            if not _bits_equal(got, want):
                raise AssertionError(f"push_rows S={S} patterns={pats} "
                                     f"nan={nan}: kernel != plain")
            err["push_rows"] = max(err["push_rows"], _max_abs_err(got, want))
            n_cases += 1
    # an all-masked lane: slot 0, pe 0, infeasible
    case = search_case(4, seed=7)
    case = case[:4] + (torch.zeros_like(case[4]), case[5])
    _, sl, pe, ok = kernel.etf_ft_search_masked(*case)
    if bool(sl.any()) or bool(pe.any()) or bool(ok.any()):
        raise AssertionError("all-masked lanes must give (0, 0, False)")
    torch.cuda.synchronize()

    # time per call at the main path's shapes (one oracle sweep's lanes)
    sc = search_case(MAIN_S, seed=3)
    pc = push_case(MAIN_S, seed=4)
    S, R, P = sc[0].shape
    cells = S * R * P
    timing = {}
    for name, fk, fp, nb, ops in (
            ("etf_ft_search_masked",
             lambda: kernel.etf_ft_search_masked(*sc[:5], None),
             lambda: ref.etf_ft_masked_reference(*sc[:5], None),
             _nbytes(*sc[:5]) + S * (4 + 4 + 4 + 1), 6 * cells),
            ("etf_ft_search",
             lambda: kernel.etf_ft_search(*sc[:4]),
             lambda: ref.etf_ft_reference(*sc[:4]),
             _nbytes(*sc[:4]) + S * (4 + 4 + 4), 5 * cells),
            ("push_rows",
             lambda: kernel.push_rows(*pc),
             lambda: ref.push_rows_reference(*pc, 6),
             _nbytes(*pc) + pc[0].shape[0] * pc[0].shape[1] * P * 4,
             pc[0].numel() * P * 3 + pc[0].shape[0] * pc[0].shape[1] * P)):
        bound, by = _bound_ms(nb, ops)
        timing[name] = {
            "ms": _device_ms(fk), "plain_ms": _device_ms(fp),
            "call_ms": _call_ms(fk), "plain_call_ms": _call_ms(fp),
            "bound_ms": bound, "bound_by": by, "library_ms": None}
    for name, t in timing.items():
        log(f"[3 kernels] {name}: bit-equal to plain, device "
            f"{t['ms'] * 1e3:.2f} us/call (plain {t['plain_ms'] * 1e3:.2f} "
            f"us), per call incl. launch {t['call_ms'] * 1e3:.2f} us (plain "
            f"{t['plain_call_ms'] * 1e3:.2f} us), bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']})")
    log(f"[3 kernels] {n_cases} cases bit-equal at S in (1, 7, {MAIN_S}, "
        f"4096) ({time.perf_counter() - t0:.1f}s)")
    return {"err": err, "timing": timing}


# ---------------------------------------------------------------------------
# phase 4: the main path at full size
# ---------------------------------------------------------------------------
def phase_main() -> dict:
    import torch
    from repro_torch.bench import summary40
    from repro_torch.kernels.etf_ft import ops
    ref = json.loads((ROOT / "benchmarks" / "BENCH_sweep.json")
                     .read_text())["derived"]
    t0 = time.perf_counter()
    ops.reset_launches()
    out = summary40.run(device="cuda")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    wall = time.perf_counter() - t0
    for name in ("etf_ft_search_masked", "push_rows"):
        if launches[name] <= 0:
            raise AssertionError(f"main path never launched {name}")
    for sw in out["sweeps"]:
        if sw["stalled"] or sw["unfinished"] or sw["ready_drop"]:
            raise AssertionError(f"unhealthy sweep: {sw}")
        log(f"[4 main] sweep {sw['label']}: {sw['scenarios']} scenarios, "
            f"{sw['wall_s']:.2f}s, {sw['steps']} super-steps, "
            f"{sw['events']} events, "
            f"{sw['wall_s'] * 1e3 / max(sw['steps'], 1):.3f} ms/step")
    for k in summary40.DERIVED:
        log(f"[4 main] {k}: port {out[k]!r} reference {ref[k]!r} "
            f"diff {out[k] - ref[k]:+.3e}")
    if out["das_matches_best_frac"] != ref["das_matches_best_frac"]:
        raise AssertionError("das_matches_best_frac differs")
    for k in summary40.DERIVED[:4]:
        if abs(out[k] - ref[k]) > TOL_DERIVED:
            raise AssertionError(f"{k}: {out[k]} vs {ref[k]}")
    steps = sum(sw["steps"] for sw in out["sweeps"])
    sweep_s = sum(sw["wall_s"] for sw in out["sweeps"])
    log(f"[4 main] oracle samples {out['n_samples']} (reference 420168); "
        f"{out['n_cells']} cells; launches {launches}; "
        f"{steps} super-steps in {sweep_s:.2f}s of sweeps = "
        f"{sweep_s * 1e3 / steps:.3f} ms/step; pipeline {wall:.1f}s")
    return {"launches": launches, "out": out}


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU, per scenario
# ---------------------------------------------------------------------------
EXACT_FIELDS = ("n_done", "pe_of", "finish", "log_feat", "log_policy",
                "log_agree", "log_task", "n_fast", "n_slow", "n_iters",
                "n_decisions", "stall_reason", "ready_drop", "makespan_us",
                "inst_exec_us")
AGG_FIELDS = ("avg_exec_us", "task_energy_uj", "sched_energy_uj",
              "total_energy_uj", "edp", "sched_time_us")


def phase_cross(trees: dict) -> None:
    import numpy as np
    from repro_torch.core import convert, simulator as sim, workloads
    t0 = time.perf_counter()
    suite = workloads.default_suite(n_instances=60)
    cells = [(m, r) for m in (0, 5, 17, 39) for r in (0, 13)]
    stacked = suite.build_many(cells)
    worst = 0.0
    for mode in (sim.MODE_LUT, sim.MODE_ETF, sim.MODE_DAS):
        res = {}
        for dev in ("cuda", "cpu"):
            tree = (convert.dtree_from_numpy(**trees["DAS"], device=dev)
                    if mode == sim.MODE_DAS else None)
            res[dev] = sim.to_numpy(sim.run_batch(mode, stacked, tree=tree,
                                                  device=dev))
        for f in EXACT_FIELDS:
            a, b = getattr(res["cuda"], f), getattr(res["cpu"], f)
            if a.dtype != b.dtype or not np.array_equal(a, b,
                                                        equal_nan=True):
                raise AssertionError(f"{sim.MODE_NAMES[mode]} {f}: card != "
                                     "CPU")
        for f in AGG_FIELDS:
            a = getattr(res["cuda"], f).astype(np.float64)
            b = getattr(res["cpu"], f).astype(np.float64)
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
            worst = max(worst, float(rel.max()))
            if (rel > TOL_AGG).any():
                raise AssertionError(f"{sim.MODE_NAMES[mode]} {f}: rel "
                                     f"{rel.max():.2e} > {TOL_AGG}")
    log(f"[5 cross] {len(cells)} cells x LUT/ETF/DAS at 60 instances: "
        f"schedules bit-equal card vs CPU, float aggregates within "
        f"{worst:.2e} relative ({time.perf_counter() - t0:.1f}s)")


KERNELS = (
    ("etf_ft_search_masked", "src/repro/kernels/etf_ft/kernel.py:122"),
    ("etf_ft_search", "src/repro/kernels/etf_ft/kernel.py:72"),
    ("push_rows", "src/repro/kernels/etf_ft/kernel.py:181"),
)


def main() -> int:
    import torch
    phase_device()
    phase_build()
    kern = phase_kernels()
    main_path = phase_main()
    phase_cross(main_path["out"]["trees"])
    rows = []
    for name, replaces in KERNELS:
        t = kern["timing"][name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/etf_ft/csrc/etf_ft.cu",
            "replaces": replaces,
            "launches": main_path["launches"][name],
            "max_abs_err": kern["err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
