"""The benchmark's inputs, made from `--seed` and the cell's files.

A configuration file (`configs/<name>.json`) gives the SoC's tables, the
apps, the mixes, the rates, the frames a scenario and, for a faulty
deployment, the fault model. A traffic file (`traffic/<name>.json`)
gives the scheduler modes a sweep cycles through, the shape of a sweep:
`grid` (every mix at every rate) or `row` (one mix at every rate, the
mixes in order), and, for a mode whose decisions a policy makes (DAS),
that policy under `policy` and the mode's name. Sweep `k` of a run
draws its arrivals, and its fault plans, from `(seed, k)`, so no sweep
of a run repeats another's inputs and the same seed gives the same
inputs. Both sides get the same arrays: the program as its own types
(`harness`), the reference as they are here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np

from dasbench.reference import dfg, ref_sim, workloads

# streams of a sweep's generator: arrivals, fault plans, the check's sample
ARRIVALS, PLANS, SAMPLE = 0, 1, 2
WARMUP = 2**32 - 1          # the sweep index of the set-up's warm-up
N_TRANSIENT_SLOTS = 4       # the plan's glitch slots a PE


class FaultPlan(NamedTuple):
    """A stacked fault plan (leading [S] axis), the program's field
    order: times in simulated microseconds, inf for never."""

    pe_fail_at: np.ndarray        # [S, P] f32
    pe_repair_at: np.ndarray      # [S, P] f32
    transient_at: np.ndarray      # [S, P, 4] f32
    cluster_slowdown: np.ndarray  # [S, C] f32
    max_retries: np.ndarray       # [S] i32
    deadline_us: np.ndarray       # [S] f32


class Policy(NamedTuple):
    """A DAS policy as its traffic file states it: a depth-2 tree in the
    port's `DTree` layout (`feat` [3] feature indices, `thr` [3], `leaf`
    [4] in {0 fast, 1 slow}; a `null` threshold in the file is an
    infinite one, a pass-through node), and one line on how the tree was
    obtained."""

    feat: tuple
    thr: tuple
    leaf: tuple
    fitted: str


def policy(mode: str, p: dict) -> Policy:
    """The traffic file's policy for `mode`, checked: every node that is
    not a pass-through reads the paper's pair (rate, the big cluster's
    earliest availability), every threshold is a float32 value written
    exactly, and every leaf picks a scheduler."""
    if set(p) != set(Policy._fields):
        raise ValueError(f"{mode} policy keys {sorted(p)}; expected "
                         f"{sorted(Policy._fields)}")
    feat, thr, leaf = list(p["feat"]), list(p["thr"]), list(p["leaf"])
    if len(feat) != 3 or len(thr) != 3 or len(leaf) != 4:
        raise ValueError(f"{mode} policy: feat [3], thr [3], leaf [4]")
    for f, t in zip(feat, thr):
        if type(f) is not int:
            raise ValueError(f"{mode} policy feature {f!r}")
        if t is None:
            continue
        if f not in (ref_sim.FEAT_RATE, ref_sim.FEAT_BIG_AVAIL):
            raise ValueError(f"{mode} policy reads feature {f}; the "
                             "reference knows the paper's pair, "
                             f"{ref_sim.FEAT_RATE} and "
                             f"{ref_sim.FEAT_BIG_AVAIL}")
        if (not isinstance(t, (int, float)) or not math.isfinite(t)
                or float(np.float32(t)) != t):
            raise ValueError(f"{mode} policy threshold {t!r} is not a "
                             "finite float32 value")
    if any(v not in (0, 1) or type(v) is not int for v in leaf):
        raise ValueError(f"{mode} policy leaves {leaf}")
    fitted = p["fitted"]
    if not isinstance(fitted, str) or not fitted or "\n" in fitted:
        raise ValueError(f"{mode} policy: `fitted` is one line")
    return Policy(tuple(feat),
                  tuple(math.inf if t is None else float(t) for t in thr),
                  tuple(leaf), fitted)


def rng(seed: int, sweep: int, stream: int) -> np.random.Generator:
    """The generator of one stream of one sweep; `seed` may be any whole
    number (taken modulo 2**64)."""
    return np.random.default_rng([seed % 2**64, sweep, stream])


@dataclasses.dataclass
class Sweep:
    """One sweep's inputs."""

    index: int
    mode: str                     # "LUT", "ETF", ...
    wl: workloads.FlatWorkload    # stacked, [S] leading
    plan: FaultPlan | None
    policy: Policy | None         # the mode's policy, DAS only


class Traffic:
    """A configuration under a traffic mix: makes sweep `k` of a seed."""

    def __init__(self, config: dict, traffic: dict):
        if config["soc"]["task_types"] != list(dfg.TASK_TYPE_NAMES):
            raise ValueError("the configuration's task types are not the "
                             "DFGs' vocabulary")
        if config["apps"] != list(dfg.APP_NAMES):
            raise ValueError("the configuration's apps are not the DFGs'")
        if float(config["frame_kbits"]) != float(workloads.FRAME_KBITS):
            raise ValueError("the generator's frames are 1 kbit")
        self.config, self.traffic = config, traffic
        self.modes = list(traffic["modes"])
        for m in self.modes:
            if m not in ref_sim.MODES:
                raise ValueError(f"mode {m!r}; the reference knows "
                                 f"{sorted(ref_sim.MODES)}")
        self.policies = {m: policy(m, p)
                         for m, p in traffic.get("policy", {}).items()}
        if not set(self.policies) <= set(self.modes):
            raise ValueError(f"policies for {sorted(self.policies)}; the "
                             f"traffic runs {self.modes}")
        self.shape = traffic["shape"]
        if self.shape not in ("grid", "row"):
            raise ValueError(f"traffic shape {self.shape!r}")
        self.frames = int(config["frames"])
        self.rates = np.asarray(config["rates_mbps"], np.float64)
        n_mix = int(config["n_mixes"])
        mixes = workloads.workload_mixes()
        if n_mix > mixes.shape[0]:
            raise ValueError(f"{n_mix} mixes; the generator has "
                             f"{mixes.shape[0]}")
        self.mixes = mixes[:n_mix]
        self.t_max = self.frames * dfg.MAX_APP_TASKS
        R = len(self.rates)
        if self.shape == "grid":
            cells = [(m, r) for m in range(n_mix) for r in range(R)]
            self._groups = [self._structure(cells)]
        else:
            self._groups = [self._structure([(m, r) for r in range(R)])
                            for m in range(n_mix)]

    def _structure(self, cells):
        """A sweep's stacked task graphs and the rate index of each lane."""
        grid = workloads.grid_structure(
            self.mixes, [(m, self.rates[r]) for m, r in cells],
            self.frames, self.t_max, self.frames)
        return grid, np.array([r for _, r in cells], np.int64)

    @property
    def cycle(self) -> int:
        """Sweeps a cycle of the traffic's modes takes."""
        return len(self.modes)

    def lanes(self) -> int:
        return int(self._groups[0][1].shape[0])

    def sweep(self, seed: int, k: int) -> Sweep:
        grid, rate = self._groups[k % len(self._groups)]
        S = rate.shape[0]
        draws = rng(seed, k, ARRIVALS).standard_exponential((S, self.frames))
        wl = workloads.with_arrivals(
            grid, workloads.arrivals(draws, self.rates[rate]))
        plan = None
        if self.config.get("faults"):
            plan = fault_plans(self.config, rng(seed, k, PLANS), S)
        mode = self.modes[k % len(self.modes)]
        return Sweep(k, mode, wl, plan, self.policies.get(mode))


def fault_plans(config: dict, g: np.random.Generator, S: int) -> FaultPlan:
    """S plans of the configuration's fault model: permanent failures on
    distinct PEs at U(0, horizon), the first repaired U(a, b) x horizon
    later; glitches on uniform PEs at U(0, horizon); scenario j takes the
    retry budget and deadline of its parity."""
    f = config["faults"]
    P = sum(config["soc"]["pes_per_cluster"])
    C = len(config["soc"]["pes_per_cluster"])
    H = float(f["horizon_us"])
    nf, nt = int(f["permanent_failures"]), int(f["transients"])
    inf = np.float32(np.inf)
    fail = np.full((S, P), inf, np.float32)
    repair = np.full((S, P), inf, np.float32)
    trans = np.full((S, P, N_TRANSIENT_SLOTS), inf, np.float32)
    rows = np.arange(S)
    pes = g.random((S, P)).argsort(axis=1)[:, :nf]
    at = g.uniform(0.0, H, (S, nf))
    lo, hi = f["repair_after"]
    rep = at + g.uniform(lo, hi, (S, nf)) * H
    for j in range(nf):
        fail[rows, pes[:, j]] = at[:, j]
        if j % 2 == 0:
            repair[rows, pes[:, j]] = rep[:, j]
    tpe = g.integers(0, P, (S, nt))
    tat = g.uniform(0.0, H, (S, nt))
    for j in range(nt):
        # the glitch takes its PE's next free slot
        slot = (tpe[:, :j] == tpe[:, j:j + 1]).sum(axis=1)
        trans[rows, tpe[:, j], slot] = tat[:, j]
    even, odd = f["even_scenarios"], f["odd_scenarios"]
    parity = rows % 2

    def pick(key, dtype):
        v = [np.inf if d[key] is None else d[key] for d in (even, odd)]
        return np.where(parity == 0, v[0], v[1]).astype(dtype)

    return FaultPlan(fail, repair, trans, np.ones((S, C), np.float32),
                     pick("max_retries", np.int32),
                     pick("deadline_us", np.float32))


def scenario(sw: Sweep, j: int):
    """Scenario `j` of a sweep, unstacked: (workload, plan or None)."""
    wl = workloads.FlatWorkload(*[np.asarray(x)[j] for x in sw.wl])
    plan = None if sw.plan is None else FaultPlan(*[x[j] for x in sw.plan])
    return wl, plan
