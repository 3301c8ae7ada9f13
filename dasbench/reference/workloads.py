"""Workload construction: 40 application mixes x 14 data rates.

A workload is a stream of application *instances* (frames) arriving at a rate
set by the input data rate (Mbps). Frames are pipelined: a new frame enters
the SoC every `FRAME_KBITS / rate` microseconds (plus deterministic jitter).

The flattened representation (`FlatWorkload`) stores every task of every
instance in one set of fixed-size arrays, so a whole (mix x rate) grid stacks
into one scenario-batched tensor program.

A frozen copy of the port's `core/workloads.py` without torch: the
benchmark builds the same arrays for the program and for its reference.
`grid_structure` and `draw_arrivals` add the vectorised form the harness
uses between sweeps (the task graphs depend on the mix only; a sweep
redraws the arrivals).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence

import numpy as np

from dasbench.reference import dfg

# The paper sweeps 14 data rates; these span lightly-loaded to congested.
DATA_RATES_MBPS = np.array(
    [62.5, 125, 187.5, 250, 375, 500, 625, 750, 875, 1000, 1250, 1500, 1750,
     2000],
    dtype=np.float32,
)
N_DATA_RATES = len(DATA_RATES_MBPS)
FRAME_KBITS = np.float32(1.0)  # one frame = 1 kbit of input data


def interarrival_us(rate_mbps: float) -> float:
    """Mean inter-frame arrival gap for a given input data rate."""
    return float(FRAME_KBITS * 1e3 / rate_mbps)  # kbit / (Mbit/s) = ms*? ->
    # 16e3 bits / (rate 1e6 bit/s) = 16e-3/rate s = 16000/rate us.


# ---------------------------------------------------------------------------
# The 40 workload mixes (fractions over the five apps). Follows the paper:
# "ranging from all instances belonging to a single application to a uniform
# distribution from all five applications".
# ---------------------------------------------------------------------------
def workload_mixes() -> np.ndarray:
    """[40, 5] application mix ratios (rows sum to 1)."""
    rng = np.random.RandomState(7)
    mixes: List[np.ndarray] = []
    eye = np.eye(dfg.N_APPS, dtype=np.float64)
    for i in range(dfg.N_APPS):            # 5 single-app workloads
        mixes.append(eye[i])
    mixes.append(np.full(dfg.N_APPS, 1.0 / dfg.N_APPS))  # uniform
    for i in range(dfg.N_APPS):            # 5 pairwise 50/50 mixes
        mixes.append((eye[i] + eye[(i + 1) % dfg.N_APPS]) / 2.0)
    for i in range(dfg.N_APPS):            # 5 dominated mixes (60/10/10/10/10)
        m = np.full(dfg.N_APPS, 0.1)
        m[i] = 0.6
        mixes.append(m)
    while len(mixes) < 40:                 # random Dirichlet mixes
        m = rng.dirichlet(np.ones(dfg.N_APPS))
        mixes.append(m)
    return np.stack(mixes[:40]).astype(np.float32)


class FlatWorkload(NamedTuple):
    """Fixed-size flattened task arrays for one workload (numpy, host side).

    All arrays are padded to t_max tasks / i_max instances; `task_valid`
    and `inst_valid` mask the padding.
    """

    # per-task
    task_type: np.ndarray     # [T] int32
    inst_id: np.ndarray       # [T] int32  (instance index)
    app_id: np.ndarray        # [T] int32
    depth: np.ndarray         # [T] int32
    out_kb: np.ndarray        # [T] float32
    preds: np.ndarray         # [T, MAX_PREDS] int32, -1 pad
    n_preds: np.ndarray       # [T] int32
    succs: np.ndarray         # [T, MAX_SUCCS] int32, -1 pad
    n_succs: np.ndarray       # [T] int32
    task_valid: np.ndarray    # [T] bool
    # per-instance
    inst_arrival: np.ndarray  # [I] float32 (us)
    inst_app: np.ndarray      # [I] int32
    inst_task_start: np.ndarray  # [I] int32 (tasks of an instance contiguous)
    inst_task_count: np.ndarray  # [I] int32
    inst_roots: np.ndarray    # [I, MAX_ROOTS] int32, -1 pad
    inst_n_roots: np.ndarray  # [I] int32
    inst_valid: np.ndarray    # [I] bool
    # scalars
    n_tasks: np.ndarray       # [] int32 (valid count)
    n_insts: np.ndarray       # [] int32
    rate_mbps: np.ndarray     # [] float32


def build_workload(
    mix: Sequence[float],
    rate_mbps: float,
    n_instances: int,
    seed: int,
    t_max: int | None = None,
    i_max: int | None = None,
) -> FlatWorkload:
    """Instantiate a workload: deterministic app interleave + Poisson-ish
    arrivals around the frame-pipelined mean gap."""
    mix = np.asarray(mix, dtype=np.float64)
    mix = mix / mix.sum()
    rng = np.random.RandomState(seed)

    # Deterministic proportional interleave of app instances (largest
    # remainder per step) so every prefix matches the mix.
    counts = np.zeros(dfg.N_APPS)
    inst_apps = np.empty(n_instances, dtype=np.int32)
    for i in range(n_instances):
        deficit = mix * (i + 1) - counts
        a = int(np.argmax(deficit))
        inst_apps[i] = a
        counts[a] += 1

    gap = interarrival_us(rate_mbps)
    # exponential inter-arrivals with the pipelined mean (streaming frames)
    gaps = rng.exponential(gap, size=n_instances).astype(np.float64)
    gaps[0] = 0.0
    arrivals = np.cumsum(gaps).astype(np.float32)

    if i_max is None:
        i_max = n_instances
    if t_max is None:
        t_max = int(sum(dfg.APPS[dfg.APP_NAMES[a]].n_tasks for a in inst_apps))
    assert i_max >= n_instances

    MP, MS, MR = dfg.MAX_PREDS, dfg.MAX_SUCCS, dfg.MAX_ROOTS
    task_type = np.zeros(t_max, np.int32)
    inst_id = np.zeros(t_max, np.int32)
    app_id = np.zeros(t_max, np.int32)
    depth = np.zeros(t_max, np.int32)
    out_kb = np.zeros(t_max, np.float32)
    preds = np.full((t_max, MP), -1, np.int32)
    n_preds = np.zeros(t_max, np.int32)
    succs = np.full((t_max, MS), -1, np.int32)
    n_succs = np.zeros(t_max, np.int32)
    task_valid = np.zeros(t_max, np.bool_)

    inst_arrival = np.full(i_max, np.inf, np.float32)
    inst_app = np.zeros(i_max, np.int32)
    inst_task_start = np.zeros(i_max, np.int32)
    inst_task_count = np.zeros(i_max, np.int32)
    inst_roots = np.full((i_max, MR), -1, np.int32)
    inst_n_roots = np.zeros(i_max, np.int32)
    inst_valid = np.zeros(i_max, np.bool_)

    cursor = 0
    for i in range(n_instances):
        a = int(inst_apps[i])
        g = dfg.APPS[dfg.APP_NAMES[a]]
        n = g.n_tasks
        assert cursor + n <= t_max, "t_max too small for workload"
        sl = slice(cursor, cursor + n)
        task_type[sl] = g.task_types
        inst_id[sl] = i
        app_id[sl] = a
        depth[sl] = g.depths()
        out_kb[sl] = g.out_kb
        gsuccs = g.succs()
        roots = []
        for j in range(n):
            p = g.preds[j]
            n_preds[cursor + j] = len(p)
            for k, q in enumerate(p):
                preds[cursor + j, k] = cursor + q
            s = gsuccs[j]
            n_succs[cursor + j] = len(s)
            for k, q in enumerate(s):
                succs[cursor + j, k] = cursor + q
            if not p:
                roots.append(cursor + j)
        task_valid[sl] = True
        inst_arrival[i] = arrivals[i]
        inst_app[i] = a
        inst_task_start[i] = cursor
        inst_task_count[i] = n
        inst_n_roots[i] = len(roots)
        for k, r in enumerate(roots):
            inst_roots[i, k] = r
        inst_valid[i] = True
        cursor += n

    return validate_workload(FlatWorkload(
        task_type=task_type, inst_id=inst_id, app_id=app_id, depth=depth,
        out_kb=out_kb, preds=preds, n_preds=n_preds, succs=succs,
        n_succs=n_succs, task_valid=task_valid, inst_arrival=inst_arrival,
        inst_app=inst_app, inst_task_start=inst_task_start,
        inst_task_count=inst_task_count, inst_roots=inst_roots,
        inst_n_roots=inst_n_roots, inst_valid=inst_valid,
        n_tasks=np.int32(cursor), n_insts=np.int32(n_instances),
        rate_mbps=np.float32(rate_mbps),
    ))


def validate_workload(wl: FlatWorkload) -> FlatWorkload:
    """Build-time sanity checks; a malformed workload inside the
    tensor simulator produces NaN results or a silent stall, not an error, so
    fail loudly here instead."""
    n_types = len(dfg.TASK_TYPE_NAMES)
    T = int(wl.n_tasks)
    I = int(wl.n_insts)
    Tp = wl.task_type.shape[0]
    if T < 0 or T > Tp or not wl.task_valid[:T].all() \
            or wl.task_valid[T:].any():
        raise ValueError(
            f"FlatWorkload: task_valid must be a prefix of length "
            f"n_tasks={T} (padded to {Tp})")
    if I < 0 or I > wl.inst_valid.shape[0] or not wl.inst_valid[:I].all() \
            or wl.inst_valid[I:].any():
        raise ValueError(
            f"FlatWorkload: inst_valid must be a prefix of length "
            f"n_insts={I}")
    tt = wl.task_type[:T]
    if ((tt < 0) | (tt >= n_types)).any():
        bad = np.where((tt < 0) | (tt >= n_types))[0][:5]
        raise ValueError(
            f"FlatWorkload: task_type out of range [0, {n_types}) "
            f"at tasks {bad.tolist()}")
    kb = wl.out_kb[:T]
    if np.isnan(kb).any() or (kb < 0).any() or np.isinf(kb).any():
        raise ValueError("FlatWorkload: out_kb must be finite and >= 0")
    arr = wl.inst_arrival[:I]
    if np.isnan(arr).any() or (arr < 0).any() or np.isinf(arr).any():
        raise ValueError(
            "FlatWorkload: inst_arrival must be finite and >= 0")
    if ((wl.inst_id[:T] < 0) | (wl.inst_id[:T] >= max(I, 1))).any():
        raise ValueError("FlatWorkload: inst_id out of range")
    for name, idx, cnt in (("preds", wl.preds, wl.n_preds),
                           ("succs", wl.succs, wl.n_succs)):
        k = np.arange(idx.shape[1])[None, :]
        valid = k < cnt[:T, None]
        v = idx[:T]
        if ((cnt[:T] < 0) | (cnt[:T] > idx.shape[1])).any():
            raise ValueError(f"FlatWorkload: n_{name} out of range")
        if (valid & ((v < 0) | (v >= T))).any():
            raise ValueError(f"FlatWorkload: {name} index out of range")
    # acyclicity: the flattened ids are a topological order by
    # construction, so every predecessor must precede its consumer — a
    # cycle cannot satisfy that for all of its edges
    k = np.arange(wl.preds.shape[1])[None, :]
    pvalid = k < wl.n_preds[:T, None]
    tasks = np.arange(T)[:, None]
    if (pvalid & (wl.preds[:T] >= tasks)).any():
        bad = np.where((pvalid & (wl.preds[:T] >= tasks)).any(axis=1))[0][:5]
        raise ValueError(
            f"FlatWorkload: dependency cycle or forward pred edge at tasks "
            f"{bad.tolist()} (predecessor id >= task id)")
    if not (np.isfinite(wl.rate_mbps) and wl.rate_mbps > 0):
        raise ValueError("FlatWorkload: rate_mbps must be finite and > 0")
    return wl


def stack_workloads(wls: Sequence[FlatWorkload]) -> FlatWorkload:
    """Stack same-shape workloads into a leading scenario axis.

    Every field of the result carries a leading `[S]` axis (scalars such as
    `n_tasks` become `[S]` vectors). Workloads built from one
    `WorkloadSuite` share padded shapes by construction, so a (mix x rate)
    sweep stacks directly; the result feeds `simulator.simulate_batch` /
    `run_batch`, which runs the scenario axis as one batch.
    """
    if not wls:
        raise ValueError("stack_workloads: need at least one workload")
    for wl in wls[1:]:
        for a, b, name in zip(wl, wls[0], FlatWorkload._fields):
            if np.shape(a) != np.shape(b):
                raise ValueError(
                    f"stack_workloads: field {name!r} shape mismatch "
                    f"{np.shape(a)} vs {np.shape(b)}; build all scenarios "
                    "from one suite (shared t_max/i_max)")
    return FlatWorkload(*[
        np.stack([np.asarray(f) for f in fields])
        for fields in zip(*wls)
    ])


@dataclasses.dataclass(frozen=True)
class WorkloadSuite:
    """The benchmark suite: mixes x rates, shared padded shapes."""

    mixes: np.ndarray
    rates: np.ndarray
    n_instances: int
    t_max: int
    i_max: int

    def build(self, mix_idx: int, rate_idx: int, seed: int = 0) -> FlatWorkload:
        return build_workload(
            self.mixes[mix_idx], float(self.rates[rate_idx]),
            self.n_instances, seed=seed + 1000 * mix_idx + rate_idx,
            t_max=self.t_max, i_max=self.i_max,
        )

    def build_many(self, cells: Sequence[tuple], seed: int = 0) -> FlatWorkload:
        """Build and stack the scenarios `[(mix_idx, rate_idx), ...]`."""
        return stack_workloads(
            [self.build(mi, ri, seed=seed) for mi, ri in cells]
        )


def default_suite(n_instances: int = 40) -> WorkloadSuite:
    mixes = workload_mixes()
    t_max = n_instances * dfg.MAX_APP_TASKS  # upper bound, shared shape
    return WorkloadSuite(
        mixes=mixes, rates=DATA_RATES_MBPS, n_instances=n_instances,
        t_max=t_max, i_max=n_instances,
    )


# ---------------------------------------------------------------------------
# the vectorised grid: structure once, arrivals a sweep
# ---------------------------------------------------------------------------
def grid_structure(mixes: np.ndarray, cells: Sequence[tuple],
                   n_instances: int, t_max: int,
                   i_max: int) -> FlatWorkload:
    """The stacked workload of `cells` [(mix_idx, rate_mbps), ...] with
    the arrivals still to draw (`with_arrivals`). A mix's task graphs do
    not depend on the rate or the seed, so each mix is built once."""
    by_mix = {}
    rows = []
    for m, rate in cells:
        if m not in by_mix:
            by_mix[m] = build_workload(mixes[m], 1.0, n_instances, seed=0,
                                       t_max=t_max, i_max=i_max)
        rows.append(by_mix[m]._replace(rate_mbps=np.float32(rate)))
    return stack_workloads(rows)


def arrivals(std_exp: np.ndarray, rates: np.ndarray) -> np.ndarray:
    """[S, n] float32 frame arrivals from [S, n] standard exponential
    draws: gaps of the pipelined mean `interarrival_us(rate)`, the first
    at 0, summed in float64 as `build_workload` sums them."""
    gap = np.array([interarrival_us(float(r)) for r in rates])
    gaps = std_exp * gap[:, None]
    gaps[:, 0] = 0.0
    return np.cumsum(gaps, axis=1).astype(np.float32)


def with_arrivals(grid: FlatWorkload, arr: np.ndarray) -> FlatWorkload:
    """`grid` with its instances arriving at `arr` [S, n_instances]."""
    inst = np.full(grid.inst_arrival.shape, np.inf, np.float32)
    inst[:, :arr.shape[1]] = arr
    return grid._replace(inst_arrival=inst)
