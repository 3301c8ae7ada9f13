"""Fault-injection plans for the DSSoC simulator (DS3/CEDR-style dynamics).

The port of `repro/core/faults.py`. A `FaultPlan` describes everything
that can go wrong during one scenario:

  * **permanent PE failures**: PE `p` is unavailable during
    `[pe_fail_at[p], pe_repair_at[p])`. Schedulers never place work on a
    dead PE; at the failure instant every in-flight assignment on the PE
    is revoked (killed) and re-enqueued.
  * **transient faults**: at each finite `transient_at[p, k]` the PE
    glitches: assignments made before that instant are killed and
    re-enqueued, but the PE stays available.
  * **cluster slowdown**: `cluster_slowdown[c]` (>= 1) multiplies the
    execution time of every task run on cluster `c`.
  * **retry budget**: a task killed by a fault is re-enqueued at the FIFO
    tail at most `max_retries` times; the next kill drops its whole job.
  * **per-job deadline**: an application instance still incomplete
    `deadline_us` after its arrival is dropped.

The builders are numpy in and numpy out, with the reference's seeds and
dtypes, so a plan built here is field-equal to the reference's. The
simulator takes a plan as tensors with a leading scenario axis `[S]`
(`to_device`); `alive_at`, `pe_slowdown` and `kill_times` work on that
form. `healthy_plan()` is the identity: running it is bit-identical to
running without a plan.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import soc

# transient-fault slots per PE (finite entries are events, inf = unused)
MAX_TRANSIENTS = 4

_INF = np.float32(np.inf)


class FaultPlan(NamedTuple):
    """Per-scenario fault schedule (arrays; batch with a leading axis).

    All times are simulated microseconds. `inf` means "never".
    """

    pe_fail_at: np.ndarray       # [P] f32 permanent-failure time
    pe_repair_at: np.ndarray     # [P] f32 repair time (inf = never)
    transient_at: np.ndarray     # [P, MAX_TRANSIENTS] f32 glitch times
    cluster_slowdown: np.ndarray  # [C] f32 exec-time multiplier (>= 1)
    max_retries: np.ndarray      # [] i32 per-task kill -> re-enqueue budget
    deadline_us: np.ndarray      # [] f32 per-job deadline after arrival


def healthy_plan(n_pes: int = soc.N_PES,
                 n_clusters: int = soc.N_CLUSTERS) -> FaultPlan:
    """The no-fault identity plan (everything healthy forever)."""
    return FaultPlan(
        pe_fail_at=np.full(n_pes, _INF, np.float32),
        pe_repair_at=np.full(n_pes, _INF, np.float32),
        transient_at=np.full((n_pes, MAX_TRANSIENTS), _INF, np.float32),
        cluster_slowdown=np.ones(n_clusters, np.float32),
        max_retries=np.int32(0),
        deadline_us=np.float32(_INF),
    )


# ---------------------------------------------------------------------------
# plan builders (numpy in / numpy out)
# ---------------------------------------------------------------------------
def _np_plan(plan: FaultPlan) -> FaultPlan:
    return FaultPlan(*[np.array(x) for x in plan])


def fail_pes(plan: FaultPlan, pes: Sequence[int], at: float,
             repair_at: float = float("inf")) -> FaultPlan:
    """Permanently fail `pes` at time `at` (optionally repaired later)."""
    p = _np_plan(plan)
    p.pe_fail_at[list(pes)] = np.float32(at)
    p.pe_repair_at[list(pes)] = np.float32(repair_at)
    return p


def fail_cluster(plan: FaultPlan, cluster: int, at: float,
                 repair_at: float = float("inf")) -> FaultPlan:
    """Fail every PE of `cluster` (see `soc.CLUSTER_NAMES`)."""
    pes = np.where(soc.PE_CLUSTER == cluster)[0]
    return fail_pes(plan, pes, at, repair_at=repair_at)


def add_transient(plan: FaultPlan, pe: int, at: float) -> FaultPlan:
    """Add one transient glitch on `pe` at time `at`."""
    p = _np_plan(plan)
    row = p.transient_at[pe]
    free = np.where(~np.isfinite(row))[0]
    if free.size == 0:
        raise ValueError(
            f"PE {pe} already has {MAX_TRANSIENTS} transient faults")
    row[free[0]] = np.float32(at)
    return p


def slow_cluster(plan: FaultPlan, cluster: int, factor: float) -> FaultPlan:
    """Throttle `cluster` by `factor` (>= 1)."""
    p = _np_plan(plan)
    p.cluster_slowdown[cluster] = np.float32(factor)
    return p


def with_retries(plan: FaultPlan, max_retries: int) -> FaultPlan:
    p = _np_plan(plan)
    return p._replace(max_retries=np.int32(max_retries))


def with_deadline(plan: FaultPlan, deadline_us: float) -> FaultPlan:
    p = _np_plan(plan)
    return p._replace(deadline_us=np.float32(deadline_us))


def random_plan(seed: int, n_fail: int = 2, n_transient: int = 4,
                t_horizon_us: float = 200.0,
                max_retries: int = 2,
                deadline_us: float = float("inf"),
                n_pes: int = soc.N_PES) -> FaultPlan:
    """A seeded adversarial plan: `n_fail` permanent failures (half of them
    repaired) plus `n_transient` transient glitches inside the horizon."""
    rng = np.random.RandomState(seed)
    plan = with_deadline(with_retries(healthy_plan(), max_retries),
                         deadline_us)
    fail = rng.choice(n_pes, size=min(n_fail, n_pes), replace=False)
    for j, pe in enumerate(fail):
        at = float(rng.uniform(0.0, t_horizon_us))
        rep = at + float(rng.uniform(0.2, 1.0) * t_horizon_us) \
            if j % 2 == 0 else float("inf")
        plan = fail_pes(plan, [int(pe)], at, repair_at=rep)
    for _ in range(n_transient):
        plan = add_transient(plan, int(rng.randint(n_pes)),
                             float(rng.uniform(0.0, t_horizon_us)))
    return plan


def stack_plans(plans: Sequence[FaultPlan]) -> FaultPlan:
    """Stack same-shape plans into a leading scenario axis."""
    if not plans:
        raise ValueError("stack_plans: need at least one plan")
    return FaultPlan(*[
        np.stack([np.asarray(f) for f in fields]) for fields in zip(*plans)
    ])


def is_batched(plan: FaultPlan) -> bool:
    """True when the plan carries a leading scenario axis."""
    return np.ndim(plan.pe_fail_at) == 2


# which fault phases a plan can ever fire, `(can_die, can_kill,
# has_deadline)`; the simulator builds only those phases
NO_CAPS = (False, False, False)
FULL_CAPS = (True, True, True)


def plan_capabilities(plan: FaultPlan) -> tuple:
    """`(can_die, can_kill, has_deadline)`, decided from the concrete
    arrays (over every scenario of a batched plan):

    * `can_die`: some PE has a finite failure time, so the availability
      mask and the feasibility checks matter;
    * `can_kill`: some kill instant (failure or glitch) is finite and
      strictly positive. A kill at `tau` revokes only assignments made
      before it, at `now >= 0`, so `tau <= 0` revokes nothing;
    * `has_deadline`: `deadline_us` is finite somewhere.

    A phase the flags rule out could never fire, so leaving it out is
    exact.
    """
    fail = np.asarray(plan.pe_fail_at)
    trans = np.asarray(plan.transient_at)
    dl = np.asarray(plan.deadline_us)
    can_die = bool(np.isfinite(fail).any())
    can_kill = bool((np.isfinite(fail) & (fail > 0)).any()
                    or (np.isfinite(trans) & (trans > 0)).any())
    has_deadline = bool(np.isfinite(dl).any())
    return can_die, can_kill, has_deadline


def validate_plan(plan: FaultPlan, n_pes: int = soc.N_PES,
                  n_clusters: int = soc.N_CLUSTERS) -> FaultPlan:
    """Sanity checks; raises ValueError on a malformed plan."""
    p = FaultPlan(*[np.asarray(x) for x in plan])
    lead = p.pe_fail_at.shape[:-1]
    if p.pe_fail_at.shape[-1] != n_pes or p.pe_repair_at.shape[-1] != n_pes:
        raise ValueError(
            f"FaultPlan: per-PE arrays must have trailing dim {n_pes}, got "
            f"{p.pe_fail_at.shape} / {p.pe_repair_at.shape}")
    if p.transient_at.shape[-2:] != (n_pes, MAX_TRANSIENTS) \
            or p.transient_at.shape[:-2] != lead:
        raise ValueError(
            f"FaultPlan: transient_at must end in ({n_pes}, "
            f"{MAX_TRANSIENTS}), got {p.transient_at.shape}")
    if p.cluster_slowdown.shape[-1] != n_clusters:
        raise ValueError(
            f"FaultPlan: cluster_slowdown must have trailing dim "
            f"{n_clusters}, got {p.cluster_slowdown.shape}")
    for name in ("pe_fail_at", "pe_repair_at", "transient_at", "deadline_us"):
        v = getattr(p, name)
        if np.isnan(v).any() or (v < 0).any():
            raise ValueError(f"FaultPlan.{name}: times must be >= 0, no NaN")
    if (p.pe_repair_at < p.pe_fail_at).any():
        raise ValueError("FaultPlan: pe_repair_at must be >= pe_fail_at")
    if np.isnan(p.cluster_slowdown).any() or (p.cluster_slowdown < 1.0).any():
        raise ValueError("FaultPlan: cluster_slowdown must be >= 1.0")
    if (p.max_retries < 0).any():
        raise ValueError("FaultPlan: max_retries must be >= 0")
    return plan


# ---------------------------------------------------------------------------
# the simulator's form: tensors with a leading [S] axis
# ---------------------------------------------------------------------------
_DTYPES = (torch.float32, torch.float32, torch.float32, torch.float32,
           torch.int64, torch.float32)


def to_device(plan: FaultPlan, device, n: int | None = None) -> FaultPlan:
    """The plan as tensors on `device`, every field with a leading `[S]`
    axis: a batched plan as it is, a shared one repeated `n` times."""
    batched = is_batched(plan)
    out = []
    for x, dt in zip(plan, _DTYPES):
        t = torch.as_tensor(np.asarray(x), dtype=dt, device=device)
        if not batched:
            t = t.expand(n, *t.shape).contiguous()
        out.append(t)
    return FaultPlan(*out)


def alive_at(plan: FaultPlan, now: torch.Tensor) -> torch.Tensor:
    """[S, P] bool availability at `now` [S] (dead inside
    `[fail_at, repair_at)`)."""
    t = now[:, None]
    return ~((plan.pe_fail_at <= t) & (t < plan.pe_repair_at))


def pe_slowdown(plan: FaultPlan, pe_cluster: torch.Tensor) -> torch.Tensor:
    """[S, P] per-PE exec-time multiplier from the cluster slowdowns."""
    return plan.cluster_slowdown[:, pe_cluster.long()]


def kill_times(plan: FaultPlan) -> torch.Tensor:
    """[S, P, 1 + MAX_TRANSIENTS]: every instant that revokes in-flight
    assignments on a PE (the permanent failure, then the glitches)."""
    return torch.cat([plan.pe_fail_at[..., None], plan.transient_at], -1)
