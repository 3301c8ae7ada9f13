"""Scenario-batched discrete-event DSSoC simulator (DS3-style) in PyTorch.

The port of `repro/core/simulator.py`. Each scenario (one workload mix
at one data rate) retires events in the reference's priority order:

  1. a task completion whose finish time is due (finish <= now),
  2. a frame (application-instance) arrival that is due,
  3. one scheduling decision if the ready queue is non-empty,
  4. otherwise advance simulated time to the next event.

Scheduling overhead follows the paper: the scheduler is a serial
resource (`sched_free`); each decision occupies it for the policy's
latency and burns the policy's energy; a scheduled task cannot start
before its decision completes.

Modes
-----
  MODE_LUT        fast scheduler only (paper's F)
  MODE_ETF        slow scheduler only (paper's S, Algorithm 1)
  MODE_ETF_IDEAL  ETF with zero scheduling overhead (paper's ETF-ideal)
  MODE_DAS        depth-2 decision tree preselects F or S per decision
  MODE_ORACLE     run both schedulers per decision, follow F, log agreement
                  (paper's "first execution" for oracle generation)
  MODE_THRESHOLD  static data-rate threshold picks F or S (paper's heuristic)

Engine
------
There is one engine: the reference's masked super-step
(`_masked_step`) with its scenario axis `[S]` written out. Each
super-step runs the phases with gates re-derived after each phase,
so it retires the same event sequence as the reference's
one-event-per-iteration loop, and `n_iters` still counts events. `run`
is the engine with S = 1; `run_batch` cuts a sweep into fixed-shape
chunks and splits each over its devices (the reference's `shard_map`:
no collective, so per-scenario results do not depend on the split).
The step has no host sync: finished lanes are frozen by the `run` gate,
and the loop polls `any(running)` only before each block of
`POLL_EVERY` super-steps (and there ends early when its caller sets
`stop`). On the CPU every block runs eagerly. On a CUDA device each
call runs on a stream of its own; the first block runs eagerly (the
warm-up), and from the second on each block replays one CUDA graph
recorded over the state's buffers, so a block costs one graph launch
of host time. The results are bit-equal to the eager loop's
(`_simulate_eager`), and the decision kernels' `LAUNCHES` count each
replay. Each call's telemetry counts, on the device, the super-steps
each lane was running (occupancy).

Every per-lane buffer that takes gated row writes is stored flat, as
`[S * N + 1, ...]`: lane s owns rows `s*N .. s*N + N - 1`, and the last
row absorbs the writes of inactive lanes (the reference drops them with
an out-of-bounds `mode="drop"` scatter). `_lanes` gives the contiguous
`[S, N, ...]` view. The buffers are updated in place; per-lane scalars
are replaced.

The two decision kernels (`kernels/etf_ft`) run on every decide and
every completion phase: the masked ETF search, and the push-time rows
gathered from the state in one call; on a CUDA device the hand-written
kernels, on the CPU their plain versions. All float operations keep the
reference's order. The one place where XLA on the CPU fuses a
multiply-add that sets the schedule, the ETF latency polynomial, is a
table (`soc.ETF_LAT_TABLE`). The energy accumulators are fused by XLA
too; they do not feed the schedule, and agree with the reference to a
relative 1e-6.

Faults
------
`plan=` (a `faults.FaultPlan`, shared or stacked along `[S]`) threads the
reference's fault model through the same step, with three more event
classes between completions and arrivals: a *kill* (a PE failure or
glitch revokes an assignment made before it; the task re-enters the
FIFO tail within its retry budget, else its job drops), a *deadline*
(a job still incomplete `deadline_us` after its arrival drops) and the
*drop* inside both. The LUT falls back to the most energy-efficient
cluster with a live PE, the ETF search masks dead PEs (`pe_alive`, the
search kernel's mask), and a decision is taken only when the chosen
scheduler has a feasible pair; otherwise time advances, to fault,
repair and deadline instants too. Each chunk builds only the fault
phases its plans can fire (`faults.plan_capabilities`, the union over
the chunk's lanes): a left-out phase could never fire, so the results
are those of the full machinery. `plan=None` runs the computation
without any fault state; `faults.healthy_plan()` gives the same results.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import os
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import faults as flt
from repro_torch.core import soc
from repro_torch.core.device import resolve
from repro_torch.core.workloads import (FRAME_KBITS, FlatWorkload,
                                        stack_workloads, to_device)
from repro_torch.kernels.etf_ft import ops as _kops

MODE_LUT = 0
MODE_ETF = 1
MODE_ETF_IDEAL = 2
MODE_DAS = 3
MODE_ORACLE = 4
MODE_THRESHOLD = 5

MODE_NAMES = {
    MODE_LUT: "LUT",
    MODE_ETF: "ETF",
    MODE_ETF_IDEAL: "ETF-ideal",
    MODE_DAS: "DAS",
    MODE_ORACLE: "oracle",
    MODE_THRESHOLD: "threshold",
}

# Ready-queue capacity. The queue drains before simulated time advances,
# so its depth is bounded by simultaneous releases (at most 12 across the
# 40x14 suite at 60 instances); `ready_drop` counts overflows.
R_MAX = soc.ETF_LAT_MAX_N
SEG = 32            # fin_run segment size of the two-level completion search
RING = 8            # data-rate shift register entries (paper: 8x16bit)
N_FEATURES = 62     # performance-counter feature bank size (paper Table I)
POLL_EVERY = 32     # super-steps between host checks of any(running)
_INF = float("inf")
_NEG = float("-inf")


class SimParams(NamedTuple):
    """Hardware tables (from `soc.SoCConfig`) as tensors on one device."""

    exec_pe: torch.Tensor          # [n_types, P] f32 (inf = cannot run)
    pe_cluster: torch.Tensor       # [P] i32
    pe_power: torch.Tensor         # [P] f32
    lut_cluster: torch.Tensor      # [n_types] i32
    cluster_pe_mask: torch.Tensor  # [C, P] bool
    us_per_kb: torch.Tensor        # [] f32
    cluster_energy: torch.Tensor   # [n_types, C] f32 (inf = cannot run)


def make_params(cfg: soc.SoCConfig | None = None,
                device="cuda") -> SimParams:
    cfg = cfg or soc.default_soc()
    soc.validate_config(cfg)
    dev = resolve(device)

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x, dtype=dtype), device=dev)

    return SimParams(
        exec_pe=t(cfg.exec_on_pe(), np.float32),
        pe_cluster=t(cfg.pe_cluster, np.int32),
        pe_power=t(cfg.cluster_power[cfg.pe_cluster], np.float32),
        lut_cluster=t(cfg.lut_cluster, np.int32),
        cluster_pe_mask=t(cfg.cluster_pe_mask, np.bool_),
        us_per_kb=t(np.float32(cfg.us_per_kb), np.float32),
        cluster_energy=t(cfg.task_energy, np.float32),
    )


class DTree(NamedTuple):
    """Depth-2 decision tree over the feature vector (3 internal nodes).

    node 0 is the root; node 1 is the left child (feature < thr), node 2
    the right child. Leaves: [LL, LR, RL, RR], value 1 => use the slow
    scheduler. Fields are [3]/[3]/[4], or [S, ...] for one tree per
    scenario.
    """

    feat: torch.Tensor    # [..., 3] i32 feature indices
    thr: torch.Tensor     # [..., 3] f32 thresholds
    leaf: torch.Tensor    # [..., 4] i32 in {0, 1}

    def predict(self, f: torch.Tensor) -> torch.Tensor:
        """f [S, N_FEATURES] -> [S] leaf values (one tree or S trees)."""
        S = f.shape[0]
        feat = self.feat.long().expand(S, 3)
        thr = self.thr.expand(S, 3)
        leaf = self.leaf.expand(S, 4)
        right0 = f.gather(1, feat[:, :1])[:, 0] >= thr[:, 0]
        node = torch.where(right0, 2, 1).unsqueeze(1)
        rightc = (f.gather(1, feat.gather(1, node))
                  >= thr.gather(1, node))[:, 0]
        idx = torch.where(right0, 2, 0) + rightc.long()
        return leaf.gather(1, idx.unsqueeze(1))[:, 0]


def always_fast_tree(device="cuda") -> DTree:
    dev = resolve(device)
    return DTree(feat=torch.zeros(3, dtype=torch.int32, device=dev),
                 thr=torch.full((3,), _INF, device=dev),
                 leaf=torch.zeros(4, dtype=torch.int32, device=dev))


class SimState(NamedTuple):
    """Engine state for S scenarios. `[S]` fields are per-lane scalars;
    fields marked flat are `[S * N + 1, ...]` buffers (see module doc)."""

    now: torch.Tensor          # [S] f32
    stalled: torch.Tensor      # [S] bool no event can ever become due again
    sched_free: torch.Tensor   # [S] f32 scheduler-core availability
    arr_ptr: torch.Tensor      # [S] i64 next instance to arrive
    n_done: torch.Tensor       # [S] i64
    n_sched: torch.Tensor      # [S] i64 tasks scheduled so far
    status: torch.Tensor       # flat [T] i8 0=waiting 2=ready 3=running 4=done
    pred_rem: torch.Tensor     # flat [T] i64
    start: torch.Tensor        # flat [T] f32
    finish: torch.Tensor       # flat [T] f32 (inf until scheduled)
    fin_run: torch.Tensor      # flat [Tp] f32 finish while running, else inf
    #   (padded to Tp = ceil(T/SEG)*SEG with inf)
    fin_seg: torch.Tensor      # flat [Tp/SEG] f32 per-segment min of fin_run
    n_running: torch.Tensor    # [S] i64 count of status==3 tasks
    pe_of: torch.Tensor        # flat [T] i64 (-1 until scheduled)
    pe_free: torch.Tensor      # flat [P] f32
    pe_busy: torch.Tensor      # flat [P] f32 accumulated busy time
    ready_ids: torch.Tensor    # flat [R_MAX] i64 FIFO, -1 = empty
    ready_cnt: torch.Tensor    # [S] i64
    ready_drop: torch.Tensor   # [S] i64 overflow counter (should stay 0)
    ready_avail: torch.Tensor  # flat [R_MAX, P] f32 availability rows,
    #   cached at push time (a ready task's preds are all finished)
    ready_exec: torch.Tensor   # flat [R_MAX, P] f32 exec rows
    task_energy: torch.Tensor  # [S] f32 uJ
    sched_energy: torch.Tensor  # [S] f32 uJ
    sched_time: torch.Tensor   # [S] f32 us of scheduler occupancy
    n_fast: torch.Tensor       # [S] i64
    n_slow: torch.Tensor       # [S] i64
    ring: torch.Tensor         # flat [RING] f32 last arrival timestamps
    ring_ptr: torch.Tensor     # [S] i64
    arr_count: torch.Tensor    # [S] i64
    d_ptr: torch.Tensor        # [S] i64 decisions logged
    log_feat: torch.Tensor     # flat [T, N_FEATURES] f32
    log_policy: torch.Tensor   # flat [T] i8 (0 fast, 1 slow)
    log_agree: torch.Tensor    # flat [T] i8 (oracle: fast/slow identical)
    log_task: torch.Tensor     # flat [T] i64
    # fault state: None without a plan; status gains 5 = dropped with
    # its job
    pe_alive: torch.Tensor | None = None   # [S, P] bool live PEs at `now`
    pe_slow: torch.Tensor | None = None    # [S, P] f32 exec multiplier
    assign_t: torch.Tensor | None = None   # flat [T] f32 decision time of
    #   the live assignment; a fault at tau revokes assign_t < tau only
    retries: torch.Tensor | None = None    # flat [T] i64 kills per task
    kill_t: torch.Tensor | None = None     # flat [T] f32 last kill time
    inst_rem: torch.Tensor | None = None   # flat [I] i64 unfinished tasks
    job_dropped: torch.Tensor | None = None  # flat [I] bool
    n_kills: torch.Tensor | None = None    # [S] i64 revoked assignments
    n_retries: torch.Tensor | None = None  # [S] i64 kills re-enqueued
    reexec_us: torch.Tensor | None = None  # [S] f32 executed work revoked
    n_dropped_tasks: torch.Tensor | None = None  # [S] i64
    recovery_us: torch.Tensor | None = None  # [S] f32 sum over recovered
    #   tasks of (final finish - last kill)
    n_recovered: torch.Tensor | None = None  # [S] i64


class SimResult(NamedTuple):
    """Per-scenario results; every field has a leading [S] axis. The
    fault fields are zero without a plan."""

    avg_exec_us: torch.Tensor     # f32 mean instance latency
    makespan_us: torch.Tensor     # f32
    total_energy_uj: torch.Tensor  # f32 (task + scheduling energy)
    task_energy_uj: torch.Tensor
    sched_energy_uj: torch.Tensor
    sched_time_us: torch.Tensor
    edp: torch.Tensor             # f32 total energy * avg exec time
    n_decisions: torch.Tensor     # i32
    n_fast: torch.Tensor
    n_slow: torch.Tensor
    n_done: torch.Tensor
    ready_drop: torch.Tensor
    n_iters: torch.Tensor         # i32 events retired
    stalled: torch.Tensor         # bool sim gave up (unschedulable tasks)
    inst_exec_us: torch.Tensor    # [S, I] f32 per-instance latency
    log_feat: torch.Tensor        # [S, T, N_FEATURES] f32
    log_policy: torch.Tensor      # [S, T] i8
    log_agree: torch.Tensor       # [S, T] i8
    log_task: torch.Tensor        # [S, T] i32
    finish: torch.Tensor          # [S, T] f32
    pe_of: torch.Tensor           # [S, T] i32
    n_faults: torch.Tensor        # i32
    n_retries: torch.Tensor       # i32
    reexec_us: torch.Tensor       # f32
    n_dropped_jobs: torch.Tensor  # i32
    n_dropped_tasks: torch.Tensor  # i32
    recovery_us: torch.Tensor     # f32
    n_recovered: torch.Tensor     # i32
    job_dropped: torch.Tensor     # [S, I] bool
    stall_reason: torch.Tensor    # i32 STALL_NONE / DEADLOCK / BUDGET


# `SimResult.stall_reason` values
STALL_NONE = 0      # drained the workload
STALL_DEADLOCK = 1  # no event can ever become due again (`stalled` flag)
STALL_BUDGET = 2    # hit the iteration cap with work remaining


# ---------------------------------------------------------------------------
# per-call constants and flat-buffer helpers
# ---------------------------------------------------------------------------
class _Ctx(NamedTuple):
    S: int
    T: int
    Tp: int
    I: int
    P: int
    C: int
    lane: torch.Tensor        # [S] i64 arange
    ar_r: torch.Tensor        # [R_MAX]
    ar_seg: torch.Tensor      # [SEG]
    ar_mp: torch.Tensor       # [MP]
    ar_ms: torch.Tensor       # [MS]
    ar_mr: torch.Tensor       # [MR]
    first_pe: torch.Tensor    # [C] i64 first PE of each cluster
    lut_cluster: torch.Tensor  # [n_types] i64
    etf_lat: torch.Tensor     # [R_MAX + 1] f32 `soc.ETF_LAT_TABLE`
    ar_t: torch.Tensor        # [T]
    ar_i: torch.Tensor        # [I]
    W: int                    # most tasks of one instance (drops only)


def _make_ctx(p: SimParams, wl: FlatWorkload, drops: bool = False) -> _Ctx:
    """`drops`: the fault path can drop jobs, which needs `W` (one host
    read of the workload, before the loop)."""
    dev = p.exec_pe.device
    S, T = wl.task_type.shape
    I = wl.inst_arrival.shape[1]

    def ar(n):
        return torch.arange(n, device=dev)

    W = 0
    if drops:
        W = int(_inst_counts(wl, S, I).max()) if I else 0
    return _Ctx(
        S=S, T=T, Tp=-(-T // SEG) * SEG, I=I, P=p.pe_cluster.shape[0],
        C=p.cluster_pe_mask.shape[0], lane=ar(S), ar_r=ar(R_MAX),
        ar_seg=ar(SEG), ar_mp=ar(wl.preds.shape[2]),
        ar_ms=ar(wl.succs.shape[2]), ar_mr=ar(wl.inst_roots.shape[2]),
        first_pe=p.cluster_pe_mask.int().argmax(1),
        lut_cluster=p.lut_cluster.long(),
        etf_lat=torch.as_tensor(soc.ETF_LAT_TABLE, device=dev),
        ar_t=ar(T), ar_i=ar(I), W=W)


def _inst_counts(wl: FlatWorkload, S: int, I: int) -> torch.Tensor:
    """[S, I] valid tasks per instance."""
    idx = torch.where(wl.task_valid, wl.inst_id, I)
    return torch.zeros((S, I + 1), dtype=torch.int64,
                       device=idx.device).scatter_add_(
        1, idx, torch.ones_like(idx))[:, :I]


def _lanes(buf: torch.Tensor, S: int) -> torch.Tensor:
    """Contiguous [S, N, ...] view of a flat [S*N + 1, ...] buffer."""
    return buf[:-1].view(S, -1, *buf.shape[1:])


def _flat(buf: torch.Tensor, ctx: _Ctx, active: torch.Tensor,
          idx: torch.Tensor) -> torch.Tensor:
    """Flat row index of lane-local `idx` ([S] or [S, K]); inactive
    entries point at the spare last row."""
    n = (buf.shape[0] - 1) // ctx.S
    base = ctx.lane * n
    if idx.dim() == 2:
        base = base[:, None]
    return torch.where(active, base + idx, ctx.S * n).reshape(-1)


def _gset(buf, ctx, active, idx, val: torch.Tensor) -> None:
    """Gated row write `buf[lane, idx] = val` where `active`."""
    fi = _flat(buf, ctx, active, idx)
    buf.index_put_((fi,), val.reshape((fi.shape[0],) + buf.shape[1:]))


def _gfill(buf, ctx, active, idx, val) -> None:
    """Gated `buf[lane, idx] = val` for a Python scalar `val`."""
    buf.index_fill_(0, _flat(buf, ctx, active, idx), val)


def _gadd(buf, ctx, active, idx, val: torch.Tensor) -> None:
    """Gated `buf[lane, idx] += val`."""
    buf.index_put_((_flat(buf, ctx, active, idx),), val, accumulate=True)


def _gmin(buf, ctx, active, idx, val: torch.Tensor) -> None:
    """Gated `buf[lane, idx] = min(buf[lane, idx], val)`."""
    buf.scatter_reduce_(0, _flat(buf, ctx, active, idx), val, "amin")


def _take(ctx: _Ctx, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane gather: x [S, N, ...], idx [S] or [S, K] -> x[lane, idx]."""
    return x[ctx.lane[:, None] if idx.dim() == 2 else ctx.lane, idx]


# ---------------------------------------------------------------------------
# feature bank (paper Table I: task / PE / system counters, 62 total)
# ---------------------------------------------------------------------------
def _features(ctx: _Ctx, p: SimParams, wl: FlatWorkload,
              s: SimState) -> torch.Tensor:
    S = ctx.S
    now = s.now
    cnt = s.arr_count.clamp_max(RING)
    ring = _lanes(s.ring, S)
    oldest = torch.where(s.arr_count >= RING,
                         _take(ctx, ring, s.ring_ptr % RING), ring[:, 0])
    newest = _take(ctx, ring, (s.ring_ptr - 1) % RING)
    span = (newest - oldest).clamp_min(1e-3)
    rate_est = torch.where(
        cnt >= 2, (cnt - 1).float() * float(FRAME_KBITS) * 1000.0 / span,
        0.0)  # Mbps

    pe_free = _lanes(s.pe_free, S)
    pe_avail = (pe_free - now[:, None]).clamp_min(0.0)            # [S, P]
    cl_avail = torch.where(p.cluster_pe_mask, pe_avail[:, None, :],
                           _INF).amin(2)                          # [S, C]
    util = _lanes(s.pe_busy, S) / now.clamp_min(1e-3)[:, None]    # [S, P]

    head = _lanes(s.ready_ids, S)[:, 0]
    head_ok = head >= 0
    h = head.clamp_min(0)
    htype = _take(ctx, wl.task_type, h)
    hpreds = _take(ctx, wl.preds, h)                        # [S, MP]
    hvalid = ctx.ar_mp < _take(ctx, wl.n_preds, h)[:, None]
    pe_of = _lanes(s.pe_of, S)
    pred_cl = torch.where(
        hvalid & (hpreds >= 0),
        p.pe_cluster[pe_of.gather(1, hpreds.clamp_min(0)).clamp_min(0)], -1)
    mp = pred_cl.shape[1]
    if mp < 4:
        pred_cl = torch.nn.functional.pad(pred_cl, (0, 4 - mp), value=-1)
    pred_cl = pred_cl[:, :4]
    lut_pe = ctx.first_pe[ctx.lut_cluster[htype]]   # first PE of LUT cluster
    exec_lut = p.exec_pe[htype, lut_pe]

    def z(x):
        return torch.where(head_ok, x.float(), 0.0)

    feats = torch.cat([
        rate_est[:, None], s.ready_cnt.float()[:, None],
        cl_avail,                                  # 6
        pe_avail,                                  # 19
        util,                                      # 19
        torch.stack([
            z(htype), z(_take(ctx, wl.depth, h)), z(_take(ctx, wl.app_id, h)),
            z(_take(ctx, wl.out_kb, h)),
            z(p.exec_pe[htype, 0]),                # exec on big
            z(exec_lut),                           # exec on LUT PE
            z(exec_lut * p.pe_power[lut_pe]),
            z(_take(ctx, wl.n_preds, h)),
        ], 1),
        pred_cl.float(),                           # 4
        torch.stack([
            (s.sched_free - now).clamp_min(0.0),
            s.arr_count.float(),
            s.n_done.float() / wl.n_tasks.float().clamp_min(1.0),
            s.n_running.float(),
        ], 1),
    ], 1)
    return feats


FEAT_RATE = 0           # input data rate (paper's #1 feature)
FEAT_BIG_AVAIL = 2      # earliest availability of the big cluster (#2)
FEAT_NAMES = (
    ["input_data_rate", "ready_queue_len"]
    + [f"cluster_avail_{c}" for c in soc.CLUSTER_NAMES]
    + [f"pe_avail_{i}" for i in range(soc.N_PES)]
    + [f"pe_util_{i}" for i in range(soc.N_PES)]
    + ["head_type", "head_depth", "head_app", "head_out_kb",
       "head_exec_big", "head_exec_lut", "head_energy_lut", "head_n_preds"]
    + [f"head_pred_cluster_{k}" for k in range(4)]
    + ["sched_backlog", "arrivals_so_far", "done_frac", "running_count"]
)


# ---------------------------------------------------------------------------
# scheduler decision helpers
# ---------------------------------------------------------------------------
def _avail_rows(p: SimParams, wl: FlatWorkload, s: SimState,
                tasks: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """[S, K, P] availability (incl. NoC transfer from pred clusters),
    gathered from the state by the avail-rows kernel. Evaluated once per
    task at push time: a task enters the ready queue only when every
    predecessor has finished, so the row is constant from then on."""
    return _kops.avail_rows(tasks, s.finish, s.pe_of, wl.preds, wl.n_preds,
                            wl.out_kb, p.us_per_kb, p.pe_cluster, bases)


def _etf_choice(ctx: _Ctx, s: SimState, alive=None):
    """Earliest-finish-time (slot, pe, feasible) over the ready buffer
    (Algorithm 1), through the masked search kernel (first global
    minimum). `alive` [S, P] masks dead PEs out (the fault path)."""
    S = ctx.S
    ids = _lanes(s.ready_ids, S)
    slot, pe, ok = _kops.etf_decide(_lanes(s.ready_avail, S),
                                    _lanes(s.pe_free, S),
                                    _lanes(s.ready_exec, S), s.now,
                                    ids >= 0, alive)
    return slot.long(), pe.long(), ok


def _lut_choice(ctx: _Ctx, p: SimParams, wl: FlatWorkload, s: SimState):
    """Fast scheduler: FIFO head -> most-energy-efficient cluster -> its
    earliest-free PE. (slot, pe, None): it never fails."""
    S = ctx.S
    t = _lanes(s.ready_ids, S)[:, 0].clamp_min(0)
    cl = ctx.lut_cluster[_take(ctx, wl.task_type, t)]
    free = torch.where(p.cluster_pe_mask[cl], _lanes(s.pe_free, S), _INF)
    return torch.zeros_like(t), free.argmin(1), None


def _lut_choice_degraded(ctx: _Ctx, p: SimParams, wl: FlatWorkload,
                         s: SimState):
    """Fault-aware fast scheduler: (slot, pe, feasible). Clusters are
    ranked by `cluster_energy` among those with a live PE, so a dead
    accelerator degrades to the next-best cluster (at last the CPUs,
    which run every type). With every PE alive it is `_lut_choice`."""
    S = ctx.S
    head = _lanes(s.ready_ids, S)[:, 0]
    t = head.clamp_min(0)
    tt = _take(ctx, wl.task_type, t)
    cl_alive = (p.cluster_pe_mask & s.pe_alive[:, None, :]).any(2)  # [S, C]
    e = torch.where(cl_alive, p.cluster_energy[tt], _INF)
    cl = e.argmin(1)
    ok = (head >= 0) & torch.isfinite(_take(ctx, e, cl))
    free = torch.where(p.cluster_pe_mask[cl] & s.pe_alive,
                       _lanes(s.pe_free, S), _INF)
    return torch.zeros_like(t), free.argmin(1), ok


class _Choice(NamedTuple):
    """What a decision reads of the state: the features, the policy's
    pick (DAS, threshold), and each scheduler's (slot, pe, feasible)."""
    feats: torch.Tensor | None
    use_slow: torch.Tensor | None
    lut: tuple | None
    etf: tuple | None


def _choose(ctx: _Ctx, mode: int, p: SimParams, wl: FlatWorkload,
            s: SimState, tree: DTree, rate_threshold: torch.Tensor,
            alive, decide: bool, ch: _Choice | None = None) -> _Choice:
    """Fill in what the mode reads of `s`: everything the decide needs
    (`decide`), or only what the feasibility check needs (the features
    only for DAS and the threshold; the LUT alone for the oracle). `ch`
    holds what is known of the same state already; it is not computed
    again (one search serves the check and the decide). With a plan the
    LUT is the degraded one."""
    feats, use_slow, lut, etf = ch if ch is not None else (None,) * 4
    mixed = mode in (MODE_DAS, MODE_THRESHOLD)
    if feats is None and (decide or mixed):
        feats = _features(ctx, p, wl, s)
    if use_slow is None and mode == MODE_DAS:
        use_slow = tree.predict(feats).bool()
    elif use_slow is None and mode == MODE_THRESHOLD:
        use_slow = feats[:, FEAT_RATE] >= rate_threshold
    if lut is None and mode not in (MODE_ETF, MODE_ETF_IDEAL):
        lut = (_lut_choice(ctx, p, wl, s) if s.pe_alive is None
               else _lut_choice_degraded(ctx, p, wl, s))
    if etf is None and mode != MODE_LUT and (decide
                                             or mode != MODE_ORACLE):
        etf = _etf_choice(ctx, s, alive)
    return _Choice(feats, use_slow, lut, etf)


def _feasible(mode: int, ch: _Choice) -> torch.Tensor:
    """[S] bool: the scheduler the mode would invoke has a feasible
    (task, PE) pair (the reference's `_can_schedule`). The fast path
    reads only the FIFO head, so a head whose every capable cluster is
    dead blocks the queue until a repair or its job's deadline."""
    if mode in (MODE_LUT, MODE_ORACLE):
        return ch.lut[2]
    if mode in (MODE_ETF, MODE_ETF_IDEAL):
        return ch.etf[2]
    return torch.where(ch.use_slow, ch.etf[2], ch.lut[2])


# ---------------------------------------------------------------------------
# state mutations, each gated per lane by `active` [S] bool
# ---------------------------------------------------------------------------
def _next_completion(ctx: _Ctx, s: SimState):
    """(task, finish) of the earliest-finishing running task: argmin over
    the segment minima, then inside the segment (first global minimum)."""
    fin_seg = _lanes(s.fin_seg, ctx.S)
    seg = fin_seg.argmin(1)
    val = _take(ctx, fin_seg, seg)
    blk = _lanes(s.fin_run, ctx.S).gather(1, seg[:, None] * SEG + ctx.ar_seg)
    return seg * SEG + blk.argmin(1), val


def _push_ready_many(ctx: _Ctx, p: SimParams, wl: FlatWorkload,
                     s: SimState, tasks: torch.Tensor, bases: torch.Tensor,
                     do_push: torch.Tensor, rows_avail=None) -> SimState:
    """FIFO-push up to K tasks per lane (k ascending), caching their rows.

    With `b_k = ready_cnt + sum_{j<k} do_push_j`, push k lands iff
    `do_push_k & (b_k < R_MAX)`; the rest count as `ready_drop`.
    """
    t = tasks.clamp_min(0)                                # [S, K]
    if rows_avail is None:
        rows_avail = _avail_rows(p, wl, s, t, bases)      # [S, K, P]
    rows_exec = p.exec_pe[_take(ctx, wl.task_type, t)]    # [S, K, P]
    if s.pe_slow is not None:
        # cluster slowdown stretches the cached rows at push time (x1.0
        # when healthy keeps the healthy plan bit-exact)
        rows_exec = rows_exec * s.pe_slow[:, None, :]
    want = do_push.long()
    before = s.ready_cnt[:, None] + want.cumsum(1) - want
    can = do_push & (before < R_MAX)
    acc = can.long()
    slots = s.ready_cnt[:, None] + acc.cumsum(1) - acc
    _gset(s.ready_ids, ctx, can, slots, t)
    _gset(s.ready_avail, ctx, can, slots, rows_avail)
    _gset(s.ready_exec, ctx, can, slots, rows_exec)
    _gfill(s.status, ctx, do_push, t, 2)
    return s._replace(ready_cnt=s.ready_cnt + acc.sum(1),
                      ready_drop=s.ready_drop + (want - acc).sum(1))


def _pop_slot(ctx: _Ctx, s: SimState, slot: torch.Tensor,
              active: torch.Tensor) -> SimState:
    """Remove `slot` keeping FIFO order (left shift of the tail); the
    vacated last slot becomes -1 (its stale rows are masked by it)."""
    S = ctx.S
    tail = ctx.ar_r[None, :] >= slot[:, None]             # [S, R]
    move = active[:, None] & tail
    ids = _lanes(s.ready_ids, S)
    shifted = torch.roll(ids, -1, 1)
    shifted[:, -1] = -1
    ids.copy_(torch.where(move, shifted, ids))
    for rows in (_lanes(s.ready_avail, S), _lanes(s.ready_exec, S)):
        rows.copy_(torch.where(move[:, :, None], torch.roll(rows, -1, 1),
                               rows))
    return s._replace(ready_cnt=s.ready_cnt - active.long())


def _assign(ctx: _Ctx, p: SimParams, s: SimState, slot, pe, lat, sched_e,
            is_slow, feats, agree, active) -> SimState:
    S = ctx.S
    task = _take(ctx, _lanes(s.ready_ids, S), slot).clamp_min(0)
    sched_done = torch.maximum(s.sched_free, s.now) + lat
    avail = _lanes(s.ready_avail, S)[ctx.lane, slot, pe]
    start = torch.maximum(
        torch.maximum(avail, _take(ctx, _lanes(s.pe_free, S), pe)),
        torch.maximum(sched_done, s.now))
    exec_t = _lanes(s.ready_exec, S)[ctx.lane, slot, pe]
    finish = start + exec_t
    e_task = exec_t * p.pe_power[pe]
    act = active.long()
    d = s.d_ptr
    _gfill(s.status, ctx, active, task, 3)
    _gset(s.start, ctx, active, task, start)
    _gset(s.finish, ctx, active, task, finish)
    _gset(s.fin_run, ctx, active, task, finish)
    _gmin(s.fin_seg, ctx, active, task // SEG, finish)
    _gset(s.pe_of, ctx, active, task, pe)
    _gset(s.pe_free, ctx, active, pe, finish)
    _gadd(s.pe_busy, ctx, active, pe, exec_t)
    _gset(s.log_feat, ctx, active, d, feats)
    _gset(s.log_policy, ctx, active, d, is_slow.to(torch.int8))
    _gset(s.log_agree, ctx, active, d, agree.to(torch.int8))
    _gset(s.log_task, ctx, active, d, task)
    s = s._replace(
        sched_free=torch.where(active, sched_done, s.sched_free),
        n_running=s.n_running + act,
        task_energy=torch.where(active, s.task_energy + e_task,
                                s.task_energy),
        sched_energy=torch.where(active, s.sched_energy + sched_e,
                                 s.sched_energy),
        sched_time=torch.where(active, s.sched_time + lat, s.sched_time),
        n_fast=s.n_fast + (1 - is_slow) * act,
        n_slow=s.n_slow + is_slow * act,
        n_sched=s.n_sched + act,
        d_ptr=d + act,
    )
    if s.assign_t is not None:
        # a fault at tau revokes live assignments with assign_t < tau, so
        # a decision taken at a fault instant is never killed by it
        _gset(s.assign_t, ctx, active, task, s.now)
    return _pop_slot(ctx, s, slot, active)


def _process_completion(ctx: _Ctx, p: SimParams, wl: FlatWorkload,
                        s: SimState, active: torch.Tensor,
                        t: torch.Tensor) -> SimState:
    S = ctx.S
    act = active.long()
    _gfill(s.status, ctx, active, t, 4)
    _gfill(s.fin_run, ctx, active, t, _INF)
    s = s._replace(n_running=s.n_running - act, n_done=s.n_done + act)
    if s.inst_rem is not None:
        _gadd(s.inst_rem, ctx, active, _take(ctx, wl.inst_id, t),
              -torch.ones_like(t))
        # a killed task finishing at last: recovery runs from its last
        # kill to its final finish
        rec = active & (_take(ctx, _lanes(s.retries, S), t) > 0)
        s = s._replace(
            recovery_us=torch.where(
                rec, s.recovery_us + (_take(ctx, _lanes(s.finish, S), t)
                                      - _take(ctx, _lanes(s.kill_t, S), t)),
                s.recovery_us),
            n_recovered=s.n_recovered + rec.long())
    # restore the fin_seg invariant: rescan only the retired task's segment
    seg = t // SEG
    blk = _lanes(s.fin_run, S).gather(1, seg[:, None] * SEG + ctx.ar_seg)
    _gset(s.fin_seg, ctx, active, seg, blk.amin(1))

    # all successors at once: they are distinct tasks, so the pred_rem
    # update and the pushes vectorize with no read-after-write hazard
    succ = _take(ctx, wl.succs, t)                        # [S, MS]
    valid = ((ctx.ar_ms < _take(ctx, wl.n_succs, t)[:, None]) & (succ >= 0)
             & active[:, None])
    sc = succ.clamp_min(0)
    new_rem = _lanes(s.pred_rem, S).gather(1, sc) - 1
    _gset(s.pred_rem, ctx, valid, sc, new_rem)
    ready_now = valid & (new_rem == 0)
    # availability base = max pred finish (all preds are done)
    pr = _take(ctx, wl.preds, sc)                         # [S, MS, MP]
    ms, mp = pr.shape[1], pr.shape[2]
    pv = ctx.ar_mp < _take(ctx, wl.n_preds, sc)[..., None]
    pfin = _lanes(s.finish, S).gather(
        1, pr.clamp_min(0).reshape(S, ms * mp)).view(S, ms, mp)
    bases = torch.where(pv, pfin, _NEG).amax(2)
    return _push_ready_many(ctx, p, wl, s, sc,
                            torch.maximum(bases, s.now[:, None]), ready_now)


def _process_arrival(ctx: _Ctx, p: SimParams, wl: FlatWorkload,
                     s: SimState, active: torch.Tensor) -> SimState:
    i = s.arr_ptr
    ic = i.clamp_max(ctx.I - 1)
    t_arr = _take(ctx, wl.inst_arrival, ic)
    act = active.long()
    _gset(s.ring, ctx, active, s.ring_ptr % RING, t_arr)
    s = s._replace(arr_ptr=i + act, ring_ptr=s.ring_ptr + act,
                   arr_count=s.arr_count + act)
    roots = _take(ctx, wl.inst_roots, ic)                 # [S, MR]
    mr = roots.shape[1]
    valid = ((ctx.ar_mr < _take(ctx, wl.inst_n_roots, ic)[:, None])
             & (roots >= 0) & active[:, None])
    bases = t_arr[:, None].expand(ctx.S, mr)
    # roots have no preds, so their availability row is the arrival time
    rows = t_arr[:, None, None].expand(ctx.S, mr, ctx.P)
    return _push_ready_many(ctx, p, wl, s, roots.clamp_min(0), bases, valid,
                            rows_avail=rows)


# ---------------------------------------------------------------------------
# fault events (kill / deadline / drop): built only for a plan that can
# fire them (`faults.plan_capabilities`)
# ---------------------------------------------------------------------------
def _pending_kill(ctx: _Ctx, plan: flt.FaultPlan, s: SimState):
    """(due [S], task [S]): the earliest fault instant that revokes a live
    assignment, a running task whose PE fails or glitches at tau with
    `assign_t < tau <= now`. Ties go to the lowest task id."""
    S = ctx.S
    taus = flt.kill_times(plan)                          # [S, P, K]
    pe = _lanes(s.pe_of, S).clamp_min(0)                 # [S, T]
    t_taus = taus.gather(1, pe[..., None].expand(-1, -1, taus.shape[2]))
    running = _lanes(s.status, S) == 3
    due = (running[..., None]
           & (_lanes(s.assign_t, S)[..., None] < t_taus)
           & (t_taus <= s.now[:, None, None]))           # [S, T, K]
    tau_t = torch.where(due, t_taus, _INF).amin(2)       # [S, T]
    return due.flatten(1).any(1), tau_t.argmin(1)


def _ordered_add(ctx: _Ctx, buf: torch.Tensor, mask: torch.Tensor,
                 idx: torch.Tensor, val: torch.Tensor) -> None:
    """`buf[lane, idx[lane, t]] += val[lane, t]` where `mask` [S, T], in
    ascending task id per lane, as the reference's scatter-add applies
    them (the order of float adds to one row sets its bits; CUDA's
    accumulating `index_put_` keeps none). The masked tasks, at most
    `ctx.W` a lane (one instance's), are compacted without a host sync,
    then added one rank at a time."""
    S, W = ctx.S, ctx.W
    rank = mask.long().cumsum(1) - 1
    pos = torch.where(mask & (rank < W), rank, W)
    order = torch.zeros((S, W + 1), dtype=torch.int64,
                        device=mask.device).scatter_(
        1, pos, ctx.ar_t.expand(S, -1))[:, :W]
    ok = torch.arange(W, device=mask.device) < mask.sum(1, keepdim=True)
    fi = _flat(buf, ctx, ok, idx.gather(1, order)).view(S, W)
    ov = val.gather(1, order)
    # rank w of every lane: distinct rows (inactive ones write the spare
    # row, never read), so a plain read-add-write is one add per row,
    # without the sort an accumulating `index_put_` does on CUDA
    for w in range(W):
        i = fi[:, w]
        buf.index_put_((i,), buf[i] + ov[:, w])


def _drop_instance(ctx: _Ctx, p: SimParams, wl: FlatWorkload, s: SimState,
                   inst: torch.Tensor, active: torch.Tensor) -> SimState:
    """Cancel every unfinished task of instance `inst` [S] (deadline miss
    or retry exhaustion). Running victims roll back their unexecuted tail
    (busy time, energy); queued ones leave the FIFO with the survivors'
    order kept; every victim retires as status 5, so `n_done` still
    converges."""
    S, P = ctx.S, ctx.P
    inst = inst.clamp_min(0)
    status = _lanes(s.status, S)
    victim = ((wl.inst_id == inst[:, None]) & wl.task_valid & (status < 4)
              & active[:, None])                           # [S, T]
    n_v = victim.sum(1)
    runn = victim & (status == 3)
    pe = _lanes(s.pe_of, S).clamp_min(0)
    start = _lanes(s.start, S)
    finish = _lanes(s.finish, S)
    exec_total = torch.where(runn, finish - start, 0.0)
    executed = torch.where(runn, torch.minimum(
        torch.maximum(s.now[:, None] - start, torch.zeros_like(start)),
        exec_total), 0.0)
    unexec = exec_total - executed
    _ordered_add(ctx, s.pe_busy, runn, pe, -unexec)
    e_back = torch.where(runn, unexec * p.pe_power[pe], 0.0).sum(1)
    # PEs that lost a victim rebuild pe_free from surviving assignments;
    # the others keep their exact value
    pe_ix = torch.where(runn, pe, P)
    pe_hit = torch.zeros((S, P + 1), dtype=torch.bool,
                         device=pe.device).scatter_(
        1, pe_ix, torch.ones_like(runn))[:, :P]
    surv = (status == 3) & ~victim
    surv_fin = torch.full((S, P + 1), _NEG, device=pe.device).scatter_reduce(
        1, torch.where(surv, pe, P), finish, "amax")[:, :P]
    free = _lanes(s.pe_free, S)
    free.copy_(torch.where(pe_hit, torch.maximum(surv_fin, s.now[:, None]),
                           free))

    status.copy_(torch.where(victim, 5, status))
    # -inf keeps dropped tasks out of the makespan and instance maxima
    finish.copy_(torch.where(victim, _NEG, finish))
    start.copy_(torch.where(victim, _INF, start))
    assign_t = _lanes(s.assign_t, S)
    assign_t.copy_(torch.where(victim, _INF, assign_t))
    fin_run = _lanes(s.fin_run, S)
    fin_run[:, :ctx.T].copy_(torch.where(runn, _INF, fin_run[:, :ctx.T]))
    # victims may span many segments: rebuild every segment minimum (the
    # invariant's own value where nothing changed)
    _lanes(s.fin_seg, S).copy_(fin_run.view(S, -1, SEG).amin(2))

    # purge victims from the FIFO, survivors first in their order
    ids = _lanes(s.ready_ids, S)
    in_q = ids >= 0
    keep = in_q & ~victim.gather(1, ids.clamp_min(0))
    perm = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    new_cnt = keep.sum(1)
    ids_p = torch.where(ctx.ar_r < new_cnt[:, None], ids.gather(1, perm), -1)
    ids.copy_(torch.where(active[:, None], ids_p, ids))
    rperm = perm[..., None].expand(-1, -1, P)
    for rows in (_lanes(s.ready_avail, S), _lanes(s.ready_exec, S)):
        rows.copy_(torch.where(active[:, None, None], rows.gather(1, rperm),
                               rows))
    _gfill(s.inst_rem, ctx, active, inst, 0)
    _gfill(s.job_dropped, ctx, active, inst, True)
    return s._replace(
        task_energy=torch.where(active, s.task_energy - e_back,
                                s.task_energy),
        n_running=s.n_running - runn.sum(1),
        n_done=s.n_done + n_v,
        n_dropped_tasks=s.n_dropped_tasks + n_v,
        ready_cnt=torch.where(active, new_cnt, s.ready_cnt))


def _process_kill(ctx: _Ctx, plan: flt.FaultPlan, p: SimParams,
                  wl: FlatWorkload, s: SimState, t: torch.Tensor,
                  active: torch.Tensor) -> SimState:
    """Revoke the live assignment of running task `t` [S] at `now` (which
    sits on the fault instant: the advance stops at every plan time).
    Executed work is wasted (`reexec_us`), its energy and busy time stay;
    the unexecuted tail rolls back. Within the retry budget the task
    re-enters the FIFO tail at `now`; past it its whole job drops."""
    S = ctx.S
    t = t.clamp_min(0)
    pe_of = _lanes(s.pe_of, S)
    finish = _lanes(s.finish, S)
    pe = _take(ctx, pe_of, t).clamp_min(0)
    start_t = _take(ctx, _lanes(s.start, S), t)
    exec_total = _take(ctx, finish, t) - start_t
    executed = torch.minimum(torch.maximum(s.now - start_t,
                                           torch.zeros_like(start_t)),
                             exec_total)
    unexec = exec_total - executed
    act = active.long()
    exhausted = _take(ctx, _lanes(s.retries, S), t) >= plan.max_retries
    rk = active & ~exhausted
    dr = active & exhausted
    others = ((_lanes(s.status, S) == 3) & (pe_of == pe[:, None])
              & (ctx.ar_t != t[:, None]))
    new_free = torch.maximum(torch.where(others, finish, _NEG).amax(1),
                             s.now)

    _gfill(s.status, ctx, active, t, 0)
    _gfill(s.start, ctx, active, t, _INF)
    _gfill(s.finish, ctx, active, t, _INF)
    _gfill(s.fin_run, ctx, active, t, _INF)
    _gfill(s.pe_of, ctx, active, t, -1)
    _gfill(s.assign_t, ctx, active, t, _INF)
    _gset(s.pe_free, ctx, active, pe, new_free)
    _gadd(s.pe_busy, ctx, active, pe, -unexec)
    _gadd(s.retries, ctx, active, t, torch.ones_like(t))
    _gset(s.kill_t, ctx, active, t, s.now)
    s = s._replace(
        n_running=s.n_running - act,
        task_energy=torch.where(active,
                                s.task_energy - unexec * p.pe_power[pe],
                                s.task_energy),
        n_kills=s.n_kills + act,
        n_retries=s.n_retries + rk.long(),
        reexec_us=torch.where(active, s.reexec_us + executed, s.reexec_us))
    # restore the fin_seg invariant for the killed task's segment
    seg = t // SEG
    blk = _lanes(s.fin_run, S).gather(1, seg[:, None] * SEG + ctx.ar_seg)
    _gset(s.fin_seg, ctx, active, seg, blk.amin(1))
    # retry: back to the FIFO tail, its row re-based at now (its preds
    # are all done, so the row can be computed again)
    s = _push_ready_many(ctx, p, wl, s, t[:, None], s.now[:, None],
                         rk[:, None])
    # exhausted: the whole job goes
    return _drop_instance(ctx, p, wl, s, _take(ctx, wl.inst_id, t), dr)


def _pending_deadline(ctx: _Ctx, plan: flt.FaultPlan, wl: FlatWorkload,
                      s: SimState):
    """(due [S], inst [S]): the earliest arrived, unfinished instance past
    its deadline. Ties go to the lowest instance id."""
    pend = ((ctx.ar_i < s.arr_ptr[:, None]) & wl.inst_valid
            & (_lanes(s.inst_rem, ctx.S) > 0))
    dl = torch.where(pend, wl.inst_arrival + plan.deadline_us[:, None], _INF)
    due = pend & (dl <= s.now[:, None])
    return due.any(1), torch.where(due, dl, _INF).argmin(1)


def _next_wakeup(ctx: _Ctx, plan: flt.FaultPlan, wl: FlatWorkload,
                 s: SimState, fcaps: tuple) -> torch.Tensor:
    """[S] earliest strictly future fault instant, repair or pending job
    deadline: extra advance targets, so `now` lands on each fault event.
    Targets a capability rules out are left out (each would be inf)."""
    can_die, can_kill, has_deadline = fcaps
    parts = []
    if can_die:
        parts += [plan.pe_fail_at, plan.pe_repair_at]
    if can_kill:
        parts.append(plan.transient_at.flatten(1))
    out = torch.full_like(s.now, _INF)
    if parts:
        times = torch.cat(parts, 1)
        out = torch.where(times > s.now[:, None], times, _INF).amin(1)
    if has_deadline:
        pend = ((ctx.ar_i < s.arr_ptr[:, None]) & wl.inst_valid
                & (_lanes(s.inst_rem, ctx.S) > 0))
        dl = torch.where(pend, wl.inst_arrival + plan.deadline_us[:, None],
                         _INF)
        out = torch.minimum(out, torch.where(dl > s.now[:, None], dl,
                                             _INF).amin(1))
    return out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _init_state(ctx: _Ctx, wl: FlatWorkload,
                pe_slow: torch.Tensor | None = None) -> SimState:
    """The state at t = 0; with `pe_slow` [S, P] (a plan's slowdowns),
    the fault state too."""
    S, T, Tp, P = ctx.S, ctx.T, ctx.Tp, ctx.P
    dev = ctx.lane.device
    f32, i64 = torch.float32, torch.int64

    def flat(n, *row, fill=0, dtype=f32):
        return torch.full((S * n + 1, *row), fill, dtype=dtype, device=dev)

    def lane(fill=0, dtype=i64):
        return torch.full((S,), fill, dtype=dtype, device=dev)

    pred_rem = flat(T, dtype=i64)
    _lanes(pred_rem, S).copy_(wl.n_preds)
    faults = {}
    if pe_slow is not None:
        inst_rem = flat(ctx.I, dtype=i64)
        _lanes(inst_rem, S).copy_(_inst_counts(wl, S, ctx.I))
        faults = dict(
            pe_alive=torch.ones((S, P), dtype=torch.bool, device=dev),
            pe_slow=pe_slow, assign_t=flat(T, fill=_INF),
            retries=flat(T, dtype=i64), kill_t=flat(T), inst_rem=inst_rem,
            job_dropped=flat(ctx.I, dtype=torch.bool), n_kills=lane(),
            n_retries=lane(), reexec_us=lane(0.0, f32),
            n_dropped_tasks=lane(), recovery_us=lane(0.0, f32),
            n_recovered=lane())
    return SimState(
        now=lane(0.0, f32), stalled=lane(False, torch.bool),
        sched_free=lane(0.0, f32), arr_ptr=lane(), n_done=lane(),
        n_sched=lane(), status=flat(T, dtype=torch.int8), pred_rem=pred_rem,
        start=flat(T, fill=_INF), finish=flat(T, fill=_INF),
        fin_run=flat(Tp, fill=_INF), fin_seg=flat(Tp // SEG, fill=_INF),
        n_running=lane(), pe_of=flat(T, fill=-1, dtype=i64),
        pe_free=flat(P), pe_busy=flat(P),
        ready_ids=flat(R_MAX, fill=-1, dtype=i64), ready_cnt=lane(),
        ready_drop=lane(), ready_avail=flat(R_MAX, P),
        ready_exec=flat(R_MAX, P), task_energy=lane(0.0, f32),
        sched_energy=lane(0.0, f32), sched_time=lane(0.0, f32),
        n_fast=lane(), n_slow=lane(), ring=flat(RING), ring_ptr=lane(),
        arr_count=lane(), d_ptr=lane(),
        log_feat=flat(T, N_FEATURES), log_policy=flat(T, dtype=torch.int8),
        log_agree=flat(T, dtype=torch.int8),
        log_task=flat(T, fill=-1, dtype=i64),
        **faults,
    )


def _decide(ctx: _Ctx, mode: int, p: SimParams, wl: FlatWorkload,
            s: SimState, ch: _Choice, active: torch.Tensor) -> SimState:
    """One decision per active lane from `ch` (`_choose` of `s`)."""
    feats = ch.feats
    etf_lat = ctx.etf_lat[s.ready_cnt]
    etf_e = etf_lat * float(soc.SCHED_POWER_W)
    lut_lat = float(soc.LUT_LATENCY_US)
    lut_e = float(soc.LUT_ENERGY_UJ)
    zero = torch.zeros_like(s.ready_cnt)

    if mode == MODE_LUT:
        slot, pe, _ = ch.lut
        return _assign(ctx, p, s, slot, pe, lut_lat, lut_e, zero, feats,
                       zero, active)
    if mode == MODE_ETF:
        slot, pe, _ = ch.etf
        return _assign(ctx, p, s, slot, pe, etf_lat, etf_e, zero + 1, feats,
                       zero, active)
    if mode == MODE_ETF_IDEAL:
        slot, pe, _ = ch.etf
        return _assign(ctx, p, s, slot, pe, 0.0, 0.0, zero + 1, feats, zero,
                       active)
    if mode == MODE_ORACLE:
        # run both, follow the fast one, log whether they agree
        slot_f, pe_f, _ = ch.lut
        slot_s, pe_s, _ = ch.etf
        ids = _lanes(s.ready_ids, ctx.S)
        agree = ((_take(ctx, ids, slot_f) == _take(ctx, ids, slot_s))
                 & (pe_f == pe_s)).long()
        return _assign(ctx, p, s, slot_f, pe_f, lut_lat, lut_e, zero, feats,
                       agree, active)

    if mode == MODE_DAS:
        cls_e = float(soc.DAS_CLS_ENERGY_UJ)
    elif mode == MODE_THRESHOLD:
        cls_e = 0.0
    else:
        raise ValueError(f"unknown mode {mode}")

    use_slow = ch.use_slow
    slot_f, pe_f, _ = ch.lut
    slot_s, pe_s, _ = ch.etf
    slot = torch.where(use_slow, slot_s, slot_f)
    pe = torch.where(use_slow, pe_s, pe_f)
    lat = torch.where(use_slow, etf_lat, lut_lat)
    e = torch.where(use_slow, etf_e, lut_e) + cls_e
    return _assign(ctx, p, s, slot, pe, lat, e, use_slow.long(), feats, zero,
                   active)


def _masked_step(ctx: _Ctx, mode: int, p: SimParams, s: SimState,
                 wl: FlatWorkload, tree: DTree, rate_threshold: torch.Tensor,
                 run: torch.Tensor, plan: flt.FaultPlan | None = None,
                 fcaps: tuple = flt.NO_CAPS):
    """One super-step of gated phases; returns (s, ev).

    Phases run in the reference's priority order (completion > kill >
    deadline > arrival > decide > advance) with gates re-derived after
    each phase, so one step retires several consecutive events when they
    would have fired back-to-back anyway; `ev` (events retired, 0..6)
    keeps `n_iters` equal to the event count. `run=False` freezes a lane.
    The kill and deadline phases exist only where `fcaps` (the chunk's
    `faults.plan_capabilities`) says they can fire; with `can_die` the
    step refreshes the live-PE mask and a decision also needs a feasible
    pair.
    """
    I = ctx.I
    can_die, can_kill, has_deadline = fcaps
    if can_die:
        s = s._replace(pe_alive=flt.alive_at(plan, s.now))
    alive = s.pe_alive if can_die else None
    fin_idx, fin_val = _next_completion(ctx, s)
    c = run & (fin_val <= s.now)
    s = _process_completion(ctx, p, wl, s, c, fin_idx)
    ev = c.long()

    # a completion tie leaves another completion due: everything below
    # waits for the next step, as the one-event loop would
    next_fin = _lanes(s.fin_seg, ctx.S).amin(1)
    no_c = ~(next_fin <= s.now)
    gate = run & no_c
    # a second due kill or deadline blocks everything after its phase
    if can_kill:
        k_due, k_task = _pending_kill(ctx, plan, s)
        k = gate & k_due
        s = _process_kill(ctx, plan, p, wl, s, k_task, k)
        gate = gate & ~_pending_kill(ctx, plan, s)[0]
        ev = ev + k.long()
    pre_arrival = gate
    if has_deadline:
        dl_due, dl_inst = _pending_deadline(ctx, plan, wl, s)
        dl = gate & dl_due
        s = _drop_instance(ctx, p, wl, s, dl_inst, dl)
        pre_arrival = gate & ~_pending_deadline(ctx, plan, wl, s)[0]
        ev = ev + dl.long()

    def arr_due(st):
        return (st.arr_ptr < wl.n_insts) & (
            _take(ctx, wl.inst_arrival, st.arr_ptr.clamp_max(I - 1)) <= st.now)

    a = pre_arrival & arr_due(s)
    s = _process_arrival(ctx, p, wl, s, a)

    # same-timestamp arrivals: the next one blocks the decide phase; an
    # arrival can also bring an already expired deadline
    gate = gate & ~arr_due(s)
    if has_deadline:
        gate = gate & ~_pending_deadline(ctx, plan, wl, s)[0]
    can_decide = s.ready_cnt > 0
    ch = None
    if can_die:
        # the check and the decide read the same state: one search
        ch = _choose(ctx, mode, p, wl, s, tree, rate_threshold, alive, False)
        can_decide = can_decide & _feasible(mode, ch)
    d = gate & can_decide
    s = _decide(ctx, mode, p, wl, s, _choose(ctx, mode, p, wl, s, tree,
                                            rate_threshold, alive, True, ch),
                d)

    # advance when nothing else can fire after this step's phases: a
    # decide leaves finish > now, but it can lower the next finish (kills
    # and drops touch fin_seg too). After the final completion the
    # one-event loop exits without advancing, hence the n_done guard.
    if can_kill or has_deadline:
        next_fin = _lanes(s.fin_seg, ctx.S).amin(1)
    else:
        next_fin = torch.where(d, _lanes(s.fin_seg, ctx.S).amin(1), next_fin)
    if can_die:
        blocked = ~((s.ready_cnt > 0) & _feasible(mode, _choose(
            ctx, mode, p, wl, s, tree, rate_threshold, alive, False)))
    else:
        blocked = s.ready_cnt == 0
    adv = gate & blocked & (s.n_done < wl.n_tasks)
    next_arr = torch.where(
        s.arr_ptr < wl.n_insts,
        _take(ctx, wl.inst_arrival, s.arr_ptr.clamp_max(I - 1)), _INF)
    nxt = torch.minimum(next_fin, next_arr)
    if can_die or can_kill or has_deadline:
        nxt = torch.minimum(nxt, _next_wakeup(ctx, plan, wl, s, fcaps))
    stuck = ~torch.isfinite(nxt)
    nxt = torch.where(stuck, s.now, nxt)
    s = s._replace(now=torch.where(adv, torch.maximum(nxt, s.now), s.now),
                   stalled=s.stalled | (adv & stuck))
    ev = ev + a.long() + d.long() + adv.long()
    return s, ev


def _finalize(ctx: _Ctx, wl: FlatWorkload, s: SimState, iters: torch.Tensor,
              max_iters) -> SimResult:
    S, I = ctx.S, ctx.I
    i32 = torch.int32
    dev = ctx.lane.device
    finish = _lanes(s.finish, S)
    valid_fin = torch.where(wl.task_valid, finish, _NEG)
    # per-instance latency: segment-max of finish over each instance
    inst_fin = torch.full((S, I), _NEG, device=dev).scatter_reduce(
        1, wl.inst_id, valid_fin, "amax")
    kept = wl.inst_valid
    if s.job_dropped is not None:
        # dropped jobs have no latency: out of the mean
        kept = kept & ~_lanes(s.job_dropped, S)
    inst_exec = torch.where(kept, inst_fin - wl.inst_arrival, float("nan"))
    avg_exec = torch.nanmean(inst_exec, 1)
    total_e = s.task_energy + s.sched_energy
    if s.job_dropped is None:
        zero_i = torch.zeros(S, dtype=i32, device=dev)
        zero_f = torch.zeros(S, dtype=torch.float32, device=dev)
        faults = dict(
            n_faults=zero_i, n_retries=zero_i, reexec_us=zero_f,
            n_dropped_jobs=zero_i, n_dropped_tasks=zero_i,
            recovery_us=zero_f, n_recovered=zero_i,
            job_dropped=torch.zeros((S, I), dtype=torch.bool, device=dev))
    else:
        dropped = _lanes(s.job_dropped, S)
        faults = dict(
            n_faults=s.n_kills.to(i32), n_retries=s.n_retries.to(i32),
            reexec_us=s.reexec_us, n_dropped_jobs=dropped.sum(1).to(i32),
            n_dropped_tasks=s.n_dropped_tasks.to(i32),
            recovery_us=s.recovery_us, n_recovered=s.n_recovered.to(i32),
            job_dropped=dropped)
    # `>=`: a super-step retires several events and may pass the cap
    budget = (iters >= max_iters) & (s.n_done < wl.n_tasks)
    return SimResult(
        avg_exec_us=avg_exec,
        makespan_us=valid_fin.amax(1),
        total_energy_uj=total_e,
        task_energy_uj=s.task_energy,
        sched_energy_uj=s.sched_energy,
        sched_time_us=s.sched_time,
        edp=total_e * avg_exec,
        n_decisions=s.d_ptr.to(i32),
        n_fast=s.n_fast.to(i32),
        n_slow=s.n_slow.to(i32),
        n_done=s.n_done.to(i32),
        ready_drop=s.ready_drop.to(i32),
        n_iters=iters.to(i32),
        stalled=s.stalled,
        inst_exec_us=inst_exec,
        log_feat=_lanes(s.log_feat, S),
        log_policy=_lanes(s.log_policy, S),
        log_agree=_lanes(s.log_agree, S),
        log_task=_lanes(s.log_task, S).to(i32),
        finish=finish,
        pe_of=_lanes(s.pe_of, S).to(i32),
        stall_reason=torch.where(
            s.stalled, STALL_DEADLOCK,
            torch.where(budget, STALL_BUDGET, STALL_NONE)).to(i32),
        **faults,
    )


def _engine_workload(wl: FlatWorkload, device) -> FlatWorkload:
    """Stacked workload as tensors on `device`, index fields in int64."""
    wl = to_device(wl, device)
    return FlatWorkload(*[x.long() if x.dtype == torch.int32 else x
                          for x in wl])


def _running(wl: FlatWorkload, s: SimState, it: torch.Tensor,
             max_iters) -> torch.Tensor:
    """[S] bool: lanes with work left, not stalled and within budget
    (`max_iters` an int, or [S] under a plan)."""
    return (s.n_done < wl.n_tasks) & ~s.stalled & (it < max_iters)


def _block(ctx: _Ctx, mode: int, p: SimParams, s: SimState,
           wl: FlatWorkload, tree: DTree, rate_threshold: torch.Tensor,
           it: torch.Tensor, max_iters, plan: flt.FaultPlan | None = None,
           fcaps: tuple = flt.NO_CAPS, active: torch.Tensor | None = None):
    """`POLL_EVERY` super-steps, each gated by `_running`; returns (s, it).
    No host sync: a finished lane is frozen by its gate. `active` ([S]
    i64), when given, counts in place the super-steps each lane ran."""
    for _ in range(POLL_EVERY):
        run = _running(wl, s, it, max_iters)
        if active is not None:
            active.add_(run)
        s, ev = _masked_step(ctx, mode, p, s, wl, tree, rate_threshold,
                             run, plan, fcaps)
        it = it + ev
    return s, it


def _capture(block, s: SimState, it: torch.Tensor):
    """Record `block(s, it)` in one CUDA graph whose result is copied back
    into `s` and `it`, which become the graph's static buffers (the flat
    buffers are updated in place already; the per-lane scalars that the
    block rebinds are copied). Returns `replay()`, which runs the block
    once more from the buffers' current values.

    Capture launches nothing, so the decision kernels' launches recorded
    during capture are taken out of `LAUNCHES` and added back once per
    replay. The graph records on the current stream and checks only this
    thread's calls (`thread_local`), so a capture on another card, in
    another thread, does not break it. A capture that fails raises, its
    graph is dropped and `LAUNCHES` is left as it was found; nothing falls
    back to eager."""
    counts = _kops.LAUNCHES
    before = dict(counts)
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g, stream=torch.cuda.current_stream(),
                              capture_error_mode="thread_local"):
            out, out_it = block(s, it)
            for buf, new in zip(s, out):
                if new is not buf:
                    buf.copy_(new)
            it.copy_(out_it)
        per_replay = {k: counts[k] - n for k, n in before.items()}
    finally:
        counts.update(before)

    def replay() -> None:
        g.replay()
        for k, n in per_replay.items():
            counts[k] += n

    return replay


def _fault_iter_bound(base: int, ctx: _Ctx, plan: flt.FaultPlan):
    """[S] iteration cap with fault headroom: every retry re-runs up to 4
    events for its task, each PE adds at most its glitches plus its fail
    and repair stops, and drops and deadlines retire at most one extra
    event an instance."""
    return (base + 4 * ctx.T * (plan.max_retries + 2)
            + ctx.P * (flt.MAX_TRANSIENTS + 2) + 2 * ctx.I + 64)


class Stopped(RuntimeError):
    """The caller's `stop` flag was set; the sweep ended at a poll."""


def _simulate(mode: int, params: SimParams, wls: FlatWorkload, tree: DTree,
              rate_threshold: torch.Tensor, telemetry: list | None,
              graph: bool, plan: flt.FaultPlan | None = None,
              step_budget: int | None = None, stop=None) -> SimResult:
    dev = params.exec_pe.device
    if dev.type != "cuda":
        return _simulate_on(mode, params, wls, tree, rate_threshold,
                            telemetry, graph, plan, step_budget, stop)
    # a stream of its own, which the graph records on: the caller's work
    # is waited for first, and the stream is drained before return
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    try:
        with torch.cuda.stream(stream):
            res = _simulate_on(mode, params, wls, tree, rate_threshold,
                               telemetry, graph, plan, step_budget, stop)
    except BaseException:
        try:
            stream.synchronize()
        except RuntimeError:
            pass        # the error being raised says more
        raise
    stream.synchronize()
    return res


def _simulate_on(mode: int, params: SimParams, wls: FlatWorkload,
                 tree: DTree, rate_threshold: torch.Tensor,
                 telemetry: list | None, graph: bool,
                 plan: flt.FaultPlan | None, step_budget: int | None,
                 stop) -> SimResult:
    dev = params.exec_pe.device
    wl = _engine_workload(wls, dev)
    fcaps = flt.NO_CAPS if plan is None else flt.plan_capabilities(plan)
    ctx = _make_ctx(params, wl, drops=fcaps[1] or fcaps[2])
    max_iters = 3 * ctx.T + ctx.I + 64
    pe_slow = None
    if plan is not None:
        # the plan's tensors live on the device before any graph records
        plan = flt.to_device(plan, dev, ctx.S)
        max_iters = _fault_iter_bound(max_iters, ctx, plan)
        pe_slow = flt.pe_slowdown(plan, params.pe_cluster)
    if step_budget is not None:
        # a device-side budget: lanes that reach it report STALL_BUDGET
        max_iters = (torch.clamp_max(max_iters, step_budget)
                     if torch.is_tensor(max_iters)
                     else min(max_iters, step_budget))
    s = _init_state(ctx, wl, pe_slow)
    it = torch.zeros(ctx.S, dtype=torch.int64, device=dev)
    # the occupancy counter is recorded into the step only when asked for
    active = (None if telemetry is None
              else torch.zeros(ctx.S, dtype=torch.int64, device=dev))

    def block(st, i):
        return _block(ctx, mode, params, st, wl, tree, rate_threshold, i,
                      max_iters, plan, fcaps, active)

    # poll any(running) (a host sync) before every block of POLL_EVERY;
    # with `graph`, the first block runs eagerly (the warm-up that loads
    # every library) and the next one is captured, then replayed. A set
    # `stop` (a `threading.Event`) ends the sweep at the next poll.
    steps, replay = 0, None
    while bool(_running(wl, s, it, max_iters).any()):
        if stop is not None and stop.is_set():
            raise Stopped(f"stopped after {steps} super-steps")
        if graph and steps and replay is None:
            replay = _capture(block, s, it)
        if replay is None:
            s, it = block(s, it)
        else:
            replay()
        steps += POLL_EVERY
    res = _finalize(ctx, wl, s, it, max_iters)
    if telemetry is not None:
        # occupancy: lane-super-steps run against those on which the
        # lane was still running (counted on the device by `_block`)
        telemetry.append({"lanes": ctx.S, "steps": steps,
                          "events": int(it.sum()),
                          "lane_trips": ctx.S * steps,
                          "active_trips": int(active.sum())})
    return res


def simulate_batch(mode: int, params: SimParams, wls: FlatWorkload,
                   tree: DTree, rate_threshold: torch.Tensor,
                   telemetry: list | None = None,
                   plan: flt.FaultPlan | None = None,
                   step_budget: int | None = None, stop=None) -> SimResult:
    """Run S scenarios to completion in one batch.

    `wls` is a stacked host workload (`workloads.stack_workloads`,
    leading `[S]` axis); it is moved to the params' device. `tree` fields
    are `[3]/[3]/[4]` or `[S, ...]`; `rate_threshold` is `[S]` f32. `plan`
    is a validated host `faults.FaultPlan`, shared or stacked along `[S]`;
    `step_budget` caps each lane's events (`STALL_BUDGET`). When
    `telemetry` is a list, a record of this call's lanes, super-steps and
    retired events is appended. On a CUDA device the first block of
    super-steps runs eagerly and the rest replay it from a CUDA graph, on
    a stream of the call's own. `stop` (a `threading.Event`), once set,
    makes the call raise `Stopped` at its next poll.
    """
    return _simulate(mode, params, wls, tree, rate_threshold, telemetry,
                     params.exec_pe.device.type == "cuda", plan, step_budget,
                     stop)


def _simulate_eager(mode: int, params: SimParams, wls: FlatWorkload,
                    tree: DTree, rate_threshold: torch.Tensor,
                    telemetry: list | None = None,
                    plan: flt.FaultPlan | None = None,
                    step_budget: int | None = None,
                    stop=None) -> SimResult:
    """`simulate_batch` with every block run eagerly, on any device: the
    same kernels in the same order, for holding the captured path to it."""
    return _simulate(mode, params, wls, tree, rate_threshold, telemetry,
                     False, plan, step_budget, stop)


def result_at(res: SimResult, i: int) -> SimResult:
    """Slice scenario `i` out of a batched `SimResult`."""
    return SimResult(*[x[i] for x in res])


def to_numpy(res: SimResult) -> SimResult:
    """The same result with every field as a host numpy array."""
    return SimResult(*[x.cpu().numpy() for x in res])


def run(mode: int, wl: FlatWorkload, params: SimParams | None = None,
        tree: DTree | None = None, rate_threshold: float = 1e9, plan=None,
        step_budget: int | None = None, device="cuda") -> SimResult:
    """Simulate one scenario (host numpy workload ok): the batched engine
    with S = 1. `plan` is an unbatched `faults.FaultPlan`. Every result
    field is a scalar or unbatched array."""
    if plan is not None and flt.is_batched(plan):
        raise ValueError("run: got a batched FaultPlan (leading scenario "
                         "axis); use run_batch for plan sweeps")
    res = run_batch(mode, stack_workloads([wl]), params, tree=tree,
                    rate_threshold=rate_threshold, plan=plan,
                    step_budget=step_budget, device=device)
    return result_at(res, 0)


def run_batch(mode: int, wls, params: SimParams | None = None,
              tree: DTree | None = None, rate_threshold=1e9,
              batch_size: int | None = None, plan=None,
              step_budget: int | None = None, device="cuda",
              telemetry: list | None = None, devices=None,
              stop=None) -> SimResult:
    """Batched sweep over a scenario axis, split over `devices`.

    `wls` is a list of same-shape `FlatWorkload`s or an already-stacked
    one (host numpy, as `workloads` builds them). `tree` (fields with a
    leading `[S]` axis), `rate_threshold` (an `[S]` array) and `plan` (a
    `faults.FaultPlan`, stacked with `faults.stack_plans`) may vary per
    scenario; a plan without the axis is shared. `step_budget` caps each
    scenario's events. `batch_size` cuts the axis into fixed-shape
    chunks; the final chunk is padded by replaying the last scenario and
    the pad lanes are dropped, so every chunk has the same shape.

    `devices` (see `_resolve_devices`; default `REPRO_BENCH_DEVICES`, else
    every visible card for `device="cuda"`) splits each chunk's scenario
    axis into equal parts, one a device (the chunk is rounded up to a
    multiple of their count). Each part runs on its device, on a stream
    and a captured graph of its own; parts on distinct cards run at the
    same time, parts on a repeated device one after another. Lanes never
    interact, so per-scenario results do not depend on the chunking, the
    padding or the devices, bit for bit. Returns a `SimResult` of tensors
    on `device`. When `telemetry` is a list, one record per part is
    appended; `stop` is passed to each part (`simulate_batch`).
    """
    return _run_batch(simulate_batch, mode, wls, params, tree,
                      rate_threshold, batch_size, plan, step_budget, device,
                      telemetry, devices, stop)


def _resolve_devices(devices=None, device="cuda") -> tuple:
    """The `devices=` knob as a tuple of `torch.device`s. `None` reads
    `REPRO_BENCH_DEVICES` when set, else takes every visible card when
    `device` is `"cuda"` (no index), or else the one device named; an int
    k takes the first k cards (on the CPU only 1 is in range); a sequence
    of devices passes through, repeats allowed."""
    if devices is None:
        raw = os.environ.get("REPRO_BENCH_DEVICES")
        if raw is not None and raw.strip():
            try:
                devices = int(raw.strip())
            except ValueError:
                raise ValueError(
                    f"REPRO_BENCH_DEVICES={raw!r} is not an integer"
                ) from None
    dev = resolve(device)
    cards = (tuple(torch.device("cuda", i)
                   for i in range(torch.cuda.device_count()))
             if dev.type == "cuda" else (dev,))
    if devices is None:
        return cards if dev.type == "cuda" and dev.index is None else (dev,)
    if isinstance(devices, int):
        if not 1 <= devices <= len(cards):
            raise ValueError(f"devices={devices} out of range "
                             f"(1..{len(cards)} available)")
        return cards[:devices]
    return tuple(resolve(d) for d in devices)


def _on_device(dev: torch.device):
    """Make `dev` the thread's current CUDA device (no-op on the CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _run_batch(simulate, mode: int, wls, params: SimParams | None = None,
               tree: DTree | None = None, rate_threshold=1e9,
               batch_size: int | None = None, plan=None,
               step_budget: int | None = None, device="cuda",
               telemetry: list | None = None, devices=None,
               stop=None) -> SimResult:
    """`run_batch` with each part run by `simulate` (`simulate_batch`, or
    `_simulate_eager` to hold the captured path to the eager one)."""
    if batch_size is not None and batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    dev = resolve(device)
    devs = _resolve_devices(devices, device)
    params = SimParams(*[x.to(dev) for x in (params or make_params(
        device=dev))])
    tree = DTree(*[torch.as_tensor(x, device=dev)
                   for x in (tree or always_fast_tree(dev))])
    stacked = wls if isinstance(wls, FlatWorkload) else stack_workloads(wls)
    n = int(stacked.task_type.shape[0])
    thr = torch.as_tensor(rate_threshold, dtype=torch.float32, device=dev)
    thr = thr.expand(n) if thr.dim() == 0 else thr
    if thr.shape != (n,):
        raise ValueError(f"rate_threshold: expected a scalar or [{n}], got "
                         f"{tuple(thr.shape)}")
    tree_b = tree.feat.dim() == 2
    if not tree_b:
        tree = DTree(*[x.expand(n, *x.shape) for x in tree])
    elif tree.feat.shape[0] != n:
        raise ValueError(f"tree: {tree.feat.shape[0]} trees for {n} "
                         "scenarios")
    plan_b = False
    if plan is not None:
        flt.validate_plan(plan, n_pes=params.pe_cluster.shape[0],
                          n_clusters=params.cluster_pe_mask.shape[0])
        plan = flt.FaultPlan(*[np.asarray(x) for x in plan])
        plan_b = flt.is_batched(plan)
        if plan_b and plan.pe_fail_at.shape[0] != n:
            raise ValueError(
                f"run_batch: batched plan has {plan.pe_fail_at.shape[0]} "
                f"scenarios but the workload has {n}")

    # the chunk: clamped to n, rounded up to a multiple of the devices
    D = len(devs)
    B = n if batch_size is None else min(batch_size, n)
    B = -(-B // D) * D
    b = B // D
    n_pad = -(-n // B) * B
    # pad lanes replay the last real scenario; their results are dropped
    pad_idx = np.minimum(np.arange(n_pad), n - 1)
    on_dev = {d: SimParams(*[x.to(d) for x in params]) for d in set(devs)}

    def run_part(d: torch.device, ids: np.ndarray) -> SimResult:
        tids = torch.as_tensor(ids, device=dev)
        part = FlatWorkload(*[np.asarray(x)[ids] for x in stacked])
        part_plan = (flt.FaultPlan(*[x[ids] for x in plan]) if plan_b
                     else plan)
        with _on_device(d):
            return simulate(
                mode, on_dev[d], part,
                DTree(*[x[tids].to(d) for x in tree]), thr[tids].to(d),
                telemetry=telemetry, plan=part_plan,
                step_budget=step_budget, stop=stop)

    def run_parts(parts: list) -> list:
        return [run_part(d, ids) for d, ids in parts]

    chunks = []
    for lo in range(0, n_pad, B):
        parts = [(d, pad_idx[lo + k * b:lo + (k + 1) * b])
                 for k, d in enumerate(devs)]
        if D == 1:
            out = run_parts(parts)
        else:
            # one thread a device, each running its parts in order, so
            # parts on distinct cards overlap; every thread is joined
            by_dev: dict = {}
            for k, (d, _) in enumerate(parts):
                by_dev.setdefault(d, []).append(k)
            out = [None] * D
            with concurrent.futures.ThreadPoolExecutor(len(by_dev)) as ex:
                futs = [(ks, ex.submit(run_parts, [parts[k] for k in ks]))
                        for ks in by_dev.values()]
                for ks, fut in futs:
                    for k, r in zip(ks, fut.result()):
                        out[k] = r
        chunks.extend(SimResult(*[x.to(dev) for x in r]) for r in out)
    if len(chunks) == 1:
        return chunks[0]
    return SimResult(*[torch.cat(xs, 0)[:n] for xs in zip(*chunks)])
