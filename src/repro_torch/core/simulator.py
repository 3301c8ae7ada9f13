"""Scenario-batched discrete-event DSSoC simulator (DS3-style) in PyTorch.

The port of `repro/core/simulator.py` without the fault path. Each
scenario (one workload mix at one data rate) retires events in the
reference's priority order:

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
(`_masked_step`) with its scenario axis `[S]` written out, driven by a
Python loop. Each super-step runs the four phases with gates re-derived
after each phase, so it retires the same event sequence as the
reference's one-event-per-iteration loop, and `n_iters` still counts
events. `run` is the engine with S = 1; `run_batch` cuts a sweep into
fixed-shape chunks. Finished lanes are frozen by the `run` gate, so the
loop polls `any(running)` (a host sync) only every `POLL_EVERY` steps.

Every per-lane buffer that takes gated row writes is stored flat, as
`[S * N + 1, ...]`: lane s owns rows `s*N .. s*N + N - 1`, and the last
row absorbs the writes of inactive lanes (the reference drops them with
an out-of-bounds `mode="drop"` scatter). `_lanes` gives the contiguous
`[S, N, ...]` view. The buffers are updated in place; per-lane scalars
are replaced.

The two decision kernels (`kernels/etf_ft`) run on every decide and
every completion phase: on a CUDA device the hand-written kernels, on
the CPU their plain versions. All float operations keep the reference's
order. The one place where XLA on the CPU fuses a multiply-add that sets
the schedule, the ETF latency polynomial, is a table
(`soc.ETF_LAT_TABLE`). The energy accumulators are fused by XLA too;
they do not feed the schedule, and agree with the reference to a
relative 1e-6.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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


class SimResult(NamedTuple):
    """Per-scenario results; every field has a leading [S] axis. The
    fault fields are all zero until the fault path is ported."""

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


def _make_ctx(p: SimParams, wl: FlatWorkload) -> _Ctx:
    dev = p.exec_pe.device
    S, T = wl.task_type.shape
    I = wl.inst_arrival.shape[1]

    def ar(n):
        return torch.arange(n, device=dev)

    return _Ctx(
        S=S, T=T, Tp=-(-T // SEG) * SEG, I=I, P=p.pe_cluster.shape[0],
        C=p.cluster_pe_mask.shape[0], lane=ar(S), ar_r=ar(R_MAX),
        ar_seg=ar(SEG), ar_mp=ar(wl.preds.shape[2]),
        ar_ms=ar(wl.succs.shape[2]), ar_mr=ar(wl.inst_roots.shape[2]),
        first_pe=p.cluster_pe_mask.int().argmax(1),
        lut_cluster=p.lut_cluster.long(),
        etf_lat=torch.as_tensor(soc.ETF_LAT_TABLE, device=dev))


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
def _avail_rows(ctx: _Ctx, p: SimParams, wl: FlatWorkload, s: SimState,
                tasks: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """[S, K, P] availability (incl. NoC transfer from pred clusters),
    through the push-rows kernel. Evaluated once per task at push time:
    a task enters the ready queue only when every predecessor has
    finished, so the row is constant from then on."""
    S = ctx.S
    K = tasks.shape[1]
    preds = _take(ctx, wl.preds, tasks)                     # [S, K, MP]
    mp = preds.shape[2]
    pv = ctx.ar_mp < _take(ctx, wl.n_preds, tasks)[..., None]
    pidx = preds.clamp_min(0).reshape(S, K * mp)
    pfin = torch.where(
        pv, _lanes(s.finish, S).gather(1, pidx).view(S, K, mp), _NEG)
    pkb = torch.where(pv, wl.out_kb.gather(1, pidx).view(S, K, mp), 0.0)
    pcl = p.pe_cluster[
        _lanes(s.pe_of, S).gather(1, pidx).clamp_min(0)].view(S, K, mp)
    return _kops.push_rows(pfin, pkb * p.us_per_kb, pcl, pv, p.pe_cluster,
                           bases, ctx.C)


def _etf_choice(ctx: _Ctx, s: SimState):
    """Earliest-finish-time (slot, pe) over the ready buffer (Algorithm 1),
    through the masked search kernel (first global minimum)."""
    S = ctx.S
    ids = _lanes(s.ready_ids, S)
    slot, pe, _ = _kops.etf_decide(_lanes(s.ready_avail, S),
                                   _lanes(s.pe_free, S),
                                   _lanes(s.ready_exec, S), s.now,
                                   ids >= 0, None)
    return slot.long(), pe.long()


def _lut_choice(ctx: _Ctx, p: SimParams, wl: FlatWorkload, s: SimState):
    """Fast scheduler: FIFO head -> most-energy-efficient cluster -> its
    earliest-free PE."""
    S = ctx.S
    t = _lanes(s.ready_ids, S)[:, 0].clamp_min(0)
    cl = ctx.lut_cluster[_take(ctx, wl.task_type, t)]
    free = torch.where(p.cluster_pe_mask[cl], _lanes(s.pe_free, S), _INF)
    return torch.zeros_like(t), free.argmin(1)


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
        rows_avail = _avail_rows(ctx, p, wl, s, t, bases)  # [S, K, P]
    rows_exec = p.exec_pe[_take(ctx, wl.task_type, t)]    # [S, K, P]
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
    return _pop_slot(ctx, s, slot, active)


def _process_completion(ctx: _Ctx, p: SimParams, wl: FlatWorkload,
                        s: SimState, active: torch.Tensor,
                        t: torch.Tensor) -> SimState:
    S = ctx.S
    act = active.long()
    _gfill(s.status, ctx, active, t, 4)
    _gfill(s.fin_run, ctx, active, t, _INF)
    s = s._replace(n_running=s.n_running - act, n_done=s.n_done + act)
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
# the engine
# ---------------------------------------------------------------------------
def _init_state(ctx: _Ctx, wl: FlatWorkload) -> SimState:
    S, T, Tp, P = ctx.S, ctx.T, ctx.Tp, ctx.P
    dev = ctx.lane.device
    f32, i64 = torch.float32, torch.int64

    def flat(n, *row, fill=0, dtype=f32):
        return torch.full((S * n + 1, *row), fill, dtype=dtype, device=dev)

    def lane(fill=0, dtype=i64):
        return torch.full((S,), fill, dtype=dtype, device=dev)

    pred_rem = flat(T, dtype=i64)
    _lanes(pred_rem, S).copy_(wl.n_preds)
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
    )


def _decide(ctx: _Ctx, mode: int, p: SimParams, wl: FlatWorkload,
            s: SimState, tree: DTree, rate_threshold: torch.Tensor,
            active: torch.Tensor) -> SimState:
    feats = _features(ctx, p, wl, s)
    etf_lat = ctx.etf_lat[s.ready_cnt]
    etf_e = etf_lat * float(soc.SCHED_POWER_W)
    lut_lat = float(soc.LUT_LATENCY_US)
    lut_e = float(soc.LUT_ENERGY_UJ)
    zero = torch.zeros_like(s.ready_cnt)

    if mode == MODE_LUT:
        slot, pe = _lut_choice(ctx, p, wl, s)
        return _assign(ctx, p, s, slot, pe, lut_lat, lut_e, zero, feats,
                       zero, active)
    if mode == MODE_ETF:
        slot, pe = _etf_choice(ctx, s)
        return _assign(ctx, p, s, slot, pe, etf_lat, etf_e, zero + 1, feats,
                       zero, active)
    if mode == MODE_ETF_IDEAL:
        slot, pe = _etf_choice(ctx, s)
        return _assign(ctx, p, s, slot, pe, 0.0, 0.0, zero + 1, feats, zero,
                       active)
    if mode == MODE_ORACLE:
        # run both, follow the fast one, log whether they agree
        slot_f, pe_f = _lut_choice(ctx, p, wl, s)
        slot_s, pe_s = _etf_choice(ctx, s)
        ids = _lanes(s.ready_ids, ctx.S)
        agree = ((_take(ctx, ids, slot_f) == _take(ctx, ids, slot_s))
                 & (pe_f == pe_s)).long()
        return _assign(ctx, p, s, slot_f, pe_f, lut_lat, lut_e, zero, feats,
                       agree, active)

    if mode == MODE_DAS:
        use_slow = tree.predict(feats).bool()
        cls_e = float(soc.DAS_CLS_ENERGY_UJ)
    elif mode == MODE_THRESHOLD:
        use_slow = feats[:, FEAT_RATE] >= rate_threshold
        cls_e = 0.0
    else:
        raise ValueError(f"unknown mode {mode}")

    slot_f, pe_f = _lut_choice(ctx, p, wl, s)
    slot_s, pe_s = _etf_choice(ctx, s)
    slot = torch.where(use_slow, slot_s, slot_f)
    pe = torch.where(use_slow, pe_s, pe_f)
    lat = torch.where(use_slow, etf_lat, lut_lat)
    e = torch.where(use_slow, etf_e, lut_e) + cls_e
    return _assign(ctx, p, s, slot, pe, lat, e, use_slow.long(), feats, zero,
                   active)


def _masked_step(ctx: _Ctx, mode: int, p: SimParams, s: SimState,
                 wl: FlatWorkload, tree: DTree, rate_threshold: torch.Tensor,
                 run: torch.Tensor):
    """One super-step of gated phases; returns (s, ev).

    Phases run in the reference's priority order (completion > arrival >
    decide > advance) with gates re-derived after each phase, so one step
    retires several consecutive events when they would have fired
    back-to-back anyway; `ev` (events retired, 0..4) keeps `n_iters`
    equal to the event count. `run=False` freezes a lane.
    """
    I = ctx.I
    fin_idx, fin_val = _next_completion(ctx, s)
    c = run & (fin_val <= s.now)
    s = _process_completion(ctx, p, wl, s, c, fin_idx)

    # a completion tie leaves another completion due: everything below
    # waits for the next step, as the one-event loop would
    next_fin = _lanes(s.fin_seg, ctx.S).amin(1)
    no_c = ~(next_fin <= s.now)

    def arr_due(st):
        return (st.arr_ptr < wl.n_insts) & (
            _take(ctx, wl.inst_arrival, st.arr_ptr.clamp_max(I - 1)) <= st.now)

    a = run & no_c & arr_due(s)
    s = _process_arrival(ctx, p, wl, s, a)

    # same-timestamp arrivals: the next one blocks the decide phase
    no_a = ~arr_due(s)
    d = run & no_c & no_a & (s.ready_cnt > 0)
    s = _decide(ctx, mode, p, wl, s, tree, rate_threshold, d)

    # advance when nothing else can fire after this step's phases: a
    # decide leaves finish > now, but it can lower the next finish. After
    # the final completion the one-event loop exits without advancing,
    # hence the n_done guard.
    next_fin = torch.where(d, _lanes(s.fin_seg, ctx.S).amin(1), next_fin)
    adv = (run & no_c & no_a & (s.ready_cnt == 0)
           & (s.n_done < wl.n_tasks))
    next_arr = torch.where(
        s.arr_ptr < wl.n_insts,
        _take(ctx, wl.inst_arrival, s.arr_ptr.clamp_max(I - 1)), _INF)
    nxt = torch.minimum(next_fin, next_arr)
    stuck = ~torch.isfinite(nxt)
    nxt = torch.where(stuck, s.now, nxt)
    s = s._replace(now=torch.where(adv, torch.maximum(nxt, s.now), s.now),
                   stalled=s.stalled | (adv & stuck))
    ev = c.long() + a.long() + d.long() + adv.long()
    return s, ev


def _finalize(ctx: _Ctx, wl: FlatWorkload, s: SimState, iters: torch.Tensor,
              max_iters: int) -> SimResult:
    S, I = ctx.S, ctx.I
    i32 = torch.int32
    dev = ctx.lane.device
    finish = _lanes(s.finish, S)
    valid_fin = torch.where(wl.task_valid, finish, _NEG)
    # per-instance latency: segment-max of finish over each instance
    inst_fin = torch.full((S, I), _NEG, device=dev).scatter_reduce(
        1, wl.inst_id, valid_fin, "amax")
    inst_exec = torch.where(wl.inst_valid, inst_fin - wl.inst_arrival,
                            float("nan"))
    avg_exec = torch.nanmean(inst_exec, 1)
    total_e = s.task_energy + s.sched_energy
    zero_i = torch.zeros(S, dtype=i32, device=dev)
    zero_f = torch.zeros(S, dtype=torch.float32, device=dev)
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
        n_faults=zero_i, n_retries=zero_i, reexec_us=zero_f,
        n_dropped_jobs=zero_i, n_dropped_tasks=zero_i, recovery_us=zero_f,
        n_recovered=zero_i,
        job_dropped=torch.zeros((S, I), dtype=torch.bool, device=dev),
        stall_reason=torch.where(
            s.stalled, STALL_DEADLOCK,
            torch.where(budget, STALL_BUDGET, STALL_NONE)).to(i32),
    )


def _engine_workload(wl: FlatWorkload, device) -> FlatWorkload:
    """Stacked workload as tensors on `device`, index fields in int64."""
    wl = to_device(wl, device)
    return FlatWorkload(*[x.long() if x.dtype == torch.int32 else x
                          for x in wl])


def simulate_batch(mode: int, params: SimParams, wls: FlatWorkload,
                   tree: DTree, rate_threshold: torch.Tensor,
                   telemetry: list | None = None) -> SimResult:
    """Run S scenarios to completion in one batch.

    `wls` is a stacked host workload (`workloads.stack_workloads`,
    leading `[S]` axis); it is moved to the params' device. `tree` fields are `[3]/[3]/[4]` or `[S, ...]`;
    `rate_threshold` is `[S]` f32. When `telemetry` is a list, a record
    of this call's lanes, super-steps and retired events is appended.
    """
    wl = _engine_workload(wls, params.exec_pe.device)
    ctx = _make_ctx(params, wl)
    max_iters = 3 * ctx.T + ctx.I + 64
    s = _init_state(ctx, wl)
    it = torch.zeros(ctx.S, dtype=torch.int64, device=ctx.lane.device)
    steps = 0
    while True:
        run = (s.n_done < wl.n_tasks) & ~s.stalled & (it < max_iters)
        if steps % POLL_EVERY == 0 and not bool(run.any()):
            break
        s, ev = _masked_step(ctx, mode, params, s, wl, tree, rate_threshold,
                             run)
        it = it + ev
        steps += 1
    res = _finalize(ctx, wl, s, it, max_iters)
    if telemetry is not None:
        telemetry.append({"lanes": ctx.S, "steps": steps,
                          "events": int(it.sum())})
    return res


def result_at(res: SimResult, i: int) -> SimResult:
    """Slice scenario `i` out of a batched `SimResult`."""
    return SimResult(*[x[i] for x in res])


def to_numpy(res: SimResult) -> SimResult:
    """The same result with every field as a host numpy array."""
    return SimResult(*[x.cpu().numpy() for x in res])


def run(mode: int, wl: FlatWorkload, params: SimParams | None = None,
        tree: DTree | None = None, rate_threshold: float = 1e9, plan=None,
        device="cuda") -> SimResult:
    """Simulate one scenario (host numpy workload ok): the batched engine
    with S = 1. Every result field is a scalar or unbatched array."""
    res = run_batch(mode, stack_workloads([wl]), params, tree=tree,
                    rate_threshold=rate_threshold, plan=plan, device=device)
    return result_at(res, 0)


def run_batch(mode: int, wls, params: SimParams | None = None,
              tree: DTree | None = None, rate_threshold=1e9,
              batch_size: int | None = None, plan=None, device="cuda",
              telemetry: list | None = None) -> SimResult:
    """Batched sweep over a scenario axis.

    `wls` is a list of same-shape `FlatWorkload`s or an already-stacked
    one (host numpy, as `workloads` builds them). `tree` (fields with a leading `[S]` axis) and
    `rate_threshold` (an `[S]` array) may vary per scenario. `batch_size`
    cuts the axis into fixed-shape chunks; the final chunk is padded by
    replaying the last scenario and the pad lanes are dropped, so every
    chunk has the same shape and per-scenario results do not depend on
    the chunking. Returns a `SimResult` of tensors on `device`.
    """
    if plan is not None:
        raise NotImplementedError(
            "fault plans are not ported yet (ROADMAP queue 1: the fault "
            "half of the simulator and faults.py)")
    if batch_size is not None and batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    dev = resolve(device)
    params = SimParams(*[x.to(dev) for x in (params or make_params(
        device=dev))])
    tree = DTree(*[x.to(dev) for x in (tree or always_fast_tree(dev))])
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

    B = n if batch_size is None else min(batch_size, n)
    n_pad = -(-n // B) * B
    # pad lanes replay the last real scenario; their results are dropped
    pad_idx = np.minimum(np.arange(n_pad), n - 1)
    chunks = []
    for lo in range(0, n_pad, B):
        ids = pad_idx[lo:lo + B]
        tids = torch.as_tensor(ids, device=dev)
        part = FlatWorkload(*[np.asarray(x)[ids] for x in stacked])
        chunks.append(simulate_batch(
            mode, params, part, DTree(*[x[tids] for x in tree]), thr[tids],
            telemetry=telemetry))
    if len(chunks) == 1:
        return chunks[0]
    return SimResult(*[torch.cat(xs, 0)[:n] for xs in zip(*chunks)])
