"""Independent float64 reference simulator (differential oracle).

A frozen copy of the port's `core/ref_sim.py` that imports nothing of
the program: the SoC's tables and the scheduler's constants come from a
configuration file (`Soc.from_config`), and the workload is the plain
arrays that `reference/workloads.py` builds. Same event semantics as the
tensor simulator (completions due, then arrivals due, then one
scheduling decision, else advance) with plain lists and floats.

`precision="bfloat16"` rounds every simulated time, energy and table
entry to bfloat16 as it is made: the benchmark's control, the reference
one precision below the float32 that the configurations state.

DAS (`MODE_DAS`, `policy=`): at every decision a depth-2 tree in the
port's `DTree` layout (`feat` [3], `thr` [3], `leaf` [4]; node 0 the
root, node 1 its left child, node 2 its right; a feature `>=` its
threshold goes right; leaf 1 = the slow scheduler) reads two features
of the state and picks LUT (0) or ETF (1); the decision takes the
chosen scheduler's latency, and its energy plus the classifier's
(`CLS_ENERGY_UJ`, the port's constant). The two features are the paper's pair,
at the port's feature-bank indices:
  * 0, the input data rate: (n - 1) frames of `FRAME_KBITS` over the
    span of the last n <= `RATE_RING` arrival times, in Mbps
    (kbit/us x 1000), 0 before the second arrival; the span is at least
    1e-3 us,
  * 2, the big cluster's earliest availability: the least over cluster
    0's PEs of max(pe_free - now, 0), dead PEs included.
Departures from the port: every time and feature is float64 (the port's
are float32, so a feature within float32 rounding of a threshold may
take the other branch); the two features are worked out from the
scheduler's state where the port keeps a ring of the last 8 arrival
times and computes its whole 62-feature bank at every decision; a node
whose threshold is infinite (pass-through) goes left without reading its
feature, as the port's does for any finite feature.

Tie-breaking contracts replicated exactly:
  * completions: earliest (finish, task-id),
  * LUT: FIFO head task; earliest-free PE within the LUT cluster
    (lowest PE id on ties),
  * ETF: scan ready slots in FIFO order x PEs ascending; strict '<' keeps
    the first minimum (the first minimum of the flattened [R, P] matrix).

Fault mirror (`plan=`): the same event classes and priority order as the
tensor simulator's fault path (completion > kill > deadline > arrival >
decide > advance) with identical tie-breaks:
  * kill: earliest fault instant revoking a live assignment
    (`assign_t < tau <= now` on a running task's PE), lowest task id on
    ties; executed work is wasted, the unexecuted tail rolls back its
    energy; within the retry budget the task re-enters the FIFO tail
    re-based at `now`, past it the whole job drops,
  * deadline: earliest arrived-but-incomplete instance past
    `arrival + deadline_us` drops every unfinished task,
  * degraded LUT: most energy-efficient cluster with a live PE,
  * degraded ETF: dead PEs skipped; infeasible decisions fall through to
    advance, whose targets include strictly-future fault/repair instants
    and pending deadlines.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from dasbench.reference.workloads import FRAME_KBITS

# scheduler modes, by the names the configurations and traffic use
MODES = {"LUT": 0, "ETF": 1, "ETF-ideal": 2, "DAS": 3}
MODE_LUT, MODE_ETF, MODE_ETF_IDEAL, MODE_DAS = 0, 1, 2, 3
# the paper's feature pair, at the port's feature-bank indices
FEAT_RATE, FEAT_BIG_AVAIL = 0, 2
RATE_RING = 8               # arrival times the rate estimate spans
CLS_ENERGY_UJ = 0.0019      # the classifier's energy a DAS decision, uJ


def bf16(x):
    """`x` (a float or an array) rounded to bfloat16, nearest even, and
    returned as float64; infinities and NaN pass."""
    a = np.asarray(x, np.float64)
    b = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    r = np.where(np.isfinite(a), b.view(np.float32).astype(np.float64), a)
    return float(r) if r.ndim == 0 else r


def _exact(x):
    return x


@dataclasses.dataclass(frozen=True)
class Soc:
    """The hardware model as plain arrays, worked out from a
    configuration file's `soc` block."""

    pe_cluster: np.ndarray      # [P] int
    exec_time: np.ndarray       # [types, C] float32, inf = cannot run
    cluster_power: np.ndarray   # [C] float32
    task_energy: np.ndarray     # [types, C] float32
    lut_cluster: np.ndarray     # [types] most energy-efficient cluster
    us_per_kb: float
    lut_latency_us: np.float32
    lut_energy_uj: np.float32
    etf_lat: tuple              # (c0, c1, c2) float32
    sched_power_w: np.float32

    @property
    def n_pes(self) -> int:
        return int(self.pe_cluster.shape[0])

    @property
    def n_clusters(self) -> int:
        return int(self.cluster_power.shape[0])

    def exec_on_pe(self) -> np.ndarray:
        return self.exec_time[:, self.pe_cluster]

    def etf_latency_us(self, n):
        c0, c1, c2 = self.etf_lat
        return c0 + c1 * n + c2 * n * n

    @classmethod
    def from_config(cls, soc: dict) -> "Soc":
        f32 = np.float32
        pe_cluster = np.concatenate([
            np.full(n, c, np.int32)
            for c, n in enumerate(soc["pes_per_cluster"])])
        exec_time = np.array(
            [[np.inf if v is None else v for v in row]
             for row in soc["exec_time_us"]], np.float32)
        power = np.array(soc["cluster_power_w"], np.float32)
        energy = np.where(np.isfinite(exec_time), exec_time * power[None, :],
                          f32(np.inf)).astype(np.float32)
        sch = soc["scheduler"]
        return cls(pe_cluster=pe_cluster, exec_time=exec_time,
                   cluster_power=power, task_energy=energy,
                   lut_cluster=np.argmin(energy, axis=1).astype(np.int32),
                   us_per_kb=float(f32(soc["noc_us_per_kb"])),
                   lut_latency_us=f32(sch["lut_latency_us"]),
                   lut_energy_uj=f32(sch["lut_energy_uj"]),
                   etf_lat=tuple(f32(c) for c in sch["etf_latency_us"]),
                   sched_power_w=f32(sch["power_w"]))


def simulate_ref(mode: int, wl, cfg: Soc, plan=None,
                 precision: str = "float64", policy=None) -> Dict:
    """One scenario: `wl` has the fields of a flat workload (plain
    arrays), `plan` those of a fault plan or None, `policy` (DAS only)
    the tree (`feat`, `thr`, `leaf`). Under DAS the result also logs each
    decision's time, two features and pick (`log_now`, `log_rate`,
    `log_big_avail`, `log_slow`) and counts the slow picks (`n_slow`)."""
    if precision not in ("float64", "bfloat16"):
        raise ValueError(f"precision {precision!r}")
    q = bf16 if precision == "bfloat16" else _exact
    exec_pe = cfg.exec_on_pe()                    # [types, P]
    pe_cluster = cfg.pe_cluster
    pe_power = cfg.cluster_power[pe_cluster]
    if q is bf16:
        exec_pe = bf16(exec_pe)
        pe_power = bf16(pe_power)
        wl = wl._replace(inst_arrival=bf16(wl.inst_arrival))
    n_tasks = int(wl.n_tasks)
    n_inst = int(wl.n_insts)
    P = cfg.n_pes

    if plan is not None:
        fail_at = q(np.asarray(plan.pe_fail_at, float))
        repair_at = q(np.asarray(plan.pe_repair_at, float))
        kill_times = np.concatenate(
            [fail_at[:, None], q(np.asarray(plan.transient_at, float))],
            axis=1)
        pe_slow = q(np.asarray(plan.cluster_slowdown, float))[pe_cluster]
        max_retries = int(plan.max_retries)
        deadline_us = q(float(plan.deadline_us))
        fault_times = np.concatenate(
            [fail_at, repair_at, kill_times.reshape(-1)])
    else:
        pe_slow = np.ones(P)

    pred_rem = wl.n_preds.astype(int).copy()
    finish = np.full(n_tasks, np.inf)
    start = np.full(n_tasks, np.inf)
    pe_of = np.full(n_tasks, -1, int)
    status = np.zeros(n_tasks, int)       # 0 wait, 2 ready, 3 run, 4 done,
    #                                       5 dropped with its job
    ready_base = np.zeros(n_tasks)
    ready: List[int] = []                         # FIFO
    pe_free = np.zeros(P)
    pe_alive = np.ones(P, bool)
    now = 0.0
    sched_free = 0.0
    arr_ptr = 0
    n_done = 0
    task_energy = 0.0
    sched_energy = 0.0
    sched_time = 0.0
    # fault accounting
    assign_t = np.full(n_tasks, np.inf)
    retries = np.zeros(n_tasks, int)
    last_kill = np.zeros(n_tasks)
    inst_rem = np.zeros(n_inst, int)
    for t in range(n_tasks):
        inst_rem[int(wl.inst_id[t])] += 1
    job_dropped = np.zeros(n_inst, bool)
    n_kills = n_retries_tot = n_dropped_tasks = n_recovered = 0
    reexec_us = recovery_us = 0.0
    log_now: List[float] = []
    log_rate: List[float] = []
    log_big: List[float] = []
    log_slow: List[int] = []
    if mode == MODE_DAS:
        thr = [q(float(t)) for t in policy.thr]
        cls_e = q(float(np.float32(CLS_ENERGY_UJ)))
        big = np.where(pe_cluster == 0)[0]

    def rate_est() -> float:
        cnt = min(arr_ptr, RATE_RING)
        if cnt < 2:
            return 0.0
        span = max(q(float(wl.inst_arrival[arr_ptr - 1])
                     - float(wl.inst_arrival[arr_ptr - cnt])), 1e-3)
        return q((cnt - 1) * float(FRAME_KBITS) * 1000.0 / span)

    def big_avail() -> float:
        return min(max(q(pe_free[pe] - now), 0.0) for pe in big)

    def das_slow(feats: dict) -> int:
        """The tree's leaf for the features {index: value}."""
        def right(node):
            return bool(np.isfinite(thr[node])
                        and feats[int(policy.feat[node])] >= thr[node])
        r0 = right(0)
        return int(policy.leaf[(2 if r0 else 0)
                               + int(right(2 if r0 else 1))])

    def avail_comm(t: int, pe: int) -> float:
        base = ready_base[t]
        for k in range(int(wl.n_preds[t])):
            p = int(wl.preds[t, k])
            comm = (q(float(wl.out_kb[p]) * cfg.us_per_kb)
                    if pe_cluster[pe_of[p]] != pe_cluster[pe] else 0.0)
            base = max(base, q(finish[p] + comm))
        return base

    def lut_choice():
        t = ready[0]
        tt = int(wl.task_type[t])
        if plan is None:
            cl = int(cfg.lut_cluster[tt])
        else:
            # energy-ranked fallback over clusters with a live PE
            cl, best_e = -1, np.inf
            for c in range(cfg.n_clusters):
                if not (pe_alive & (pe_cluster == c)).any():
                    continue
                e = float(cfg.task_energy[tt, c])
                if e < best_e:
                    best_e, cl = e, c
            if not np.isfinite(best_e):
                return None
        pes = np.where((pe_cluster == cl) & pe_alive)[0]
        pe = int(pes[np.argmin(pe_free[pes])])
        return 0, pe

    def etf_choice():
        best = (np.inf, -1, -1)
        for slot, t in enumerate(ready):
            for pe in range(P):
                if not pe_alive[pe]:
                    continue
                e = q(exec_pe[wl.task_type[t], pe] * pe_slow[pe])
                if not np.isfinite(e):
                    continue
                ft = q(max(avail_comm(t, pe), pe_free[pe], now) + e)
                if ft < best[0]:
                    best = (ft, slot, pe)
        if best[1] < 0:
            return None
        return best[1], best[2]

    def rollback_running(victims):
        """Refund the unexecuted tail of running victims and rebuild the
        pe_free of every PE that lost one."""
        nonlocal task_energy
        hit = set()
        for t in victims:
            if status[t] != 3:
                continue
            pe = pe_of[t]
            exec_total = q(finish[t] - start[t])
            executed = min(max(q(now - start[t]), 0.0), exec_total)
            task_energy = q(task_energy - q(
                q(exec_total - executed) * float(pe_power[pe])))
            hit.add(pe)
        vset = set(victims)
        for pe in hit:
            surv = [finish[u] for u in range(n_tasks)
                    if status[u] == 3 and pe_of[u] == pe and u not in vset]
            pe_free[pe] = max(max(surv, default=-np.inf), now)

    def drop_instance(i: int):
        nonlocal n_done, n_dropped_tasks
        victims = [t for t in range(n_tasks)
                   if int(wl.inst_id[t]) == i and status[t] < 4]
        rollback_running(victims)
        vset = set(victims)
        ready[:] = [t for t in ready if t not in vset]
        for t in victims:
            status[t] = 5
            finish[t] = -np.inf
            start[t] = np.inf
            assign_t[t] = np.inf
        n_done += len(victims)
        n_dropped_tasks += len(victims)
        inst_rem[i] = 0
        job_dropped[i] = True

    while n_done < n_tasks:
        if plan is not None:
            pe_alive = ~((fail_at <= now) & (now < repair_at))
        # 1. completions due
        due = [(finish[t], t) for t in range(n_tasks)
               if status[t] == 3 and finish[t] <= now]
        if due:
            _, t = min(due)
            status[t] = 4
            n_done += 1
            inst_rem[int(wl.inst_id[t])] -= 1
            if plan is not None and retries[t] > 0:
                n_recovered += 1
                recovery_us = q(recovery_us + q(finish[t] - last_kill[t]))
            for k in range(int(wl.n_succs[t])):
                s = int(wl.succs[t, k])
                pred_rem[s] -= 1
                if pred_rem[s] == 0:
                    base = max((finish[int(wl.preds[s, j])]
                                for j in range(int(wl.n_preds[s]))),
                               default=now)
                    ready_base[s] = max(base, now)
                    status[s] = 2
                    ready.append(s)
            continue
        if plan is not None:
            # 2. fault kills due (earliest tau, lowest task id)
            kt, ktau = -1, np.inf
            for t in range(n_tasks):
                if status[t] != 3:
                    continue
                taus = kill_times[pe_of[t]]
                d = taus[(assign_t[t] < taus) & (taus <= now)]
                if d.size and d.min() < ktau:
                    ktau, kt = float(d.min()), t
            if kt >= 0:
                t = kt
                pe = pe_of[t]
                exec_total = q(finish[t] - start[t])
                executed = min(max(q(now - start[t]), 0.0), exec_total)
                reexec_us = q(reexec_us + executed)
                rollback_running([t])
                exhausted = retries[t] >= max_retries
                retries[t] += 1
                last_kill[t] = now
                n_kills += 1
                status[t] = 0
                finish[t] = np.inf
                start[t] = np.inf
                pe_of[t] = -1
                assign_t[t] = np.inf
                if exhausted:
                    drop_instance(int(wl.inst_id[t]))
                else:
                    n_retries_tot += 1
                    ready_base[t] = now
                    status[t] = 2
                    ready.append(t)
                continue
            # 3. job deadlines due (earliest deadline, lowest instance id)
            di, ddl = -1, np.inf
            for i in range(min(arr_ptr, n_inst)):
                if inst_rem[i] <= 0:
                    continue
                dl = q(float(wl.inst_arrival[i]) + deadline_us)
                if dl <= now and dl < ddl:
                    ddl, di = dl, i
            if di >= 0:
                drop_instance(di)
                continue
        # 4. arrivals due
        if arr_ptr < n_inst and wl.inst_arrival[arr_ptr] <= now:
            i = arr_ptr
            arr_ptr += 1
            for k in range(int(wl.inst_n_roots[i])):
                r = int(wl.inst_roots[i, k])
                ready_base[r] = float(wl.inst_arrival[i])
                status[r] = 2
                ready.append(r)
            continue
        # 5. one scheduling decision (feasible under the availability mask)
        if ready:
            n = float(len(ready))
            if mode == MODE_LUT:
                choice = lut_choice()
                lat = q(float(cfg.lut_latency_us))
                e = q(float(cfg.lut_energy_uj))
            elif mode == MODE_ETF:
                choice = etf_choice()
                lat = q(float(cfg.etf_latency_us(n)))
                e = q(lat * float(cfg.sched_power_w))
            elif mode == MODE_ETF_IDEAL:
                choice = etf_choice()
                lat, e = 0.0, 0.0
            elif mode == MODE_DAS:
                feats = {FEAT_RATE: rate_est(), FEAT_BIG_AVAIL: big_avail()}
                slow = das_slow(feats)
                if slow:
                    choice = etf_choice()
                    lat = q(float(cfg.etf_latency_us(n)))
                    e = q(lat * float(cfg.sched_power_w))
                else:
                    choice = lut_choice()
                    lat = q(float(cfg.lut_latency_us))
                    e = q(float(cfg.lut_energy_uj))
                e = q(e + cls_e)
            else:
                raise ValueError(mode)
            if choice is not None:
                slot, pe = choice
                t = ready.pop(slot)
                sched_done = q(max(sched_free, now) + lat)
                sched_free = sched_done
                st = max(avail_comm(t, pe), pe_free[pe], sched_done, now)
                ex = q(float(exec_pe[wl.task_type[t], pe])
                       * float(pe_slow[pe]))
                start[t] = st
                finish[t] = q(st + ex)
                pe_of[t] = pe
                pe_free[pe] = finish[t]
                status[t] = 3
                assign_t[t] = now
                task_energy = q(task_energy + q(ex * float(pe_power[pe])))
                sched_energy = q(sched_energy + e)
                sched_time = q(sched_time + lat)
                if mode == MODE_DAS:
                    log_now.append(now)
                    log_rate.append(feats[FEAT_RATE])
                    log_big.append(feats[FEAT_BIG_AVAIL])
                    log_slow.append(slow)
                continue
        # 6. advance time
        nxt = np.inf
        if arr_ptr < n_inst:
            nxt = min(nxt, float(wl.inst_arrival[arr_ptr]))
        running = finish[status == 3]
        if running.size:
            nxt = min(nxt, float(running.min()))
        if plan is not None:
            fut = fault_times[fault_times > now]
            if fut.size:
                nxt = min(nxt, float(fut.min()))
            for i in range(min(arr_ptr, n_inst)):
                if inst_rem[i] > 0:
                    dl = q(float(wl.inst_arrival[i]) + deadline_us)
                    if dl > now:
                        nxt = min(nxt, dl)
        if not np.isfinite(nxt):
            break
        now = max(now, nxt)

    inst_fin = np.full(n_inst, -np.inf)
    for t in range(n_tasks):
        inst_fin[int(wl.inst_id[t])] = max(inst_fin[int(wl.inst_id[t])],
                                           finish[t])
    inst_exec = q(inst_fin - wl.inst_arrival[:n_inst])
    kept = ~job_dropped
    das = {} if mode != MODE_DAS else {
        "n_slow": int(sum(log_slow)),
        "log_now": np.array(log_now),
        "log_rate": np.array(log_rate),
        "log_big_avail": np.array(log_big),
        "log_slow": np.array(log_slow, np.int8),
    }
    return {
        "avg_exec_us": q(float(np.mean(inst_exec[kept]))) if kept.any()
        else float("nan"),
        "finish": finish,
        "pe_of": pe_of,
        "task_energy_uj": task_energy,
        "sched_energy_uj": sched_energy,
        "sched_time_us": sched_time,
        "n_done": n_done,
        "n_faults": n_kills,
        "n_retries": n_retries_tot,
        "reexec_us": reexec_us,
        "n_dropped_jobs": int(job_dropped.sum()),
        "n_dropped_tasks": n_dropped_tasks,
        "recovery_us": recovery_us,
        "n_recovered": n_recovered,
        "job_dropped": job_dropped,
        **das,
    }
