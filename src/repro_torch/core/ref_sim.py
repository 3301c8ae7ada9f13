"""Independent float64 reference simulator (differential oracle).

The port of `repro/core/ref_sim.py`, in numpy and plain Python: the
same event semantics as the tensor simulator (completions due, then
arrivals due, then one scheduling decision, else advance) with plain
lists and floats. Two independently written simulators agreeing on
per-task finish times is strong evidence neither mis-encodes the model.

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

from typing import Dict, List

import numpy as np

from repro_torch.core import soc
from repro_torch.core.simulator import MODE_ETF, MODE_ETF_IDEAL, MODE_LUT
from repro_torch.core.workloads import FlatWorkload


def simulate_ref(mode: int, wl: FlatWorkload,
                 cfg: soc.SoCConfig | None = None,
                 plan=None) -> Dict:
    cfg = cfg or soc.default_soc()
    exec_pe = cfg.exec_on_pe()                    # [types, P]
    pe_cluster = cfg.pe_cluster
    pe_power = cfg.cluster_power[pe_cluster]
    n_tasks = int(wl.n_tasks)
    n_inst = int(wl.n_insts)
    P = cfg.n_pes

    if plan is not None:
        fail_at = np.asarray(plan.pe_fail_at, float)
        repair_at = np.asarray(plan.pe_repair_at, float)
        kill_times = np.concatenate(
            [fail_at[:, None], np.asarray(plan.transient_at, float)], axis=1)
        pe_slow = np.asarray(plan.cluster_slowdown, float)[pe_cluster]
        max_retries = int(plan.max_retries)
        deadline_us = float(plan.deadline_us)
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

    def avail_comm(t: int, pe: int) -> float:
        base = ready_base[t]
        for k in range(int(wl.n_preds[t])):
            p = int(wl.preds[t, k])
            comm = (float(wl.out_kb[p]) * cfg.us_per_kb
                    if pe_cluster[pe_of[p]] != pe_cluster[pe] else 0.0)
            base = max(base, finish[p] + comm)
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
                e = exec_pe[wl.task_type[t], pe] * pe_slow[pe]
                if not np.isfinite(e):
                    continue
                ft = max(avail_comm(t, pe), pe_free[pe], now) + e
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
            exec_total = finish[t] - start[t]
            executed = min(max(now - start[t], 0.0), exec_total)
            task_energy -= (exec_total - executed) * float(pe_power[pe])
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
                recovery_us += finish[t] - last_kill[t]
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
                exec_total = finish[t] - start[t]
                executed = min(max(now - start[t], 0.0), exec_total)
                reexec_us += executed
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
                dl = float(wl.inst_arrival[i]) + deadline_us
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
                lat, e = float(soc.LUT_LATENCY_US), float(soc.LUT_ENERGY_UJ)
            elif mode == MODE_ETF:
                choice = etf_choice()
                lat = float(soc.etf_latency_us(n))
                e = lat * float(soc.SCHED_POWER_W)
            elif mode == MODE_ETF_IDEAL:
                choice = etf_choice()
                lat, e = 0.0, 0.0
            else:
                raise ValueError(mode)
            if choice is not None:
                slot, pe = choice
                t = ready.pop(slot)
                sched_done = max(sched_free, now) + lat
                sched_free = sched_done
                st = max(avail_comm(t, pe), pe_free[pe], sched_done, now)
                ex = float(exec_pe[wl.task_type[t], pe]) * float(pe_slow[pe])
                start[t] = st
                finish[t] = st + ex
                pe_of[t] = pe
                pe_free[pe] = finish[t]
                status[t] = 3
                assign_t[t] = now
                task_energy += ex * float(pe_power[pe])
                sched_energy += e
                sched_time += lat
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
                    dl = float(wl.inst_arrival[i]) + deadline_us
                    if dl > now:
                        nxt = min(nxt, dl)
        if not np.isfinite(nxt):
            break
        now = max(now, nxt)

    inst_fin = np.full(n_inst, -np.inf)
    for t in range(n_tasks):
        inst_fin[int(wl.inst_id[t])] = max(inst_fin[int(wl.inst_id[t])],
                                           finish[t])
    inst_exec = inst_fin - wl.inst_arrival[:n_inst]
    kept = ~job_dropped
    return {
        "avg_exec_us": float(np.mean(inst_exec[kept])) if kept.any()
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
    }
