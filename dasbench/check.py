"""How `correct` is decided: a sample of the window's scenarios against
the plain reference.

Each sampled scenario's results as the program returned them (`Row`)
are held to `reference/ref_sim.py` run on the same inputs. A cell
compares the numbers its limits file (`limits/<workload>.json`) names,
each against its own limit. Three are the worst over the sample; the
others are pooled over the sample, since one near-tie broken the other
way in float32 (against the reference's float64) reroutes the rest of
one congested scenario's schedule, and a number of one scenario swings
with that while the pool does not:

  avg_exec_rel  worst |avg_exec_us - ref| / ref (the paper's latency)
  sched_rel     worst |sched_time_us - ref| / ref (the decisions' latency)
  sched_energy_rel  worst |sched_energy_uj - ref| / ref (the decisions'
                energy, under DAS the classifier's with it)
  energy_gap    sum of |total_energy_uj - ref task + scheduling energy|
                over the sum of the reference's
  finish_off    share of the sample's tasks whose finish is off the
                reference's by more than 1e-3 of its scenario's largest,
                or finished on one side only
  fault_gap     the sample's sum over faults, retries, dropped jobs,
                dropped tasks and recovered tasks of |count - ref|, over
                the reference's sum (at least 1)
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np

FAULT_COUNTS = ("n_faults", "n_retries", "n_dropped_jobs",
                "n_dropped_tasks", "n_recovered")
# the program's result fields a sampled row keeps
ROW_FIELDS = ("avg_exec_us", "total_energy_uj", "sched_time_us",
              "sched_energy_uj", "finish", "n_iters") + FAULT_COUNTS


class Row(NamedTuple):
    """One sampled scenario: where it ran and what the program said."""

    sweep: int
    lane: int                 # its index in the sweep's scenario order
    out: Dict[str, np.ndarray]


def _rel(a: float, b: float) -> float:
    if math.isnan(a) and math.isnan(b):
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def numbers(out: Dict[str, np.ndarray], ref: dict,
            n_tasks: int) -> Dict[str, float]:
    """One scenario's program output against the reference's: the
    relative gaps and the counts the shares pool."""
    fin = np.asarray(out["finish"], np.float64)[:n_tasks]
    fin_ref = np.asarray(ref["finish"], np.float64)[:n_tasks]
    both = np.isfinite(fin) & np.isfinite(fin_ref)
    diff = np.zeros_like(fin)
    diff[both] = np.abs(fin[both] - fin_ref[both])
    scale = max(np.abs(fin_ref[np.isfinite(fin_ref)]).max(initial=0.0),
                1e-30)
    off = (np.isfinite(fin) != np.isfinite(fin_ref)) | (diff > 1e-3 * scale)
    energy_ref = ref["task_energy_uj"] + ref["sched_energy_uj"]
    return {
        "avg_exec_rel": _rel(float(out["avg_exec_us"]),
                             float(ref["avg_exec_us"])),
        "sched_rel": _rel(float(out["sched_time_us"]),
                          float(ref["sched_time_us"])),
        "sched_energy_rel": _rel(float(out["sched_energy_uj"]),
                                 float(ref["sched_energy_uj"])),
        "energy_diff": abs(float(out["total_energy_uj"]) - energy_ref),
        "energy_ref": energy_ref,
        "tasks": n_tasks,
        "tasks_off": int(off.sum()),
        "counts_gap": sum(abs(int(out[k]) - int(ref[k]))
                          for k in FAULT_COUNTS),
        "counts_ref": sum(int(ref[k]) for k in FAULT_COUNTS),
    }


def readings(per_row: List[Dict[str, float]]) -> Dict[str, float]:
    """The compared numbers over the sample: the worst relative gaps and
    the pooled shares."""
    tot = {k: sum(r[k] for r in per_row) for k in
           ("energy_diff", "energy_ref", "tasks", "tasks_off",
            "counts_gap", "counts_ref")}
    out = {k: max(r[k] for r in per_row)
           for k in ("avg_exec_rel", "sched_rel", "sched_energy_rel")}
    out["energy_gap"] = tot["energy_diff"] / max(tot["energy_ref"], 1e-30)
    out["finish_off"] = tot["tasks_off"] / max(1, tot["tasks"])
    out["fault_gap"] = tot["counts_gap"] / max(1, tot["counts_ref"])
    return out


def judge(readings: Dict[str, float],
          limits: Dict[str, float]) -> tuple:
    """(correct, [(name, reading, limit), ...]) for the numbers the cell's
    limits name; a NaN reading fails."""
    rows = [(k, readings[k], float(lim)) for k, lim in limits.items()]
    ok = all(v <= lim for _, v, lim in rows)
    return ok, rows


def pick_sample(g: np.random.Generator, rows: List[Row], n: int) -> List[Row]:
    """`n` rows drawn without replacement, the one with the most events
    of all (the longest scenario the window ran) always among them."""
    if len(rows) <= n:
        return list(rows)
    longest = max(range(len(rows)), key=lambda i: int(rows[i].out["n_iters"]))
    rest = [i for i in range(len(rows)) if i != longest]
    take = g.choice(len(rest), size=n - 1, replace=False)
    return [rows[longest]] + [rows[rest[i]] for i in sorted(take)]
