"""Shared benchmark pipeline: the workload suite, the oracle datasets, the
trained DAS policies and the per-mode evaluation grids, on one device.

The port of `benchmarks/common.py`. Every sweep — the two oracle sweeps
and every evaluation grid — goes through the crash-safe campaign runner
(`core.campaign.run_campaign` over `sim.run_batch`: fixed-shape chunks
split over the devices, per-chunk retry and backoff, a watchdog, and,
when a campaign directory is set, atomic chunk checkpoints that a killed
run resumes bit for bit). The two oracle sweeps (`MODE_ORACLE` and
`MODE_ETF` over the training grid) are metric-independent, since only
the labelling of pending samples reads the metric, so they run once and
serve the datasets of both metrics. Each sweep's wall time, super-steps,
retired events and health counters are kept in `Bench.sweeps`, its
campaign counters in `Bench.campaigns` (`Bench.campaign_stats()`).

A `Bench` holds its caches itself, so two pipelines in one process (the
GPU run and a CPU cross-check, say) never share results. The sections
(`fig2`, `fig3`, `table2`, `summary40`, `heuristic`, `overhead`,
`faults`) each take one, so `bench.run` trains DAS once for all.

Environment knobs, read at call time as the reference reads them:
  REPRO_BENCH_INSTANCES     frames per workload (default 60)
  REPRO_BENCH_FULL=0        train on the 10 x 8 subset, not 40 x 14
  REPRO_BENCH_BATCH         scenarios a chunk (bounds peak memory; results
                            do not depend on it). Unset, `batch_size`
                            autotunes it once a device: a short timed probe
                            over a ladder of candidates for the device's
                            type, its pick kept in an on-disk cache keyed
                            by device type, card name, device count and
                            torch version. Delete the cache file to probe
                            again.
  REPRO_BENCH_DEVICES       devices a chunk is split over (default: every
                            visible card; `simulator._resolve_devices`)
  REPRO_BENCH_CAMPAIGN_DIR  checkpoint the sweeps' chunks into this
                            directory (`bench.run --resume DIR`)
  REPRO_BENCH_WATCHDOG_S    per-chunk wall-clock watchdog (default off)
  REPRO_BENCH_STEP_BUDGET   per-chunk step budget (default off; a trip
                            retries with an escalated budget)
  REPRO_BENCH_PACK=0        no length-aware chunk packing
  REPRO_BENCH_CACHE_DIR     the autotune cache's directory (default
                            ~/.cache/repro_torch; the file is
                            `autotune.json` in it)
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import classifier as clf
from repro_torch.core import campaign, das, oracle, simulator as sim
from repro_torch.core import workloads
from repro_torch.core.device import resolve

N_INSTANCES = 60          # frames per workload, as the reference's default
# the training grid with REPRO_BENCH_FULL=0, as the reference's
SUBSET_MIXES = [0, 1, 2, 3, 4, 5, 8, 12, 17, 22]
SUBSET_RATES = [0, 3, 5, 7, 9, 11, 12, 13]


class Bench:
    """One benchmark pipeline on one device.

    `train_mixes` / `train_rates` pick the oracle grid (default: the
    paper's full 40 mixes x 14 rates). Every sweep is cut into chunks
    of `batch_size(device)` scenarios (`REPRO_BENCH_BATCH`, else the
    autotune's pick; on the card one chunk covers every sweep of the
    benchmark). `campaign_dir` roots the sweeps' chunk checkpoints
    (None: none are written).
    """

    def __init__(self, device="cuda", n_instances: int = N_INSTANCES,
                 train_mixes: Sequence[int] | None = None,
                 train_rates: Sequence[int] | None = None,
                 campaign_dir: str | None = None):
        self.device = resolve(device)
        self.campaign_dir = campaign_dir
        self.campaigns: List[Dict] = []
        self.suite = workloads.default_suite(n_instances=n_instances)
        self.params = sim.make_params(device=self.device)
        self.train_mixes = list(range(self.suite.mixes.shape[0])
                                if train_mixes is None else train_mixes)
        self.train_rates = list(range(len(self.suite.rates))
                                if train_rates is None else train_rates)
        self.sweeps: List[Dict] = []
        self._oracle_sweeps: Dict[int, sim.SimResult] = {}
        self._datasets: Dict[str, oracle.OracleDataset] = {}
        self._policies: Dict[Tuple[str, str], das.DASPolicy] = {}
        self._cells: Dict[Tuple[int, int], workloads.FlatWorkload] = {}

    # -- sweeps ------------------------------------------------------------
    def sweep(self, mode: int, stacked: workloads.FlatWorkload, tree=None,
              rate_threshold=1e9, plan=None, label: str = "",
              cells: Sequence[Tuple[int, int]] | None = None
              ) -> sim.SimResult:
        """One crash-safe batched sweep (`plan`: a `faults.FaultPlan`,
        shared or stacked) through `campaign.run_campaign`; returns the
        result as numpy arrays. Chunks are checkpointed under
        `campaign_dir` when set; the campaign's counters go to
        `campaigns`. Stalled cells and dropped jobs are reported by name
        (`report_health`)."""
        t0 = time.perf_counter()
        out = campaign.run_campaign(
            mode, stacked, self.params, tree=tree,
            rate_threshold=rate_threshold, plan=plan,
            batch_size=batch_size(self.device),
            device=self.device, checkpoint_dir=self.campaign_dir,
            watchdog_s=_env_opt_float("REPRO_BENCH_WATCHDOG_S"),
            step_budget=_env_opt_int("REPRO_BENCH_STEP_BUDGET"))
        res = out.result           # host numpy: waited for the device
        wall = time.perf_counter() - t0
        label = label or sim.MODE_NAMES[mode]
        self.campaigns.append({"label": label, **out.stats})
        rep = report_health(res, label=label, cells=cells)
        self.sweeps.append({
            "label": label,
            "mode": sim.MODE_NAMES[mode],
            "scenarios": int(res.n_done.shape[0]),
            "wall_s": wall,
            "steps": out.stats["steps"],
            "events": out.stats["retired_events"],
            **{k: rep[k] for k in ("stalled", "unfinished", "ready_drop",
                                   "dropped_jobs", "dropped_tasks")},
        })
        return res

    def campaign_stats(self) -> Dict:
        """The campaign counters summed over this pipeline's sweeps, with
        the reference's keys (`benchmarks.common.campaign_stats`): chunk
        reuse, retries, timeouts, out-of-memory shrinks, stall trips,
        chunk wall times and occupancy (lane super-steps on which the
        lane was running, over those run); and the port's super-steps
        and checkpoint bytes and seconds."""
        keys = ("n_scenarios", "n_chunks", "chunks_reused",
                "chunks_computed", "retries", "timeouts", "oom_events",
                "shrinks", "stall_trips", "lane_trips", "active_trips",
                "retired_events", "steps", "checkpoint_bytes",
                "checkpoint_write_s", "checkpoint_read_s")
        totals = {k: sum(c[k] for c in self.campaigns) for k in keys}
        walls = [w for c in self.campaigns for w in c["chunk_wall_s"]]
        return {
            "n_sweeps": len(self.campaigns),
            **totals,
            "occupancy": (totals["active_trips"] / totals["lane_trips"]
                          if totals["lane_trips"] else None),
            "chunk_wall_s_max": max(walls) if walls else 0.0,
            "chunk_wall_s_mean": sum(walls) / len(walls) if walls else 0.0,
            "sweeps": self.campaigns,
        }

    def dataset(self, metric: str = "avg_exec_us") -> oracle.OracleDataset:
        if metric not in self._datasets:
            def runner(m, stacked, p, bs):
                if m not in self._oracle_sweeps:
                    self._oracle_sweeps[m] = self.sweep(
                        m, stacked, label=f"oracle {sim.MODE_NAMES[m]}")
                return self._oracle_sweeps[m]

            self._datasets[metric] = oracle.generate(
                self.suite, self.params, mix_indices=self.train_mixes,
                rate_indices=self.train_rates, metric=metric,
                runner=runner, device=self.device)
        return self._datasets[metric]

    def das_policy(self) -> das.DASPolicy:
        """The paper's feature pair (rate, big-cluster availability)."""
        key = ("paper", "avg_exec_us")
        if key not in self._policies:
            self._policies[key] = das.fit_policy(self.dataset())
        return self._policies[key]

    def das_policy_auto(self, metric: str = "avg_exec_us") -> das.DASPolicy:
        """2 features chosen by greedy selection instead of the paper's
        pair."""
        key = ("auto", metric)
        if key not in self._policies:
            ds = self.dataset(metric)
            tr, _ = oracle.train_test_split(ds)
            idx = np.random.RandomState(0).permutation(len(tr))[:6000]
            sel = clf.greedy_select(tr.features[idx], tr.labels[idx], k=2)
            self._policies[key] = das.fit_policy(ds, feature_ids=sel)
        return self._policies[key]

    # -- evaluation grids --------------------------------------------------
    def cell_workload(self, mix_idx: int,
                      rate_idx: int) -> workloads.FlatWorkload:
        key = (mix_idx, rate_idx)
        if key not in self._cells:
            self._cells[key] = self.suite.build(mix_idx, rate_idx)
        return self._cells[key]

    def eval_cell(self, mix_idx: int, rate_idx: int, mode: int, tree=None,
                  rate_threshold: float = 1e9) -> sim.SimResult:
        """One scenario through `sim.run`; a numpy `SimResult` of
        scalars."""
        return sim.to_numpy(sim.run(
            mode, self.cell_workload(mix_idx, rate_idx), self.params,
            tree=tree, rate_threshold=rate_threshold, device=self.device))

    def eval_grid(self, cells: Sequence[Tuple[int, int]], mode: int,
                  tree=None, rate_threshold=1e9,
                  label: str = "") -> sim.SimResult:
        """One batched sweep of `mode` over `[(mix_idx, rate_idx), ...]`;
        a numpy `SimResult` with one row per cell, in order.
        `rate_threshold` is a scalar or one value per cell."""
        stacked = workloads.stack_workloads(
            [self.cell_workload(mi, ri) for mi, ri in cells])
        return self.sweep(mode, stacked, tree=tree,
                          rate_threshold=rate_threshold,
                          label=label or f"grid {sim.MODE_NAMES[mode]}",
                          cells=cells)

    def eval_modes_grid(self, cells: Sequence[Tuple[int, int]],
                        with_fs: bool = False) -> Dict[str, sim.SimResult]:
        """All scheduler modes over a cell grid, one batched sweep each.
        DAS = the paper's feature pair; DAS-FS = the same depth-2 tree on
        the 2 features the greedy selection picks."""
        out = {
            "LUT": self.eval_grid(cells, sim.MODE_LUT),
            "ETF": self.eval_grid(cells, sim.MODE_ETF),
            "ETF-ideal": self.eval_grid(cells, sim.MODE_ETF_IDEAL),
            "DAS": self.eval_grid(cells, sim.MODE_DAS,
                                  tree=self.das_policy().tree),
        }
        if with_fs:
            out["DAS-FS"] = self.eval_grid(
                cells, sim.MODE_DAS, tree=self.das_policy_auto().tree,
                label="grid DAS-FS")
        return out


def _env_int(name: str, default: int) -> int:
    """A positive-integer environment knob; anything else is an error."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer "
                         f"(default {default})") from None
    if val <= 0:
        raise ValueError(f"{name}={val} must be a positive integer")
    return val


def _env_opt_int(name: str) -> int | None:
    """Like `_env_int` but unset/blank means None (knob off)."""
    raw = os.environ.get(name, "").strip()
    return _env_int(name, 0) if raw else None


def _env_opt_float(name: str) -> float | None:
    """A positive float knob; unset/blank means None (knob off)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number") from None
    if val <= 0:
        raise ValueError(f"{name}={val} must be positive")
    return val


# ---------------------------------------------------------------------------
# the chunk-size autotune and its cache
# ---------------------------------------------------------------------------
# chunk sizes the probe tries, by device type. On the CPU a lane costs its
# share of every super-step and a chunk runs until its slowest lane
# retires, so the reference's ladder weighs the two. On the card a
# super-step takes 1.1-1.4 ms at every width from 32 to 560 scenarios,
# and a packed chunk runs 1,060-1,700 of them whatever its width, so a
# sweep's wall time goes with its chunk count and one chunk wins
# (PERF.md, the chunk-size table: a full-grid sweep takes 2.3-2.6 s in
# one chunk of 560, 4.6-4.9 s at 256, 6.4-7.0 s at 128, 21-22 s at 32).
# 1024 is one chunk for every sweep of the benchmark (the largest is 560
# scenarios); two smaller rungs keep the probe near 11 s on an H100.
_BATCH_CANDIDATES = {"cpu": (8, 16, 32), "cuda": (128, 256, 1024)}
_PROBE_FRAMES = 6


def _probe_cells(device_type: str) -> List[Tuple[int, int]]:
    """The probe's (mix, rate) grid: the reference's 8 mixes x 4 rates,
    and on the card all 40 x 14. A chunk clamps to its sweep, so on 32
    scenarios every candidate from 32 up is the same single chunk; on 560
    each of the card's candidates is a chunking of its own."""
    if device_type == "cuda":
        return [(m, r) for m in range(40) for r in range(14)]
    return [(m, r) for m in range(8) for r in (0, 5, 9, 13)]


def _autotune_cache_path() -> str:
    root = os.environ.get("REPRO_BENCH_CACHE_DIR", "").strip() \
        or os.path.join(os.path.expanduser("~"), ".cache", "repro_torch")
    return os.path.join(root, "autotune.json")


def _autotune_key(device) -> str:
    """Cache key: what shifts the chunk-size crossover. The card's name
    stands where the reference has its backend ("cuda" does not tell an
    H100 from another card), and the probe runs on the device split that
    the sweeps use, so the device count is part of it."""
    dev = resolve(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return (f"{dev.type}|{name}|dev{len(sim._resolve_devices(None, dev))}"
            f"|torch{torch.__version__}")


def _autotune_cache_load() -> dict:
    """Read the autotune cache, deleting it if corrupt (a crash mid-write
    cannot truncate it, since writes are atomic, but a hand edit can)."""
    path = _autotune_cache_path()
    try:
        with open(path) as f:
            cache = json.load(f)
        if not isinstance(cache, dict):
            raise ValueError("autotune cache is not a JSON object")
        return cache
    except FileNotFoundError:
        return {}
    except (OSError, ValueError):
        print(f"# autotune cache {path} unreadable; deleting and re-probing")
        try:
            os.remove(path)
        except OSError:
            pass
        return {}


def _autotune_cache_store(key: str, value: int) -> None:
    """Add `key: value` to the cache file, keeping the other entries; a
    write that fails is reported and the run goes on uncached."""
    path = _autotune_cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cache = _autotune_cache_load()
        cache[key] = value
        campaign.atomic_write_json(path, cache)
    except OSError as e:
        print(f"# autotune cache write failed ({e}); continuing uncached")


def _probe_sweep_s(stacked, params, batch: int, dev) -> float:
    """Seconds of one LUT sweep of `stacked` at chunk size `batch`, timed
    after a warm-up sweep."""
    sim.run_batch(sim.MODE_LUT, stacked, params, batch_size=batch,
                  device=dev)
    t0 = time.perf_counter()
    np.asarray(sim.to_numpy(sim.run_batch(
        sim.MODE_LUT, stacked, params, batch_size=batch,
        device=dev)).avg_exec_us)
    return time.perf_counter() - t0


def _probe_batch_size(device) -> int:
    """Timed probe: one LUT sweep of the device's probe grid
    (`_probe_cells`, 6 frames) a candidate, after a warm-up sweep; the
    fastest wins. Results never depend on the value, only wall time and
    peak memory do."""
    dev = resolve(device)
    cands = _BATCH_CANDIDATES[dev.type]
    stacked = workloads.default_suite(n_instances=_PROBE_FRAMES) \
        .build_many(_probe_cells(dev.type))
    params = sim.make_params(device=dev)
    t00 = time.time()
    best, took = None, []
    for b in cands:
        dt = _probe_sweep_s(stacked, params, b, dev)
        took.append(f"{b}: {dt:.3f}s")
        if best is None or dt < best[1]:
            best = (b, dt)
    print(f"# autotuned REPRO_BENCH_BATCH={best[0]} on {dev} "
          f"({len(cands)} candidates in {time.time() - t00:.0f}s; timed "
          f"{', '.join(took)})")
    return best[0]


def resolve_batch_size(device="cuda") -> Tuple[int, str]:
    """(chunk size for every sweep of the benchmark on `device`, where it
    came from). `REPRO_BENCH_BATCH` wins when set ("env"); otherwise the
    device's autotuned value, resolved once a process a device: the
    on-disk cache's entry for `_autotune_key` ("cache"), or on a miss the
    timed probe, whose pick is stored ("probe"). Corrupt cache files are
    deleted and probed again; entries of other keys are kept and
    missed."""
    if os.environ.get("REPRO_BENCH_BATCH", "").strip():
        return _env_int("REPRO_BENCH_BATCH", 16), "env"
    return _autotuned(str(resolve(device)))


def batch_size(device="cuda") -> int:
    """The chunk size of `resolve_batch_size`."""
    return resolve_batch_size(device)[0]


@functools.lru_cache(maxsize=None)
def _autotuned(device: str) -> Tuple[int, str]:
    key = _autotune_key(device)
    cached = _autotune_cache_load().get(key)
    if isinstance(cached, int) and cached > 0:
        print(f"# autotune cache hit: REPRO_BENCH_BATCH={cached} [{key}]")
        return cached, "cache"
    best = _probe_batch_size(device)
    _autotune_cache_store(key, best)
    return best, "probe"


def env_config() -> Dict:
    """The reference's two size knobs, read at call time:
    `REPRO_BENCH_INSTANCES` (frames per workload, default 60) and
    `REPRO_BENCH_FULL=0` (train on the 10 x 8 subset instead of the
    full 40 x 14 grid; summary40 then takes 14 mixes)."""
    full = os.environ.get("REPRO_BENCH_FULL", "1") != "0"
    return {"n_instances": _env_int("REPRO_BENCH_INSTANCES", N_INSTANCES),
            "full_grid": full,
            "train_mixes": None if full else SUBSET_MIXES,
            "train_rates": None if full else SUBSET_RATES}


def bench_from_env(device="cuda", campaign_dir: str | None = None) -> Bench:
    """A `Bench` sized by `env_config()`, checkpointing into
    `campaign_dir`, else `REPRO_BENCH_CAMPAIGN_DIR` when set."""
    cfg = env_config()
    cdir = (campaign_dir
            or os.environ.get("REPRO_BENCH_CAMPAIGN_DIR", "").strip() or None)
    return Bench(device, n_instances=cfg["n_instances"],
                 train_mixes=cfg["train_mixes"],
                 train_rates=cfg["train_rates"], campaign_dir=cdir)


def cli(description: str, argv=None, extra=()):
    """Parse a section's command line: `--device` (default cuda), `--csv`
    and the section's own flags `extra` ((flag, help) pairs)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--csv", action="store_true",
                    help="emit name,us_per_call,derived CSV lines")
    for flag, help_ in extra:
        ap.add_argument(flag, action="store_true", help=help_)
    return ap.parse_args(argv)


_STALL_REASONS = {sim.STALL_DEADLOCK: "deadlock",
                  sim.STALL_BUDGET: "step-budget"}


def report_health(res: sim.SimResult, label: str = "",
                  cells: Sequence[Tuple[int, int]] | None = None) -> Dict:
    """The health counters of one batched numpy result, which must be
    zero on a clean sweep (`stalled`, `unfinished`: any stall reason,
    `ready_drop`, and without faults `dropped_jobs` / `dropped_tasks`),
    with the stalled scenarios and those with dropped jobs named (index,
    and (mix, rate) when `cells` is known) and printed: either silently
    skews an average."""
    def where(k):
        k = int(k)
        return (k, tuple(cells[k])) if cells is not None else (k,)

    reason = np.asarray(res.stall_reason)
    stalled_m = np.asarray(res.stalled) | (reason != sim.STALL_NONE)
    jobs = np.asarray(res.n_dropped_jobs)
    tasks = np.asarray(res.n_dropped_tasks)
    stalled = [(*where(k), _STALL_REASONS.get(int(reason[k]), "deadlock"))
               for k in np.flatnonzero(stalled_m)]
    dropped = [(*where(k), int(jobs[k]), int(tasks[k]))
               for k in np.flatnonzero((jobs > 0) | (tasks > 0))]
    out = {"stalled": int(np.asarray(res.stalled).sum()),
           "unfinished": int(stalled_m.sum()),
           "ready_drop": int(np.asarray(res.ready_drop).sum()),
           "dropped_jobs": int(jobs.sum()), "dropped_tasks": int(tasks.sum()),
           "stalled_at": stalled, "dropped_at": dropped}
    for what, entries in (("stalled cell(s), averages exclude unfinished "
                           "work", stalled),
                          ("scenario(s) with dropped jobs", dropped)):
        if entries:
            print(f"# health [{label}]: {len(entries)} {what}:")
            for e in entries[:8]:
                print(f"#   scenario {e}")
            if len(entries) > 8:
                print(f"#   ... and {len(entries) - 8} more")
    return out
