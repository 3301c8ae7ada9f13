"""Crash-safe sweep campaigns over `simulator.run_batch`.

The port of `repro/core/campaign.py`. A sweep over a (mix x rate) grid
is a long run, and one host-side failure (an out-of-memory chunk, a
chunk that never ends, a killed process) would otherwise throw away
every chunk already done. This layer wraps the sweep engine with:

  * **chunking** — the scenario axis is cut into the engine's own
    fixed-shape chunks (the same rounding to the device count and the
    same padding as `run_batch`), so per-scenario results are those of
    one uninterrupted sweep, bit for bit;
  * **checkpointing** — each completed chunk is written atomically (a
    temporary file, `fsync`, `os.replace`) into a campaign directory
    keyed by a content hash of the scenario spec (workloads, params,
    tree, thresholds, fault plan, mode), beside a `manifest.json` of the
    layout. A killed campaign run again with the same spec resumes from
    the completed chunks and returns byte-identical results;
  * **watchdog** — each chunk runs in a worker thread under a wall-clock
    limit (`watchdog_s`). On expiry the worker's stop flag is set; the
    simulator checks it at its next poll of `any(running)` (every
    `simulator.POLL_EVERY` super-steps) and raises, and the worker is
    joined before the retry starts, so two attempts never issue CUDA
    work at once (a graph capture would fail on the other's calls). A
    worker that has not stopped one more `watchdog_s` later is stuck
    inside a block, and the campaign ends with a `CampaignError`. An
    optional `step_budget` caps each lane's events on the device (lanes
    that hit it report `SimResult.stall_reason == STALL_BUDGET`);
  * **retry** — chunk failures (CUDA out of memory, watchdog expiry,
    step-budget trips) are retried with exponential backoff and seeded
    jitter. Out of memory also frees the caching allocator and halves the
    chunk's batch (down to one scenario a device) before giving up;
    stall trips escalate the step budget. Any other exception propagates
    at once: it is a bug, not infrastructure weather;
  * **length-aware packing** — a chunk runs until its longest scenario
    retires while the others idle behind their gates, so scenarios are
    ordered by a predicted event count (`3 * n_tasks + n_insts`, the
    engine's own iteration bound), descending, so chunk-mates retire
    together and the padded tail chunk replays the cheapest scenario.
    The permutation is kept in the manifest, checked on resume, and the
    results are put back in grid order before return. `pack=False` or
    `REPRO_BENCH_PACK=0` opts out; per-sweep occupancy (lane super-steps
    on which the lane was running, over those run) is in the stats.

Checkpoint format (`<dir>/<spec_hash[:16]>-b<B>/`):

  * `manifest.json` — `{version, spec_hash, mode, n_scenarios,
    chunk_size, n_chunks, fields, perm, torch, numpy}`, written atomically
    once. Chunks are stored in packed order; `perm` maps a packed
    position to its grid index.
  * `chunk_00000.npz` .. — one file per completed chunk: every
    `SimResult` field (as the port returns it, host numpy) under
    `r_<name>` with leading dim `chunk_size`, and a `meta` JSON blob
    (wall time, attempts, retries, shrinks). The (atomically renamed)
    file is the completion marker; an unreadable or misshapen file is
    deleted and its chunk recomputed.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import threading
import time
import traceback
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import faults as flt, simulator as sim
from repro_torch.core.workloads import FlatWorkload, stack_workloads

MANIFEST_NAME = "manifest.json"
FORMAT_VERSION = 2    # v2: length-aware packing (chunks in packed order)


class CampaignError(RuntimeError):
    """A chunk exhausted its retry budget (or the spec/manifest clash)."""


class ChunkTimeout(CampaignError):
    """A chunk exceeded the host-side watchdog."""


class ChunkStalled(CampaignError):
    """A chunk came back with lanes that hit the device-side step budget."""


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff/retry knobs for failed chunks.

    `max_retries` bounds retries *per chunk* (so `max_retries + 1` total
    attempts). Backoff for retry `k` is
    `min(backoff_max_s, backoff_base_s * backoff_factor**k)` stretched by
    up to `jitter_frac` of itself (seeded, so campaigns are reproducible).
    `budget_escalation` multiplies the step budget after a stall trip;
    `shrink_floor` is the smallest per-device batch OOM-halving may reach.
    """

    max_retries: int = 3
    backoff_base_s: float = 0.5
    backoff_factor: float = 2.0
    backoff_max_s: float = 30.0
    jitter_frac: float = 0.25
    seed: int = 0
    budget_escalation: int = 8
    shrink_floor: int = 1

    def backoff_s(self, attempt: int, rng: np.random.RandomState) -> float:
        base = min(self.backoff_max_s,
                   self.backoff_base_s * self.backoff_factor ** attempt)
        return base * (1.0 + self.jitter_frac * float(rng.uniform()))


@dataclasses.dataclass
class CampaignStats:
    """Counters of one campaign (`as_dict` feeds `bench.run --json`)."""

    n_scenarios: int = 0
    n_chunks: int = 0
    chunks_reused: int = 0      # loaded from a checkpoint, not recomputed
    chunks_computed: int = 0
    retries: int = 0            # chunk attempts after the first
    timeouts: int = 0           # watchdog expiries
    oom_events: int = 0         # out-of-memory catches
    shrinks: int = 0            # batch-size halvings
    stall_trips: int = 0        # step-budget exhaustions
    chunk_wall_s: list = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    packed: bool = False        # length-aware chunk packing in effect
    # occupancy, summed over computed (not reused) chunks: `lane_trips` =
    # lanes x super-steps run, `active_trips` = those on which the lane
    # was still running, `retired_events` = simulator events retired,
    # `steps` = super-steps run (summed over the chunks' device parts)
    lane_trips: int = 0
    active_trips: int = 0
    retired_events: int = 0
    steps: int = 0
    # checkpoint cost (the port's): bytes of chunk files written, and
    # seconds writing (fsync included) and reading them
    checkpoint_bytes: int = 0
    checkpoint_write_s: float = 0.0
    checkpoint_read_s: float = 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["occupancy"] = (self.active_trips / self.lane_trips
                          if self.lane_trips else None)
        return d


class CampaignResult(NamedTuple):
    result: sim.SimResult   # leading [S] axis, host numpy
    stats: dict             # CampaignStats.as_dict()


# ---------------------------------------------------------------------------
# spec hashing + atomic files
# ---------------------------------------------------------------------------
def _host(x) -> np.ndarray:
    """`x` (a tensor on any device, or array-like) as host numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _hash_update(h, tag: str, value) -> None:
    if value is None:
        h.update(f"{tag}:none".encode())
        return
    arr = np.ascontiguousarray(_host(value))
    h.update(f"{tag}:{arr.dtype.str}:{arr.shape}".encode())
    h.update(arr.tobytes())


def spec_hash(mode: int, stacked: FlatWorkload, params, tree,
              rate_threshold, plan) -> str:
    """Content hash of everything that determines per-scenario results,
    over host numpy (a spec hashes the same wherever its tensors live).

    Deliberately excludes chunk size, device count and retry/watchdog
    knobs: results are invariant to them, so checkpoints written under
    one host configuration remain addressable (the chunk *layout* is
    keyed separately, by the `-b<B>` directory suffix).
    """
    h = hashlib.sha256()
    h.update(f"campaign-v{FORMAT_VERSION}:mode={int(mode)}".encode())
    for name, field in zip(FlatWorkload._fields, stacked):
        _hash_update(h, f"wl.{name}", field)
    for name, field in zip(type(params)._fields, params):
        _hash_update(h, f"p.{name}", field)
    for name, field in zip(type(tree)._fields, tree):
        _hash_update(h, f"t.{name}", field)
    _hash_update(h, "rate_threshold", rate_threshold)
    if plan is None:
        _hash_update(h, "plan", None)
    else:
        for name, field in zip(flt.FaultPlan._fields, plan):
            _hash_update(h, f"f.{name}", field)
    return h.hexdigest()


def atomic_write_json(path: str, obj, default=repr) -> None:
    """Write JSON via a temp file + `os.replace` so a crash mid-dump never
    leaves a truncated file behind (also used by `bench.run --json`)."""
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, default=default)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _atomic_savez(path: str, **arrays) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _chunk_path(cdir: str, idx: int) -> str:
    return os.path.join(cdir, f"chunk_{idx:05d}.npz")


def _save_chunk(path: str, res: sim.SimResult, meta: dict) -> None:
    arrays = {f"r_{name}": np.asarray(field)
              for name, field in zip(sim.SimResult._fields, res)}
    arrays["meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    _atomic_savez(path, **arrays)


def _load_chunk(path: str, chunk_size: int):
    """Load a checkpointed chunk; corrupt/stale files are deleted and
    `None` is returned so the chunk is recomputed."""
    try:
        with np.load(path) as z:
            fields = [z[f"r_{name}"] for name in sim.SimResult._fields]
    except Exception:
        fields = None
    if fields is None or any(f.shape[:1] != (chunk_size,) for f in fields):
        try:
            os.remove(path)
        except OSError:
            pass
        return None
    return sim.SimResult(*fields)


def _open_campaign_dir(root: str, manifest: dict) -> str:
    """Create/validate the per-spec campaign directory under `root`."""
    cdir = os.path.join(
        root, f"{manifest['spec_hash'][:16]}-b{manifest['chunk_size']}")
    os.makedirs(cdir, exist_ok=True)
    mpath = os.path.join(cdir, MANIFEST_NAME)
    if os.path.exists(mpath):
        try:
            with open(mpath) as f:
                old = json.load(f)
        except (OSError, ValueError):
            old = None
        keys = ("version", "spec_hash", "mode", "n_scenarios",
                "chunk_size", "n_chunks", "fields", "perm")
        if old is not None and all(old.get(k) == manifest[k] for k in keys):
            return cdir
        # unreadable or stale manifest (e.g. a checkpoint format bump):
        # drop the old chunks — their layout can no longer be trusted
        for name in os.listdir(cdir):
            if name.startswith("chunk_") or name == MANIFEST_NAME:
                try:
                    os.remove(os.path.join(cdir, name))
                except OSError:
                    pass
    atomic_write_json(mpath, manifest)
    return cdir


# ---------------------------------------------------------------------------
# failure classification + watchdog
# ---------------------------------------------------------------------------
def _is_oom(exc: BaseException) -> bool:
    """`torch.OutOfMemoryError` reads "CUDA out of memory"."""
    msg = str(exc).lower()
    return ("resource_exhausted" in msg or "out of memory" in msg
            or "outofmemory" in msg)


def _free_device_memory() -> None:
    """Return the caching allocator's free blocks to the card before an
    out-of-memory retry (a failed attempt's tensors are garbage now)."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _let_go(exc: BaseException) -> BaseException:
    """A failed attempt's exception, let go of its attempt.

    A traceback holds the failed frames, and their locals hold the
    attempt's tensors and its half-captured CUDA graph; some of those
    frames also hold the exception (the watchdog's box, a future), a
    cycle that only a collection would free. So the locals of every frame
    in the traceback, and in those of its cause and context, are cleared:
    the attempt's memory is freed by reference counting as soon as the
    caller drops `exc`. Returns a copy without traceback, cause or
    context, which names the failure (same type and message) for the
    back-off message and the final `CampaignError`."""
    seen, e = set(), exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        traceback.clear_frames(e.__traceback__)
        e = e.__cause__ or e.__context__
    try:
        return type(exc)(*exc.args)
    except Exception:  # noqa: BLE001 — a type that takes other arguments
        return CampaignError(f"{type(exc).__name__}: {exc}")


def _call_with_watchdog(fn: Callable, timeout_s: float | None,
                        label: str = "chunk"):
    """Run `fn(stop)` under a wall-clock timeout.

    Without a timeout `fn(None)` runs inline. Otherwise it runs in a
    worker thread; on expiry `stop` (a `threading.Event`) is set, the
    worker is joined — the simulator raises `simulator.Stopped` at its
    next poll, at most one block of super-steps later for a chunk that is
    slow — and `ChunkTimeout` is raised. Joining, where the reference
    abandons the worker, keeps the retry's CUDA work from overlapping the
    expired attempt's: a graph capture fails on another thread's calls.
    The join waits `timeout_s` more at most: a worker still running then
    is stuck inside a block (a kernel or a sync that does not return),
    where no poll reads the flag, and a plain `CampaignError`, which is
    not retried, names the chunk."""
    if timeout_s is None:
        return fn(None)
    stop = threading.Event()
    box = {}

    def work():
        try:
            box["out"] = fn(stop)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e

    # a daemon thread: a stuck one must not hold the interpreter at exit
    worker = threading.Thread(target=work, name=f"campaign {label}",
                              daemon=True)
    worker.start()
    worker.join(timeout_s)
    if worker.is_alive():
        stop.set()
        worker.join(timeout_s)
        if worker.is_alive():
            raise CampaignError(
                f"{label}: stuck; its worker did not stop within "
                f"{timeout_s:g}s of the {timeout_s:g}s watchdog's expiry")
        box.clear()                 # the stopped attempt's error, frames
        raise ChunkTimeout(f"chunk exceeded the {timeout_s:g}s watchdog")
    if "err" in box:
        raise box.pop("err")        # the box lets go of it at once
    return box["out"]


# Module-level so tests can monkeypatch it to inject OOMs / hangs / crashes.
def _compute_chunk(mode: int, part: FlatWorkload, params, tree,
                   rate_threshold, plan, batch: int, devices: tuple,
                   step_budget: int | None,
                   telemetry: list | None = None,
                   stop=None) -> sim.SimResult:
    """One fixed-shape `run_batch` call, fetched to host numpy."""
    res = sim.run_batch(mode, part, params, tree=tree,
                        rate_threshold=rate_threshold, plan=plan,
                        batch_size=batch, devices=list(devices),
                        device=devices[0], step_budget=step_budget,
                        telemetry=telemetry, stop=stop)
    return sim.to_numpy(res)


def _resolve_pack(pack: bool | None) -> bool:
    """`pack=` knob, falling back to `REPRO_BENCH_PACK` (default on)."""
    if pack is not None:
        return bool(pack)
    raw = os.environ.get("REPRO_BENCH_PACK", "1").strip().lower()
    return raw not in ("0", "off", "no", "false")


def predicted_events(stacked: FlatWorkload) -> np.ndarray:
    """[S] cheap per-scenario event-count predictor: `3 * n_tasks +
    n_insts`, the shape of the engine's iteration bound (each task is
    pushed, decided, and completed once; each instance arrives once).
    Fault retries add a data-dependent tail the predictor ignores —
    ordering only needs to be correlated with the true length."""
    return (3 * np.asarray(stacked.n_tasks, np.int64)
            + np.asarray(stacked.n_insts, np.int64))


# ---------------------------------------------------------------------------
# the campaign runner
# ---------------------------------------------------------------------------
def _shrink_batch(b: int, n_dev: int, floor: int) -> int:
    """Halve a chunk batch, keeping it a positive device multiple."""
    lo = max(floor, 1) * n_dev
    return max(lo, (b // 2) // n_dev * n_dev or lo)


def run_campaign(mode: int, wls, params=None, tree=None,
                 rate_threshold=1e9,
                 batch_size: int | None = None,
                 plan=None,
                 devices=None,
                 checkpoint_dir: str | None = None,
                 resume: bool = True,
                 watchdog_s: float | None = None,
                 step_budget: int | None = None,
                 retry: RetryPolicy | None = None,
                 chunk_delay_s: float = 0.0,
                 pack: bool | None = None,
                 device="cuda") -> CampaignResult:
    """Crash-safe equivalent of `sim.run_batch` (same sweep arguments).

    `device` and `devices` are `run_batch`'s (`simulator._resolve_devices`).
    Campaign knobs: `checkpoint_dir` roots the chunk checkpoints (None
    disables checkpointing; `resume=False` recomputes existing chunks),
    `watchdog_s` / `step_budget` bound each chunk in wall clock / device
    steps, `retry` configures backoff (see `RetryPolicy`),
    `chunk_delay_s` sleeps between chunks (a throttle; the kill-and-resume
    smoke test uses it to widen the SIGKILL window), and `pack` orders
    scenarios into chunks by predicted event count (default:
    `REPRO_BENCH_PACK`, on) — results are put back in input order before
    return, so packing never changes what a caller sees.

    Returns `(result, stats)`: `result` (host numpy) is bit-identical to
    one uninterrupted `run_batch` call over the same scenarios — whether
    the chunks were computed now, loaded from checkpoints, or both,
    packed or not.
    """
    devs = sim._resolve_devices(devices, device)
    D = len(devs)
    params = params or sim.make_params(device=devs[0])
    tree = tree if tree is not None else sim.always_fast_tree(devs[0])
    retry = retry or RetryPolicy()
    stacked = wls if isinstance(wls, FlatWorkload) else stack_workloads(wls)
    stacked = FlatWorkload(*[np.asarray(f) for f in stacked])
    n = int(stacked.task_type.shape[0])
    if plan is not None:
        plan = flt.validate_plan(
            plan, n_pes=params.pe_cluster.shape[0],
            n_clusters=params.cluster_pe_mask.shape[0])
        plan = flt.FaultPlan(*[np.asarray(f) for f in plan])
    rate_threshold = _host(rate_threshold).astype(np.float32)

    if batch_size is not None and batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    # identical chunk geometry to run_batch: clamp, round up to a device
    # multiple, pad the ragged tail by replaying the last real scenario
    B = n if batch_size is None else min(batch_size, n)
    B = -(-B // D) * D
    n_pad = -(-n // B) * B
    n_chunks = n_pad // B
    # length-aware packing: schedule scenarios in descending predicted
    # length so each fixed-shape chunk's lanes retire together and the
    # padded tail chunk (which replays its last scenario) is the cheapest.
    # The stable sort keeps the layout (and hence checkpoint addressing)
    # deterministic for resume.
    do_pack = _resolve_pack(pack) and n_chunks > 1
    if do_pack:
        perm = np.argsort(-predicted_events(stacked), kind="stable")
    else:
        perm = np.arange(n)
    # schedule order incl. the replayed-pad tail (grid indices per lane)
    sched = np.concatenate([perm, np.full(n_pad - n, perm[-1] if n else 0,
                                          dtype=perm.dtype)])

    tree_np = type(tree)(*[_host(f) for f in tree])
    tree_b = tree_np.feat.ndim == 2
    thr_b = rate_threshold.ndim >= 1
    plan_b = plan is not None and flt.is_batched(plan)
    if plan_b and plan.pe_fail_at.shape[0] != n:
        raise ValueError(
            f"run_campaign: batched plan has {plan.pe_fail_at.shape[0]} "
            f"scenarios but the workload has {n}")

    def make_args(ids: np.ndarray):
        part = FlatWorkload(*[f[ids] for f in stacked])
        t = type(tree)(*[f[ids] for f in tree_np]) if tree_b else tree_np
        rt = rate_threshold[ids] if thr_b else rate_threshold
        pl = flt.FaultPlan(*[f[ids] for f in plan]) if plan_b else plan
        return part, t, rt, pl

    stats = CampaignStats(n_scenarios=n, n_chunks=n_chunks,
                          packed=bool(do_pack))
    cdir = None
    if checkpoint_dir:
        h = spec_hash(mode, stacked, params, tree_np, rate_threshold, plan)
        manifest = {
            "version": FORMAT_VERSION, "spec_hash": h, "mode": int(mode),
            "n_scenarios": n, "chunk_size": B, "n_chunks": n_chunks,
            "fields": list(sim.SimResult._fields),
            "perm": [int(i) for i in perm],
            "torch": torch.__version__, "numpy": np.__version__,
        }
        cdir = _open_campaign_dir(checkpoint_dir, manifest)

    rng = np.random.RandomState(retry.seed)
    t_start = time.perf_counter()
    chunk_results = []
    for ci in range(n_chunks):
        path = _chunk_path(cdir, ci) if cdir else None
        res = None
        if path and resume and os.path.exists(path):
            t0 = time.perf_counter()
            res = _load_chunk(path, B)
            stats.checkpoint_read_s += time.perf_counter() - t0
            if res is not None:
                stats.chunks_reused += 1
                stats.chunk_wall_s.append(0.0)
        if res is None:
            t0 = time.perf_counter()
            ids = sched[ci * B:(ci + 1) * B]
            res, meta = _run_chunk_with_retries(
                mode, make_args, ids, params, B, devs, watchdog_s,
                step_budget, retry, rng, stats, label=f"chunk {ci}")
            wall = time.perf_counter() - t0
            meta["wall_s"] = round(wall, 4)
            stats.chunk_wall_s.append(round(wall, 4))
            stats.chunks_computed += 1
            if path:
                t0 = time.perf_counter()
                _save_chunk(path, res, meta)
                stats.checkpoint_write_s += time.perf_counter() - t0
                stats.checkpoint_bytes += os.path.getsize(path)
        chunk_results.append(res)
        if chunk_delay_s:
            time.sleep(chunk_delay_s)
    # chunks are in schedule (packed) order: unscatter back to input order
    # (`packed[i]` is scenario `perm[i]`, so row j comes from `inv[j]`)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    out = sim.SimResult(*[
        np.concatenate(fields, axis=0)[:n][inv]
        for fields in zip(*chunk_results)
    ])
    stats.wall_s = round(time.perf_counter() - t_start, 4)
    return CampaignResult(out, stats.as_dict())


def _run_chunk_with_retries(mode, make_args, chunk_ids, params, B, devs,
                            watchdog_s, step_budget, retry: RetryPolicy,
                            rng, stats: CampaignStats,
                            label: str) -> tuple:
    """Attempt one chunk until it succeeds or the retry budget runs out.

    Mutable per-chunk state across attempts: `b` (the sub-batch size,
    halved on OOM) and `budget` (the step budget, escalated on stall
    trips). The returned result always covers the full `B` scenarios."""
    D = len(devs)
    b = B
    budget = step_budget
    meta = {"attempts": 0, "retries": 0, "shrinks": 0, "timeouts": 0,
            "stall_trips": 0, "final_batch": b, "final_step_budget": budget}
    failure = None
    for attempt in range(retry.max_retries + 1):
        meta["attempts"] = attempt + 1
        if attempt:
            stats.retries += 1
            meta["retries"] += 1
            delay = retry.backoff_s(attempt - 1, rng)
            if delay > 0:
                print(f"# campaign [{label}]: retry {attempt}/"
                      f"{retry.max_retries} after {failure}; backing off "
                      f"{delay:.2f}s (batch {b}, step budget {budget})")
                time.sleep(delay)
        # fresh per attempt so a failed attempt's partial sub-dispatches
        # never pollute the occupancy counters
        tel = []
        oom = False
        try:
            res = _attempt_chunk(mode, make_args, chunk_ids, params, B, b,
                                 devs, budget, watchdog_s, telemetry=tel,
                                 label=label)
        except ChunkTimeout as e:
            stats.timeouts += 1
            meta["timeouts"] += 1
            failure = _let_go(e)
            continue
        except Exception as e:  # noqa: BLE001 — classified below
            if not _is_oom(e):
                raise
            failure = _let_go(e)
            oom = True
        if oom:
            # past the handler nothing holds the failed attempt: its
            # tensors and graph are freed, and the allocator can give
            # their blocks back before the retry
            stats.oom_events += 1
            _free_device_memory()
            if b > retry.shrink_floor * D:
                b = _shrink_batch(b, D, retry.shrink_floor)
                stats.shrinks += 1
                meta["shrinks"] += 1
                meta["final_batch"] = b
            continue
        if budget is not None and \
                (np.asarray(res.stall_reason) == sim.STALL_BUDGET).any():
            stats.stall_trips += 1
            meta["stall_trips"] += 1
            failure = ChunkStalled(
                f"lanes hit the {budget}-step budget")
            budget = budget * retry.budget_escalation
            meta["final_step_budget"] = budget
            continue
        for rec in tel:
            stats.lane_trips += rec["lane_trips"]
            stats.active_trips += rec["active_trips"]
            stats.retired_events += rec["events"]
            stats.steps += rec["steps"]
        return res, meta
    raise CampaignError(
        f"{label}: gave up after {retry.max_retries + 1} attempts "
        f"(last failure: {failure})") from failure


def _attempt_chunk(mode, make_args, chunk_ids, params, B, b, devs,
                   budget, watchdog_s, telemetry: list | None = None,
                   label: str = "chunk") -> sim.SimResult:
    """One attempt at a chunk, possibly as `ceil(B/b)` sub-dispatches
    when OOM shrank the batch below the chunk size. Sub-chunks are padded
    the same way as the campaign pads the global tail (replay the last
    scenario, slice the pad off), so shrinking never changes results."""
    if b >= B:
        part, t, rt, pl = make_args(chunk_ids)
        return _call_with_watchdog(
            lambda stop: _compute_chunk(mode, part, params, t, rt, pl, B,
                                        devs, budget, telemetry=telemetry,
                                        stop=stop),
            watchdog_s, label)
    n_sub = -(-B // b) * b
    sub_idx = np.minimum(np.arange(n_sub), B - 1)
    subs = []
    for lo in range(0, n_sub, b):
        ids = chunk_ids[sub_idx[lo:lo + b]]
        part, t, rt, pl = make_args(ids)
        subs.append(_call_with_watchdog(
            lambda stop, part=part, t=t, rt=rt, pl=pl: _compute_chunk(
                mode, part, params, t, rt, pl, b, devs, budget,
                telemetry=telemetry, stop=stop),
            watchdog_s, label))
    return sim.SimResult(*[
        np.concatenate(fields, axis=0)[:B] for fields in zip(*subs)
    ])
