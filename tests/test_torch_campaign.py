"""The port's crash-safe sweep campaigns (`repro_torch.core.campaign`),
case for case against `tests/test_campaign.py` (its autotune cases are
in `tests/test_torch_autotune.py`), on the same inputs.

The bar is the reference's: a campaign killed after k of n chunks and
resumed against the same checkpoint directory equals one uninterrupted
`run_batch` sweep byte for byte, in all six modes and under stacked
fault plans; injected failures (a `torch.OutOfMemoryError`, watchdog
trips, step-budget stalls) are retried and counted; checkpoints are
reused, corrupt ones recomputed, stale manifests evicted. Where a case
produces a sweep, the port's result is also held to the JAX package's
`run_batch` on the same workloads: schedule and integer fields bit-equal,
the float aggregates within 1e-6 relative (as
`tests/test_torch_simulator.py` holds them). "Kill" is a non-retryable
exception injected into the chunk compute after k chunks; the real
SIGKILL runs in `repro_torch.bench.kill_resume_smoke`, also run here.
"""
import functools
import json
import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import campaign as jcamp, faults as jflt  # noqa: E402
from repro.core import simulator as jsim, workloads as jwl  # noqa: E402
from repro_torch.bench import common  # noqa: E402
from repro_torch.core import campaign as camp, faults as flt  # noqa: E402
from repro_torch.core import simulator as sim, workloads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PARAMS = sim.make_params(device="cpu")
SUITE = workloads.default_suite(n_instances=4)
# 5 scenarios at B=2 -> 3 chunks, the last one padded
CELLS = [(0, 0), (1, 7), (5, 13), (3, 5), (4, 9)]
WLS = [SUITE.build(mi, ri) for mi, ri in CELLS]
B = 2
N_CHUNKS = 3

ALL_MODES = [sim.MODE_LUT, sim.MODE_ETF, sim.MODE_ETF_IDEAL, sim.MODE_DAS,
             sim.MODE_ORACLE, sim.MODE_THRESHOLD]
AGG = ("avg_exec_us", "total_energy_uj", "task_energy_uj",
       "sched_energy_uj", "edp", "reexec_us", "recovery_us")

# no sleeping in unit tests
FAST = camp.RetryPolicy(backoff_base_s=0.0, backoff_max_s=0.0,
                        jitter_frac=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engine's tensors here are tiny: one intra-op thread is faster
    and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TREE = ([sim.FEAT_RATE, 1, 1], [500.0, 4.0, 6.0], [0, 1, 0, 1])


def _tree():
    feat, thr, leaf = TREE
    return sim.DTree(feat=torch.tensor(feat, dtype=torch.int32),
                     thr=torch.tensor(thr, dtype=torch.float32),
                     leaf=torch.tensor(leaf, dtype=torch.int32))


def _mode_kw(mode, jax=False):
    kw = {}
    if mode == sim.MODE_DAS:
        feat, thr, leaf = TREE
        kw["tree"] = (jsim.DTree(jnp.array(feat, jnp.int32),
                                 jnp.array(thr, jnp.float32),
                                 jnp.array(leaf, jnp.int32))
                      if jax else _tree())
    if mode == sim.MODE_THRESHOLD:
        kw["rate_threshold"] = 500.0
    return kw


def _run_batch(mode, **kw):
    return sim.to_numpy(sim.run_batch(mode, WLS, PARAMS, device="cpu",
                                      **kw))


@functools.lru_cache(maxsize=None)
def _ref(mode):
    """One uninterrupted sweep of `mode` over `WLS` (one chunk: results
    do not depend on the chunking), shared by the cases below."""
    return _run_batch(mode, **_mode_kw(mode))


@functools.lru_cache(maxsize=None)
def _jax_run_batch(mode, plans: bool = False, step_budget=None):
    """The JAX package's sweep over `CELLS` (one chunk), under the
    stacked `random_plan(s, deadline_us=3000.0)` when `plans`."""
    jwls = [jwl.default_suite(n_instances=4).build(mi, ri)
            for mi, ri in CELLS]
    plan = (jflt.stack_plans([jflt.random_plan(s, deadline_us=3000.0)
                              for s in range(len(CELLS))]) if plans
            else None)
    res = jsim.run_batch(mode, jwls, plan=plan, step_budget=step_budget,
                         **_mode_kw(mode, jax=True))
    return jsim.SimResult(*[np.asarray(x) for x in res])


def _assert_bit_exact(ref, out, ctx=""):
    for name in sim.SimResult._fields:
        a, b = np.asarray(getattr(ref, name)), np.asarray(getattr(out, name))
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, name)
        assert a.tobytes() == b.tobytes(), (ctx, name, a, b)


def _assert_matches_jax(jres, res, ctx=""):
    for name in sim.SimResult._fields:
        a, b = np.asarray(getattr(jres, name)), np.asarray(getattr(res, name))
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, name)
        if name in AGG:
            np.testing.assert_allclose(b.astype(np.float64),
                                       a.astype(np.float64), rtol=1e-6,
                                       atol=0, err_msg=f"{ctx} {name}")
        else:
            assert np.array_equal(a, b, equal_nan=True), (ctx, name)


class _Killed(Exception):
    """Stand-in for SIGKILL: not OOM, not a timeout -> never retried."""


def _kill_after(monkeypatch, k: int):
    """Patch the chunk compute to die (non-retryably) after k chunks."""
    real = camp._compute_chunk
    seen = {"n": 0}

    def bomb(*a, **kw):
        if seen["n"] >= k:
            raise _Killed(f"killed after {k} chunks")
        seen["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(camp, "_compute_chunk", bomb)
    return lambda: monkeypatch.setattr(camp, "_compute_chunk", real)


def _campaign(mode=sim.MODE_LUT, **kw):
    kw.setdefault("batch_size", B)
    kw.setdefault("retry", FAST)
    return camp.run_campaign(mode, WLS, PARAMS, device="cpu", **kw)


def test_workloads_are_the_references():
    """The port's suite builds the reference's workloads, field for
    field, so every JAX comparison below runs on the same inputs."""
    mine = workloads.stack_workloads(WLS)
    ref = jwl.stack_workloads([jwl.default_suite(n_instances=4).build(*c)
                               for c in CELLS])
    for name, a, b in zip(workloads.FlatWorkload._fields, mine, ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


# ---------------------------------------------------------------------------
# the headline invariant: kill -> resume == one uninterrupted sweep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ALL_MODES, ids=lambda m: sim.MODE_NAMES[m])
def test_kill_resume_bit_exact_all_modes(mode, tmp_path, monkeypatch):
    kw = _mode_kw(mode)
    ref = _ref(mode)

    unkill = _kill_after(monkeypatch, 2)
    with pytest.raises(_Killed):
        _campaign(mode, checkpoint_dir=str(tmp_path), **kw)
    unkill()

    out = _campaign(mode, checkpoint_dir=str(tmp_path), **kw)
    assert out.stats["chunks_reused"] == 2, out.stats
    assert out.stats["chunks_computed"] == N_CHUNKS - 2, out.stats
    _assert_bit_exact(ref, out.result, ctx=f"mode {mode}")
    _assert_matches_jax(_jax_run_batch(mode), out.result,
                        ctx=f"mode {mode} vs JAX")


def test_kill_resume_bit_exact_stacked_fault_plans(tmp_path, monkeypatch):
    """The same invariant with a per-scenario FaultPlan riding the
    scenario axis (chunk slicing must slice the plan too)."""
    plans = flt.stack_plans([flt.random_plan(s, deadline_us=3000.0)
                             for s in range(len(WLS))])
    ref = _run_batch(sim.MODE_LUT, plan=plans)

    unkill = _kill_after(monkeypatch, 1)
    with pytest.raises(_Killed):
        _campaign(plan=plans, checkpoint_dir=str(tmp_path))
    unkill()

    out = _campaign(plan=plans, checkpoint_dir=str(tmp_path))
    assert out.stats["chunks_reused"] == 1, out.stats
    _assert_bit_exact(ref, out.result, ctx="stacked plans")
    _assert_matches_jax(_jax_run_batch(sim.MODE_LUT, plans=True),
                        out.result, ctx="stacked plans vs JAX")


def test_packed_kill_resume_bit_exact(tmp_path, monkeypatch):
    """Length-aware packing: chunks hold scenarios in predicted-length
    order, the permutation rides the manifest, and a killed packed
    campaign resumes to the same unscattered grid-order result."""
    ref = _ref(sim.MODE_ETF)

    unkill = _kill_after(monkeypatch, 2)
    with pytest.raises(_Killed):
        _campaign(sim.MODE_ETF, checkpoint_dir=str(tmp_path), pack=True)
    unkill()

    out = _campaign(sim.MODE_ETF, checkpoint_dir=str(tmp_path), pack=True)
    assert out.stats["packed"] is True
    assert out.stats["chunks_reused"] == 2, out.stats
    assert out.stats["chunks_computed"] == N_CHUNKS - 2, out.stats
    _assert_bit_exact(ref, out.result, ctx="packed kill-resume")
    # the manifest records the (descending predicted-length) permutation,
    # the reference's own
    [cdir] = [d for d in tmp_path.iterdir() if d.is_dir()]
    man = json.loads((cdir / camp.MANIFEST_NAME).read_text())
    pred = camp.predicted_events(workloads.stack_workloads(WLS))
    assert sorted(man["perm"]) == list(range(len(WLS)))
    assert list(np.asarray(pred)[man["perm"]]) == \
        sorted(pred, reverse=True)
    jperm = np.argsort(-jcamp.predicted_events(jwl.stack_workloads(
        [jwl.default_suite(n_instances=4).build(*c) for c in CELLS])),
        kind="stable")
    assert man["perm"] == [int(i) for i in jperm]
    assert man["version"] == jcamp.FORMAT_VERSION and "torch" in man
    # occupancy telemetry covers the computed chunk(s)
    assert out.stats["lane_trips"] > 0
    assert 0 < out.stats["occupancy"] <= 1.0


def test_pack_knob_and_env_opt_out(monkeypatch):
    """pack=False / REPRO_BENCH_PACK=0 keep grid order; either way the
    unscattered result is bit-exact vs run_batch."""
    ref = _ref(sim.MODE_LUT)
    packed = _campaign(pack=True)
    plain = _campaign(pack=False)
    assert packed.stats["packed"] is True
    assert plain.stats["packed"] is False
    _assert_bit_exact(ref, packed.result, ctx="packed")
    _assert_bit_exact(ref, plain.result, ctx="unpacked")
    # packing may only help: never more allocated lane super-steps
    assert packed.stats["lane_trips"] <= plain.stats["lane_trips"]
    monkeypatch.setenv("REPRO_BENCH_PACK", "0")
    env_off = _campaign()
    assert env_off.stats["packed"] is False
    _assert_bit_exact(ref, env_off.result, ctx="env opt-out")


def test_pack_mismatch_resume_recomputes(tmp_path):
    """Chunks checkpointed under one packing order must not be reused by
    a campaign scheduling a different order (the manifest's perm
    mismatches, so the old chunks are dropped)."""
    _campaign(checkpoint_dir=str(tmp_path), pack=True)
    ref = _ref(sim.MODE_LUT)
    out = _campaign(checkpoint_dir=str(tmp_path), pack=False)
    assert out.stats["chunks_reused"] == 0, out.stats
    assert out.stats["chunks_computed"] == N_CHUNKS, out.stats
    _assert_bit_exact(ref, out.result, ctx="pack-mismatch resume")


def test_predicted_events_shape_and_monotonicity():
    """The predictor is `3 * n_tasks + n_insts`, as the reference's."""
    stacked = workloads.stack_workloads(WLS)
    pred = camp.predicted_events(stacked)
    assert pred.shape == (len(WLS),)
    expect = 3 * np.asarray(stacked.n_tasks, np.int64) \
        + np.asarray(stacked.n_insts, np.int64)
    np.testing.assert_array_equal(pred, expect)
    np.testing.assert_array_equal(pred, jcamp.predicted_events(stacked))


def test_uncheckpointed_campaign_matches_run_batch():
    """Without a checkpoint dir the campaign is run_batch + stats."""
    ref = _ref(sim.MODE_ETF)
    out = _campaign(sim.MODE_ETF)
    assert out.stats["n_chunks"] == N_CHUNKS
    assert out.stats["chunks_computed"] == N_CHUNKS
    _assert_bit_exact(ref, out.result)
    _assert_matches_jax(_jax_run_batch(sim.MODE_ETF), out.result,
                        ctx="ETF vs JAX")


def test_full_resume_reuses_every_chunk(tmp_path):
    first = _campaign(checkpoint_dir=str(tmp_path))
    again = _campaign(checkpoint_dir=str(tmp_path))
    assert again.stats["chunks_reused"] == N_CHUNKS
    assert again.stats["chunks_computed"] == 0
    _assert_bit_exact(first.result, again.result)
    # resume=False recomputes but must not change anything
    fresh = _campaign(checkpoint_dir=str(tmp_path), resume=False)
    assert fresh.stats["chunks_computed"] == N_CHUNKS
    _assert_bit_exact(first.result, fresh.result)


def test_corrupt_chunk_is_recomputed(tmp_path):
    first = _campaign(checkpoint_dir=str(tmp_path))
    [cdir] = [d for d in tmp_path.iterdir() if d.is_dir()]
    victim = cdir / "chunk_00001.npz"
    victim.write_bytes(b"not an npz file")
    out = _campaign(checkpoint_dir=str(tmp_path))
    assert out.stats["chunks_reused"] == N_CHUNKS - 1, out.stats
    assert out.stats["chunks_computed"] == 1, out.stats
    _assert_bit_exact(first.result, out.result)


def test_different_spec_does_not_share_checkpoints(tmp_path):
    """Changing anything that affects results (here: the mode) must miss
    the checkpoint, not silently reuse the wrong chunks."""
    _campaign(checkpoint_dir=str(tmp_path))
    out = _campaign(sim.MODE_ETF, checkpoint_dir=str(tmp_path))
    assert out.stats["chunks_reused"] == 0
    ref = _ref(sim.MODE_ETF)
    _assert_bit_exact(ref, out.result)


def test_stale_manifest_drops_old_chunks(tmp_path):
    _campaign(checkpoint_dir=str(tmp_path))
    [cdir] = [d for d in tmp_path.iterdir() if d.is_dir()]
    mpath = cdir / camp.MANIFEST_NAME
    stale = json.loads(mpath.read_text())
    stale["version"] = camp.FORMAT_VERSION - 1
    mpath.write_text(json.dumps(stale))
    # same spec, but the manifest no longer matches -> chunks dropped
    out = _campaign(checkpoint_dir=str(tmp_path))
    assert out.stats["chunks_reused"] == 0
    assert out.stats["chunks_computed"] == N_CHUNKS


# ---------------------------------------------------------------------------
# failure injection: OOM shrink, watchdog, step-budget escalation
# ---------------------------------------------------------------------------
def test_forced_oom_shrinks_and_completes(monkeypatch):
    """A `torch.OutOfMemoryError` above batch 1 -> halving retries down
    to single-scenario sub-chunks, final grid complete and bit-exact."""
    ref = _ref(sim.MODE_LUT)
    real = camp._compute_chunk

    def oomy(mode, part, params, tree, rt, plan, batch, devices, budget,
             **kw):
        if batch > 1:
            raise torch.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 1.21 GiB")
        return real(mode, part, params, tree, rt, plan, batch, devices,
                    budget, **kw)

    monkeypatch.setattr(camp, "_compute_chunk", oomy)
    out = _campaign()
    assert out.stats["oom_events"] == N_CHUNKS, out.stats
    assert out.stats["shrinks"] == N_CHUNKS, out.stats
    assert out.stats["retries"] == N_CHUNKS, out.stats
    _assert_bit_exact(ref, out.result, ctx="post-shrink")


def test_oom_exhaustion_raises_campaign_error(monkeypatch):
    monkeypatch.setattr(
        camp, "_compute_chunk",
        lambda *a, **k: (_ for _ in ()).throw(
            torch.OutOfMemoryError("CUDA out of memory")))
    with pytest.raises(camp.CampaignError, match="gave up after 2 attempts"):
        _campaign(retry=camp.RetryPolicy(max_retries=1, backoff_base_s=0.0,
                                         backoff_max_s=0.0, jitter_frac=0.0))


@pytest.mark.parametrize("watchdog_s", [None, 60.0],
                         ids=["inline", "watchdog-thread"])
def test_oom_retry_frees_the_failed_attempt(watchdog_s, monkeypatch):
    """A failed attempt's frame holds a tensor and its own exception (a
    cycle, as the watchdog's box and a future make one). By the time
    `_free_device_memory` runs, the tensor is dead without a collection;
    the retried run is bit-equal, and on exhaustion the `CampaignError`
    reads as before, chained from a copy of the last failure that holds
    no traceback. Inline and through the watchdog's worker thread."""
    import gc
    import weakref
    real = camp._compute_chunk
    held, dead_at_free = [], []
    msg = "CUDA out of memory. Tried to allocate 1.21 GiB"

    def oomy(mode, part, params, tree, rt, plan, batch, devices, budget,
             fail_always=False, **kw):
        if batch > 1 or fail_always:
            tensor = torch.ones(1000)
            held.append(weakref.ref(tensor))
            err = torch.OutOfMemoryError(msg)
            raise err
        return real(mode, part, params, tree, rt, plan, batch, devices,
                    budget, **kw)

    monkeypatch.setattr(camp, "_free_device_memory", lambda: dead_at_free
                        .append([r() is None for r in held]))
    was = gc.isenabled()
    gc.disable()             # only reference counting may free the tensor
    try:
        monkeypatch.setattr(camp, "_compute_chunk", oomy)
        out = _campaign(watchdog_s=watchdog_s)
        assert out.stats["oom_events"] == N_CHUNKS, out.stats
        assert len(dead_at_free) == N_CHUNKS
        assert all(all(d) for d in dead_at_free), dead_at_free
        _assert_bit_exact(_ref(sim.MODE_LUT), out.result, ctx="freed retry")

        held.clear()
        dead_at_free.clear()
        monkeypatch.setattr(camp, "_compute_chunk",
                            lambda *a, **k: oomy(*a, fail_always=True, **k))
        with pytest.raises(camp.CampaignError) as e:
            _campaign(watchdog_s=watchdog_s,
                      retry=camp.RetryPolicy(max_retries=1,
                                             backoff_base_s=0.0,
                                             backoff_max_s=0.0,
                                             jitter_frac=0.0))
    finally:
        if was:
            gc.enable()
    assert str(e.value) == (f"chunk 0: gave up after 2 attempts (last "
                            f"failure: {msg})")
    cause = e.value.__cause__
    assert type(cause) is torch.OutOfMemoryError and str(cause) == msg
    assert cause.__traceback__ is None and cause.__context__ is None
    assert dead_at_free == [[True], [True, True]]


def test_unrecognized_exception_propagates(monkeypatch):
    """Bugs are not infrastructure weather: no retry, no swallowing."""
    monkeypatch.setattr(
        camp, "_compute_chunk",
        lambda *a, **k: (_ for _ in ()).throw(ValueError("a real bug")))
    with pytest.raises(ValueError, match="a real bug"):
        _campaign()


def test_watchdog_trips_then_retry_succeeds(monkeypatch):
    ref = _ref(sim.MODE_LUT)
    real = camp._compute_chunk
    slow = {"left": 1}

    def sleepy(*a, **kw):
        if slow["left"]:
            slow["left"] -= 1
            time.sleep(3.0)
        return real(*a, **kw)

    monkeypatch.setattr(camp, "_compute_chunk", sleepy)
    # the limit is above a chunk's time here (a few tenths of a second
    # on one CPU thread), the first attempt's hold above the limit
    out = _campaign(watchdog_s=2.0)
    assert out.stats["timeouts"] >= 1, out.stats
    assert out.stats["retries"] >= 1, out.stats
    _assert_bit_exact(ref, out.result, ctx="post-watchdog")


def test_watchdog_stops_the_simulation_before_the_retry(monkeypatch):
    """The port's watchdog does not abandon the expired attempt: the
    simulator sees the stop flag at its next poll and raises `Stopped`,
    and the retry starts only after. A block held mid-simulation trips
    the watchdog; no two blocks ever run at once, and the retry gives
    the uninterrupted result."""
    ref = _ref(sim.MODE_ETF)
    real = sim._block
    state = {"held": False, "inside": 0, "most": 0, "stopped": 0}
    lock = threading.Lock()

    def held_block(*a, **kw):
        with lock:
            state["inside"] += 1
            state["most"] = max(state["most"], state["inside"])
        try:
            if not state["held"]:
                state["held"] = True
                time.sleep(3.0)
            return real(*a, **kw)
        finally:
            with lock:
                state["inside"] -= 1

    real_sim = sim._simulate_on

    def counting(*a, **kw):
        try:
            return real_sim(*a, **kw)
        except sim.Stopped:
            state["stopped"] += 1
            raise

    monkeypatch.setattr(sim, "_block", held_block)
    monkeypatch.setattr(sim, "_simulate_on", counting)
    out = _campaign(sim.MODE_ETF, watchdog_s=2.0)
    assert out.stats["timeouts"] == 1 and out.stats["retries"] == 1, \
        out.stats
    assert state["stopped"] == 1 and state["most"] == 1, state
    _assert_bit_exact(ref, out.result, ctx="stopped and retried")


def test_stuck_worker_ends_the_campaign_unretried(monkeypatch):
    """A worker that has not stopped one more watchdog period after its
    flag was set is stuck inside a block, where no poll reads the flag:
    the campaign ends with a plain `CampaignError` naming the chunk, is
    not retried, and does not wait for the worker."""
    calls = {"n": 0}

    def stuck(*a, **kw):
        calls["n"] += 1
        time.sleep(6.0)             # reads no stop flag
        raise AssertionError("a stuck worker's result is never read")

    monkeypatch.setattr(camp, "_compute_chunk", stuck)
    t0 = time.perf_counter()
    with pytest.raises(camp.CampaignError, match=r"chunk \d+: stuck") as e:
        _campaign(watchdog_s=1.0)
    assert type(e.value) is camp.CampaignError
    assert calls["n"] == 1 and time.perf_counter() - t0 < 5.0


def test_watchdog_retry_frees_the_stopped_attempt(monkeypatch):
    """An attempt stopped by the watchdog holds a tensor in its frame
    until its flag is set, then ends at its poll (`simulator.Stopped`,
    kept in the watchdog's box): the retry starts with that tensor dead,
    without a collection, and finishes bit-equal."""
    import gc
    import weakref
    real = camp._compute_chunk
    held, dead_at_retry = [], []

    def stopped_once(*a, stop=None, **kw):
        if not held:
            tensor = torch.ones(1000)
            held.append(weakref.ref(tensor))
            assert stop.wait(30), "the watchdog set no stop flag"
            raise sim.Stopped("stopped at a poll")
        dead_at_retry.append(held[0]() is None)
        return real(*a, stop=stop, **kw)

    monkeypatch.setattr(camp, "_compute_chunk", stopped_once)
    was = gc.isenabled()
    gc.disable()
    try:
        # the limit is above a chunk's time here, as in the cases above
        out = _campaign(watchdog_s=3.0)
    finally:
        if was:
            gc.enable()
    assert out.stats["timeouts"] >= 1 and out.stats["retries"] >= 1
    assert dead_at_retry[0] is True, dead_at_retry
    _assert_bit_exact(_ref(sim.MODE_LUT), out.result, ctx="stopped retry")


def test_step_budget_trip_escalates_and_completes():
    """A starvation-level step budget trips `STALL_BUDGET`, the retry
    escalates it x`budget_escalation`, and the campaign still converges
    to the unbudgeted result."""
    ref = _ref(sim.MODE_LUT)
    out = _campaign(step_budget=8, retry=camp.RetryPolicy(
        max_retries=6, backoff_base_s=0.0, backoff_max_s=0.0,
        jitter_frac=0.0))
    assert out.stats["stall_trips"] >= 1, out.stats
    assert (np.asarray(out.result.stall_reason) == sim.STALL_NONE).all()
    _assert_bit_exact(ref, out.result, ctx="post-escalation")


def test_step_budget_surfaces_stall_reason():
    """Without the campaign's escalation, a tripped budget is visible as
    `STALL_BUDGET`, in the single-scenario and the batched engine, as
    in the reference's."""
    r = sim.to_numpy(sim.run(sim.MODE_LUT, WLS[0], PARAMS, step_budget=8,
                             device="cpu"))
    assert int(r.stall_reason) == sim.STALL_BUDGET
    assert int(r.n_done) < int(np.asarray(WLS[0].task_type).shape[0])
    rb = _run_batch(sim.MODE_LUT, batch_size=B, step_budget=8)
    assert (np.asarray(rb.stall_reason) == sim.STALL_BUDGET).all()
    jrb = _jax_run_batch(sim.MODE_LUT, step_budget=8)
    np.testing.assert_array_equal(rb.stall_reason, jrb.stall_reason)
    # a generous budget changes nothing
    r0 = sim.to_numpy(sim.run(sim.MODE_LUT, WLS[0], PARAMS, device="cpu"))
    r1 = sim.to_numpy(sim.run(sim.MODE_LUT, WLS[0], PARAMS,
                              step_budget=10_000_000, device="cpu"))
    assert int(r1.stall_reason) == sim.STALL_NONE
    _assert_bit_exact(r0, r1, ctx="generous budget")


# ---------------------------------------------------------------------------
# small pieces: geometry, atomic writes, policy math
# ---------------------------------------------------------------------------
def test_shrink_batch_respects_device_multiple_and_floor():
    assert camp._shrink_batch(8, 1, 1) == 4
    assert camp._shrink_batch(2, 1, 1) == 1
    assert camp._shrink_batch(1, 1, 1) == 1   # already at the floor
    assert camp._shrink_batch(8, 4, 1) == 4   # stays a device multiple
    assert camp._shrink_batch(4, 4, 1) == 4
    assert camp._shrink_batch(16, 1, 4) == 8
    assert camp._shrink_batch(8, 1, 4) == 4   # clamped at floor * D
    for b in range(1, 33):
        for d in (1, 2, 3, 4):
            for floor in (1, 2, 4):
                assert camp._shrink_batch(b, d, floor) == \
                    jcamp._shrink_batch(b, d, floor), (b, d, floor)


def test_backoff_is_seeded_and_capped():
    pol = camp.RetryPolicy(backoff_base_s=1.0, backoff_factor=2.0,
                           backoff_max_s=3.0, jitter_frac=0.5, seed=7)
    a = [pol.backoff_s(k, np.random.RandomState(pol.seed)) for k in range(4)]
    b = [pol.backoff_s(k, np.random.RandomState(pol.seed)) for k in range(4)]
    assert a == b                       # reproducible
    assert all(x <= 3.0 * 1.5 for x in a)   # capped (+jitter)
    assert a[1] >= a[0]                 # growing until the cap
    jpol = jcamp.RetryPolicy(backoff_base_s=1.0, backoff_factor=2.0,
                             backoff_max_s=3.0, jitter_frac=0.5, seed=7)
    assert a == [jpol.backoff_s(k, np.random.RandomState(7))
                 for k in range(4)]


def test_atomic_write_json(tmp_path):
    path = str(tmp_path / "out.json")
    camp.atomic_write_json(path, {"a": 1})
    camp.atomic_write_json(path, {"a": 2, "arr": np.int64(3)},
                           default=lambda o: int(o))
    with open(path) as f:
        assert json.load(f) == {"a": 2, "arr": 3}
    assert not os.path.exists(path + ".tmp")


def test_spec_hash_sensitivity():
    stacked = workloads.stack_workloads(WLS)
    tree = _tree()

    def h(mode, thr, params=PARAMS, tree=tree):
        return camp.spec_hash(mode, stacked, params, tree,
                              np.asarray(thr, np.float32), None)

    assert h(sim.MODE_LUT, 500.0) == h(sim.MODE_LUT, 500.0)
    assert h(sim.MODE_LUT, 500.0) != h(sim.MODE_ETF, 500.0)
    assert h(sim.MODE_LUT, 500.0) != h(sim.MODE_LUT, 600.0)
    # hashed as host numpy: tensors or arrays, one hash
    np_params = type(PARAMS)(*[x.numpy() for x in PARAMS])
    np_tree = type(tree)(*[x.numpy() for x in tree])
    assert h(sim.MODE_LUT, 500.0) == h(sim.MODE_LUT, 500.0, np_params,
                                       np_tree)
    tree2 = sim.DTree(tree.feat, tree.thr + 1.0, tree.leaf)
    assert h(sim.MODE_LUT, 500.0) != h(sim.MODE_LUT, 500.0, tree=tree2)


def _stacked_plans():
    return flt.stack_plans([flt.random_plan(s, deadline_us=3000.0)
                            for s in range(len(WLS))])


# Spec hashes of format v2, which name the campaign directories already
# on disk: a change that moves one makes every such directory miss.
PINNED_HASHES = {
    "defaults": (sim.MODE_LUT, dict, "7fcb4e8a9642bb634754f8495a1f32b0"
                 "02efbad69151cb282bb185afd752363b"),
    "tree-thr-plan": (sim.MODE_DAS, lambda: dict(
        tree=_tree(), rate_threshold=np.full(len(WLS), 500.0),
        plan=_stacked_plans()), "9d302f06daf6d54e8e73c1307b844578"
        "572f600c7e746c38e441fba83c6e1754"),
    "shared-plan": (sim.MODE_THRESHOLD, lambda: dict(
        rate_threshold=500.0, plan=flt.healthy_plan()),
        "4b901106ccc94d63799f7d593cb6638b8f5a8ac4536002e14c5222763baeccfb"),
}


@pytest.mark.parametrize("case", sorted(PINNED_HASHES))
def test_spec_hash_is_pinned(case, tmp_path, monkeypatch):
    """A campaign's spec hashes as it always has, over the inputs that
    the campaign prepares (defaults applied, threshold as float32); the
    directory is named by it. No chunk runs."""
    mode, kw, want = PINNED_HASHES[case]
    _kill_after(monkeypatch, 0)
    with pytest.raises(_Killed):
        _campaign(mode, checkpoint_dir=str(tmp_path), **kw())
    cdir, = tmp_path.iterdir()
    man = json.loads((cdir / camp.MANIFEST_NAME).read_text())
    assert man["spec_hash"] == want and cdir.name == f"{want[:16]}-b{B}"
    if case == "tree-thr-plan":
        assert camp.spec_hash(
            mode, workloads.stack_workloads(WLS), PARAMS, _tree(),
            np.full(len(WLS), 500.0, np.float32), _stacked_plans()) == want


def test_campaign_prepares_once_and_indexes_once_a_chunk(monkeypatch):
    """The campaign runs the sweep's steps itself, never `run_batch`:
    the plan is checked once a sweep, and each chunk's lanes are cut
    from the inputs once (`Sweep.lanes`), also when an OOM shrinks it
    into sub-dispatches (one cut each)."""
    calls = {"validate": 0, "lanes": 0}
    validate, lanes = flt.validate_plan, sim.Sweep.lanes

    def counted(name, real):
        def call(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return call

    plans = _stacked_plans()
    ref = _run_batch(sim.MODE_LUT, plan=plans)
    monkeypatch.setattr(flt, "validate_plan", counted("validate", validate))
    monkeypatch.setattr(sim.Sweep, "lanes", counted("lanes", lanes))
    monkeypatch.setattr(sim, "run_batch", None)
    out = _campaign(plan=plans)
    assert calls == {"validate": 1, "lanes": N_CHUNKS}
    _assert_bit_exact(ref, out.result)

    real = camp._compute_chunk

    def oom_once(mode, part, params, tree, rt, plan, batch, *a, **kw):
        if batch == B and not calls.get("oom"):
            calls["oom"] = 1
            raise torch.OutOfMemoryError("CUDA out of memory")
        return real(mode, part, params, tree, rt, plan, batch, *a, **kw)

    monkeypatch.setattr(camp, "_compute_chunk", oom_once)
    calls.update(validate=0, lanes=0)
    out = _campaign(plan=plans)
    # chunk 0: the failed attempt, then two sub-dispatches of one lane
    assert calls["validate"] == 1 and calls["lanes"] == N_CHUNKS + 2
    assert out.stats["shrinks"] == 1
    _assert_bit_exact(ref, out.result)


def test_batch_size_validation():
    with pytest.raises(ValueError, match="positive"):
        _campaign(batch_size=0)


def test_batched_plan_length_mismatch():
    plans = flt.stack_plans([flt.random_plan(s) for s in range(2)])
    with pytest.raises(ValueError, match="2 scenarios"):
        _campaign(plan=plans)


def test_kill_resume_smoke_with_a_real_sigkill(tmp_path):
    """The SIGKILL smoke test end to end, on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.kill_resume_smoke",
         "--device", "cpu", "--dir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "byte-identical" in out.stdout and "PASS" in out.stdout


# ---------------------------------------------------------------------------
# bench.common: the Bench's campaign routing and health naming
# ---------------------------------------------------------------------------
def test_bench_sweeps_go_through_the_campaign(tmp_path, monkeypatch):
    """`Bench.sweep` is a campaign: checkpoints under `campaign_dir`,
    the reference's knobs read at call time, counters in
    `campaign_stats()` with the reference's keys."""
    monkeypatch.setenv("REPRO_BENCH_BATCH", "2")
    bench = common.Bench("cpu", n_instances=4, campaign_dir=str(tmp_path))
    stacked = workloads.stack_workloads(WLS)
    first = bench.sweep(sim.MODE_LUT, stacked, cells=CELLS)
    again = bench.sweep(sim.MODE_LUT, stacked, cells=CELLS)
    _assert_bit_exact(_ref(sim.MODE_LUT), first)
    _assert_bit_exact(first, again)
    st = bench.campaign_stats()
    assert st["n_sweeps"] == 2 and st["n_chunks"] == 2 * N_CHUNKS
    assert st["chunks_computed"] == N_CHUNKS == st["chunks_reused"]
    assert 0 < st["occupancy"] <= 1 and st["steps"] > 0
    ref_keys = {"n_sweeps", "n_scenarios", "n_chunks", "chunks_reused",
                "chunks_computed", "retries", "timeouts", "oom_events",
                "shrinks", "stall_trips", "lane_trips", "active_trips",
                "retired_events", "occupancy", "chunk_wall_s_max",
                "chunk_wall_s_mean", "sweeps"}
    assert ref_keys <= set(st)
    assert bench.sweeps[0]["steps"] == st["sweeps"][0]["steps"] > 0
    assert bench.sweeps[1]["steps"] == 0          # every chunk reused
    monkeypatch.setenv("REPRO_BENCH_WATCHDOG_S", "-1")
    with pytest.raises(ValueError, match="must be positive"):
        bench.sweep(sim.MODE_LUT, stacked)


def _fake_result(stalled=False, stall_reason=sim.STALL_NONE, jobs=0,
                 tasks=0):
    return types.SimpleNamespace(
        stalled=np.bool_(stalled), stall_reason=np.int32(stall_reason),
        n_dropped_jobs=np.int32(jobs), n_dropped_tasks=np.int32(tasks))


def _stack_fakes(results):
    return types.SimpleNamespace(**{
        k: np.array([getattr(r, k) for r in results])
        for k in ("stalled", "stall_reason", "n_dropped_jobs",
                  "n_dropped_tasks")}, ready_drop=np.zeros(len(results)))


def test_report_health_names_offending_scenarios(capsys):
    jcommon = pytest.importorskip("benchmarks.common")
    results = [_fake_result(),
               _fake_result(stalled=True, stall_reason=sim.STALL_DEADLOCK),
               _fake_result(stall_reason=sim.STALL_BUDGET),
               _fake_result(jobs=3, tasks=7)]
    cells = [(0, 0), (1, 7), (5, 13), (3, 5)]
    health = common.report_health(_stack_fakes(results), label="unit",
                                  cells=cells)
    assert health["unfinished"] == 2 and health["stalled"] == 1
    assert health["dropped_jobs"] == 3 and health["dropped_tasks"] == 7
    assert health["stalled_at"] == [(1, (1, 7), "deadlock"),
                                    (2, (5, 13), "step-budget")]
    assert health["dropped_at"] == [(3, (3, 5), 3, 7)]
    out = capsys.readouterr().out
    assert "scenario (1, (1, 7), 'deadlock')" in out
    assert "step-budget" in out and "scenario (3, (3, 5), 3, 7)" in out
    ref = jcommon.report_health(results, label="unit", cells=cells)
    capsys.readouterr()
    for k in ("stalled_at", "dropped_at", "dropped_jobs", "dropped_tasks"):
        assert health[k] == ref[k], k
    assert health["unfinished"] == ref["stalled_cells"]


def test_report_health_clean_sweep_is_quiet(capsys):
    health = common.report_health(_stack_fakes([_fake_result()] * 3),
                                  label="unit")
    assert health["stalled_at"] == [] and health["dropped_at"] == []
    assert capsys.readouterr().out == ""
