"""The port's fault plans and fault path against the JAX package, on the
cases of `tests/test_faults.py` (mix 5 at rate 6, 8 frames, and its four
mixed plans over four cells).

Every case is one lane of one batched sweep a mode on each side (LUT,
ETF and DAS, the plans stacked along the scenario axis): schedule and
integer fields bit-equal, the float aggregates (energies, EDP, mean
latency, re-executed and recovery time) within 1e-6 relative, since XLA
on the CPU contracts some of them into FMAs. The reference's own
assertions then run on the port's lanes; the port's sequential runs,
its chunking and its per-chunk phase gating are held to its batched
lanes bit for bit.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import faults as jf, simulator as jsim  # noqa: E402
from repro.core import workloads as jwl  # noqa: E402
from repro_torch.core import convert, das, faults, soc  # noqa: E402
from repro_torch.core import simulator as sim, workloads  # noqa: E402

N_INST = 8
CELL = (5, 6)
AGG = ("avg_exec_us", "total_energy_uj", "task_energy_uj",
       "sched_energy_uj", "edp", "reexec_us", "recovery_us")
EXACT = tuple(f for f in sim.SimResult._fields if f not in AGG)
BASE_FIELDS = sim.SimResult._fields[:21]
FAULT_COUNTERS = ("n_faults", "n_retries", "reexec_us", "n_dropped_jobs",
                  "n_dropped_tasks", "recovery_us", "n_recovered")
FFT_PES = np.where(soc.PE_CLUSTER == soc.FFT_ACC)[0]
FFT_TYPES = [i for i, n in enumerate(soc.TASK_TYPE_NAMES)
             if n in ("fft", "ifft")]
MODES = [sim.MODE_LUT, sim.MODE_ETF, sim.MODE_DAS]
PLAN_CELLS = [(0, 3), (5, 6), (5, 13), (1, 9)]
SHARED_RATES = (0, 4, 8, 13)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engine's tensors here are tiny: one intra-op thread is faster
    and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _storm(F, times, retries):
    plan = F.with_retries(F.healthy_plan(), retries)
    for pe in range(soc.N_PES):
        for t in times:
            plan = F.add_transient(plan, pe, float(t))
    return plan


def _plans(F):
    """The four mixed plans of `tests/test_faults.py`, built by `F`."""
    hp = F.healthy_plan()
    return [
        hp,
        F.fail_cluster(hp, soc.FFT_ACC, 0.0),
        F.fail_pes(F.with_retries(hp, 2), [0, 8, 12], 2.0, repair_at=6.0),
        F.with_deadline(F.slow_cluster(hp, soc.BIG, 2.0), 40.0),
    ]


def _cases(F):
    """name -> (plan, cell): every scenario of the reference's tests,
    built with the fault module `F` (the reference's or the port's)."""
    hp = F.healthy_plan()
    fft0 = F.fail_cluster(hp, soc.FFT_ACC, at=0.0)
    cases = {
        "healthy": (hp, CELL),
        "fft_dead": (fft0, CELL),
        "slow_little": (F.slow_cluster(hp, soc.LITTLE, 3.0), CELL),
        "transients_retry": (_storm(F, [1.0, 3.0], 4), CELL),
        "retry_exhaustion": (_storm(F, [1.0, 3.0], 0), CELL),
        "deadline": (F.with_deadline(hp, 2.0), CELL),
        # a drop that rolls back several running tasks of one PE, whose
        # busy time then takes its adds in task order
        "deadline_shared_pe": (F.with_deadline(hp, 3.0), (0, 13)),
        "all_dead_dl_0": (F.with_deadline(
            F.fail_pes(hp, range(soc.N_PES), at=0.0), 2000.0), CELL),
        "all_dead_dl_17": (F.with_deadline(
            F.fail_pes(hp, range(soc.N_PES), at=17.5), 2000.0), CELL),
        "all_dead_inf": (F.fail_pes(hp, range(soc.N_PES), at=0.0), CELL),
        "gated_base": (fft0, CELL),
        "gated_armed": (F.add_transient(fft0, 0, at=1e30), CELL),
        "gated_slack": (F.with_deadline(fft0, 1e30), CELL),
    }
    for k, (plan, cell) in enumerate(zip(_plans(F), PLAN_CELLS)):
        cases[f"stacked_{k}"] = (plan, cell)
    for ri in SHARED_RATES:
        cases[f"shared_{ri}"] = (_plans(F)[2], (5, ri))
    for seed in (0, 1, 2):
        cases[f"random_{seed}"] = (F.random_plan(
            seed, n_fail=3, n_transient=4, t_horizon_us=60.0,
            max_retries=3), CELL)
    for seed in (0, 1):
        cases[f"budget0_{seed}"] = (F.random_plan(
            seed, n_fail=3, n_transient=4, t_horizon_us=20.0,
            max_retries=0), CELL)
    return cases


NAMES = list(_cases(faults))
LANE = {n: k for k, n in enumerate(NAMES)}


def _jtree():
    return jsim.DTree(feat=jnp.array([sim.FEAT_RATE, 1, 1], jnp.int32),
                      thr=jnp.array([500.0, 4.0, 6.0], jnp.float32),
                      leaf=jnp.array([0, 1, 0, 1], jnp.int32))


def _tree():
    return convert.dtree_from_numpy(*[np.asarray(x) for x in _jtree()],
                                    device="cpu")


@functools.lru_cache(maxsize=None)
def _suite():
    return workloads.default_suite(n_instances=N_INST)


def _wl(cell=CELL):
    return _suite().build(*cell)


def _kw(mode):
    return {"tree": _tree()} if mode == sim.MODE_DAS else {}


@functools.lru_cache(maxsize=None)
def _jax(mode):
    """One batched JAX sweep of every case (its plans stacked)."""
    cases = _cases(jf)
    suite = jwl.default_suite(n_instances=N_INST)
    stacked = jwl.stack_workloads([suite.build(*c) for _, c in
                                   cases.values()])
    kw = {"tree": _jtree()} if mode == sim.MODE_DAS else {}
    res = jsim.run_batch(mode, stacked, plan=jf.stack_plans(
        [p for p, _ in cases.values()]), **kw)
    return jsim.SimResult(*[np.asarray(x) for x in res])


@functools.lru_cache(maxsize=None)
def _port(mode):
    """The same sweep through the port, on the CPU."""
    cases = _cases(faults)
    stacked = _suite().build_many([c for _, c in cases.values()])
    return sim.to_numpy(sim.run_batch(
        mode, stacked, plan=faults.stack_plans(
            [p for p, _ in cases.values()]), device="cpu", **_kw(mode)))


def _lane(mode, name):
    return sim.result_at(_port(mode), LANE[name])


def _assert_equal(a, b, fields=sim.SimResult._fields, tag=""):
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, (tag, f)
        assert np.array_equal(x, y, equal_nan=True), (tag, f)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------
def _assert_plans_equal(a, b):
    for f, x, y in zip(faults.FaultPlan._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_plans_are_field_equal_to_the_reference():
    """Every builder, on the same arguments and seeds, gives the
    reference's arrays and dtypes; so does stacking them."""
    jc, tc = _cases(jf), _cases(faults)
    for name in NAMES:
        _assert_plans_equal(jc[name][0], tc[name][0])
    for seed in range(16):
        for kw in ({}, {"n_fail": 5, "n_transient": 9, "max_retries": 0,
                        "deadline_us": 12.5, "t_horizon_us": 33.0}):
            _assert_plans_equal(jf.random_plan(seed, **kw),
                                faults.random_plan(seed, **kw))
    _assert_plans_equal(jf.stack_plans([p for p, _ in jc.values()]),
                        faults.stack_plans([p for p, _ in tc.values()]))
    with pytest.raises(ValueError, match="at least one"):
        faults.stack_plans([])
    with pytest.raises(ValueError, match="already has"):
        _storm(faults, [1.0, 2.0, 3.0, 4.0, 5.0], 0)


def test_plan_capabilities_flags():
    hp = faults.healthy_plan()
    assert faults.plan_capabilities(hp) == (False, False, False)
    assert faults.plan_capabilities(
        faults.fail_pes(hp, [0, 1], at=0.0)) == (True, False, False)
    assert faults.plan_capabilities(
        faults.fail_pes(hp, [0], at=25.0)) == (True, True, False)
    assert faults.plan_capabilities(
        faults.with_deadline(hp, 1e4)) == (False, False, True)
    assert faults.plan_capabilities(
        faults.add_transient(hp, 3, at=40.0)) == (False, True, False)
    jc, tc = _cases(jf), _cases(faults)
    for name in NAMES:
        assert faults.plan_capabilities(tc[name][0]) == \
            jf.plan_capabilities(jc[name][0]), name
    assert faults.plan_capabilities(faults.stack_plans(
        [p for p, _ in tc.values()])) == faults.FULL_CAPS


def test_validate_plan_rejects_malformed():
    hp = faults.healthy_plan()
    for bad, match in (
            (faults.fail_pes(hp, [0], at=5.0, repair_at=1.0), "repair"),
            (faults.slow_cluster(hp, soc.BIG, 0.5), "slowdown"),
            (faults.with_retries(hp, -1), "max_retries"),
            (faults.healthy_plan(n_pes=7), "trailing dim")):
        with pytest.raises(ValueError, match=match):
            faults.validate_plan(bad)
        with pytest.raises(ValueError, match=match):
            sim.run(sim.MODE_LUT, _wl(), plan=bad, device="cpu")
    stacked = faults.stack_plans([hp] * 2)
    assert faults.is_batched(stacked) and not faults.is_batched(hp)
    faults.validate_plan(stacked)
    with pytest.raises(ValueError, match="batched"):
        sim.run(sim.MODE_LUT, _wl(), plan=stacked, device="cpu")
    with pytest.raises(ValueError, match="scenarios"):
        sim.run_batch(sim.MODE_LUT, workloads.stack_workloads([_wl()] * 3),
                      plan=stacked, device="cpu")


# ---------------------------------------------------------------------------
# the fault path against the reference, lane by lane
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES, ids=lambda m: sim.MODE_NAMES[m])
def test_fault_path_matches_jax(mode):
    rj, rt = _jax(mode), _port(mode)
    for name in NAMES:
        k = LANE[name]
        a, b = sim.result_at(rj, k), sim.result_at(rt, k)
        _assert_equal(a, b, EXACT, tag=name)
        for f in AGG:
            np.testing.assert_allclose(
                np.float64(getattr(b, f)), np.float64(getattr(a, f)),
                rtol=1e-6, atol=0, err_msg=f"{name} {f}")
    # the cases really exercise the machinery
    assert rt.n_faults.sum() > 0 and rt.n_retries.sum() > 0
    assert rt.n_dropped_jobs.sum() > 0 and rt.n_recovered.sum() > 0
    assert rt.stalled.sum() == 1      # all PEs dead for ever, no deadline


@pytest.mark.parametrize("mode", list(sim.MODE_NAMES),
                         ids=lambda m: sim.MODE_NAMES[m])
def test_healthy_plan_is_identity(mode):
    stacked = _suite().build_many(PLAN_CELLS)
    kw = dict(_kw(mode), rate_threshold=600.0, device="cpu")
    r0 = sim.to_numpy(sim.run_batch(mode, stacked, **kw))
    r1 = sim.to_numpy(sim.run_batch(mode, stacked,
                                    plan=faults.healthy_plan(), **kw))
    _assert_equal(r0, r1, BASE_FIELDS, tag=sim.MODE_NAMES[mode])
    for name in FAULT_COUNTERS:
        assert not np.asarray(getattr(r1, name)).any(), name
    assert not r1.job_dropped.any()


# ---------------------------------------------------------------------------
# the reference's assertions on the port's lanes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES, ids=lambda m: sim.MODE_NAMES[m])
def test_dead_fft_cluster_degrades_to_cpu(mode):
    r, healthy = _lane(mode, "fft_dead"), _lane(mode, "healthy")
    wl = _wl()
    nt = int(wl.n_tasks)
    assert int(r.n_done) == nt and not bool(r.stalled)
    assert int(r.n_dropped_jobs) == 0
    assert not np.isin(r.pe_of[:nt], FFT_PES).any(), "task on a dead PE"
    assert np.isin(wl.task_type[:nt], FFT_TYPES).any()
    assert float(r.avg_exec_us) > float(healthy.avg_exec_us)


def test_cluster_slowdown_stretches_exec():
    r = _lane(sim.MODE_LUT, "slow_little")
    assert int(r.n_done) == int(_wl().n_tasks)
    assert float(r.avg_exec_us) > float(
        _lane(sim.MODE_LUT, "healthy").avg_exec_us)


def test_transient_kills_and_recovers():
    r = _lane(sim.MODE_ETF, "transients_retry")
    assert int(r.n_done) == int(_wl().n_tasks) and not bool(r.stalled)
    assert int(r.n_faults) > 0
    assert int(r.n_retries) == int(r.n_faults)   # budget never exhausted
    assert int(r.n_dropped_jobs) == 0
    assert int(r.n_recovered) > 0 and float(r.recovery_us) > 0
    assert float(r.reexec_us) >= 0


def test_retry_exhaustion_drops_jobs_and_terminates():
    r = _lane(sim.MODE_ETF, "retry_exhaustion")
    assert int(r.n_faults) > 0 and int(r.n_retries) == 0
    assert int(r.n_dropped_jobs) > 0
    assert int(r.n_dropped_tasks) >= int(r.n_dropped_jobs)
    assert not bool(r.stalled)
    assert int(r.n_done) == int(_wl().n_tasks)
    assert int(r.job_dropped.sum()) == int(r.n_dropped_jobs)


def test_deadline_drops_late_jobs():
    r = _lane(sim.MODE_LUT, "deadline")
    wl = _wl()
    assert int(r.n_dropped_jobs) > 0 and not bool(r.stalled)
    assert int(r.n_done) == int(wl.n_tasks)
    inst = r.inst_exec_us[:int(wl.n_insts)]
    dropped = r.job_dropped[:int(wl.n_insts)]
    assert np.isnan(inst[dropped]).all()
    kept = inst[~dropped]
    assert np.isfinite(kept).all() and (kept <= 2.0 + 1e-3).all()


@pytest.mark.parametrize("mode", MODES, ids=lambda m: sim.MODE_NAMES[m])
def test_batched_matches_sequential_with_stacked_plans(mode):
    for k, (plan, cell) in enumerate(zip(_plans(faults), PLAN_CELLS)):
        seq = sim.run(mode, _wl(cell), plan=plan, device="cpu", **_kw(mode))
        _assert_equal(_lane(mode, f"stacked_{k}"), sim.to_numpy(seq),
                      tag=f"plan {k}")


def test_batched_shared_plan_and_chunking():
    plan = _plans(faults)[2]
    stacked = _suite().build_many([(5, ri) for ri in SHARED_RATES])
    full = sim.to_numpy(sim.run_batch(sim.MODE_ETF, stacked, plan=plan,
                                      device="cpu"))
    chunked = sim.to_numpy(sim.run_batch(sim.MODE_ETF, stacked, plan=plan,
                                         batch_size=3, device="cpu"))
    _assert_equal(full, chunked)
    for k, ri in enumerate(SHARED_RATES):
        _assert_equal(sim.result_at(full, k), _lane(sim.MODE_ETF,
                                                    f"shared_{ri}"))


def test_completed_tasks_never_occupy_dead_pes():
    """No completed task's final run [start, finish) overlaps its PE's
    dead window [fail_at, repair_at)."""
    wl = _wl()
    nt = int(wl.n_tasks)
    exec_pe = soc.default_soc().exec_on_pe()  # slowdown 1 in random_plan
    for seed in (0, 1, 2):
        plan = _cases(faults)[f"random_{seed}"][0]
        r = _lane(sim.MODE_ETF, f"random_{seed}")
        assert not bool(r.stalled)
        done = r.finish[:nt] > -np.inf
        done &= ~r.job_dropped[wl.inst_id[:nt]]
        pe = np.clip(r.pe_of[:nt], 0, None)
        start = r.finish[:nt] - exec_pe[wl.task_type[:nt], pe]
        overlap = (done & (start < plan.pe_repair_at[pe])
                   & (plan.pe_fail_at[pe] < r.finish[:nt] - 1e-6))
        assert not overlap.any(), (seed, np.where(overlap)[0][:5])


def test_all_pes_dead_finite_deadline_never_stalls():
    n_jobs = int(_wl().inst_id.max()) + 1
    for name in ("all_dead_dl_0", "all_dead_dl_17"):
        r = _lane(sim.MODE_ETF, name)
        assert not bool(r.stalled), name
        assert int(r.stall_reason) == sim.STALL_NONE
        assert int(r.job_dropped.sum()) == int(r.n_dropped_jobs)
    assert int(_lane(sim.MODE_ETF, "all_dead_dl_0").n_dropped_jobs) == n_jobs


def test_all_pes_dead_infinite_deadline_is_a_deadlock_stall():
    r = _lane(sim.MODE_ETF, "all_dead_inf")
    assert bool(r.stalled)
    assert int(r.stall_reason) == sim.STALL_DEADLOCK
    assert int(r.n_done) == 0


def test_retry_budget_zero_never_retries():
    for seed in (0, 1):
        r = _lane(sim.MODE_ETF, f"budget0_{seed}")
        assert not bool(r.stalled)
        assert int(r.n_retries) == 0
        assert int(r.n_dropped_jobs) <= int(r.n_faults)


def test_ordered_add_takes_the_references_order():
    """A drop rolls back the busy time of every running victim, several
    of them on one PE at times: the float adds to that PE then happen in
    ascending task order, as the reference's scatter-add does them.
    Values picked so that any other order gives other bits."""
    import jax.numpy as jnp
    params = sim.make_params(device="cpu")
    wl = sim._engine_workload(_suite().build_many([CELL] * 3),
                              torch.device("cpu"))
    ctx = sim._make_ctx(params, wl, drops=True)
    S, T, P = ctx.S, ctx.T, ctx.P
    vals = np.zeros((S, T), np.float32)
    idx = np.zeros((S, T), np.int64)
    mask = np.zeros((S, T), bool)
    # lane 0: three victims on PE 2; lane 1: two on PE 5, one on PE 0;
    # lane 2: none
    for lane, rows in ((0, [(3, 2, 1e8), (7, 2, -1e8), (9, 2, 1.0)]),
                       (1, [(1, 5, 1.0), (4, 0, 7.0), (8, 5, 1e8)])):
        for t, pe, v in rows:
            vals[lane, t], idx[lane, t], mask[lane, t] = v, pe, True
    buf = torch.zeros(S * P + 1)
    sim._ordered_add(ctx, buf, torch.as_tensor(mask), torch.as_tensor(idx),
                     torch.as_tensor(vals))
    got = sim._lanes(buf, S).numpy()
    for lane in range(S):
        want = jnp.zeros(P, jnp.float32).at[
            np.where(mask[lane], idx[lane], P)].add(vals[lane], mode="drop")
        np.testing.assert_array_equal(got[lane], np.asarray(want))
    assert got[0, 2] == 1.0 and got[1, 5] == 1e8


# ---------------------------------------------------------------------------
# phase gating: a chunk builds only the phases its plans can fire
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES, ids=lambda m: sim.MODE_NAMES[m])
def test_gated_kill_phase_bit_exact_vs_full_machinery(mode):
    """Failing at t = 0 builds no kill and drop phases (`can_kill` is
    False); one finite glitch far past the makespan builds them all while
    firing nothing. Both agree bit for bit, alone and in chunks of 2,
    and with the lanes of the all-phase sweep held to JAX above."""
    cases = _cases(faults)
    base, armed = cases["gated_base"][0], cases["gated_armed"][0]
    assert faults.plan_capabilities(base) == (True, False, False)
    assert faults.plan_capabilities(armed) == (True, True, False)
    gated = sim.to_numpy(sim.run(mode, _wl(), plan=base, device="cpu",
                                 **_kw(mode)))
    full = sim.to_numpy(sim.run(mode, _wl(), plan=armed, device="cpu",
                                **_kw(mode)))
    _assert_equal(gated, full)
    _assert_equal(gated, _lane(mode, "gated_base"))
    wl_b = workloads.stack_workloads([_wl()] * 3)
    rb = sim.to_numpy(sim.run_batch(mode, wl_b, plan=faults.stack_plans(
        [base] * 3), batch_size=2, device="cpu", **_kw(mode)))
    _assert_equal(gated, sim.result_at(rb, 2))


def test_gated_deadline_phase_bit_exact_when_slack():
    cases = _cases(faults)
    base, slack = cases["gated_base"][0], cases["gated_slack"][0]
    assert faults.plan_capabilities(slack)[2]
    gated = sim.to_numpy(sim.run(sim.MODE_ETF, _wl(), plan=base,
                                 device="cpu"))
    full = sim.to_numpy(sim.run(sim.MODE_ETF, _wl(), plan=slack,
                                device="cpu"))
    assert int(full.n_dropped_jobs) == 0
    _assert_equal(gated, full)
    _assert_equal(full, _lane(sim.MODE_ETF, "gated_slack"))


# ---------------------------------------------------------------------------
# the iteration budget and the policy entry point
# ---------------------------------------------------------------------------
def test_step_budget_matches_jax():
    """A per-lane event budget under a plan whose retry budget varies by
    lane (the cap is `_fault_iter_bound`, clipped to the budget): the
    lanes that reach it report STALL_BUDGET, as the reference's do."""
    cases = _cases(faults)
    names = ["transients_retry", "retry_exhaustion", "deadline",
             "stacked_2"]
    suite = jwl.default_suite(n_instances=N_INST)
    jstack = jwl.stack_workloads([suite.build(*cases[n][1]) for n in names])
    jc = _cases(jf)
    rj = jsim.run_batch(sim.MODE_ETF, jstack, step_budget=150,
                        plan=jf.stack_plans([jc[n][0] for n in names]))
    rj = jsim.SimResult(*[np.asarray(x) for x in rj])
    rt = sim.to_numpy(sim.run_batch(
        sim.MODE_ETF, _suite().build_many([cases[n][1] for n in names]),
        step_budget=150, plan=faults.stack_plans(
            [cases[n][0] for n in names]), device="cpu"))
    _assert_equal(rj, rt, EXACT)
    assert (rt.stall_reason == sim.STALL_BUDGET).all()


def test_das_policy_runs_a_plan():
    tree = _tree()
    pol = das.DASPolicy(tree=tree, dtree=None, feature_ids=[0, 1],
                        train_accuracy=0.0, test_accuracy=0.0, n_train=0)
    plan = _cases(faults)["transients_retry"][0]
    _assert_equal(sim.to_numpy(pol.run(_wl(), plan=plan, device="cpu")),
                  _lane(sim.MODE_DAS, "transients_retry"))
