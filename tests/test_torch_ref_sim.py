"""The port's float64 reference simulator (`core/ref_sim.py`) against the
JAX package's, and the port's tensor simulator against it, without and
with fault plans (`tests/test_differential.py`, `tests/test_faults.py`).

The two reference simulators are the same numpy arithmetic, so they must
agree exactly. The tensor simulator runs in float32 against float64, so
it is held to the reference's own tolerances: finish times within 1e-3
of the largest for at least 98% of the tasks, PE choices equal for more
than 90% (a float64 tie broken the other way), mean latency within
1e-4 relative (1e-3 under faults).
"""
import functools

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import faults as jf, ref_sim as jref  # noqa: E402
from repro.core import workloads as jwl  # noqa: E402
from repro_torch.core import faults, ref_sim, simulator as sim  # noqa: E402
from repro_torch.core import soc, workloads  # noqa: E402

MIXES, RATES = (0, 1, 4, 5), (0, 9, 13)
CELLS = [(m, r) for m in MIXES for r in RATES]
REF_MODES = [sim.MODE_LUT, sim.MODE_ETF, sim.MODE_ETF_IDEAL]
FAULT_MODES = [sim.MODE_LUT, sim.MODE_ETF]


def _plans(F):
    """Plans with failures at t = 0, failures with repairs and retries, a
    glitch storm with no retry budget, and a deadline."""
    hp = F.healthy_plan()
    storm = F.with_retries(hp, 0)
    for pe in range(0, soc.N_PES, 3):
        storm = F.add_transient(storm, pe, 1.5)
    return {
        "fft_dead": F.fail_cluster(hp, soc.FFT_ACC, 0.0),
        "fail_repair": F.fail_pes(F.with_retries(hp, 2), [0, 8, 12], 2.0,
                                  repair_at=6.0),
        "storm_r0": storm,
        "deadline": F.with_deadline(F.slow_cluster(hp, soc.BIG, 2.0), 6.0),
    }


@functools.lru_cache(maxsize=None)
def _suites(n):
    return jwl.default_suite(n_instances=n), workloads.default_suite(
        n_instances=n)


def _assert_same(a: dict, b: dict, tag):
    assert a.keys() == b.keys(), tag
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (tag, k)
        assert x.tobytes() == y.tobytes(), (tag, k)


@pytest.mark.parametrize("mode", REF_MODES, ids=lambda m: sim.MODE_NAMES[m])
def test_ref_sim_equals_jax_ref_sim(mode):
    js, ts = _suites(10)
    for cell in CELLS:
        _assert_same(jref.simulate_ref(mode, js.build(*cell)),
                     ref_sim.simulate_ref(mode, ts.build(*cell)),
                     (mode, cell))


@pytest.mark.parametrize("mode", FAULT_MODES, ids=lambda m: sim.MODE_NAMES[m])
def test_ref_sim_equals_jax_ref_sim_under_faults(mode):
    js, ts = _suites(8)
    jp, tp = _plans(jf), _plans(faults)
    for name in tp:
        for cell in ((5, 6), (0, 12)):
            _assert_same(jref.simulate_ref(mode, js.build(*cell),
                                           plan=jp[name]),
                         ref_sim.simulate_ref(mode, ts.build(*cell),
                                              plan=tp[name]),
                         (mode, name, cell))


def _hold_to_ref(res, ref, wl, avg_rel):
    nt = int(wl.n_tasks)
    assert int(res.n_done) == ref["n_done"]
    fin, fin_ref = res.finish[:nt], ref["finish"][:nt]
    ok = np.isfinite(fin) & np.isfinite(fin_ref)
    atol = 1e-3 * max(1.0, float(np.abs(fin_ref[ok]).max()))
    diff = np.abs(fin[ok] - fin_ref[ok])
    assert (diff <= atol).mean() >= 0.98, diff.max()
    assert (res.pe_of[:nt] == ref["pe_of"][:nt]).mean() > 0.9
    assert float(res.avg_exec_us) == pytest.approx(
        ref["avg_exec_us"], rel=avg_rel, abs=1e-3, nan_ok=True)
    return diff


@pytest.mark.parametrize("mode", REF_MODES, ids=lambda m: sim.MODE_NAMES[m])
def test_port_sim_matches_ref_sim(mode):
    """`tests/test_differential.py` on the port: one batched sweep of the
    twelve cells against the reference simulator, cell by cell."""
    _, ts = _suites(10)
    res = sim.to_numpy(sim.run_batch(mode, ts.build_many(CELLS),
                                     device="cpu"))
    for k, cell in enumerate(CELLS):
        wl = ts.build(*cell)
        ref = ref_sim.simulate_ref(mode, wl)
        r = sim.result_at(res, k)
        diff = _hold_to_ref(r, ref, wl, 1e-4)
        assert diff.max() < 0.25, (cell, diff.max())
        # tied placements may land on clusters with different power
        assert float(r.task_energy_uj) == pytest.approx(
            ref["task_energy_uj"], rel=0.05)


@pytest.mark.parametrize("mode", FAULT_MODES, ids=lambda m: sim.MODE_NAMES[m])
def test_port_sim_matches_ref_sim_under_faults(mode):
    """`tests/test_faults.py`'s differential on the port, every plan of
    `_plans` stacked along the scenario axis: the fault counts equal."""
    _, ts = _suites(8)
    plans = _plans(faults)
    wl = ts.build(5, 6)
    res = sim.to_numpy(sim.run_batch(
        mode, workloads.stack_workloads([wl] * len(plans)),
        plan=faults.stack_plans(list(plans.values())), device="cpu"))
    fired = 0
    for k, (name, plan) in enumerate(plans.items()):
        ref = ref_sim.simulate_ref(mode, wl, plan=plan)
        r = sim.result_at(res, k)
        for f in ("n_faults", "n_retries", "n_dropped_jobs",
                  "n_dropped_tasks", "n_recovered"):
            assert int(getattr(r, f)) == ref[f], (name, f)
        np.testing.assert_array_equal(r.job_dropped, ref["job_dropped"])
        _hold_to_ref(r, ref, wl, 1e-3)
        fired += ref["n_faults"] + ref["n_dropped_jobs"]
    assert fired > 0
