"""The frozen generator and reference against the port's own copies:
equal arrays, and equal simulations in every mode the cells use, with
and without fault plans; the reference's DAS against its LUT and ETF and
against the port's simulator decision by decision."""
import json
import math

import numpy as np
import pytest
import torch

from dasbench import inputs
from dasbench.reference import dfg, ref_sim, workloads
from repro_torch.core import dfg as pdfg, faults as pfaults
from repro_torch.core import ref_sim as pref, soc as psoc
from repro_torch.core import simulator as psim
from repro_torch.core import workloads as pwl

from dasbench.tests.conftest import ROOT, STRESS_FAULTS

HEALTHY = json.loads((ROOT / "dasbench" / "configs" / "dssoc19-healthy.json")
                     .read_text())
CONFIGS = {"dssoc19-healthy": HEALTHY,
           "stressed": dict(HEALTHY, faults=STRESS_FAULTS)}
MODES = {"LUT": 0, "ETF": 1, "ETF-ideal": 2}
DAS_POLICY = inputs.policy("DAS", json.loads(
    (ROOT / "dasbench" / "traffic" / "das-grid.json").read_text())
    ["policy"]["DAS"])
# rates high, either side of the tree's cut (466.6 Mbps), low
DAS_CELLS = ((0, 13), (4, 5), (5, 4), (21, 2))


def _same(a, b, tag):
    for name, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (tag, name)
        assert x.tobytes() == y.tobytes(), (tag, name)


def test_dfgs_equal_the_ports():
    assert dfg.TASK_TYPE_NAMES == psoc.TASK_TYPE_NAMES
    assert dfg.APP_NAMES == pdfg.APP_NAMES
    for name in dfg.APP_NAMES:
        a, b = dfg.APPS[name], pdfg.APPS[name]
        assert a.preds == b.preds, name
        np.testing.assert_array_equal(a.task_types, b.task_types)
        np.testing.assert_array_equal(a.out_kb, b.out_kb)
    assert (dfg.MAX_PREDS, dfg.MAX_SUCCS, dfg.MAX_ROOTS) == (
        pdfg.MAX_PREDS, pdfg.MAX_SUCCS, pdfg.MAX_ROOTS)


def test_soc_tables_equal_the_ports():
    cfg = CONFIGS["dssoc19-healthy"]
    soc = ref_sim.Soc.from_config(cfg["soc"])
    port = psoc.default_soc()
    for got, want in ((soc.pe_cluster, port.pe_cluster),
                      (soc.exec_time, port.exec_time),
                      (soc.cluster_power, port.cluster_power),
                      (soc.task_energy, port.task_energy),
                      (soc.lut_cluster, port.lut_cluster),
                      (soc.exec_on_pe(), port.exec_on_pe())):
        np.testing.assert_array_equal(got, want)
    assert soc.us_per_kb == port.us_per_kb
    for n in range(psoc.ETF_LAT_MAX_N + 1):
        assert soc.etf_latency_us(float(n)) == psoc.etf_latency_us(float(n))
    assert cfg["rates_mbps"] == [float(r) for r in pwl.DATA_RATES_MBPS]
    np.testing.assert_array_equal(workloads.workload_mixes(),
                                  pwl.workload_mixes())


@pytest.mark.parametrize("cell", [(0, 0), (4, 13), (5, 6), (33, 9)])
def test_build_workload_equals_the_ports(cell):
    a = workloads.default_suite(n_instances=12).build(*cell)
    b = pwl.default_suite(n_instances=12).build(*cell)
    _same(a, b, cell)


def test_grid_with_arrivals_equals_the_ports_suite():
    """The vectorised grid, given the suite's own exponential draws,
    is the port's `build_many`, array for array."""
    n = 8
    cells = [(m, r) for m in (0, 3, 17) for r in (0, 7, 13)]
    suite = pwl.default_suite(n_instances=n)
    want = suite.build_many(cells, seed=5)
    rates = workloads.DATA_RATES_MBPS.astype(np.float64)
    draws = np.stack([
        np.random.RandomState(5 + 1000 * m + r).standard_exponential(n)
        for m, r in cells])
    grid = workloads.grid_structure(
        workloads.workload_mixes(), [(m, rates[r]) for m, r in cells], n,
        suite.t_max, suite.i_max)
    got = workloads.with_arrivals(
        grid, workloads.arrivals(draws, rates[[r for _, r in cells]]))
    _same(got, want, "grid")


def _port_plan(p):
    return pfaults.FaultPlan(*[np.asarray(x) for x in p])


@pytest.mark.parametrize("mode", ["LUT", "ETF", "ETF-ideal"])
def test_reference_equals_the_ports(mode):
    soc = ref_sim.Soc.from_config(CONFIGS["dssoc19-healthy"]["soc"])
    suite = workloads.default_suite(n_instances=10)
    psuite = pwl.default_suite(n_instances=10)
    for cell in ((0, 13), (4, 5), (5, 6), (21, 11)):
        got = ref_sim.simulate_ref(MODES[mode], suite.build(*cell), soc)
        want = pref.simulate_ref(MODES[mode], psuite.build(*cell))
        assert got.keys() == want.keys()
        for k in got:
            x, y = np.asarray(got[k]), np.asarray(want[k])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
                (mode, cell, k)


@pytest.mark.parametrize("mode", ["LUT", "ETF"])
def test_reference_equals_the_ports_under_the_cells_plans(mode):
    """Plans of the stress fault model, scenario by scenario."""
    cfg = CONFIGS["stressed"]
    soc = ref_sim.Soc.from_config(cfg["soc"])
    small = dict(cfg, frames=8, n_mixes=2)
    tr = inputs.Traffic(small, {"modes": [mode], "shape": "grid"})
    sw = tr.sweep(2**31 + 7, 3)
    fired = 0
    for j in range(0, 28, 3):
        wl, plan = inputs.scenario(sw, j)
        got = ref_sim.simulate_ref(MODES[mode], wl, soc, plan)
        want = pref.simulate_ref(MODES[mode], pwl.FlatWorkload(*wl),
                                 plan=_port_plan(plan))
        for k in got:
            x, y = np.asarray(got[k]), np.asarray(want[k])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
                (mode, j, k)
        fired += got["n_faults"] + got["n_dropped_jobs"]
    assert fired > 0


def test_fault_plans_follow_the_model():
    cfg = CONFIGS["stressed"]
    p = inputs.fault_plans(cfg, inputs.rng(123, 0, inputs.PLANS), 64)
    pfaults.validate_plan(_port_plan(p))
    dead = np.isfinite(p.pe_fail_at)
    assert (dead.sum(1) == 2).all()
    assert (np.isfinite(p.pe_repair_at).sum(1) == 1).all()
    assert (np.isfinite(p.transient_at).sum((1, 2)) == 4).all()
    assert (p.pe_fail_at[dead] < 200).all() and (p.transient_at[
        np.isfinite(p.transient_at)] < 200).all()
    np.testing.assert_array_equal(p.max_retries, np.tile([2, 0], 32))
    np.testing.assert_array_equal(p.deadline_us,
                                  np.tile([6.0, np.inf], 32).astype(
                                      np.float32))
    # all three fault phases can fire, as in the repository's stress set
    assert pfaults.plan_capabilities(_port_plan(p)) == pfaults.FULL_CAPS


def test_bf16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, 300.7, np.inf, -2.5])
    got = ref_sim.bf16(x)
    assert got[0] == 1.0 and got[1] == 1.0      # a tie rounds to even
    assert got[2] == 1.0078125
    assert got[3] == 300.0 and np.isinf(got[4]) and got[5] == -2.5
    assert ref_sim.bf16(300.7) == 300.0


@pytest.mark.parametrize("slow", [0, 1])
def test_das_with_a_constant_tree_is_lut_or_etf(slow):
    """A tree that always picks one scheduler schedules as that
    scheduler, bit for bit, and adds the classifier's energy a
    decision."""
    soc = ref_sim.Soc.from_config(CONFIGS["dssoc19-healthy"]["soc"])
    suite = workloads.default_suite(n_instances=10)
    tree = DAS_POLICY._replace(feat=(0, 0, 0), thr=(math.inf,) * 3,
                               leaf=(slow,) * 4)
    cls_e = float(np.float32(ref_sim.CLS_ENERGY_UJ))
    for cell in DAS_CELLS:
        wl = suite.build(*cell)
        das = ref_sim.simulate_ref(ref_sim.MODE_DAS, wl, soc, policy=tree)
        base = ref_sim.simulate_ref(
            ref_sim.MODE_ETF if slow else ref_sim.MODE_LUT, wl, soc)
        for k in ("finish", "pe_of", "avg_exec_us", "task_energy_uj",
                  "sched_time_us"):
            x, y = np.asarray(das[k]), np.asarray(base[k])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
                (slow, cell, k)
        n = len(das["log_slow"])
        assert n == int(wl.n_tasks) and das["n_slow"] == slow * n
        # the same sum in another order: float64 rounding alone
        assert das["sched_energy_uj"] == pytest.approx(
            base["sched_energy_uj"] + n * cls_e, rel=1e-12)


def test_das_features_and_picks_equal_the_ports():
    """On four small cells, decision by decision, the reference's rate
    and big-cluster availability equal the port's feature bank
    (`log_feat[..., 0]`, `[..., 2]`) and its picks the port's
    `log_policy`, under the frozen tree."""
    soc = ref_sim.Soc.from_config(CONFIGS["dssoc19-healthy"]["soc"])
    suite = workloads.default_suite(n_instances=10)
    psuite = pwl.default_suite(n_instances=10)
    params = psim.make_params(device="cpu")
    tree = psim.DTree(
        torch.tensor(DAS_POLICY.feat, dtype=torch.int32),
        torch.tensor(DAS_POLICY.thr, dtype=torch.float32),
        torch.tensor(DAS_POLICY.leaf, dtype=torch.int32))
    thr = [t for t in DAS_POLICY.thr if math.isfinite(t)]
    picks = slow = near_misses = 0
    for cell in DAS_CELLS:
        ref = ref_sim.simulate_ref(ref_sim.MODE_DAS, suite.build(*cell), soc,
                                   policy=DAS_POLICY)
        res = psim.to_numpy(psim.run(psim.MODE_DAS, psuite.build(*cell),
                                     params, tree=tree, device="cpu"))
        n = int(res.n_decisions)
        port_slow = np.asarray(res.log_policy).reshape(-1)[:n]
        miss = np.flatnonzero(port_slow != ref["log_slow"][:n])
        # a pick that differs changes the schedule from there on: compare
        # up to the first, which has to be a near tie at a threshold
        m = int(miss[0]) + 1 if miss.size else n
        if not miss.size:
            assert n == len(ref["log_slow"])
            assert int(res.n_slow) == ref["n_slow"]
        feat = np.asarray(res.log_feat, np.float64).reshape(-1, 62)[:m]
        rate, avail = ref["log_rate"][:m], ref["log_big_avail"][:m]
        # The port's times and features are float32, the reference's
        # float64: 1e-5 relative. The availability is a difference of two
        # times (a PE's free time less `now`), so its rounding is that of
        # the times: 1e-5 of the feature or of `now`, the larger.
        np.testing.assert_allclose(feat[:, 0], rate, rtol=1e-5, atol=0,
                                   err_msg=str(cell))
        gap = np.abs(feat[:, 2] - avail)
        scale = np.maximum(np.abs(avail), ref["log_now"][:m])
        assert (gap <= 1e-5 * scale).all(), (cell, gap.max())
        if miss.size:
            f = (rate[-1], avail[-1])
            assert any(abs(v - t) <= 1e-5 * max(abs(t), 1.0)
                       for v in f for t in thr), (cell, m - 1, f)
            near_misses += 1
        n = m
        picks += n
        slow += int(ref["log_slow"][:n].sum())
    print(f"{picks} picks, {slow} slow, {near_misses} missed at a "
          "threshold")
    # the tree mixes both schedulers on these cells
    assert 0 < slow < picks
