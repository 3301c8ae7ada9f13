"""The port's oracle labelling, classifiers, DAS policy and the summary40
pipeline against the JAX package, at 10 instances per workload."""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import classifier as jclf, das as jdas  # noqa: E402
from repro.core import oracle as joracle, simulator as jsim  # noqa: E402
from repro.core import workloads as jwl  # noqa: E402
from repro_torch.bench import summary40  # noqa: E402
from repro_torch.core import classifier as clf, das, oracle  # noqa: E402
from repro_torch.core import simulator as sim, workloads  # noqa: E402

# summary40's own rates; the summary slice below trains and evaluates on
# this grid, so the reference compiles each sweep shape once
MIXES, RATES = (0, 1, 2), tuple(summary40.LOW_RATES + summary40.HIGH_RATES)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engine's tensors here are tiny: one intra-op thread is faster
    and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
METRICS = ("avg_exec_us", "edp")


@functools.lru_cache(maxsize=None)
def _datasets(metric):
    jds = joracle.generate(jwl.default_suite(n_instances=10),
                           mix_indices=MIXES, rate_indices=RATES,
                           metric=metric)
    tds = oracle.generate(workloads.default_suite(n_instances=10),
                          mix_indices=MIXES, rate_indices=RATES,
                          metric=metric, device="cpu")
    return jds, tds


def _assert_ds_equal(a, b):
    for f in ("features", "labels", "groups", "rates"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("metric", METRICS)
def test_oracle_dataset_equals_jax(metric):
    jds, tds = _datasets(metric)
    assert len(tds) > 0
    if metric == "avg_exec_us":   # on this grid EDP labels are all F
        assert 0 < tds.labels.mean() < 1
    _assert_ds_equal(jds, tds)


def test_sequential_generate_equals_batched():
    suite = workloads.default_suite(n_instances=10)
    kw = dict(mix_indices=(5,), rate_indices=(13,), device="cpu")
    _assert_ds_equal(oracle.generate(suite, batched=True, **kw),
                     oracle.generate(suite, batched=False, **kw))


def test_train_test_split_equals_jax():
    jds, tds = _datasets("avg_exec_us")
    for a, b in zip(joracle.train_test_split(jds),
                    oracle.train_test_split(tds)):
        _assert_ds_equal(a, b)


def _assert_policy_equal(jp, tp):
    for f, x in zip(jsim.DTree._fields, jp.tree):
        np.testing.assert_array_equal(np.asarray(x),
                                      getattr(tp.tree, f).numpy(), err_msg=f)
    assert list(jp.feature_ids) == list(tp.feature_ids)
    assert jp.train_accuracy == tp.train_accuracy
    assert jp.test_accuracy == tp.test_accuracy
    assert jp.n_train == tp.n_train


@pytest.mark.parametrize("metric", METRICS)
def test_fit_policy_identical_splits(metric):
    jds, tds = _datasets(metric)
    _assert_policy_equal(jdas.fit_policy(jds), das.fit_policy(tds))


def test_greedy_feature_policy_identical():
    jds, tds = _datasets("avg_exec_us")
    jsel = jclf.greedy_select(jds.features, jds.labels, k=2)
    tsel = clf.greedy_select(tds.features, tds.labels, k=2)
    assert jsel == tsel
    _assert_policy_equal(jdas.fit_policy(jds, feature_ids=jsel),
                         das.fit_policy(tds, feature_ids=tsel))


def test_logistic_regression_accuracy_within_1e3():
    jds, tds = _datasets("avg_exec_us")
    jlr = jclf.LogisticRegression.fit(jds.features, jds.labels)
    tlr = clf.LogisticRegression.fit(tds.features, tds.labels, device="cpu")
    ja = jlr.accuracy(jds.features, jds.labels)
    ta = tlr.accuracy(tds.features, tds.labels)
    assert abs(ja - ta) <= 1e-3, (ja, ta)
    assert ta > 0.5


def test_train_das_runs_its_policy():
    suite = workloads.default_suite(n_instances=10)
    pol = das.train_das(suite, mix_indices=MIXES, rate_indices=RATES,
                        device="cpu")
    _, tds = _datasets("avg_exec_us")
    _assert_policy_equal(das.fit_policy(tds), pol)
    res = sim.to_numpy(pol.run(suite.build(5, 13), device="cpu"))
    assert int(res.n_done) == int(suite.build(5, 13).n_tasks)


# ---------------------------------------------------------------------------
# the slice as a whole: summary40 on a 3-mix grid against the reference
# ---------------------------------------------------------------------------
S40_MIXES, S40_RATES, S40_INSTANCES = MIXES, RATES, 10


def _jax_summary():
    """`benchmarks/summary40.py`'s pipeline on the JAX package, cut to
    the test grid (no campaign layer: plain `run_batch` sweeps)."""
    suite = jwl.default_suite(n_instances=S40_INSTANCES)
    ds = {m: _datasets(m)[0] for m in METRICS}   # the same grid

    def auto(metric):
        tr, _ = joracle.train_test_split(ds[metric])
        idx = np.random.RandomState(0).permutation(len(tr))[:6000]
        sel = jclf.greedy_select(tr.features[idx], tr.labels[idx], k=2)
        return jdas.fit_policy(ds[metric], feature_ids=sel)

    cells = [(mi, ri) for mi in S40_MIXES for ri in S40_RATES]
    stacked = suite.build_many(cells)

    def grid(mode, tree=None):
        r = jsim.run_batch(mode, stacked, tree=tree)
        return jsim.SimResult(*[np.asarray(x, np.float64)
                                if np.asarray(x).dtype == np.float32
                                else np.asarray(x) for x in r])

    d = grid(jsim.MODE_DAS, auto("avg_exec_us").tree).avg_exec_us
    de = grid(jsim.MODE_DAS, auto("edp").tree).edp
    lut, etf = grid(jsim.MODE_LUT), grid(jsim.MODE_ETF)
    low = np.array([ri in summary40.LOW_RATES for _, ri in cells])
    return {
        "speedup_vs_etf_low": float(np.mean(etf.avg_exec_us[low] / d[low])),
        "edp_red_vs_etf_low": float(np.mean(1 - de[low] / etf.edp[low])),
        "speedup_vs_lut_high": float(np.mean(lut.avg_exec_us[~low]
                                             / d[~low])),
        "edp_red_vs_lut_high": float(np.mean(1 - de[~low] / lut.edp[~low])),
        "das_matches_best_frac": float(
            (d <= np.minimum(lut.avg_exec_us, etf.avg_exec_us) * 1.02).sum())
        / len(cells),
        "n_samples": {m: len(ds[m]) for m in METRICS},
    }


def test_summary40_slice_matches_jax(monkeypatch):
    # one chunk a sweep, as on the JAX side; the autotune's probe never runs
    monkeypatch.setenv("REPRO_BENCH_BATCH", str(1 << 20))
    got = summary40.run("cpu", n_instances=S40_INSTANCES,
                        n_mixes=len(S40_MIXES),
                        train_mixes=S40_MIXES, train_rates=S40_RATES)
    want = _jax_summary()
    assert got["das_matches_best_frac"] == want["das_matches_best_frac"]
    for k in summary40.DERIVED[:4]:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
    assert got["n_samples"] == want["n_samples"]
    assert got["n_cells"] == len(S40_MIXES) * len(S40_RATES)
    for sw in got["sweeps"]:
        assert sw["stalled"] == sw["unfinished"] == sw["ready_drop"] == 0
        assert sw["steps"] > 0 and sw["events"] > 0
    assert {s["label"] for s in got["sweeps"]} >= {
        "oracle oracle", "oracle ETF", "grid LUT", "grid ETF",
        "grid ETF-ideal", "grid DAS", "grid DAS-FS", "grid DAS-EDP"}
