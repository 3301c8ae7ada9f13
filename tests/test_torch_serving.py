"""The port's serving engine and DAS dispatch (`repro_torch.serve`), case
for case against `tests/test_serving.py`, and held to the JAX package's
engine: the same requests through both give identical latencies, energy,
EDP and dispatch counts (numpy float64, exact), and the `serving_das`
section with the reference's TPU v5e replica constants injected gives
the rows of `benchmarks.serving_das.run`.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.serve import costmodel as jcm  # noqa: E402
from repro.serve import dispatch as jdsp  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.bench import serving_das  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.serve import costmodel as cm  # noqa: E402
from repro_torch.serve import dispatch as dsp  # noqa: E402
from repro_torch.serve import engine as eng  # noqa: E402

CFG = eng.EngineConfig(n_replicas=3, max_batch=8)
SPEC = cm.ReplicaSpec("t", n_chips=4)
MC = cm.ModelCost.from_config(configs.get_config("phi3-mini-3.8b"))


def _v5e(name="v5e-8", n_chips=8) -> cm.ReplicaSpec:
    """The reference's replica, its constants read from the JAX package."""
    ref = jcm.ReplicaSpec(name, n_chips=n_chips)
    return cm.ReplicaSpec(**dataclasses.asdict(ref))


def _run(dispatcher, rate=20.0, n=60, seed=0):
    reqs = eng.poisson_requests(rate, n, seed)
    return eng.run_engine(reqs, dispatcher, CFG, SPEC, MC)


def test_all_requests_complete():
    res = _run(dsp.LUTDispatcher(3))
    assert all(r.done_s >= 0 for r in res.requests)
    assert all(r.first_token_s >= r.arrival_s for r in res.requests
               if r.first_token_s >= 0)
    assert res.makespan_s > 0 and np.isfinite(res.energy_j)


def test_request_ordering_invariants():
    res = _run(dsp.ETFDispatcher(), rate=50, n=40)
    for r in res.requests:
        assert r.dispatched_s >= r.arrival_s
        assert r.done_s >= r.first_token_s >= r.dispatched_s
        assert r.tokens_out >= r.gen_len


def test_etf_balances_better_than_lut_under_skew():
    """With heavy load, ETF's finish-time search should not be much worse
    than the static table (usually better)."""
    r_lut = _run(dsp.LUTDispatcher(3), rate=100, n=100)
    r_etf = _run(dsp.ETFDispatcher(), rate=100, n=100)
    assert r_etf.mean_latency_s < r_lut.mean_latency_s * 1.5


def test_dispatch_latency_accounting():
    r = _run(dsp.ETFDispatcher(), rate=30, n=50)
    assert r.dispatch_busy_s > 0
    r2 = _run(dsp.LUTDispatcher(3), rate=30, n=50)
    assert r2.dispatch_busy_s < r.dispatch_busy_s


def test_das_dispatcher_trains_and_runs():
    scen = [(5, 40, 0), (80, 40, 0)]
    das = dsp.train_das_dispatcher(scen, CFG, SPEC, MC)
    assert 0.0 <= das.label_slow_frac <= 1.0
    res = _run(das, rate=40, n=60)
    assert res.dispatch_fast + res.dispatch_slow == 60


def test_cost_model_monotonicity():
    assert cm.prefill_seconds(MC, SPEC, 2048) > cm.prefill_seconds(
        MC, SPEC, 512)
    assert cm.decode_step_seconds(MC, SPEC, 16, 4096) >= \
        cm.decode_step_seconds(MC, SPEC, 1, 4096)
    # MLA cache smaller than GQA cache per token
    mla = cm.ModelCost.from_config(configs.get_config("minicpm3-4b"))
    gqa = cm.ModelCost.from_config(configs.get_config("yi-34b"))
    assert mla.kv_bytes_per_token < gqa.kv_bytes_per_token
    # SSM has no per-token cache growth
    ssm = cm.ModelCost.from_config(configs.get_config("mamba2-780m"))
    assert ssm.kv_bytes_per_token == 0.0


# ---------------------------------------------------------------------------
# parity with the JAX package's engine
# ---------------------------------------------------------------------------
def test_h100_replica_constants():
    """The port's replica is an H100 card: no TPU constant is left."""
    spec = cm.ReplicaSpec("h100-8")
    assert (spec.peak_flops, spec.hbm_bw) == (989e12, 3.35e12)
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.CHIP_HBM_BYTES) == \
        (989e12, 3.35e12, 80e9)
    assert spec.power_w == 700.0 and 0 < spec.idle_w < spec.power_w
    ref = jcm.ReplicaSpec("v5e-8")
    assert (spec.peak_flops, spec.hbm_bw, spec.power_w, spec.idle_w) != \
        (ref.peak_flops, ref.hbm_bw, ref.power_w, ref.idle_w)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_cost_equals_the_references(arch):
    mine = cm.ModelCost.from_config(configs.get_config(arch))
    ref = jcm.ModelCost.from_config(jconfigs.get_config(arch))
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def _both(name, jax: bool, das_tree=None):
    mod = jdsp if jax else dsp
    if name == "LUT":
        return mod.LUTDispatcher(3)
    if name == "ETF":
        return mod.ETFDispatcher()
    if name == "threshold":
        return mod.ThresholdDispatcher(40.0, 3)
    return mod.DASDispatcher(das_tree, 3)


@pytest.mark.parametrize("name", ["LUT", "ETF", "threshold", "DAS"])
@pytest.mark.parametrize("rate", [5.0, 40.0, 150.0])
def test_engine_equals_the_references(name, rate):
    """The same requests, replicas and dispatcher through both engines:
    every latency, the energy, EDP and the dispatch counts identical."""
    jspec = jcm.ReplicaSpec("t", n_chips=4)
    jmc = jcm.ModelCost.from_config(jconfigs.get_config("phi3-mini-3.8b"))
    jcfg = jeng.EngineConfig(n_replicas=3, max_batch=8)
    spec = cm.ReplicaSpec(**dataclasses.asdict(jspec))
    jtree = tree = None
    if name == "DAS":
        scen = [(5, 40, 0), (80, 40, 0)]
        jtree = jdsp.train_das_dispatcher(scen, jcfg, jspec, jmc).tree
        tree = dsp.train_das_dispatcher(scen, CFG, spec, MC).tree
        x = np.random.RandomState(0).uniform(0, 200, (64, 2))
        np.testing.assert_array_equal(tree.predict(x), jtree.predict(x))
    ref = jeng.run_engine(jeng.poisson_requests(rate, 80, 3),
                          _both(name, True, jtree), jcfg, jspec, jmc)
    got = eng.run_engine(eng.poisson_requests(rate, 80, 3),
                         _both(name, False, tree), CFG, spec, MC)
    for f in ("mean_latency_s", "p99_latency_s", "mean_ttft_s",
              "throughput_rps", "energy_j", "edp", "dispatch_fast",
              "dispatch_slow", "dispatch_busy_s", "makespan_s"):
        assert getattr(got, f) == getattr(ref, f), f
    for a, b in zip(got.requests, ref.requests):
        assert (a.replica, a.dispatched_s, a.first_token_s, a.done_s,
                a.tokens_out) == (b.replica, b.dispatched_s,
                                  b.first_token_s, b.done_s, b.tokens_out)


def test_serving_das_section_equals_the_references():
    """`serving_das` with the reference's v5e replica injected gives the
    rows of the reference's section, exactly."""
    jsection = pytest.importorskip("benchmarks.serving_das")
    assert serving_das.run(spec=_v5e()) == jsection.run()


def test_serving_das_section_on_the_h100():
    rows = serving_das.run()
    assert [r["rate"] for r in rows] == list(serving_das.RATES)
    for r in rows:
        for k in ("LUT", "ETF", "DAS"):
            assert np.isfinite(r[f"lat_{k}"]) and r[f"lat_{k}"] > 0
            assert np.isfinite(r[f"edp_{k}"]) and r[f"edp_{k}"] > 0
