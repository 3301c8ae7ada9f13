"""The port's simulator against the JAX package's `run_batch`, on the
`tests/test_differential.py` grid (mixes 0, 1, 4, 5 x rates 0, 9, 13,
10 instances), all six modes, one batched sweep per mode on each side.

Schedule and integer fields must be bit-equal. The float aggregates
(energies, EDP, mean latency) may differ in the last bits: XLA on the
CPU contracts the energy accumulators into FMAs and sums the latency
mean in its own order, so they are held to a relative 1e-6.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import das as jdas, oracle as joracle  # noqa: E402
from repro.core import simulator as jsim, workloads as jwl  # noqa: E402
from repro_torch.core import convert, simulator as sim  # noqa: E402

MIXES, RATES = (0, 1, 4, 5), (0, 9, 13)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engine's tensors here are tiny: one intra-op thread is faster
    and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
CELLS = [(m, r) for m in MIXES for r in RATES]
THRESHOLD = 900.0
AGG = ("avg_exec_us", "total_energy_uj", "task_energy_uj",
       "sched_energy_uj", "edp")
EXACT = tuple(f for f in sim.SimResult._fields if f not in AGG)
MODES = list(sim.MODE_NAMES)


@functools.lru_cache(maxsize=None)
def _jax_stacked():
    return jwl.default_suite(n_instances=10).build_many(CELLS)


@functools.lru_cache(maxsize=None)
def _stacked():
    """The same stacked workload, carried over as the port's type."""
    return convert.workload_from_numpy(*[np.asarray(x)
                                         for x in _jax_stacked()])


@functools.lru_cache(maxsize=None)
def _jax_tree():
    """The reference's DAS tree, trained on this grid."""
    ds = joracle.generate(jwl.default_suite(n_instances=10),
                          mix_indices=MIXES, rate_indices=RATES)
    return jdas.fit_policy(ds).tree


def _port_tree(jtree):
    return convert.dtree_from_numpy(*[np.asarray(x) for x in jtree],
                                    device="cpu")


@functools.lru_cache(maxsize=None)
def _results(mode):
    tree = _jax_tree() if mode == sim.MODE_DAS else None
    rj = jsim.run_batch(mode, _jax_stacked(), tree=tree,
                        rate_threshold=THRESHOLD)
    rt = sim.run_batch(mode, _stacked(),
                       tree=None if tree is None else _port_tree(tree),
                       rate_threshold=THRESHOLD, device="cpu")
    return (jsim.SimResult(*[np.asarray(x) for x in rj]), sim.to_numpy(rt))


def _assert_exact(a, b, fields=EXACT, tag=""):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (tag, f, x.dtype, y.dtype)
        assert x.shape == y.shape, (tag, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{tag} {f}")


def _assert_close(a, b, rel=1e-6, tag=""):
    for f in AGG:
        x = getattr(a, f).astype(np.float64)
        y = getattr(b, f).astype(np.float64)
        np.testing.assert_allclose(y, x, rtol=rel, atol=0,
                                   err_msg=f"{tag} {f}")


def test_jax_tree_splits():
    """The DAS cases below exercise both schedulers only if the tree
    really splits."""
    leaf = np.asarray(_jax_tree().leaf)
    assert leaf.min() == 0 and leaf.max() == 1


@pytest.mark.parametrize("mode", MODES, ids=lambda m: sim.MODE_NAMES[m])
def test_schedule_fields_bit_equal_to_jax(mode):
    rj, rt = _results(mode)
    _assert_exact(rj, rt, tag=sim.MODE_NAMES[mode])
    assert (rt.ready_drop == 0).all() and not rt.stalled.any()
    assert (rt.stall_reason == sim.STALL_NONE).all()


@pytest.mark.parametrize("mode", MODES, ids=lambda m: sim.MODE_NAMES[m])
def test_float_aggregates_within_1e6_of_jax(mode):
    rj, rt = _results(mode)
    _assert_close(rj, rt, tag=sim.MODE_NAMES[mode])


def test_modes_take_both_schedulers():
    _, das = _results(sim.MODE_DAS)
    _, thr = _results(sim.MODE_THRESHOLD)
    for r in (das, thr):
        assert r.n_fast.sum() > 0 and r.n_slow.sum() > 0
    _, orc = _results(sim.MODE_ORACLE)
    n = orc.n_decisions
    agree = np.concatenate([orc.log_agree[k, :n[k]] for k in range(len(n))])
    assert 0 < agree.mean() < 1


def test_run_matches_run_batch():
    """`run` is the engine with S = 1."""
    tree = _port_tree(_jax_tree())
    _, res = _results(sim.MODE_DAS)
    suite = jwl.default_suite(n_instances=10)
    k = 7
    one = sim.to_numpy(sim.run(sim.MODE_DAS, suite.build(*CELLS[k]),
                               tree=tree, device="cpu"))
    _assert_exact(sim.result_at(res, k), one, fields=sim.SimResult._fields)


def test_batch_size_does_not_change_results():
    """Chunks of 5 (the last padded by replaying scenario 11) give what
    one chunk gives, with one tree per scenario."""
    jt = _jax_tree()
    n = len(CELLS)
    trees = convert.dtree_from_numpy(
        *[np.broadcast_to(np.asarray(x), (n,) + np.shape(x)) for x in jt],
        device="cpu")
    chunked = sim.to_numpy(sim.run_batch(sim.MODE_DAS, _stacked(),
                                         tree=trees, batch_size=5,
                                         device="cpu"))
    _, whole = _results(sim.MODE_DAS)
    _assert_exact(whole, chunked, fields=sim.SimResult._fields)


def test_per_scenario_thresholds_match_jax():
    n = len(CELLS)
    thr = np.linspace(100.0, 2000.0, n).astype(np.float32)
    rj = jsim.run_batch(sim.MODE_THRESHOLD, _jax_stacked(),
                        rate_threshold=jnp.asarray(thr))
    rt = sim.to_numpy(sim.run_batch(sim.MODE_THRESHOLD, _stacked(),
                                    rate_threshold=thr, device="cpu"))
    rj = jsim.SimResult(*[np.asarray(x) for x in rj])
    _assert_exact(rj, rt)
    _assert_close(rj, rt)


def test_fault_plan_is_not_ported_yet():
    """`plan=` takes only a well-formed `FaultPlan`: anything else is
    refused before the engine runs (the fault path itself is held to the
    reference in `test_torch_faults.py`)."""
    from repro_torch.core import faults
    with pytest.raises(TypeError):
        sim.run_batch(sim.MODE_LUT, _stacked(), plan=object(), device="cpu")
    with pytest.raises(ValueError, match="trailing dim"):
        sim.run_batch(sim.MODE_LUT, _stacked(),
                      plan=faults.healthy_plan(n_pes=7), device="cpu")


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        sim.run_batch(sim.MODE_LUT, _stacked(), batch_size=0, device="cpu")
    with pytest.raises(ValueError):
        sim.run_batch(sim.MODE_THRESHOLD, _stacked(),
                      rate_threshold=np.zeros(3, np.float32), device="cpu")


def test_dtree_predict_matches_jax():
    rng = np.random.RandomState(3)
    feats = rng.uniform(0, 2000, size=(64, sim.N_FEATURES)).astype(
        np.float32)
    jt = jsim.DTree(jnp.array([0, 2, 5], jnp.int32),
                    jnp.array([900.0, 1.0, 0.5], jnp.float32),
                    jnp.array([0, 1, 1, 0], jnp.int32))
    want = np.array([int(jt.predict(jnp.asarray(f))) for f in feats])
    got = _port_tree(jt).predict(torch.as_tensor(feats)).numpy()
    np.testing.assert_array_equal(got, want)
