"""The port's hardware tables, DAGs and workloads against the JAX package."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import dfg as jdfg, soc as jsoc  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import workloads as jwl  # noqa: E402
from repro_torch.core import convert, dfg, simulator as sim, soc  # noqa: E402
from repro_torch.core import workloads  # noqa: E402
from repro_torch.core.device import resolve  # noqa: E402

SOC_NAMES = ("PE_CLUSTER", "CLUSTER_PE_START", "CLUSTER_PE_MASK",
             "EXEC_TIME", "CLUSTER_POWER", "TASK_ENERGY", "LUT_CLUSTER",
             "US_PER_KB", "LUT_LATENCY_US", "LUT_ENERGY_UJ",
             "DAS_CLS_ENERGY_UJ", "ETF_LAT_C0", "ETF_LAT_C1", "ETF_LAT_C2",
             "SCHED_POWER_W", "CLUSTER_NAMES", "PES_PER_CLUSTER",
             "TASK_TYPE_NAMES", "N_PES", "N_CLUSTERS", "N_TASK_TYPES")


@pytest.mark.parametrize("name", SOC_NAMES)
def test_soc_constant_matches(name):
    a, b = getattr(jsoc, name), getattr(soc, name)
    assert np.asarray(a).dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_make_params_matches():
    jp = jsim.make_params()
    tp = sim.make_params(device="cpu")
    for f, a, b in zip(jsim.SimParams._fields, jp, tp):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, f
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f)


def test_sim_params_from_numpy_roundtrip():
    jp = jsim.make_params()
    tp = convert.sim_params_from_numpy(*[np.asarray(x) for x in jp],
                                       device="cpu")
    for a, b in zip(sim.make_params(device="cpu"), tp):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_etf_latency_table_matches_jitted_reference():
    """XLA contracts the latency polynomial into FMAs; the table holds the
    contracted values, which the plain formula misses at n = 7, 15."""
    f = jax.jit(jsoc.etf_latency_us)
    want = np.array([np.asarray(f(jnp.float32(n))) for n in range(17)],
                    np.float32)
    assert soc.ETF_LAT_TABLE.dtype == np.float32
    np.testing.assert_array_equal(soc.ETF_LAT_TABLE, want)
    batched = jax.jit(jax.vmap(jsoc.etf_latency_us))(
        jnp.arange(17, dtype=jnp.float32))
    np.testing.assert_array_equal(soc.ETF_LAT_TABLE, np.asarray(batched))


@pytest.mark.parametrize("app", jdfg.APP_NAMES)
def test_app_graphs_match(app):
    a, b = jdfg.APPS[app], dfg.APPS[app]
    np.testing.assert_array_equal(a.task_types, b.task_types)
    np.testing.assert_array_equal(a.out_kb, b.out_kb)
    assert a.preds == b.preds
    np.testing.assert_array_equal(a.depths(), b.depths())
    assert a.succs() == b.succs()


def test_dfg_bounds_match():
    for name in ("APP_NAMES", "N_APPS", "MAX_APP_TASKS", "MAX_PREDS",
                 "MAX_SUCCS", "MAX_ROOTS"):
        assert getattr(jdfg, name) == getattr(dfg, name), name


def test_mixes_and_rates_match():
    np.testing.assert_array_equal(jwl.workload_mixes(),
                                  workloads.workload_mixes())
    np.testing.assert_array_equal(jwl.DATA_RATES_MBPS,
                                  workloads.DATA_RATES_MBPS)


CELLS = [(0, 0), (1, 9), (4, 13), (5, 3), (17, 7), (22, 11), (39, 13),
         (10, 0)]


def _assert_workload_equal(a, b):
    for f, x, y in zip(jwl.FlatWorkload._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("n_inst", [10, 60])
@pytest.mark.parametrize("cell", CELLS)
def test_workload_matches(n_inst, cell):
    js = jwl.default_suite(n_instances=n_inst)
    ts = workloads.default_suite(n_instances=n_inst)
    _assert_workload_equal(js.build(*cell), ts.build(*cell))


def test_build_many_and_to_device():
    js = jwl.default_suite(n_instances=10)
    ts = workloads.default_suite(n_instances=10)
    jst, tst = js.build_many(CELLS), ts.build_many(CELLS)
    _assert_workload_equal(jst, tst)
    dev = workloads.to_device(tst, "cpu")
    for x, y in zip(tst, dev):
        assert torch.is_tensor(y)
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
        assert np.asarray(x).dtype == y.numpy().dtype


def test_workload_from_numpy():
    wl = jwl.default_suite(n_instances=10).build(4, 9)
    got = convert.workload_from_numpy(*[np.asarray(x) for x in wl])
    _assert_workload_equal(wl, got)
    with pytest.raises(ValueError):
        convert.workload_from_numpy(*[np.asarray(x) for x in wl][:-1])


def _corrupt(wl, field, fn):
    arrs = {f: np.array(x) for f, x in zip(wl._fields, wl)}
    fn(arrs[field])
    return arrs


@pytest.mark.parametrize("field,fn", [
    ("task_type", lambda a: a.__setitem__(0, 99)),
    ("out_kb", lambda a: a.__setitem__(0, np.nan)),
    ("inst_arrival", lambda a: a.__setitem__(0, -1.0)),
    ("preds", lambda a: a.__setitem__((1, 0), 5)),
])
def test_validate_workload_rejects_like_reference(field, fn):
    wl = jwl.default_suite(n_instances=10).build(0, 0)
    bad = _corrupt(wl, field, fn)
    with pytest.raises(ValueError):
        jwl.validate_workload(jwl.FlatWorkload(**bad))
    with pytest.raises(ValueError):
        workloads.validate_workload(workloads.FlatWorkload(**bad))


def test_stack_workloads_shape_mismatch_raises():
    a = workloads.default_suite(n_instances=10).build(0, 0)
    b = workloads.default_suite(n_instances=12).build(0, 0)
    with pytest.raises(ValueError):
        workloads.stack_workloads([a, b])


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the error path needs none")
    with pytest.raises(RuntimeError):
        resolve("cuda")
    with pytest.raises(RuntimeError):
        sim.make_params()
    assert resolve("cpu").type == "cpu"
