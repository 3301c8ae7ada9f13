"""The port's split and padded sweep engine (`simulator.run_batch` with
`devices=`), case for case against `tests/test_shard_sweep.py`.

Lists of CPU devices stand in for the reference's forced XLA host
devices: a list with a repeated device splits each chunk into equal
parts run one after another, the path that distinct cards run at the
same time. Per-scenario results must not depend on `batch_size`, the
device count or the final chunk's padding, bit for bit, in every mode,
with and without stacked fault plans; and they must be the JAX
package's on the same inputs (schedule and integer fields bit-equal,
float aggregates within 1e-6 relative). The sweep's steps are pinned
too: the chunk layout (`simulator.chunk_layout`) and the inputs'
checks (`simulator.prepare_sweep`), which `run_campaign` shares.
"""
import functools
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import faults as jflt, simulator as jsim  # noqa: E402
from repro.core import workloads as jwl  # noqa: E402
from repro_torch.core import campaign as camp, faults as flt  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core import workloads  # noqa: E402

PARAMS = sim.make_params(device="cpu")
SUITE = workloads.default_suite(n_instances=6)
# 5 scenarios: every chunk size below leaves a ragged, padded final chunk,
# and 5 never divides a 4-device split evenly
CELLS = [(0, 0), (1, 7), (5, 13), (3, 5), (4, 9)]
WLS = [SUITE.build(mi, ri) for mi, ri in CELLS]
# the stand-ins for several devices: one device named four times
DEVS = ["cpu"] * 4

ALL_MODES = [sim.MODE_LUT, sim.MODE_ETF, sim.MODE_ETF_IDEAL, sim.MODE_DAS,
             sim.MODE_ORACLE, sim.MODE_THRESHOLD]
AGG = ("avg_exec_us", "total_energy_uj", "task_energy_uj",
       "sched_energy_uj", "edp", "reexec_us", "recovery_us")
TREE = ([sim.FEAT_RATE, 1, 1], [500.0, 4.0, 6.0], [0, 1, 0, 1])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed_tree() -> sim.DTree:
    feat, thr, leaf = TREE
    return sim.DTree(feat=torch.tensor(feat, dtype=torch.int32),
                     thr=torch.tensor(thr, dtype=torch.float32),
                     leaf=torch.tensor(leaf, dtype=torch.int32))


def _jax_tree() -> jsim.DTree:
    feat, thr, leaf = TREE
    return jsim.DTree(jnp.array(feat, jnp.int32), jnp.array(thr, jnp.float32),
                      jnp.array(leaf, jnp.int32))


def _run_batch(mode, **kw):
    kw.setdefault("device", "cpu")
    return sim.to_numpy(sim.run_batch(mode, WLS, PARAMS, **kw))


@functools.lru_cache(maxsize=None)
def _jax(mode, plans: bool = False):
    """The JAX package's sweep of `mode` over `CELLS`, under the stacked
    `random_plan(0..4)` when `plans`: one chunk (the reference's results
    do not depend on the chunking: `tests/test_shard_sweep.py`)."""
    jwls = [jwl.default_suite(n_instances=6).build(*c) for c in CELLS]
    plan = (jflt.stack_plans([jflt.random_plan(s) for s in range(len(WLS))])
            if plans else None)
    tree = _jax_tree() if mode == sim.MODE_DAS else None
    res = jsim.run_batch(mode, jwls, tree=tree, rate_threshold=500.0,
                         plan=plan)
    return jsim.SimResult(*[np.asarray(x) for x in res])


def _assert_equal(a, b, ctx, jax=False):
    """Every field bit-equal (NaN in place), the float aggregates within
    1e-6 relative when `a` is the JAX package's."""
    for name in sim.SimResult._fields:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype and x.shape == y.shape, (ctx, name)
        if jax and name in AGG:
            np.testing.assert_allclose(y.astype(np.float64),
                                       x.astype(np.float64), rtol=1e-6,
                                       atol=0, err_msg=f"{ctx} {name}")
        else:
            assert np.array_equal(x, y, equal_nan=True), (ctx, name)


@functools.lru_cache(maxsize=None)
def _ref(mode):
    """The unsplit, unpadded sweep: one chunk on one device."""
    tree = _mixed_tree() if mode == sim.MODE_DAS else None
    return _run_batch(mode, tree=tree, rate_threshold=500.0, devices=1)


@pytest.mark.parametrize("mode", ALL_MODES, ids=lambda m: sim.MODE_NAMES[m])
def test_sharded_padded_matches_run(mode):
    """batch_size=2 over two device stand-ins: padded and split chunks,
    bit-exact vs the unsplit sweep, and the JAX package's result."""
    tree = _mixed_tree() if mode == sim.MODE_DAS else None
    tel = []
    rb = _run_batch(mode, tree=tree, rate_threshold=500.0, batch_size=2,
                    devices=DEVS[:2], telemetry=tel)
    # 3 chunks of 2 lanes, each split in two parts of one lane
    assert [t["lanes"] for t in tel] == [1] * 6
    _assert_equal(_ref(mode), rb, sim.MODE_NAMES[mode])
    _assert_equal(_jax(mode), rb, sim.MODE_NAMES[mode], jax=True)


def test_invariant_to_batch_size_devices_and_padding():
    """The same sweep through every chunking/splitting configuration —
    including sizes that force pad widths 0..B-1 — is one result."""
    tree = _mixed_tree()
    ref = _ref(sim.MODE_DAS)          # batch_size None on one device
    for bs, devs in ((1, 1), (2, 1), (3, 1), (5, 1),
                     (1, DEVS[:2]), (3, DEVS[:2]), (None, DEVS[:3]),
                     (2, DEVS)):
        r = _run_batch(sim.MODE_DAS, tree=tree, rate_threshold=500.0,
                       batch_size=bs, devices=devs)
        _assert_equal(ref, r, f"batch_size={bs} devices={devs}")


@functools.lru_cache(maxsize=None)
def _plans_split(mode, batch_size):
    """`mode` under stacked per-scenario plans, split over two device
    stand-ins (5 lanes: padded whatever the batch)."""
    tree = _mixed_tree() if mode == sim.MODE_DAS else None
    plans = flt.stack_plans([flt.random_plan(s) for s in range(len(WLS))])
    return _run_batch(mode, tree=tree, rate_threshold=500.0, plan=plans,
                      batch_size=batch_size, devices=DEVS[:2])


@pytest.mark.parametrize("mode", [sim.MODE_LUT, sim.MODE_DAS],
                         ids=lambda m: sim.MODE_NAMES[m])
def test_stacked_fault_plans_sharded(mode):
    """A stacked per-scenario FaultPlan threads through the padded,
    split chunks bit-exactly (pad lanes replay the last plan, results
    sliced off): chunks of 2 lanes in parts of 1 give the one chunk of
    6 lanes in parts of 3, bit for bit, and the JAX package's sweep."""
    two = _plans_split(mode, 2)
    _assert_equal(_plans_split(mode, None), two, sim.MODE_NAMES[mode])
    _assert_equal(_jax(mode, plans=True), two, sim.MODE_NAMES[mode],
                  jax=True)


def test_shared_plan_sharded():
    """An unbatched (shared) plan goes to every part whole; the healthy
    plan keeps the fault path's results those of no plan."""
    rb = _run_batch(sim.MODE_ETF, rate_threshold=500.0,
                    plan=flt.healthy_plan(), batch_size=3, devices=DEVS[:3])
    _assert_equal(_ref(sim.MODE_ETF), rb, "healthy plan")
    _assert_equal(_jax(sim.MODE_ETF), rb, "healthy plan", jax=True)


@pytest.mark.parametrize("mode", ALL_MODES, ids=lambda m: sim.MODE_NAMES[m])
def test_stacked_fault_plans_all_modes(mode):
    """Stacked per-scenario FaultPlans in every mode, split and padded,
    against the JAX package's sweep (the reference runs this case through
    its kernel-backed decision path; the port's CPU path is the kernels'
    plain version, `tests/test_torch_etf_ft.py`)."""
    _assert_equal(_jax(mode, plans=True), _plans_split(mode, None),
                  sim.MODE_NAMES[mode], jax=True)


def test_dead_pe_degraded_etf_tie_breaks():
    """Kill whole clusters at t=0 so the degraded ETF search runs against
    a mostly-dead PE mask: the port must pick the same first global
    minimum (slot, pe) as the reference, in a split sweep."""
    def plan_of(F):
        plan = F.fail_cluster(F.healthy_plan(), 0, at=0.0)
        plan = F.fail_cluster(plan, 2, at=0.0)
        return F.fail_pes(plan, [9, 10, 11], at=50.0)

    plan = plan_of(flt)
    dead_from_t0 = np.where(np.asarray(plan.pe_fail_at) == 0.0)[0]
    wls3 = WLS[:3]
    rb = sim.to_numpy(sim.run_batch(sim.MODE_ETF, wls3, PARAMS, plan=plan,
                                    batch_size=2, devices=DEVS[:2],
                                    device="cpu"))
    pe_of = np.asarray(rb.pe_of)
    assert not np.isin(pe_of[pe_of >= 0], dead_from_t0).any()
    assert (np.asarray(rb.n_done) > 0).all()
    jwls = [jwl.default_suite(n_instances=6).build(*c) for c in CELLS[:3]]
    jr = jsim.run_batch(sim.MODE_ETF, jwls, plan=plan_of(jflt),
                        kernels="off")
    _assert_equal(jsim.SimResult(*[np.asarray(x) for x in jr]), rb,
                  "dead PEs", jax=True)


def test_multi_device_split_really_splits():
    """The split ran: one telemetry record per part, each of its share
    of the lanes, and the same result as one device."""
    tel = []
    shd = _run_batch(sim.MODE_LUT, rate_threshold=500.0, batch_size=len(WLS),
                     devices=DEVS, telemetry=tel)
    # 5 lanes rounded up to 8 over 4 devices: 4 parts of 2
    assert [t["lanes"] for t in tel] == [2, 2, 2, 2]
    _assert_equal(_ref(sim.MODE_LUT), shd, "4 parts")


def test_devices_knob_resolution():
    cpu = torch.device("cpu")
    assert sim._resolve_devices(None, "cpu") == (cpu,)
    assert sim._resolve_devices(1, "cpu") == (cpu,)
    assert sim._resolve_devices(["cpu", "cpu"], "cpu") == (cpu, cpu)
    if not torch.cuda.is_available():
        # asking for the card without one is an error, not the CPU
        with pytest.raises(RuntimeError, match="GPU"):
            sim._resolve_devices(None, "cuda")


def test_devices_knob_validation(monkeypatch):
    with pytest.raises(ValueError, match="out of range"):
        sim.run_batch(sim.MODE_LUT, WLS, PARAMS, devices=2, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        sim._resolve_devices(0, "cpu")
    monkeypatch.setenv("REPRO_BENCH_DEVICES", "lots")
    with pytest.raises(ValueError, match="not an integer"):
        sim._resolve_devices(None, "cpu")


def test_devices_env_knob(monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_DEVICES", "1")
    r = _run_batch(sim.MODE_LUT, rate_threshold=500.0, batch_size=2)
    _assert_equal(_ref(sim.MODE_LUT), r, "env 1")
    assert os.environ["REPRO_BENCH_DEVICES"] == "1"
    monkeypatch.setenv("REPRO_BENCH_DEVICES", "2")
    with pytest.raises(ValueError, match="out of range"):
        _run_batch(sim.MODE_LUT)


@pytest.mark.parametrize("n,batch,n_dev,B,order", [
    (5, None, 1, 5, [0, 1, 2, 3, 4]),
    (5, 8, 1, 5, [0, 1, 2, 3, 4]),                  # batch above n
    (5, 2, 1, 2, [0, 1, 2, 3, 4, 4]),               # ragged tail
    (5, 3, 2, 4, [0, 1, 2, 3, 4, 4, 4, 4]),         # two devices
    (5, None, 4, 8, [0, 1, 2, 3, 4, 4, 4, 4]),      # n below the devices
    (4, 2, 2, 2, [0, 1, 2, 3]),                     # a chunk shrunk by 2
    (6, 4, 2, 4, [0, 1, 2, 3, 4, 5, 5, 5]),         # shrunk, ragged
    (2, 1, 1, 1, [0, 1]),                           # shrunk to one lane
], ids=["whole", "batch-above-n", "ragged", "two-devices", "four-devices",
        "shrunk", "shrunk-ragged", "shrunk-to-one"])
def test_chunk_layout(n, batch, n_dev, B, order):
    """The chunk size is the batch clamped to n and rounded up to a
    multiple of the devices; the order pads to a multiple of it by
    replaying the last lane."""
    got_B, got = sim.chunk_layout(n, batch, n_dev)
    assert got_B == B and got.tolist() == order
    assert B % n_dev == 0 and len(got) % B == 0 and len(got) - n < B


_ERRORS = {
    "batch": ({"batch_size": 0}, "batch_size must be positive, got 0"),
    "threshold": ({"rate_threshold": np.full(3, 500.0)},
                  r"rate_threshold: expected a scalar or \[5\], got \(3,\)"),
    "tree": ({"tree": sim.DTree(*[x.expand(2, *x.shape)
                                  for x in _mixed_tree()])},
             "tree: 2 trees for 5 scenarios"),
    "plan": ({"plan": flt.stack_plans([flt.random_plan(s)
                                       for s in range(2)])},
             "{who}: batched plan has 2 scenarios but the workload has 5"),
}


@pytest.mark.parametrize("who", ["run_batch", "run_campaign"])
@pytest.mark.parametrize("case", sorted(_ERRORS))
def test_sweep_inputs_checked_in_one_place(case, who):
    """Every size and shape error of a sweep comes from `prepare_sweep`,
    with one text, through `run_batch` and `run_campaign` alike."""
    kw, msg = _ERRORS[case]
    run = sim.run_batch if who == "run_batch" else camp.run_campaign
    with pytest.raises(ValueError, match=msg.format(who=who)):
        run(sim.MODE_LUT, WLS, PARAMS, device="cpu", **kw)
