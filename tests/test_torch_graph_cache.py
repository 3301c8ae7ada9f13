"""The engine's kept graphs (`simulator._GRAPHS`), on the CPU.

A CUDA graph records the kernels of one block of super-steps over fixed
buffers and replays them on whatever those buffers hold. Here it is
stood in for by `graph_standin.FakeGraph`, which replays the ATen ops
recorded while `torch.cuda.graph` ran. So `simulator._capture` runs as it is and
`_simulate(..., graph=True)` keeps its graph on the CPU, and a later call
of the same shapes copies its inputs into the kept buffers, resets the
state and replays. Held to `_simulate_eager` field by field, bit for bit.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from graph_standin import RECORDING as _RECORDING  # noqa: E402
from graph_standin import FakeGraph as _FakeGraph  # noqa: E402
from graph_standin import fake_capture as _fake_capture  # noqa: E402
from graph_standin import storage as _storage  # noqa: E402
from repro_torch.core import campaign as camp, convert  # noqa: E402
from repro_torch.core import faults, simulator as sim, workloads  # noqa: E402

PARAMS = sim.make_params(device="cpu")
SUITE = workloads.default_suite(n_instances=4)
CELLS = [(0, 9), (4, 13), (5, 2), (1, 6)]


@pytest.fixture(autouse=True)
def _graphs_on_cpu(monkeypatch):
    """The stand-in graph, one thread, and no kept graph before or after."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    sim.clear_graph_cache()
    yield
    sim.clear_graph_cache()
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _wls(seed: int, n: int = len(CELLS)):
    """`n` scenarios of the same shapes, arrivals drawn from `seed`."""
    return SUITE.build_many([CELLS[i % len(CELLS)] for i in range(n)],
                            seed=seed)


@functools.lru_cache(maxsize=None)
def _plans(seed: int, deadline: bool = True, n: int = len(CELLS)):
    """Plans that fail PEs and glitch, half with no retry budget, half
    (with `deadline`) with a deadline that fires: kills, retries and
    drops."""
    plans = [faults.random_plan(seed * 10 + k, n_fail=3, t_horizon_us=6.0)
             for k in range(n)]
    plans = [faults.with_retries(p, 0) if k % 2 or not deadline
             else faults.with_deadline(p, 4.0) for k, p in enumerate(plans)]
    return faults.stack_plans(plans)


def _tree(n: int = len(CELLS)):
    """A tree that splits on the rate, so DAS takes both schedulers."""
    t = convert.dtree_from_numpy(
        np.array([sim.FEAT_RATE, 0, 0], np.int32),
        np.array([400.0, 1e9, -1e9], np.float32),
        np.array([0, 0, 1, 1], np.int32), device="cpu")
    return sim.DTree(*[x.expand(n, *x.shape).contiguous() for x in t])


def _call(mode, seed, plan=None, n=len(CELLS), counted=True, **kw):
    """One engine call on the graph path; returns (result, its telemetry
    record, None when occupancy is not counted)."""
    tel = [] if counted else None
    res = sim._simulate(mode, PARAMS, _wls(seed, n), _tree(n),
                        torch.full((n,), 900.0), tel, True, plan, **kw)
    return res, (tel[-1] if tel else None)


def _eager(mode, seed, plan=None, n=len(CELLS), **kw):
    return sim._simulate_eager(mode, PARAMS, _wls(seed, n), _tree(n),
                               torch.full((n,), 900.0), plan=plan, **kw)


def _host(res) -> dict:
    return {f: getattr(res, f).numpy().copy() for f in sim.SimResult._fields}


def _assert_same(got, want):
    for f in sim.SimResult._fields:
        a, b = got[f], want[f]
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


CASES = {
    "LUT": (sim.MODE_LUT, False),
    "ETF": (sim.MODE_ETF, False),
    "DAS": (sim.MODE_DAS, False),
    "DAS-kills-drops": (sim.MODE_DAS, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_kept_graph_replays_bit_equal_to_the_eager_loop(case):
    """The second call of a shape, on other arrivals (and other plans),
    replays the first call's graph from super-step 0: bit-equal to the
    eager loop on its own inputs; the first call's result is left as it
    was."""
    mode, planned = CASES[case]
    pa = _plans(1) if planned else None
    pb = _plans(2) if planned else None
    first, rec_a = _call(mode, 1, plan=pa)
    kept = _host(first)
    second, rec_b = _call(mode, 2, plan=pb)
    assert (rec_a["graph"], rec_b["graph"]) == ("captured", "hit")
    assert rec_b["replays"] == rec_b["steps"] // sim.POLL_EVERY > 1
    _assert_same(_host(second), _host(_eager(mode, 2, plan=pb)))
    _assert_same(_host(first), kept)
    _assert_same(kept, _host(_eager(mode, 1, plan=pa)))
    if planned:
        assert int(second.n_faults.sum()) > 0
        assert int(second.n_dropped_jobs.sum()) > 0
    # the result owns its buffers: none is a view of the kept state
    g, = sim._GRAPHS.values()
    kept_ptrs = {_storage(t) for t in sim._tensors((g.s, g.inputs))}
    assert not {_storage(x) for x in second} & kept_ptrs


# (the first call, the second call, what the second does)
CHANGES = {
    "lanes": ({}, dict(n=3), "captured"),
    "mode": ({}, dict(mode=sim.MODE_ETF), "captured"),
    "fault-phases": (dict(plan=_plans(1)),
                     dict(plan=_plans(2, deadline=False)), "captured"),
    "step-budget": ({}, dict(step_budget=200), "captured"),
    "occupancy-off": ({}, dict(counted=False), "captured"),
    # under a plan the budget is folded into the [S] cap, an input
    "step-budget-under-a-plan": (dict(plan=_plans(1)),
                                 dict(plan=_plans(2), step_budget=200),
                                 "hit"),
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_a_changed_key_captures_anew(change):
    """What the graph bakes in is the key: the lanes, the mode, the fault
    phases built, an int step budget, whether occupancy is counted. A
    call that changes one captures a graph of its own, kept beside the
    first; a budget under a plan is data, copied in."""
    first, second, expect = CHANGES[change]
    first = {"mode": sim.MODE_DAS, **first}
    _, rec = _call(first.pop("mode"), 1, **first)
    assert rec["graph"] == "captured"
    kw = {"mode": sim.MODE_DAS, **second}
    mode, n = kw.pop("mode"), kw.get("n", len(CELLS))
    res, rec = _call(mode, 2, **kw)
    assert (rec or {"graph": "captured"})["graph"] == expect
    assert len(sim._GRAPHS) == (2 if expect == "captured" else 1)
    kw.pop("counted", None)
    _assert_same(_host(res), _host(_eager(mode, 2, **kw)))
    if "step_budget" in kw:
        assert (res.stall_reason == sim.STALL_BUDGET).any()


def test_the_cache_keeps_the_most_recent_few_a_device():
    """Least recently used out first, at `GRAPH_CACHE_SIZE` a device;
    `clear_graph_cache` drops every entry."""
    size = sim.GRAPH_CACHE_SIZE
    for n in range(1, size + 2):                   # one key a lane count
        assert _call(sim.MODE_LUT, 1, n=n)[1]["graph"] == "captured"
    assert len(sim._GRAPHS) == size
    assert [k[4][0][0] for k in sim._GRAPHS] == list(range(2, size + 2))
    assert _call(sim.MODE_LUT, 2, n=2)[1]["graph"] == "hit"
    assert _call(sim.MODE_LUT, 2, n=1)[1]["graph"] == "captured"
    assert [k[4][0][0] for k in sim._GRAPHS] == [4, 5, 2, 1]
    sim.clear_graph_cache()
    assert not sim._GRAPHS
    assert _call(sim.MODE_LUT, 2, n=2)[1]["graph"] == "captured"


def test_freeing_device_memory_drops_the_kept_graphs():
    """The campaign's out-of-memory retry starts with no kept graph."""
    _call(sim.MODE_ETF, 1)
    assert len(sim._GRAPHS) == 1
    camp._free_device_memory()
    assert not sim._GRAPHS
    assert _call(sim.MODE_ETF, 2)[1]["graph"] == "captured"


def test_a_held_entry_is_not_given_to_a_second_call():
    """While a call replays the kept graph, a second call of its key
    captures its own and does not keep it; the first call's entry is
    kept when it returns."""
    _call(sim.MODE_ETF, 1)
    g, = sim._GRAPHS.values()
    real, inner = g.replay, []

    def replay():
        if not inner:
            inner.append(_call(sim.MODE_ETF, 3))
        real()

    g.replay = replay
    outer, rec = _call(sim.MODE_ETF, 2)
    assert rec["graph"] == "hit" and inner[0][1]["graph"] == "captured"
    assert list(sim._GRAPHS.values()) == [g] and not g.held
    _assert_same(_host(outer), _host(_eager(sim.MODE_ETF, 2)))
    _assert_same(_host(inner[0][0]), _host(_eager(sim.MODE_ETF, 3)))
    g.replay = real
    assert _call(sim.MODE_ETF, 3)[1]["graph"] == "hit"


@pytest.fixture
def counted(monkeypatch):
    """`avail_rows` counted in `LAUNCHES` on the CPU too, as the card's
    kernel counts itself: once a call, while recording included."""
    counts = sim._kops.LAUNCHES
    real = sim._kops.avail_rows

    def avail_rows(*a, **kw):
        counts["avail_rows"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(sim._kops, "avail_rows", avail_rows)
    return counts


def test_a_hit_counts_one_blocks_launches_a_replay(counted):
    """`avail_rows` runs once a super-step. A captured call counts its
    eager block's and each replay's; a hit counts each replay's: as many
    as the eager loop on the same inputs."""
    def launches(fn):
        n = counted["avail_rows"]
        out = fn()
        return counted["avail_rows"] - n, out

    n_eager, _ = launches(lambda: _eager(sim.MODE_DAS, 2))
    n_cap, (_, rec_cap) = launches(lambda: _call(sim.MODE_DAS, 1))
    n_hit, (_, rec_hit) = launches(lambda: _call(sim.MODE_DAS, 2))
    assert rec_cap["graph"] == "captured" and rec_hit["graph"] == "hit"
    assert n_cap == rec_cap["steps"]
    assert n_hit == rec_hit["replays"] * sim.POLL_EVERY == n_eager


FAILURES = ["capture-oom", "stopped-hit"]


@pytest.mark.parametrize("failure", FAILURES)
def test_a_failed_call_keeps_nothing(failure, counted, monkeypatch):
    """A capture that fails keeps nothing and leaves `LAUNCHES` with the
    eager block's launches alone; a hit that fails drops its entry."""
    import threading
    if failure == "capture-oom":
        real = sim._block

        def oom_block(*a, **kw):
            out = real(*a, **kw)
            if _RECORDING:
                raise torch.OutOfMemoryError("CUDA out of memory")
            return out

        monkeypatch.setattr(sim, "_block", oom_block)
        n = counted["avail_rows"]
        with pytest.raises(torch.OutOfMemoryError):
            _call(sim.MODE_ETF, 1)
        assert counted["avail_rows"] - n == sim.POLL_EVERY
        monkeypatch.setattr(sim, "_block", real)
    else:
        _call(sim.MODE_ETF, 1)
        assert len(sim._GRAPHS) == 1
        stop = threading.Event()
        stop.set()
        with pytest.raises(sim.Stopped):
            _call(sim.MODE_ETF, 2, stop=stop)
    assert not sim._GRAPHS
    assert _call(sim.MODE_ETF, 2)[1]["graph"] == "captured"


def test_the_cpu_and_eager_paths_keep_nothing():
    """`simulate_batch` on the CPU and `_simulate_eager` run every block
    eagerly and never touch the cache."""
    tel = []
    sim.simulate_batch(sim.MODE_ETF, PARAMS, _wls(1), _tree(),
                       torch.full((len(CELLS),), 900.0), tel)
    sim._simulate_eager(sim.MODE_ETF, PARAMS, _wls(1), _tree(),
                        torch.full((len(CELLS),), 900.0), tel)
    assert [r["graph"] for r in tel] == ["eager", "eager"]
    assert not sim._GRAPHS


def test_repeated_device_parts_of_one_shape_capture_once():
    """A chunk split over one device named twice (`run_chunk`): the first
    part captures, the second replays its graph; bit-equal to the eager
    loop."""
    tel = []
    wls = SUITE.build_many(CELLS * 2)
    sw = sim.prepare_sweep(wls, PARAMS, None, 1e9, None, None,
                           ["cpu", "cpu"], "cpu", "run_batch")
    res = sim.run_chunk(functools.partial(sim._simulate, graph=True),
                        sim.MODE_ETF, sw.params, sw.devs,
                        *sw.lanes(np.arange(sw.n)), telemetry=tel)
    assert [r["graph"] for r in tel] == ["captured", "hit"]
    want = sim._run_batch(sim._simulate_eager, sim.MODE_ETF, wls, PARAMS,
                          device="cpu")
    _assert_same(_host(res), _host(want))


def test_threads_never_hold_one_entry_at_once():
    """Threads taking and giving back entries of a few keys (more threads
    than cores, the interpreter switching often): an entry is held by one
    thread at a time, and at the end none is held and the bound holds."""
    import random
    import sys
    import threading
    import time
    keys = [("cpu", k) for k in range(3)] + [("cuda:0", 0)]
    users, clash, lock = {}, [], threading.Lock()

    def work(seed):
        rng = random.Random(seed)
        for _ in range(400):
            key = rng.choice(keys)
            g = sim._take_graph(key) or sim._Graph(
                key, (), (), None, None, None, sim._GRAPHS_GEN[0])
            with lock:
                users[id(g)] = users.get(id(g), 0) + 1
                if users[id(g)] > 1:
                    clash.append(key)
            time.sleep(0)
            with lock:
                users[id(g)] -= 1
            sim._give_back(g, ok=rng.random() > 0.1)
            if rng.random() < 0.01:
                sim.clear_graph_cache()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,), daemon=True)
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not clash
    assert not any(g.held for g in sim._GRAPHS.values())
    for dev in ("cpu", "cuda:0"):
        assert sum(k[0] == dev for k in sim._GRAPHS) <= sim.GRAPH_CACHE_SIZE
