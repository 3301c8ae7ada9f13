"""The harness driven on the CPU at a small size: each cell comes out
correct; with the timed path broken underneath, `correct` comes out
false; the control (the reference in bfloat16 in the program's place)
comes out false; a cell added as new files is found by name; a traffic's
policy is checked and reaches the program as the call it was before."""
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dasbench import control, harness, inputs, trace
from dasbench.program import Program
from repro_torch.core import campaign, simulator as sim, soc

from dasbench.tests.conftest import ROOT, STRESS_FAULTS

# the DSSoC lane's cells (the LM lane's: `test_bench_lm.py`)
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]
    if harness.resolve_cell(ROOT, w["name"])["config"].get(
        "kind", "dssoc") == "dssoc"]
# the grid under a fault plan a scenario, ETF and LUT in turns: the
# harness's plan path, which no cell drives yet
STRESSED = "stressed.mixed-grid"
DAS = "healthy.das-grid"
SEED = 2**31 + 4099


def _spec(name):
    if name != STRESSED:
        return harness.resolve_cell(ROOT, name)
    spec = harness.resolve_cell(ROOT, "healthy.etf-grid")
    spec["cell"] = dict(spec["cell"], name=STRESSED)
    spec["config"] = dict(spec["config"], faults=STRESS_FAULTS)
    spec["traffic"] = dict(spec["traffic"], modes=["ETF", "LUT"])
    spec["limits"] = {"avg_exec_rel": 0.15, "sched_rel": 0.1,
                      "energy_gap": 0.02, "finish_off": 0.15,
                      "fault_gap": 0.03}
    return spec


def small(name, frames=6, n_mixes=2):
    spec = _spec(name)
    spec["config"] = dict(spec["config"], frames=frames, n_mixes=n_mixes)
    return spec


def run_small(name, seed=SEED, **kw):
    return harness.run(small(name, **kw), seed, 0.2, False, "cpu",
                       time.perf_counter(), log=lambda *a: None)


@pytest.mark.parametrize("name", CELLS + [STRESSED])
def test_cell_is_correct_on_the_cpu(name, small_batch):
    out = run_small(name)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 14 and out["failed"] == 0
    spec = _spec(name)
    assert set(out["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    # the check's numbers come last, each beside its limit
    assert list(out)[-1] == "check"
    assert set(spec["limits"]) <= set(out["check"])


def _stuck_step(ctx, mode, p, s, wl, tree, thr, run, plan=None,
                fcaps=None):
    """A step that returns its state unchanged (and counts an event, so
    the lanes reach their iteration cap instead of looping)."""
    return s, run.long()


def _half_batch(real):
    def compute(mode, part, params, tree, rate_threshold, plan, batch,
                *a, **k):
        n = int(part.task_type.shape[0])
        idx = np.arange(n) % max(1, n // 2)
        part = type(part)(*[np.asarray(f)[idx] for f in part])
        if plan is not None and np.ndim(plan.pe_fail_at) == 2:
            plan = type(plan)(*[np.asarray(f)[idx] for f in plan])
        return real(mode, part, params, tree, rate_threshold, plan, batch,
                    *a, **k)
    return compute


def _altered(real):
    """Every task's finish time reported 1% late where the engine
    produces it (the scenario's aggregates left as they are)."""
    def finalize(*a, **k):
        res = real(*a, **k)
        return res._replace(finish=res.finish * 1.01)
    return finalize


FAULTS = {
    "state_unchanged": lambda mp: mp.setattr(sim, "_masked_step",
                                             _stuck_step),
    "half_batch": lambda mp: mp.setattr(
        campaign, "_compute_chunk", _half_batch(campaign._compute_chunk)),
    "answer_altered": lambda mp: mp.setattr(
        sim, "_finalize", _altered(sim._finalize)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["healthy.etf-grid", STRESSED, DAS])
def test_broken_timed_path_is_not_correct(name, fault, small_batch,
                                          monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run_small(name, frames=4)
    assert out["correct"] is False, (fault, out["check"])


def _rate_halved(real):
    """The feature bank's rate estimate halved where it is made."""
    def features(*a, **k):
        f = real(*a, **k)
        return torch.cat([f[:, :1] * 0.5, f[:, 1:]], 1)
    return features


def _tree_changed(real, change):
    """`run_campaign` given the harness's tree changed underneath."""
    def run(*a, **k):
        k = dict(k)
        tree = change(k.pop("tree"))
        return real(*a, **k) if tree is None else real(*a, tree=tree, **k)
    return run


DAS_FAULTS = {
    "rate_halved": lambda mp: mp.setattr(sim, "_features",
                                         _rate_halved(sim._features)),
    "leaves_inverted": lambda mp: mp.setattr(campaign, "run_campaign",
                                             _tree_changed(
        campaign.run_campaign, lambda t: t._replace(leaf=1 - t.leaf))),
    # the port's own fallback, the always-fast tree
    "policy_dropped": lambda mp: mp.setattr(campaign, "run_campaign",
                                            _tree_changed(
        campaign.run_campaign, lambda t: None)),
    # `_decide` charges no classifier energy
    "classifier_energy_dropped": lambda mp: mp.setattr(
        soc, "DAS_CLS_ENERGY_UJ", np.float32(0.0)),
}


@pytest.mark.parametrize("fault", sorted(DAS_FAULTS))
def test_broken_das_policy_is_not_correct(fault, small_batch, monkeypatch):
    DAS_FAULTS[fault](monkeypatch)
    out = run_small(DAS)
    assert out["correct"] is False, (fault, out["check"])


def test_sweep_without_a_policy_makes_the_call_it_made_before(monkeypatch):
    """A mode without a policy passes `run_campaign` the mode, the
    workload, the params, the plan, the chunk size and the device, and
    nothing else; DAS adds its policy's tree, made once; a DAS sweep
    without a policy, or a policy for another mode, is refused."""
    calls = []

    class Out:
        result = stats = None

    monkeypatch.setattr(campaign, "run_campaign",
                        lambda *a, **k: calls.append((a, k)) or Out)
    cfg = small("healthy.etf-grid")["config"]
    prog = Program(cfg, "cpu")
    das = inputs.Traffic(cfg, small(DAS)["traffic"]).sweep(SEED, 0)
    sw = inputs.Traffic(cfg, small("healthy.etf-grid")["traffic"]).sweep(
        SEED, 0)
    prog.sweep(sw.mode, sw.wl, sw.plan, 64, sw.policy)
    prog.sweep(das.mode, das.wl, das.plan, 64, das.policy)
    prog.sweep(das.mode, das.wl, das.plan, 64, das.policy)
    (a, k), (a_das, k_das), (_, k_again) = calls
    assert k_again["tree"] is k_das["tree"]
    assert len(a) == 3 and a[0] == sim.MODE_ETF and a[2] is prog.params
    assert all(np.array_equal(x, y) for x, y in zip(a[1], sw.wl))
    assert k == {"plan": None, "batch_size": 64, "device": "cpu"}
    assert a_das[0] == sim.MODE_DAS
    tree = k_das.pop("tree")
    assert k_das == k
    assert tree.feat.tolist() == list(das.policy.feat)
    assert tree.thr.tolist() == list(das.policy.thr)
    assert tree.leaf.tolist() == list(das.policy.leaf)
    with pytest.raises(ValueError):
        prog.sweep("DAS", das.wl, None, 64)
    with pytest.raises(ValueError):
        prog.sweep("ETF", sw.wl, None, 64, das.policy)
    assert len(calls) == 3


def _das_traffic(**change):
    t = json.loads((ROOT / "dasbench" / "traffic" / "das-grid.json")
                   .read_text())
    t["policy"]["DAS"].update(change)
    return t


BAD_POLICIES = {
    "a node reads another feature": dict(feat=[5, 0, 0]),
    "a threshold that is no float32": dict(thr=[0.1, None, None]),
    "an infinite threshold written as a number": dict(
        thr=[float("inf"), None, None]),
    "a leaf that picks no scheduler": dict(leaf=[0, 2, 0, 1]),
    "too few leaves": dict(leaf=[0, 1, 1]),
    "a key the tree does not have": dict(classifier_energy_uj=0.0019),
    "a fit in two lines": dict(fitted="a\nb"),
}


@pytest.mark.parametrize("bad", sorted(BAD_POLICIES))
def test_a_bad_policy_is_refused(bad):
    cfg = small(DAS)["config"]
    with pytest.raises(ValueError):
        inputs.Traffic(cfg, _das_traffic(**BAD_POLICIES[bad]))


def test_a_policy_belongs_to_the_modes_that_run_it():
    cfg = small(DAS)["config"]
    # a pass-through node may name any feature: it reads none
    ok = inputs.Traffic(cfg, _das_traffic(feat=[0, 7, 0],
                                          thr=[100.0, None, 500.0]))
    assert ok.sweep(1, 0).policy.thr[1] == float("inf")
    # DAS without a policy is refused where the sweep would run the
    # port's always-fast tree
    no_policy = dict(_das_traffic())
    del no_policy["policy"]
    with pytest.raises(ValueError, match="policy None"):
        harness.run(dict(small(DAS), traffic=no_policy), SEED, 0.2, False,
                    "cpu", time.perf_counter(), log=lambda *a: None)
    with pytest.raises(ValueError, match="runs"):
        inputs.Traffic(cfg, dict(_das_traffic(), modes=["ETF"]))
    with pytest.raises(ValueError, match="mode"):
        inputs.Traffic(cfg, dict(_das_traffic(), modes=["DAS", "oracle"]))


@pytest.mark.parametrize("name", CELLS + [STRESSED])
def test_control_is_not_correct(name):
    spec = small(name, frames=8)
    out = control.run(spec, SEED, 2)
    assert out["correct"] is False, out["check"]


def test_cell_added_as_files_is_found_by_name(tmp_path):
    """New cells, their traffic, their limits and a new per-layer metric,
    each a new file beside the existing ones, with entries added to
    `BENCHMARK.json`: the harness runs them with no existing file of
    `dasbench/` edited. One is a second DAS traffic, its policy in its
    own file."""
    shutil.copytree(ROOT / "dasbench", tmp_path / "dasbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out",
                                                  ".cache", "tests"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "dasbench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] += [
        {"name": "healthy.lut-rows", "config": "dssoc19-healthy",
         "traffic": "lut-rows", "chips": 1, "why": "a row under LUT"},
        {"name": "healthy.das-rows", "config": "dssoc19-healthy",
         "traffic": "das-rows", "chips": 1, "why": "a row under DAS"}]
    bench["per_layer"].append({
        "name": "engine.events_per_sweep", "unit": "events",
        "better": "higher", "source": "program_counter", "layer": "engine",
        "moves": "scenarios_per_s", "workloads": ["healthy.lut-rows"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    d = tmp_path / "dasbench"
    (d / "traffic" / "lut-rows.json").write_text(json.dumps({
        "modes": ["LUT"], "shape": "row",
        "check": {"keep_per_sweep": 3, "sample": 6}}))
    (d / "traffic" / "das-rows.json").write_text(json.dumps({
        "modes": ["DAS"], "shape": "row",
        "check": {"keep_per_sweep": 3, "sample": 6},
        "policy": {"DAS": {
            "feat": [0, 2, 0], "thr": [700.0, 0.25, None],
            "leaf": [0, 1, 1, 1], "fitted": "by hand, for this test"}}}))
    for cell in ("healthy.lut-rows", "healthy.das-rows"):
        (d / "limits" / f"{cell}.json").write_text(json.dumps(
            {"avg_exec_rel": 1e-2, "finish_off": 5e-2}))
    (d / "metrics" / "engine.events_per_sweep.py").write_text(
        "def read(r):\n"
        "    return sum(s['events'] for s in r.sweeps) / len(r.sweeps)\n")
    script = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}]\n"
        "from dasbench import harness\n"
        "from pathlib import Path\n"
        "outs = {}\n"
        "for cell in ('healthy.lut-rows', 'healthy.das-rows'):\n"
        "    spec = harness.resolve_cell(Path(sys.path[0]), cell)\n"
        "    spec['config'] = dict(spec['config'], frames=4, n_mixes=2)\n"
        "    outs[cell] = harness.run(spec, 11, 0.1, False, 'cpu',"
        " time.perf_counter(), log=lambda *a: None)\n"
        "    outs[cell]['per_layer'] = [m['name']"
        " for m in spec['per_layer']]\n"
        "assert harness.__file__.startswith(sys.path[0]), harness.__file__\n"
        "r = harness.Readings(spec['cell'], spec['config'], spec['traffic'],"
        " 1.0, 1.0, [{'events': 10}, {'events': 20}], [], None)\n"
        "outs['layer'] = harness.reader('engine.events_per_sweep')(r)\n"
        "print(json.dumps(outs))\n")
    env = {"REPRO_BENCH_BATCH": "64", "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    outs = json.loads(proc.stdout.strip().splitlines()[-1])
    lut, das = outs["healthy.lut-rows"], outs["healthy.das-rows"]
    assert lut["correct"], lut["check"]
    assert das["correct"], das["check"]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "dasbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())
    assert lut["per_layer"][-1] == "engine.events_per_sweep"
    assert outs["layer"] == 15
    assert set(das["metrics"]) == set(lut["metrics"])


def test_no_gpu_no_result(tmp_path):
    """On a machine without a card the command prints no result and
    fails."""
    proc = subprocess.run(
        [sys.executable, "dasbench/run.py", "--workload", "healthy.etf-grid",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


class _FakeSlice:
    """The profiler's slice without a card: one device operation, a
    search kernel, over the first half of the traced sweep."""

    def __init__(self):
        self.spans, self.starts = [], 0

    def start(self):
        self.starts += 1
        self.t0 = time.time_ns()

    span = trace.Slice.span

    def stop(self):
        t1 = time.time_ns()
        self.spans.append(("slice", self.t0, t1))

        class Event:
            def __init__(s, t0, dur):
                s.t0, s.dur = t0, dur

            def name(s):
                return "void etf_search_fixed<16, 19>(...)"

            def device_type(s):
                return "DeviceType.CUDA"

            def start_ns(s):
                return s.t0

            def duration_ns(s):
                return s.dur

        ev = [Event(self.t0, (t1 - self.t0) // 2)]
        return type("R", (), {"events": lambda s: ev})(), self.spans


@pytest.mark.parametrize("name", ["healthy.etf-grid", DAS])
def test_traced_run_reads_idle_against_the_untraced_sweep(name, small_batch,
                                                          monkeypatch,
                                                          tmp_path):
    """A `--trace 1` run sweeps its first inputs untraced, then traced,
    and reads the per-layer metrics from the traced one."""
    made = []
    monkeypatch.setattr(harness, "OUT_DIR", tmp_path)
    monkeypatch.setattr(trace, "Slice",
                        lambda: made.append(_FakeSlice()) or made[-1])
    spec = small(name, frames=4)
    out = harness.run(spec, SEED, 0.2, True, "cpu", time.perf_counter(),
                      log=lambda *a: None)
    assert out["correct"], out["check"]
    assert made[0].starts == 1
    assert {s[0] for s in made[0].spans} == {"draw", "run_campaign", "keep",
                                             "slice"}
    trace_file = json.loads((harness.OUT_DIR / f"{name}.trace.json")
                            .read_text())
    first, = trace_file["traced_sweeps"]
    assert first["traced"] and first["index"] == 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == {x["name"] for x in spec["per_layer"]}
    busy = out["device"]["busy_s"]
    assert busy == pytest.approx(out["device"]["window_s"] / 2, rel=1e-6)
    assert m["device.idle_share"] == pytest.approx(
        1 - busy / first["untraced_wall_s"])
    assert m["etf_ft.search_roofline"] > 0
    if name == DAS:
        # both sweeps of the window, the untraced and the traced, of the
        # same inputs
        sweeps = trace_file["traced_sweeps"]
        assert m["das.slow_share"] == sweeps[0]["slow"] / sweeps[0][
            "decisions"]
        assert 0 < m["das.slow_share"] < 1
